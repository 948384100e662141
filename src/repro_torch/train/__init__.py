"""Training: LR schedules, the train and eval steps, the ``Trainer`` loop
with checkpoints and the resilience ladder, the chaos harness and the
restart supervisor."""
from .schedule import constant, cosine_warmup, linear_warmup
from .steps import TrainState, loss_fn, make_eval_step, make_train_step

__all__ = ["TrainState", "loss_fn", "make_train_step", "make_eval_step",
           "cosine_warmup", "linear_warmup", "constant"]
