"""Training: LR schedules, the train step and the ``Trainer`` loop."""
