"""Data parallelism and ZeRO-1 over ``torch.distributed``: the active mesh
and the placements of state and batches (``sharding``), FSDP's schedule of
the train step (``fsdp``: weights gathered on use, gradients reduced to
blocks), the partitioned optimizer update (``zero``), and the collectives
with their backward that the models' mesh bodies run (``collectives``)."""
