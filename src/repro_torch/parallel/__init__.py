"""Data parallelism and ZeRO-1 over ``torch.distributed``: the active mesh
and the placements of state and batches (``sharding``), and the
partitioned optimizer update (``zero``)."""
