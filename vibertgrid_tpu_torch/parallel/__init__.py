"""Data parallelism over ``torch.distributed``: the bootstrap and rank
helpers (``mesh``), the global-batch reductions of a train step
(``collectives``) and the ZeRO-1 partition of the optimizer state
(``sharding``)."""
