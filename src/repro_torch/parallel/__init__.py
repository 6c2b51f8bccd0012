"""Multi-GPU composition: the sharding rules and the shard context
(``sharding``), the collectives the runners name (``collectives``), the
compressed gradient mean (``compression``) and the GPipe pipeline
(``pipeline``).  Collectives run outside the kernels, through
``torch.distributed``."""
