"""The multi-device solve: scenarios (chains) sharded over torch.distributed
ranks, the crown replicated (``sharding``), the rank launcher
(``launcher``) and the sharded solvers' entry points (``shard_solver``)."""
