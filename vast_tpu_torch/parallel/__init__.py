"""Parallelism over ``torch.distributed``: the process group and the
``(dp, fsdp, tp)`` mesh (``mesh``), the collectives of training and
evaluation (``collectives``), tensor parallelism (``tp``) and parameter
sharding (``fsdp``). Counterpart of ``vast_tpu.parallel``."""

from vast_tpu_torch.parallel.mesh import (active, barrier, create_mesh,
                                          data_group, destroy, group_rank,
                                          group_size, init_distributed,
                                          is_main, rank, tp_group, world)

__all__ = ["active", "barrier", "create_mesh", "data_group", "destroy",
           "group_rank", "group_size", "init_distributed", "is_main",
           "rank", "tp_group", "world"]
