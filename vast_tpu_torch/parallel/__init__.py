"""Data parallelism over ``torch.distributed``: the process group
(``mesh``) and the collectives of training and evaluation
(``collectives``). Counterpart of ``vast_tpu.parallel`` for its ``dp``
axis; ``fsdp`` and ``tp`` are not ported."""

from vast_tpu_torch.parallel.mesh import (active, barrier, destroy,
                                          init_distributed, is_main, rank,
                                          world)

__all__ = ["active", "barrier", "destroy", "init_distributed", "is_main",
           "rank", "world"]
