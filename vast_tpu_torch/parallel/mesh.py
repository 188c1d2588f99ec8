"""The process group of a data-parallel run: one process a card.

Counterpart of ``vast_tpu.parallel.mesh`` for its ``dp`` axis alone, and
of the reference's utils/initialize.py:14-16. ``vast_tpu`` starts
``jax.distributed`` from ``VAST_COORDINATOR`` (run.py:17-25) and lets
XLA place a global batch on a mesh; here ``torchrun`` starts one process
a card and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (and the
rendezvous address), and each rank loads its own rows of the global
batch, so ``shard_batch``, ``constrain_batch_dim`` and
``combined_param_sharding`` have no counterpart.

The backend is ``nccl`` for CUDA ranks and ``gloo`` for CPU ranks.
``VAST_DIST_BACKEND=gloo`` lets CUDA ranks share cards over gloo (two
ranks on one card: NCCL refuses a card twice). A CUDA world with more
ranks on a host than cards and no such request raises; it never falls to
gloo by itself, a rank never falls to the CPU, and a process that
torchrun started with ``WORLD_SIZE`` > 1 but that has no group raises at
its first collective rather than taking it for the identity.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from vast_tpu_torch.device import resolve_device

BACKEND_ENV = "VAST_DIST_BACKEND"


def choose_backend(device_type: str, local_world: int, n_cards: int,
                   requested: str | None = None) -> str:
    """The backend of a rank on ``device_type`` ('cuda' or 'cpu') with
    ``local_world`` ranks on its host and ``n_cards`` cards visible;
    ``requested`` is ``VAST_DIST_BACKEND`` ('' or None: the default)."""
    if requested not in (None, "", "gloo", "nccl"):
        raise ValueError(f"{BACKEND_ENV}={requested!r}: 'gloo' or 'nccl'")
    if device_type == "cpu":
        if requested == "nccl":
            raise ValueError(f"{BACKEND_ENV}=nccl needs CUDA ranks")
        return "gloo"
    if requested == "gloo":
        return "gloo"
    if local_world > n_cards:
        raise RuntimeError(
            f"{local_world} ranks on this host and {n_cards} CUDA "
            f"card(s): NCCL takes one card a rank. Start at most "
            f"{n_cards} ranks a host, or set {BACKEND_ENV}=gloo to let "
            f"ranks share a card over gloo")
    return "nccl"


def init_distributed(device=None, init_method: str | None = None):
    """Join the run's process group; returns ``(rank, world, device)``.

    Without ``WORLD_SIZE`` in the environment this is a world of one on
    ``device`` (None: the GPU) and no group is started. Otherwise
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (``torchrun`` sets them)
    place the rank: a CUDA rank on card ``LOCAL_RANK`` (modulo the cards,
    where ``VAST_DIST_BACKEND=gloo`` shares them), a CPU rank where
    ``device`` is 'cpu'. ``init_method`` (None: ``env://``, torchrun's
    rendezvous address) reaches ``init_process_group``."""
    if "WORLD_SIZE" not in os.environ:
        return 0, 1, resolve_device(device)
    world_size = int(os.environ["WORLD_SIZE"])
    rank_ = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = resolve_device(device)
    requested = os.environ.get(BACKEND_ENV)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        backend = choose_backend("cuda", local_world, n_cards, requested)
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    else:
        backend = choose_backend("cpu", local_world, 0, requested)
    if dist.is_initialized():
        if dist.get_backend() != backend or dist.get_rank() != rank_:
            raise RuntimeError(
                f"a process group ({dist.get_backend()}, rank "
                f"{dist.get_rank()}) runs already; this rank wants "
                f"{backend}, rank {rank_}")
    else:
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank_, world_size=world_size,
                                **({"device_id": dev}
                                   if backend == "nccl" else {}))
    return rank_, world_size, dev


def active() -> bool:
    """Whether a process group runs (a world of one has none). Raises
    where ``WORLD_SIZE`` > 1 says there should be one."""
    if dist.is_available() and dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']} but no process group "
            f"runs: call vast_tpu_torch.parallel.init_distributed() first")
    return False


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing in a world of one)."""
    if not active():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def destroy() -> None:
    """Leave the process group, where one runs."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
