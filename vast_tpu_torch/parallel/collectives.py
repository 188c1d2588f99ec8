"""The collectives of data-parallel training and evaluation.

Counterpart of ``vast_tpu.parallel.collectives`` (collectives.py:81-145:
``gather_array``, ``sum_across_hosts``, ``gather_list``) and of the
reference's utils/distributed.py:12-66 (``GatherLayer``,
``concat_all_gather``), over ``group`` (None: ``torch.distributed``'s
default group; a sharded run passes its mesh's data group, the dp x fsdp
ranks that split the batch: ``parallel.mesh.data_group``). Every one is
built on ``all_gather`` and ``all_reduce`` alone, which gloo (CPU ranks,
or CUDA ranks sharing a card) and NCCL both serve. Without a process
group each is the identity. ``host_rows`` and
``assemble_addressable_rows`` have no counterpart: a rank's outputs are
its own rows already.

Tensors travel on the device the backend needs: a CUDA one under NCCL,
where they are (CPU or CUDA) under gloo. numpy arrays come back as
numpy, tensors on the device they came from.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.distributed as dist

from vast_tpu_torch.parallel.mesh import active, group_rank, group_size

# at most this many bytes a rank in one call of sum_across_hosts
SUM_CHUNK_BYTES = 64 << 20


def _comm_device(t: torch.Tensor) -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on every rank), in rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def _gather_ragged(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t``, whose leading dims may differ: padded to the
    largest for the gather, each cut back to its own count."""
    count = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    counts = [int(c) for c in _all_gather(count, group)]
    most = max(counts)
    if t.shape[0] < most:
        t = torch.cat([t, t.new_zeros((most - t.shape[0],) + t.shape[1:])])
    return [p[:c] for p, c in zip(_all_gather(t, group), counts)]


def _as_tensor(x):
    """(tensor on the collective's device, back-conversion)."""
    if isinstance(x, torch.Tensor):
        home = x.device
        return x.to(_comm_device(x)), lambda t: t.to(home)
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(_comm_device(t)), lambda t: t.cpu().numpy()


def gather_array(x, group=None):
    """Concatenate every rank's ``x`` along axis 0, in rank order; the
    ranks' row counts may differ (ragged: an evaluation shard trimmed of
    its ``padded_tail``), as the reference's ``ddp_allgather``
    (utils/distributed.py:133-151). numpy or tensor in, the same out."""
    if not active():
        return x
    t, back = _as_tensor(x)
    return back(torch.cat(_gather_ragged(t, group)))


def gather_list(items: list, group=None) -> list:
    """Concatenate every rank's list of JSON-serialisable items, in rank
    order: each list travels as UTF-8 JSON, padded to the longest."""
    if not active():
        return list(items)
    payload = np.frombuffer(json.dumps(items).encode("utf-8"), np.uint8)
    t, _ = _as_tensor(payload.copy())
    out: list = []
    for part in _gather_ragged(t, group):
        out.extend(json.loads(bytes(part.cpu().numpy()).decode("utf-8")))
    return out


def sum_across_hosts(x, group=None):
    """Elementwise sum of every rank's ``x`` (the same shape on each):
    the merge of disjoint partial results, such as each rank's share of
    the rerank's score matrix (``evaluation_mm.rerank_scores``), zero
    elsewhere. In slices of at most ``SUM_CHUNK_BYTES`` along axis 0."""
    if not active():
        return x
    t, back = _as_tensor(x)
    t = t.clone()
    row = max(t[:1].numel() * t.element_size(), 1)
    rows = max(1, SUM_CHUNK_BYTES // row)
    for s in range(0, t.shape[0], rows):
        part = t[s:s + rows]
        dist.all_reduce(part, group=group)
    return back(t)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; no gradient)."""
    out = t.detach().clone()
    if active():
        dist.all_reduce(out, group=group)
    return out


def all_reduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``t`` over the ranks (a new tensor; no gradient)."""
    return all_reduce_sum(t, group) / group_size(group)


@torch.no_grad()
def all_gather_detached(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along axis 0, carrying no
    gradient: the reference's ``concat_all_gather``. The ranks' shapes
    must be equal."""
    if not active():
        return t.detach()
    return torch.cat(_all_gather(t.detach(), group))


class _GatherWithGrad(torch.autograd.Function):
    """The reference's ``GatherLayer`` (utils/distributed.py:12-28):
    forward gathers; backward sums the gradient of the gathered tensor
    over the ranks and returns this rank's slice."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return torch.cat(_all_gather(t, group))

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return (grad.chunk(group_size(ctx.group))[group_rank(ctx.group)],
                None)


def all_gather_with_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along axis 0, with the gradient of
    this rank's rows summed over every rank's use of them."""
    if not active():
        return t
    return _GatherWithGrad.apply(t, group)
