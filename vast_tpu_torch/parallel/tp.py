"""Megatron-style tensor parallelism on local tensors.

Counterpart of the ``tp`` axis of ``vast_tpu.parallel.mesh`` (mesh.py:
84-146), where XLA splits the column- and row-parallel kernels of a
global program. Here each rank of the tp group holds its heads of a
split module and runs the same kernels on them (H / tp heads): a
column-parallel layer's output rows (q, k, v, the MLP's up projection)
and a row-parallel layer's input columns (the attention's output and
the MLP's down projection). Two autograd functions join the parts
(Megatron-LM's ``f`` and ``g``):

* :func:`copy_to` before a column-parallel layer: identity forward, the
  input's gradient summed over the group backward;
* :func:`reduce_from` after a row-parallel layer: the partial outputs
  summed over the group forward, identity backward.

:class:`ColumnParallelLinear` and :class:`RowParallelLinear` are
``layers.Linear`` with those around it; the row-parallel one adds its
bias once, after the sum. A parameter that stays whole but that a split
module uses only in part (a column layer's bias, EVA's q and v biases,
BEATs' head gate) is sliced at use and its gradient summed over the
group by the trainer (``ParamPlan.tp_partial``). :func:`layer_norm`
normalises a tensor whose channels are split over the group (EVA02's
sub-LayerNorms) with the mean and variance of all of them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from vast_tpu_torch.models import layers


@dataclasses.dataclass(frozen=True, eq=False)
class TpInfo:
    """This rank's place in its tp group."""

    group: object
    rank: int
    size: int

    def block(self, n: int) -> slice:
        """This rank's contiguous part of ``n`` channels."""
        part = n // self.size
        return slice(self.rank * part, (self.rank + 1) * part)


def _all_reduce(x: torch.Tensor, tp: TpInfo) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=tp.group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.tp), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduce(torch.autograd.Function):
    """A sum over the group whose every rank's output depends on every
    rank's input: the gradient is summed too."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.tp), None


def copy_to(x: torch.Tensor, tp: TpInfo | None) -> torch.Tensor:
    """Enter the tp region (identity where ``tp`` is None)."""
    return x if tp is None else _CopyTo.apply(x, tp)


def reduce_from(x: torch.Tensor, tp: TpInfo | None) -> torch.Tensor:
    """Leave the tp region: the sum of the ranks' partial outputs."""
    return x if tp is None else _ReduceFrom.apply(x, tp)


def all_reduce(x: torch.Tensor, tp: TpInfo | None) -> torch.Tensor:
    return x if tp is None else _AllReduce.apply(x, tp)


def layer_norm(x, ln: layers.LayerNorm, tp: TpInfo | None, rows=None):
    """``ln`` over channels split over ``tp``: ``x`` holds this rank's
    channels (``rows`` of ``ln``'s weight and bias; None: its block), the
    statistics are those of every rank's, in fp32 (flax's mean of squares
    less the squared mean)."""
    if tp is None:
        return ln(x)
    rows = tp.block(ln.weight.shape[0]) if rows is None else rows
    xf = x.float()
    n = ln.weight.shape[0]
    stats = all_reduce(torch.stack([xf.sum(-1), xf.square().sum(-1)]), tp)
    mean = stats[0] / n
    var = (stats[1] / n - mean.square()).clamp(min=0.0)
    y = (xf - mean[..., None]) * torch.rsqrt(var[..., None] + ln.eps)
    y = y.to(x.dtype)
    return y * ln.weight[rows].to(x.dtype) + ln.bias[rows].to(x.dtype)


class ColumnParallelLinear(layers.Linear):
    """This rank's output rows; the bias stays whole and is sliced."""

    tp: TpInfo

    def forward(self, x):
        x = copy_to(x, self.tp)
        b = None
        if self.bias is not None:
            b = self.bias[self.tp.block(self.bias.shape[0])].to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class RowParallelLinear(layers.Linear):
    """This rank's input columns; the partial products summed, then the
    whole bias added once."""

    tp: TpInfo

    def forward(self, x):
        y = reduce_from(F.linear(x, self.weight.to(x.dtype)), self.tp)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def parallelize(linear: layers.Linear, kind: str, tp: TpInfo) -> None:
    """Make ``linear`` (its weight already this rank's part) column- or
    row-parallel in place: its parameters and names stay."""
    linear.__class__ = {"col": ColumnParallelLinear,
                        "row": RowParallelLinear}[kind]
    linear.tp = tp


def split_module(module, tp: TpInfo) -> None:
    """Turn the layers of ``module.tp_linears()`` column- or
    row-parallel, as vast_tpu's owner names class them, and give
    ``module`` its ``tp``."""
    from vast_tpu_torch.parallel.mesh import COL

    for child, (owner, _) in module.tp_linears().items():
        parallelize(module.get_submodule(child),
                    "col" if owner in COL else "row", tp)
    module.tp = tp
