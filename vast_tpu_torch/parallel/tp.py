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
bias once, after the sum. A column-parallel weight of several runs (the
packed q, k and v of CLIP's ``in_proj`` and Swin's ``qkv``) holds this
rank's heads of each run, and its bias is sliced alike (``TpInfo.part``).
A parameter that stays whole but that a split module uses only in part
(a column layer's bias, EVA's q and v biases, BEATs' head gate, Swin's
relative-position table, AST's q, k and v: :class:`PartColumnLinear`) is
sliced at use and its gradient summed over the group by the trainer
(``ParamPlan.tp_partial``). :func:`layer_norm`
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

    def part(self, t: torch.Tensor, runs: int = 1) -> torch.Tensor:
        """This rank's rows (dim 0) of ``t``: its block of each of
        ``runs`` equal runs (``ParamPlan.tp_index``'s rows)."""
        if runs == 1:
            return t[self.block(t.shape[0])]
        t = t.unflatten(0, (runs, -1))
        return t[:, self.block(t.shape[1])].flatten(0, 1)


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
    """This rank's output rows (its block of each of ``runs`` runs); the
    bias stays whole and is sliced alike."""

    tp: TpInfo
    runs: int = 1

    def forward(self, x):
        x = copy_to(x, self.tp)
        b = None
        if self.bias is not None:
            b = self.tp.part(self.bias, self.runs).to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class PartColumnLinear(ColumnParallelLinear):
    """A column-parallel layer whose weight stays whole too (vast_tpu
    keeps AST's q, k and v whole under tp): this rank's rows of the
    weight and the bias are sliced at use."""

    def forward(self, x):
        x = copy_to(x, self.tp)
        b = None if self.bias is None else self.tp.part(self.bias)
        return F.linear(x, self.tp.part(self.weight).to(x.dtype),
                        None if b is None else b.to(x.dtype))


class RowParallelLinear(layers.Linear):
    """This rank's input columns; the partial products summed, then the
    whole bias added once."""

    tp: TpInfo

    def forward(self, x):
        y = reduce_from(F.linear(x, self.weight.to(x.dtype)), self.tp)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def parallelize(linear: layers.Linear, kind: str, tp: TpInfo,
                runs: int = 1) -> None:
    """Make ``linear`` column-parallel ('col', its weight already this
    rank's part, of ``runs`` runs), row-parallel ('row') or a whole layer
    used in part ('part') in place: its parameters and names stay."""
    linear.__class__ = {"col": ColumnParallelLinear,
                        "row": RowParallelLinear,
                        "part": PartColumnLinear}[kind]
    linear.tp = tp
    linear.runs = runs


def split_module(module, tp: TpInfo) -> None:
    """Turn the layers of ``module.tp_linears()`` column- or
    row-parallel, as vast_tpu's owner names class them, and give
    ``module`` its ``tp``. A bare weight of the table (CLIP's packed
    ``in_proj_weight``) is the module's own: its forward splits it."""
    from vast_tpu_torch.parallel.mesh import COL, tp_params

    for child, (owner, runs) in module.tp_linears().items():
        if tp_params(module, child)[0] == f"{child}.weight":
            parallelize(module.get_submodule(child),
                        "col" if owner in COL else "row", tp, runs)
    module.tp = tp
