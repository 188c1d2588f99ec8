"""The process group of a run and its mesh: one process a card.

Counterpart of ``vast_tpu.parallel.mesh`` and of the reference's
utils/initialize.py:14-16. ``vast_tpu`` starts ``jax.distributed`` from
``VAST_COORDINATOR`` (run.py:17-25) and lets XLA place a global batch on
a mesh; here ``torchrun`` starts one process a card and sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` (and the rendezvous address), and each
rank loads its own rows of the global batch, so ``shard_batch``,
``batch_sharding``, ``replicated`` and ``constrain_batch_dim`` have no
counterpart.

The mesh (``create_mesh``) is a ``DeviceMesh`` over the world with dims
``("dp", "fsdp", "tp")``, rank ``r`` at ``(r // (fsdp * tp), r // tp %
fsdp, r % tp)``. Its **data group** (``data_group``: the dp x fsdp ranks
of one tp index) carries the batch, as ``batch_sharding`` puts the
batch over ``("dp", "fsdp")``; its **tp group** (``tp_group``) shares the
heads of a split module and sees the same rows. ``combined_param_sharding``
says, parameter by parameter, which are split over ``tp`` (Megatron
column- and row-parallel) and ``fsdp`` (ZeRO-3), by ``vast_tpu``'s rule
(mesh.py:84-146); ``training/step.py``'s ``shard_state`` carries the
plan out.

The backend is ``nccl`` for CUDA ranks and ``gloo`` for CPU ranks.
``VAST_DIST_BACKEND=gloo`` lets CUDA ranks share cards over gloo (two
ranks on one card: NCCL refuses a card twice). A CUDA world with more
ranks on a host than cards and no such request raises; it never falls to
gloo by itself, a rank never falls to the CPU, and a process that
torchrun started with ``WORLD_SIZE`` > 1 but that has no group raises at
its first collective rather than taking it for the identity.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

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


# ------------------------------------------------------------------ mesh

MESH_DIMS = ("dp", "fsdp", "tp")


def create_mesh(dp: int | None = None, fsdp: int = 1, tp: int = 1):
    """The run's ``DeviceMesh`` over every rank, dims ``("dp", "fsdp",
    "tp")`` (``vast_tpu``'s ``create_mesh``, mesh.py:27-35). ``dp``
    None: ``world // (fsdp * tp)``. ``dp * fsdp * tp`` must be the world.
    Every rank calls it, in the same order as its other groups: it builds
    the data group beside the mesh's own."""
    from torch.distributed.device_mesh import DeviceMesh

    n = world()
    if dp is None:
        dp = n // (fsdp * tp)
    if dp < 1 or fsdp < 1 or tp < 1 or dp * fsdp * tp != n:
        raise ValueError(f"mesh dp={dp} x fsdp={fsdp} x tp={tp} does not "
                         f"multiply to the world of {n} ranks")
    if not active():
        raise RuntimeError("create_mesh needs a process group: call "
                           "vast_tpu_torch.parallel.init_distributed() "
                           "under torchrun")
    grid = torch.arange(n).view(dp, fsdp, tp)
    device_type = "cuda" if dist.get_backend() == "nccl" or (
        torch.cuda.is_available() and torch.cuda.is_initialized()) else "cpu"
    mesh = DeviceMesh(device_type, grid, mesh_dim_names=MESH_DIMS)
    data = None
    for t in range(tp):
        ranks = grid[..., t].flatten().tolist()
        g = dist.new_group(ranks)
        if rank() in ranks:
            data = g
    mesh._vast_data_group = data
    return mesh


def mesh_shape(mesh) -> dict:
    """``{"dp": .., "fsdp": .., "tp": ..}`` of a mesh, or of such a dict
    itself (a plan needs only the sizes, and no process group)."""
    if isinstance(mesh, dict):
        return {d: int(mesh.get(d, 1)) for d in MESH_DIMS}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_group(mesh):
    """The dp x fsdp ranks of this rank's tp index: the group that
    splits the batch (None: the default group, where there is no mesh)."""
    return None if mesh is None else mesh._vast_data_group


def tp_group(mesh):
    return None if mesh is None else mesh.get_group("tp")


def fsdp_group(mesh):
    return None if mesh is None else mesh.get_group("fsdp")


def group_rank(group=None) -> int:
    """This rank's index in ``group`` (None: the world)."""
    return dist.get_rank(group) if active() else 0


def group_size(group=None) -> int:
    return dist.get_world_size(group) if active() else 1


# ------------------------------------------------------------ the plan

# vast_tpu's owner names of column- and row-parallel kernels (mesh.py:
# 84-86); the port's modules map their linear layers onto them
# (``tp_linears()``), since torch's module names differ (BERT's
# ``attention.output.dense`` is flax's ``out``)
COL = ("query", "key", "value", "qkv", "q_proj", "k_proj", "v_proj",
       "in_proj", "intermediate", "fc1", "w1", "w2", "c_fc")
ROW = ("out", "out_proj", "output", "proj", "fc2", "w3", "c_proj")

# parameters below this many elements stay whole on every rank (LN
# scales, biases, relative-bias tables, type embeddings), as in vast_tpu
MIN_SHARD_SIZE = 16384


@dataclasses.dataclass(frozen=True)
class ParamPlan:
    """Where a parameter of full shape ``shape`` lives.

    ``tp_dim``: the dim split over ``tp`` (0: a column-parallel weight's
    output rows; 1: a row-parallel weight's input columns); rank ``t``
    holds ``tp_index(t)`` of it: part ``t`` of each of ``tp_groups``
    equal runs (EVA01's fused ``qkv`` has three, q, k and v, so that each
    rank holds its heads of each). ``fsdp_dim``: the dim of the tp-local
    tensor split into ``fsdp`` contiguous parts, rank ``f`` of the fsdp
    group holding part ``f``. ``tp_partial``: the parameter stays whole
    but its tp-split module uses only this rank's heads of it, so its
    gradient is summed over the tp group."""

    shape: tuple
    tp_dim: int | None = None
    tp: int = 1
    tp_groups: int = 1
    fsdp_dim: int | None = None
    fsdp: int = 1
    tp_partial: bool = False

    @property
    def whole(self) -> bool:
        return self.tp_dim is None and self.fsdp_dim is None

    def tp_index(self, t: int) -> np.ndarray:
        """The indices along ``tp_dim`` that tp rank ``t`` holds."""
        n = self.shape[self.tp_dim]
        run = n // self.tp_groups
        part = run // self.tp
        return np.concatenate([np.arange(g * run + t * part,
                                         g * run + (t + 1) * part)
                               for g in range(self.tp_groups)])

    def local_shape(self) -> tuple:
        s = list(self.shape)
        if self.tp_dim is not None:
            s[self.tp_dim] //= self.tp
        if self.fsdp_dim is not None:
            s[self.fsdp_dim] //= self.fsdp
        return tuple(s)

    def split(self, full: torch.Tensor, t: int, f: int) -> torch.Tensor:
        """Rank (tp ``t``, fsdp ``f``)'s part of the full tensor."""
        x = full
        if self.tp_dim is not None:
            idx = torch.from_numpy(self.tp_index(t)).to(x.device)
            x = x.index_select(self.tp_dim, idx)
        if self.fsdp_dim is not None:
            n = x.shape[self.fsdp_dim] // self.fsdp
            x = x.narrow(self.fsdp_dim, f * n, n)
        return x.contiguous()


def _fsdp_dim(shape, fsdp: int, skip) -> int | None:
    """vast_tpu's choice: the largest dim (the first of equals) other
    than ``skip`` that divides by ``fsdp`` and holds at least two rows a
    part."""
    dims = sorted((d for d in range(len(shape)) if d != skip),
                  key=lambda d: -shape[d])
    for d in dims:
        if shape[d] % fsdp == 0 and shape[d] >= 2 * fsdp:
            return d
    return None


def tp_params(mod: nn.Module, child: str) -> tuple:
    """The names under ``mod`` of the weight and the bias (None: none) of
    ``child`` of its ``tp_linears()``: a linear layer's ``weight`` and
    ``bias``, or the module's own bare pair ``{child}_weight`` /
    ``{child}_bias`` (``nn.MultiheadAttention``'s packed ``in_proj``,
    CLIP's, under the reference's names)."""
    try:
        layer = mod.get_submodule(child)
    except AttributeError:
        bias = f"{child}_bias"
        return (f"{child}_weight",
                bias if getattr(mod, bias, None) is not None else None)
    return f"{child}.weight", None if layer.bias is None else f"{child}.bias"


def tp_modules(model: nn.Module, tp: int, min_size: int) -> dict:
    """``{module name: module}`` of the modules that split over ``tp``:
    those with a ``tp_linears()`` table whose ``tp_splits(tp)`` holds (its
    heads, or its hidden size, divide) and whose weights are all at
    least ``min_size`` elements and divide. A module whose weights lie
    on both sides of ``min_size`` stays whole, where ``vast_tpu``'s rule,
    parameter by parameter, would split the larger alone."""
    out = {}
    for name, mod in model.named_modules():
        if not hasattr(mod, "tp_linears") or not mod.tp_splits(tp):
            continue
        ok = True
        for child, (flax_name, _) in mod.tp_linears().items():
            w = mod.get_parameter(tp_params(mod, child)[0])
            dim = 0 if flax_name in COL else 1
            ok &= w.numel() >= min_size and w.shape[dim] % tp == 0
        if ok:
            out[name] = mod
    return out


def combined_param_sharding(mesh, model: nn.Module, use_fsdp: bool = True,
                            use_tp: bool = True,
                            min_size: int | None = None) -> dict:
    """``{parameter name: ParamPlan}`` for ``model`` on ``mesh`` (a
    ``DeviceMesh`` from ``create_mesh``, or a dict of its sizes), by
    ``vast_tpu``'s rule (mesh.py:95-146):

    * a 2-D weight of a column- or row-parallel layer (``COL`` / ``ROW``)
      is split over ``tp``: torch's (out, in) weights are the transpose
      of flax's (in, out) kernels, so a column-parallel weight splits
      dim 0 and a row-parallel one dim 1. The port splits whole modules,
      on their heads: a module whose heads (or MLP hidden size) do not
      divide by ``tp`` stays whole on every tp rank;
    * any other parameter of at least ``min_size`` elements (default
      ``MIN_SHARD_SIZE``) is split over ``fsdp``: the port splits the
      largest dim other than the tp dim that divides (the first of
      equals), as ``vast_tpu`` picks it;
    * embedding tables, parameters below ``min_size`` and 0-d ones stay
      whole on every rank; so does a parameter with no divisible dim.
    """
    sizes = mesh_shape(mesh)
    tp = sizes["tp"] if use_tp else 1
    fsdp = sizes["fsdp"] if use_fsdp else 1
    if min_size is None:
        min_size = MIN_SHARD_SIZE
    split = tp_modules(model, tp, min_size) if tp > 1 else {}
    tp_of, partial = {}, set()
    for mname, mod in split.items():
        pre = f"{mname}." if mname else ""
        for child, (flax_name, groups) in mod.tp_linears().items():
            col = flax_name in COL
            weight, bias = tp_params(mod, child)
            tp_of[f"{pre}{weight}"] = (0 if col else 1, groups)
            if col and bias is not None:
                # whole, sliced to this rank's rows at use
                partial.add(f"{pre}{bias}")
        partial.update(f"{pre}{n}" for n in mod.tp_partial_params())
    plans = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            kw = {"shape": shape, "tp_partial": name in partial}
            tp_dim = None
            if name in tp_of:
                tp_dim, groups = tp_of[name]
                kw.update(tp_dim=tp_dim, tp=tp, tp_groups=groups)
            if (fsdp > 1 and p.dim() and p.numel() >= min_size
                    and not isinstance(mod, nn.Embedding)):
                local = list(shape)
                if tp_dim is not None:
                    local[tp_dim] //= tp
                fd = _fsdp_dim(local, fsdp, tp_dim)
                if fd is not None:
                    kw.update(fsdp_dim=fd, fsdp=fsdp)
            plans[name] = ParamPlan(**kw)
    return plans


def tp_param_sharding(mesh, model: nn.Module,
                      min_size: int | None = None) -> dict:
    """Megatron-style tensor parallelism only (no fsdp)."""
    return combined_param_sharding(mesh, model, use_fsdp=False,
                                   min_size=min_size)


def fsdp_param_sharding(mesh, model: nn.Module,
                        min_size: int | None = None) -> dict:
    """ZeRO-3-style largest-divisible-dim sharding only (no tp)."""
    return combined_param_sharding(mesh, model, use_tp=False,
                                   min_size=min_size)
