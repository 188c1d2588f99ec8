"""Parameters split over the mesh: ``fsdp`` (ZeRO-3) and ``tp``.

Counterpart of what XLA does with ``vast_tpu``'s sharded train state
(training/step.py:96-154): each rank stores only its part of a split
parameter, per ``parallel.mesh.combined_param_sharding``'s plan, and
the whole tensor exists only while a layer uses it.

* **fsdp**: a module that owns a split parameter gathers it over the
  fsdp group in a forward pre-hook, the layer reads the whole tensor,
  and the forward hook drops it (the parameter holds the rank's part
  throughout). A module that reads a child's weight itself (the fused
  qkv of EVA and BEATs: ``GATHER_CHILDREN``) gathers it for the child;
  ``VASTModel``'s own parameters are gathered around its entry points.
  The gather is an autograd function: its backward reduces the whole
  gradient (``reduction``) and keeps this rank's part. Under activation
  checkpointing the recompute gathers again, as FSDP does.
* **tp**: the split modules hold this rank's heads
  (``parallel/tp.py``); their parameters stay split.
* Parameters that stay whole have their gradients reduced after the
  backward (``reduce_grads``, one all-reduce a bucket).
* ``reduction``: a gradient is averaged over the data group, as DDP
  averages; summed over the tp group too where a tp module uses the
  parameter in part; and averaged over the tp group where its ranks
  hold the same parameter whole, which keeps their copies equal. A
  parameter both used in part and split over fsdp (AST's q, k and v)
  has its whole gradient summed over the tp group and averaged over the
  data group in one all-reduce over the world, before the rank keeps
  its fsdp part; the clipping norm counts each part once.

Every collective is an all-gather or an all-reduce, which gloo carries
on CPU and CUDA tensors and NCCL on CUDA ones: one code path on every
backend. ``full`` and ``split`` move a tensor between its whole form
(reference names and shapes, the packed q/k/v weights of EVA01, CLIP,
Swin and VideoSwin in reference row order) and this rank's part, for the
saver and the optimizer's state.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
import torch.distributed as dist
from torch import nn

from vast_tpu_torch.parallel import mesh as pmesh
from vast_tpu_torch.parallel.tp import TpInfo


class _Gather(torch.autograd.Function):
    """A split parameter's whole tensor; backward: the whole gradient
    reduced as ``ShardedParams.reduction`` says, this rank's part of
    it."""

    @staticmethod
    def forward(ctx, part, sh, plan):
        ctx.sh, ctx.plan = sh, plan
        return torch.cat(sh.gather(part, sh.fsdp_group), plan.fsdp_dim)

    @staticmethod
    def backward(ctx, grad):
        sh, plan = ctx.sh, ctx.plan
        group, divisor = sh.reduction(plan)
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=group)
        n = grad.shape[plan.fsdp_dim] // plan.fsdp
        part = grad.narrow(plan.fsdp_dim, sh.fsdp_rank * n, n)
        return part / divisor, None, None


class ShardedParams:
    """``model``'s parameters placed by ``plans`` on ``mesh``: made by
    ``training.step.shard_state``, which splits the tensors; this object
    gathers them for use, reduces their gradients and converts whole
    tensors to parts and back."""

    def __init__(self, model: nn.Module, mesh, plans: dict):
        self.model, self.plans = model, plans
        sizes = pmesh.mesh_shape(mesh)
        self.data_group = pmesh.data_group(mesh)
        self.data_size = pmesh.group_size(self.data_group)
        self.fsdp_group = pmesh.fsdp_group(mesh)
        self.fsdp_rank = pmesh.group_rank(self.fsdp_group)
        tpg = pmesh.tp_group(mesh)
        self.tp = (TpInfo(tpg, pmesh.group_rank(tpg), sizes["tp"])
                   if sizes["tp"] > 1 else None)
        self.world_size = pmesh.world()
        self._own = []                 # the root's split parameters
        self._own_depth = 0

    @staticmethod
    def gather(t: torch.Tensor, group) -> list[torch.Tensor]:
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, t, group=group)
        return out

    def reduction(self, plan):
        """(group, divisor) of a parameter's gradient: the mean over the
        data group, as DDP's; summed over the tp group too where a tp
        module uses the parameter in part; and where the ranks of a tp
        group hold the same parameter whole, averaged over them too, so
        that they step it alike where their backwards are not bitwise
        equal (cuDNN's and the embedding's scatter-adds are not)."""
        if self.tp is None or plan.tp_dim is not None:
            return self.data_group, self.data_size
        if plan.tp_partial:
            return None, self.data_size
        return None, self.data_size * self.tp.size

    # -------------------------------------------------- gathering for use

    def _whole(self, p: torch.Tensor, plan) -> torch.Tensor:
        full = _Gather.apply(p, self, plan)
        full._vast_shard = p           # FusedCache keys on the stored part
        return full

    def _put(self, entries) -> None:
        for owner, pname, p, plan in entries:
            owner.__dict__[pname] = self._whole(p, plan)

    @staticmethod
    def _drop(entries) -> None:
        for owner, pname, _, _ in entries:
            owner.__dict__.pop(pname, None)

    def install(self) -> None:
        """Register the gathers: each split parameter at the module that
        reads it (its owner, or the parent naming it in
        ``GATHER_CHILDREN``; the root's around its entry points)."""
        modules = dict(self.model.named_modules())
        sites = defaultdict(list)
        for mname, mod in modules.items():
            for pname, p in mod.named_parameters(recurse=False):
                name = f"{mname}.{pname}" if mname else pname
                plan = self.plans[name]
                if plan.fsdp_dim is None:
                    continue
                site = mname
                parent, _, child = mname.rpartition(".")
                if mname and child in getattr(modules[parent],
                                              "GATHER_CHILDREN", ()):
                    site = parent
                sites[site].append((mod, pname, p, plan))
        for site, entries in sites.items():
            if site == "":
                self._own = entries
                continue
            mod = modules[site]
            mod.register_forward_pre_hook(lambda m, a, e=entries: self._put(e))
            mod.register_forward_hook(lambda m, a, o, e=entries: self._drop(e),
                                      always_call=True)
        self.model.gather_own = self.own_gathered

    @contextlib.contextmanager
    def own_gathered(self):
        """The root module's split parameters gathered (re-entrant)."""
        if self._own_depth == 0:
            self._put(self._own)
        self._own_depth += 1
        try:
            yield
        finally:
            self._own_depth -= 1
            if self._own_depth == 0:
                self._drop(self._own)

    # -------------------------------------------------------- gradients

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """After the backward: each parameter that is not fsdp-split
        gets its gradient reduced as ``reduction`` says (the gather's
        backward reduced the others); a missing gradient counts as
        zeros. One all-reduce per (group, divisor, dtype)."""
        buckets = defaultdict(list)
        for name, p in self.model.named_parameters():
            plan = self.plans[name]
            if not p.requires_grad or plan.fsdp_dim is not None:
                continue
            group, divisor = self.reduction(plan)
            if group is self.data_group and self.data_size == 1:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            buckets[id(group), divisor, p.grad.dtype].append((p, group))
        for (_, divisor, _), entries in buckets.items():
            grads = [p.grad for p, _ in entries]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=entries[0][1])
            flat /= divisor
            for g, part in zip(grads, flat.split([g.numel()
                                                  for g in grads])):
                g.copy_(part.view_as(g))

    def norm_weight(self, name: str) -> float:
        """The share of this rank's copy of ``name``'s part in the sum
        over the world: the number of parts over the number of ranks."""
        plan = self.plans[name]
        parts = ((plan.tp if plan.tp_dim is not None else 1)
                 * (plan.fsdp if plan.fsdp_dim is not None else 1))
        return parts / self.world_size

    def global_norm(self, grads: dict) -> torch.Tensor:
        """sqrt of the sum of squares of the whole gradient, each element
        counted once, in fp32 (a missing gradient counts as zeros)."""
        device = next(g.device for g in grads.values() if g is not None)
        local = sum((g.float().square().sum() * self.norm_weight(n)
                     for n, g in grads.items() if g is not None),
                    torch.zeros((), device=device))
        dist.all_reduce(local)
        return torch.sqrt(local)

    # ------------------------------------------------ whole <-> this part

    @torch.no_grad()
    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of ``name`` from every rank's part ``t`` (a
        parameter or a moment of it); every rank calls it."""
        plan = self.plans.get(name)
        if plan is None or plan.whole:
            return t
        x = t
        if plan.fsdp_dim is not None:
            x = torch.cat(self.gather(x, self.fsdp_group), plan.fsdp_dim)
        if plan.tp_dim is not None:
            out = x.new_empty(plan.shape)
            for r, part in enumerate(self.gather(x, self.tp.group)):
                idx = torch.from_numpy(plan.tp_index(r)).to(x.device)
                out.index_copy_(plan.tp_dim, idx, part)
            x = out
        return x

    def split(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor of ``name``."""
        plan = self.plans.get(name)
        if plan is None or plan.whole:
            return full
        return plan.split(full, 0 if self.tp is None else self.tp.rank,
                          self.fsdp_rank)

    def full_state_dict(self, keep: bool = True) -> dict:
        """The model's state dict with whole tensors under reference
        names, as an unsharded model's ``state_dict()``; every rank
        gathers, and only where ``keep`` holds is it kept (rank 0,
        which writes it)."""
        out = {}
        for name, t in self.model.state_dict().items():
            whole = self.full(name, t)
            if keep:
                out[name] = whole
        return out

    @torch.no_grad()
    def load_full_state_dict(self, sd: dict) -> None:
        """Strictly load whole tensors (an unsharded model's state dict)
        into this rank's parts."""
        own = self.model.state_dict()
        missing = sorted(set(own) - set(sd))
        unexpected = sorted(set(sd) - set(own))
        if missing or unexpected:
            raise KeyError(f"state dict: missing {missing}, unexpected "
                           f"{unexpected}")
        for name, t in own.items():
            t.copy_(self.split(name, sd[name].to(t.device)))
