"""Activation checkpointing of encoder blocks.

Counterpart of ``vast_tpu.models.remat`` (remat.py:49-96): each EVA
and CLIP block, BEATs and AST layer and BERT layer runs under
``torch.utils.checkpoint.checkpoint`` (non-reentrant), as ``nn.remat``
wraps them in ``vast_tpu`` (eva_vit.py:365-368, clip_vit.py:102-105,
beats.py:290-294, ast.py:91-94, bert.py:285-293). Policies:

* ``none``: no checkpoint; the block keeps all its activations;
* ``full``: save only the block's inputs, recompute everything;
* ``attn``: also save the outputs of the attention ops, token-major
  (``ops.flash_attention.TMAJOR_OP``) and head-major (``FLASH_OP``: its
  output and its lse), so the backward recomputes the projections, MLP
  and norms but never re-runs an attention forward kernel (JAX tags
  that output ``attn_out``);
* ``dots``: ``attn`` plus the outputs of every ``aten.mm`` / ``addmm``
  (the projection and MLP products; JAX's
  ``dots_with_no_batch_dims_saveable``);
* ``attn_offload`` / ``dots_offload``: what ``attn`` / ``dots`` keep,
  moved to pinned host memory when the block's forward ends and back to
  its device when the backward recomputes the block (JAX's
  ``offload_dst="pinned_host"``, remat.py:60-90). Selective
  checkpointing caches those outputs itself, not through
  ``saved_tensors_hooks``, so the move is made on its cache. The
  gradients are those of ``attn`` / ``dots``; a CPU tensor stays where
  it is.

Checkpointing applies only while autograd records; under ``no_grad`` or
``inference_mode`` a block runs plainly.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, _VersionWrapper,
                                    checkpoint,
                                    create_selective_checkpoint_contexts)

from vast_tpu_torch.ops.flash_attention import FLASH_OP, TMAJOR_OP

POLICIES = ("none", "full", "attn", "dots", "attn_offload", "dots_offload")
_ATTN = (TMAJOR_OP, FLASH_OP)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_attn(ctx, op, *args, **kwargs):
    if op in _ATTN:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots(ctx, op, *args, **kwargs):
    if op in _ATTN or op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _cached(storage):
    """The entries selective checkpointing cached (the layout of its
    store differs between torch versions: walk it)."""
    stack = [storage]
    while stack:
        x = stack.pop()
        if isinstance(x, _VersionWrapper):
            if isinstance(x.val, torch.Tensor):
                yield x
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


def _move(entry, tensor) -> None:
    entry.val = tensor
    entry.version = tensor._version


def _to_host(storage) -> None:
    for e in _cached(storage):
        if e.val.device.type == "cuda":
            host = torch.empty(e.val.shape, dtype=e.val.dtype,
                               pin_memory=True)
            host.copy_(e.val, non_blocking=True)
            e.home = e.val.device
            _move(e, host)


def _to_device(storage) -> None:
    for e in _cached(storage):
        home = getattr(e, "home", None)
        if home is not None and e.val.device != home:
            _move(e, e.val.to(home, non_blocking=True))


class _Around:
    """A dispatch mode of selective checkpointing, with ``after`` run on
    its exit (the forward's) or ``before`` on its entry (the
    recompute's)."""

    def __init__(self, mode, before=None, after=None):
        self.mode, self.before, self.after = mode, before, after

    def __enter__(self):
        if self.before is not None:
            self.before(self.mode.storage)
        return self.mode.__enter__()

    def __exit__(self, *exc):
        out = self.mode.__exit__(*exc)
        if self.after is not None:
            self.after(self.mode.storage)
        return out


def _offloading_contexts(policy_fn):
    """``create_selective_checkpoint_contexts(policy_fn)`` whose cache
    lives in pinned host memory between the forward and the recompute."""
    fwd, rec = create_selective_checkpoint_contexts(policy_fn)
    return _Around(fwd, after=_to_host), _Around(rec, before=_to_device)


_CONTEXTS = {
    "full": None,
    "attn": functools.partial(create_selective_checkpoint_contexts,
                              _save_attn),
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _save_dots),
    "attn_offload": functools.partial(_offloading_contexts, _save_attn),
    "dots_offload": functools.partial(_offloading_contexts, _save_dots),
}


def check_policy(name: str) -> str:
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy {name!r}: one of "
                         f"{POLICIES}")
    return name


def remat_call(policy: str, fn, *args):
    """``fn(*args)`` under the checkpoint ``policy``. Randomness inside
    ``fn`` must come from its arguments (a seed: models/layers.py), so
    that the recompute draws what the forward drew; the global RNG state
    is therefore not stashed."""
    if check_policy(policy) == "none" or not torch.is_grad_enabled():
        return fn(*args)
    ctx = _CONTEXTS[policy]
    kwargs = {} if ctx is None else {"context_fn": ctx}
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)
