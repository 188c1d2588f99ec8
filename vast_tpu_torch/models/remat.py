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
  ``dots_with_no_batch_dims_saveable``).

The ``*_offload`` policies, which park the saved tensors in host memory,
are not ported yet. Checkpointing applies only while autograd records;
under ``no_grad`` or ``inference_mode`` a block runs plainly.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from vast_tpu_torch.ops.flash_attention import FLASH_OP, TMAJOR_OP

POLICIES = ("none", "full", "attn", "dots")
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


_CONTEXTS = {
    "full": None,
    "attn": functools.partial(create_selective_checkpoint_contexts,
                              _save_attn),
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _save_dots),
}


def check_policy(name: str) -> str:
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy {name!r}: one of "
                         f"{POLICIES} (the *_offload policies are not "
                         f"ported)")
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
