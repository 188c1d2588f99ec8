"""Attention front end: the plain route and the port's routing rule.

Counterpart of ``vast_tpu.ops.attention``. The rule reads shapes only, so
it routes the same on every device:

* every EVA01 and BEATs self-attention goes through the token-major
  kernel (``ops.flash_attention.self_attention_tmajor``) at any L; those
  models call it directly and never come here;
* small problems (Lq * Lk < 128 * 128) and short queries over long keys
  (D < 128 and Lk >= 8 * Lq) take the plain route here: ``torch.matmul``
  + softmax in fp32, as ``vast_tpu`` does on these shapes
  (attention.py:234-244). BERT's caption self-attention (40 x 40) and its
  cross-attention of one caption over the condition tokens are such;
* every other shape goes through the head-major kernels
  (``ops.flash_attention.flash_attention``, differentiable), as
  ``vast_tpu`` sends it to its Pallas ``flash_attention``. That is every
  CLIP and AST self-attention (577 and 257 tokens at their full sizes),
  and BERT's grouped rerank, whose T texts of one candidate fold into
  one query of 40 T rows over that candidate's K/V: from T = 8 on, Lk <
  8 Lq. ``vast_tpu`` also
  keeps shapes whose TPU tile padding would waste more than 2.5x on the
  plain route; the CUDA kernel pads nothing in memory, so that test has
  no counterpart.

On CPU tensors the kernel's wrapper computes its plain version.
"""

from __future__ import annotations

import torch

from vast_tpu_torch import profiling
from vast_tpu_torch.ops.flash_attention import flash_attention


NEG_INF = -1e30


def reference_attention(q, k, v, bias=None):
    """Plain attention over head-major (B, H, L, D); q already scaled.

    Scores and softmax in fp32, probabilities cast to v's dtype for the
    p.v product, as ``vast_tpu.ops.attention.reference_attention``.
    """
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _prepare_bias(bias, mask):
    """Additive fp32 bias from a float bias and/or a bool mask (True =
    attend), broadcastable to (B, H, Lq, Lk). Where a bias is given and
    a new tensor is made of it (a cast, or its sum with the mask), the
    open span counts that tensor's ``bias_bytes``."""
    add_bias = None if bias is None else bias.float()
    if mask is not None:
        mb = torch.where(mask.bool(), 0.0, NEG_INF).float()
        while mb.dim() < 4:
            mb = mb[:, None]
        add_bias = mb if add_bias is None else add_bias + mb
    if bias is not None and add_bias is not bias:
        profiling.count("bias_bytes", add_bias.nbytes)
    return add_bias


def _plain_route(lq: int, lk: int, d: int) -> bool:
    """Shapes the plain route serves: small problems, and short queries
    over long keys (vast_tpu attention.py:234-244)."""
    return lq * lk < 128 * 128 or (d < 128 and lk >= 8 * lq)


def multi_head_attention_hmajor(q, k, v, *, bias=None, mask=None,
                                scale=None):
    """Scaled dot-product attention over head-major (B, H, L, D) tensors.

    Returns (B, H, Lq, D) in q's dtype. ``bias``: additive float,
    broadcastable to (B, H, Lq, Lk). ``mask``: bool, True = attend.
    """
    lq, d = q.shape[2], q.shape[3]
    lk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    add_bias = _prepare_bias(bias, mask)
    if not _plain_route(lq, lk, d):
        return flash_attention(q, k, v, add_bias, scale=scale)
    out = reference_attention(q * scale, k, v, add_bias)
    return out.to(q.dtype)


def multi_head_attention(q, k, v, *, bias=None, mask=None, scale=None):
    """Token-major (B, L, H, D) wrapper of
    :func:`multi_head_attention_hmajor`."""
    out = multi_head_attention_hmajor(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        bias=bias, mask=mask, scale=scale)
    return out.transpose(1, 2)
