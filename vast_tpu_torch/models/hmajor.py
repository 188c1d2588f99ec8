"""The fused per-head [q | k | v] projection layout of the token-major kernel.

Counterpart of ``TokenSlicedQKV`` / ``TokenSlicedOut`` in
``vast_tpu.models.hmajor`` (hmajor.py:108-179). One plain projection
matmul with reordered weights writes (B, L, H*3*D), each head's q, k and
v contiguous, which is what ``self_attention_tmajor`` reads; the query
scale may be baked into the q rows. The port keeps the true head width
(no padding), so the kernel's (B, L, H*D) output is already the ordinary
head-concatenated layout and the output projection is a plain linear
layer: ``TokenSlicedOut`` needs no counterpart.

Without autograd (inference) the reordered weights are built once from
the checkpoint-layout parameters and rebuilt only when those parameters
change (their tensor version counters move on every in-place write, as
a state-dict load, an init or an optimizer step does), never on every
forward. While autograd records, they are rebuilt on every call from the
parameters, differentiably, so the gradient reaches the checkpoint-layout
parameters (``qkv.weight``, ``q_bias``, ``v_bias``, BEATs' ``q/k/v_proj``).
"""

from __future__ import annotations

import torch


def fuse_qkv(wq, wk, wv, bq, bk, bv, heads: int, q_scale: float = 1.0):
    """(out=H*D, in) q/k/v weights and (H*D,) biases -> the fused
    (H*3*D, in) weight and (H*3*D,) bias, per head [q | k | v]."""
    hd, w_in = wq.shape
    d = hd // heads
    w = torch.stack([wq.float() * q_scale, wk.float(), wv.float()],
                    dim=0).view(3, heads, d, w_in).transpose(0, 1)
    b = torch.stack([bq.float() * q_scale, bk.float(), bv.float()],
                    dim=0).view(3, heads, d).transpose(0, 1)
    return (w.reshape(heads * 3 * d, w_in).to(wq.dtype),
            b.reshape(heads * 3 * d).to(wq.dtype))


class FusedCache:
    """Holds a value derived from some parameters; rebuilds it when any of
    them was written to, moved or re-typed since the last build. While
    autograd records, it builds the value afresh and keeps nothing: a
    cached value would carry no gradient to the parameters.

    A parameter split over fsdp (``parallel/fsdp.py``) is read as a
    whole tensor gathered anew for each forward, perhaps at the address
    and version of the last one: the key is then that of the part the
    rank stores (``_vast_shard``), which an optimizer step or a restore
    writes to."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, params, build):
        if torch.is_grad_enabled():
            return build()
        stored = [getattr(p, "_vast_shard", p) for p in params]
        key = tuple((p._version, p.data_ptr(), p.dtype, p.device)
                    for p in stored)
        if key != self._key:
            with torch.no_grad():
                self._value = build()
            self._key = key
        return self._value
