"""The fused per-head [q | k | v] projection layout of the token-major kernel.

Counterpart of ``TokenSlicedQKV`` / ``TokenSlicedOut`` in
``vast_tpu.models.hmajor`` (hmajor.py:108-179). One plain projection
matmul with reordered weights writes (B, L, H*3*D), each head's q, k and
v contiguous, which is what ``self_attention_tmajor`` reads; the query
scale may be baked into the q rows. The port keeps the true head width
(no padding), so the kernel's (B, L, H*D) output is already the ordinary
head-concatenated layout and the output projection is a plain linear
layer: ``TokenSlicedOut`` needs no counterpart.

The reordered weights are built once from the checkpoint-layout
parameters and rebuilt only when those parameters change (their tensor
version counters move on every in-place write, as a state-dict load or
an init does), never on every forward.
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
    them was written to, moved or re-typed since the last build."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, params, build):
        key = tuple((p._version, p.data_ptr(), p.dtype, p.device)
                    for p in params)
        if key != self._key:
            with torch.no_grad():
                self._value = build()
            self._key = key
        return self._value
