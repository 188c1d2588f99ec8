"""Attention kernels: the CUDA kernels and their plain twins.

Counterparts of ``vast_tpu.ops.flash_attention``'s forward kernels, all
built from ``csrc/flash_attention.cu``:

* :func:`self_attention_tmajor` (token-major fused qkv, with and without
  a score bias) replaces the Pallas kernels ``_tmajor_fwd_kernel``
  (flash_attention.py:762) and ``_tmajor_fwd_kernel_bias`` (:789);
* :func:`flash_attention` (head-major q, k, v) replaces
  ``_single_kernel_nolse`` (:87), the inference forward of
  ``flash_attention`` (:156). The logsumexp output of ``_single_kernel``
  serves the backward and comes with the training slice.

Each wrapper launches its kernel for CUDA tensors and raises on anything
it does not take; it uses its plain version (``_..._plain``) only for
CPU tensors. ``LAUNCHES`` counts kernel launches, so a run can show that
its path went through the kernels.

The TPU mechanisms around the Pallas kernels (head packing, VMEM-sized
batch groups, 16/128 padding of L and of D, shard_map) have no
counterpart: the kernel takes any length, masks its ragged tiles itself,
reads the true head width D <= 128, and reads every operand through its
strides, so no caller pads, transposes or copies for it.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches by variant; tests and chip_smoke.py reset and read them
LAUNCHES = {"tmajor_attention_fwd": 0, "tmajor_attention_fwd_bias": 0,
            "flash_attention_fwd": 0}

MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _self_attention_tmajor_plain(qkv, bias=None, *, heads: int,
                                 lk_true: int = 0, scale: float = 1.0):
    """The same function in plain PyTorch, computed in fp32 from the
    inputs; returns the input dtype."""
    b, l, total = qkv.shape
    d = total // (3 * heads)
    x = qkv.float().view(b, l, heads, 3, d).permute(3, 0, 2, 1, 4)
    q, k, v = x[0], x[1], x[2]                          # (B, H, L, D)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if lk_true:
        s[..., lk_true:] = float("-inf")
    o = torch.matmul(torch.softmax(s, dim=-1), v)       # (B, H, L, D)
    return o.transpose(1, 2).reshape(b, l, heads * d).to(qkv.dtype)


def _check(qkv, bias, heads, lk_true):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, L, H*3*D), got {tuple(qkv.shape)}")
    b, l, total = qkv.shape
    if heads < 1 or total % (3 * heads):
        raise ValueError(f"last dim {total} is not heads({heads}) * 3 * D")
    d = total // (3 * heads)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head width {d} > {MAX_HEAD_DIM}")
    if not 0 <= lk_true <= l:
        raise ValueError(f"lk_true {lk_true} outside [0, {l}]")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv dtype {qkv.dtype} not in {list(_DTYPE_CODES)}")
    if bias is not None:
        if bias.shape[0] not in (1, b) or tuple(bias.shape[1:]) != (heads, l, l):
            raise ValueError(f"bias must be ({b} or 1, {heads}, {l}, {l}), "
                             f"got {tuple(bias.shape)}")
        if bias.device != qkv.device:
            raise ValueError("bias and qkv are on different devices")
    return b, l, d


def self_attention_tmajor(qkv, bias=None, *, heads: int, lk_true: int = 0,
                          scale: float = 1.0):
    """Self-attention over a fused token-major qkv tensor.

    qkv: (B, L, H*3*D), each head's [q | k | v] contiguous (one projection
    matmul writes it). Returns (B, L, H*D) in qkv's dtype. Keys at and
    beyond ``lk_true`` (when non-zero) are masked; ``scale`` multiplies
    the fp32 scores; ``bias`` (B or 1, H, L, L) is added after the scale
    (BEATs' gated rel-pos semantics).
    """
    b, l, d = _check(qkv, bias, heads, lk_true)
    if qkv.device.type == "cpu":
        return _self_attention_tmajor_plain(qkv, bias, heads=heads,
                                            lk_true=lk_true, scale=scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if bias is not None:
        if bias.dtype != qkv.dtype:
            raise TypeError(f"bias dtype {bias.dtype} != qkv dtype "
                            f"{qkv.dtype}")
        if not bias.is_contiguous():
            raise ValueError("bias must be contiguous")
    out = torch.empty((b, l, heads * d), dtype=qkv.dtype, device=qkv.device)
    bias_stride = 0 if bias is None or bias.shape[0] == 1 else bias.stride(0)
    with torch.cuda.device(qkv.device):
        err = _kernel("vast_tmajor_attention_fwd")(
            ctypes.c_void_p(qkv.data_ptr()),
            ctypes.c_void_p(None if bias is None else bias.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), _DTYPE_CODES[qkv.dtype],
            b, l, heads, d, lk_true or l, bias_stride, float(scale),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"tmajor attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["tmajor_attention_fwd" if bias is None
             else "tmajor_attention_fwd_bias"] += 1
    return out


def _flash_attention_plain(q, k, v, bias=None, *, scale: float = 1.0,
                           lk_true: int = 0):
    """The same function in plain PyTorch, computed in fp32 from the
    inputs; returns q's dtype. A row with no finite score gives zeros."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if lk_true:
        s[..., lk_true:] = float("-inf")
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p / torch.where(l == 0, 1.0, l), v.float())
    return o.to(q.dtype)


def flash_attention(q, k, v, bias=None, *, scale: float = 1.0,
                    lk_true: int = 0):
    """Attention over head-major (B, H, L, D) tensors.

    q (B, H, Lq, D), k and v (B, H, Lk, D); returns (B, H, Lq, D) in q's
    dtype and q's memory layout. ``scale`` multiplies the fp32 scores (the
    JAX function takes q already scaled, i.e. scale 1); ``bias``, 4-D and
    broadcastable to (B, H, Lq, Lk), in fp32 or q's dtype, is added after
    the scale; keys at and beyond ``lk_true`` (when non-zero) are masked.
    Any strides are taken as long as the last axis is contiguous: the
    kernel reads BERT's token-major projections as they are.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q, k, v must be (B, H, L, D) with equal k and v "
                         f"shapes, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head width {d} > {MAX_HEAD_DIM}")
    if not 0 <= lk_true <= lk:
        raise ValueError(f"lk_true {lk_true} outside [0, {lk}]")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: "
                        f"one of {list(_DTYPE_CODES)} for all three")
    if bias is not None:
        if bias.dim() != 4 or bias.shape[-1] != lk:
            raise ValueError(f"bias {tuple(bias.shape)} is not 4-D over "
                             f"{lk} keys")
        bias = bias.expand(b, h, lq, lk)       # raises if not broadcastable
        if bias.device != q.device:
            raise ValueError("bias and q are on different devices")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v are on different devices")
    if q.device.type == "cpu":
        return _flash_attention_plain(q, k, v, bias, scale=scale,
                                      lk_true=lk_true)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    operands = (q, k, v) if bias is None else (q, k, v, bias)
    if any(t.stride(-1) != 1 for t in operands):
        raise ValueError("the last axis of q, k, v and bias must be "
                         "contiguous")
    if bias is not None and bias.dtype not in (torch.float32, q.dtype):
        raise TypeError(f"bias dtype {bias.dtype}: float32 or {q.dtype}")
    out = torch.empty_like(q)                  # q's layout
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    strides += [0, 0, 0] if bias is None else list(bias.stride()[:3])
    with torch.cuda.device(q.device):
        err = _kernel("vast_flash_attention_fwd")(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v)),
            ctypes.c_void_p(None if bias is None else bias.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[q.dtype if bias is None else bias.dtype],
            b, h, lq, d, lk_true or lk, (ctypes.c_longlong * 15)(*strides),
            float(scale),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention_fwd"] += 1
    return out


_ARGTYPES = {
    "vast_tmajor_attention_fwd": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p],
    "vast_flash_attention_fwd": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p],
}


def _kernel(symbol: str):
    from vast_tpu_torch.build import load

    fn = getattr(load("flash_attention"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn
