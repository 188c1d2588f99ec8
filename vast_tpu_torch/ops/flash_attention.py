"""Attention kernels: the CUDA kernels and their plain twins.

Counterparts of ``vast_tpu.ops.flash_attention``'s kernels, all built
from ``csrc/flash_attention.cu``:

* :func:`self_attention_tmajor` (token-major fused qkv, with and without
  a score bias) replaces the Pallas kernels ``_tmajor_fwd_kernel``
  (flash_attention.py:762) and ``_tmajor_fwd_kernel_bias`` (:789); it is
  differentiable, its gradient being
* :func:`self_attention_tmajor_bwd`, which replaces
  ``_tmajor_bwd_kernel`` (:795) and ``_tmajor_bwd_kernel_bias`` (:841);
* :func:`flash_attention` (head-major q, k, v) replaces
  ``_single_kernel_nolse`` (:87), the inference forward of
  ``flash_attention`` (:156). The logsumexp output of ``_single_kernel``
  and the head-major backward come with the other encoders.

Each wrapper launches its kernel for CUDA tensors and raises on anything
it does not take; it uses its plain version (``_..._plain``) only for
CPU tensors. The head-major forward has no backward yet and raises on
CUDA when asked for a gradient. ``LAUNCHES`` counts kernel
launches, so a run can show that its path went through the kernels.

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
            "tmajor_attention_bwd": 0, "tmajor_attention_bwd_bias": 0,
            "flash_attention_fwd": 0}

MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _tmajor_probs_plain(qkv, bias, heads, lk_true, scale):
    """q, k, v (B, H, L, D) of a fused token-major qkv and the softmax p
    (B, H, L, L) of the scaled, biased and masked scores, in fp32."""
    b, l, total = qkv.shape
    d = total // (3 * heads)
    x = qkv.float().view(b, l, heads, 3, d).permute(3, 0, 2, 1, 4)
    q, k, v = x[0], x[1], x[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if lk_true:
        s[..., lk_true:] = float("-inf")
    return q, k, v, torch.softmax(s, dim=-1)


def _self_attention_tmajor_plain(qkv, bias=None, *, heads: int,
                                 lk_true: int = 0, scale: float = 1.0):
    """The same function in plain PyTorch, computed in fp32 from the
    inputs; returns the input dtype."""
    b, l, total = qkv.shape
    _, _, v, p = _tmajor_probs_plain(qkv, bias, heads, lk_true, scale)
    o = torch.matmul(p, v)                              # (B, H, L, D)
    return o.transpose(1, 2).reshape(b, l, total // 3).to(qkv.dtype)


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
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {qkv.device}")
    if bias is not None:
        if bias.shape[0] not in (1, b) or tuple(bias.shape[1:]) != (heads, l, l):
            raise ValueError(f"bias must be ({b} or 1, {heads}, {l}, {l}), "
                             f"got {tuple(bias.shape)}")
        if bias.device != qkv.device:
            raise ValueError("bias and qkv are on different devices")
    return b, l, d


def self_attention_tmajor(qkv, bias=None, *, heads: int, lk_true: int = 0,
                          scale: float = 1.0):
    """Self-attention over a fused token-major qkv tensor, differentiable.

    qkv: (B, L, H*3*D), each head's [q | k | v] contiguous (one projection
    matmul writes it). Returns (B, L, H*D) in qkv's dtype. Keys at and
    beyond ``lk_true`` (when non-zero) are masked; ``scale`` multiplies
    the fp32 scores; ``bias`` (B or 1, H, L, L) is added after the scale
    (BEATs' gated rel-pos semantics).

    The counterpart of vast_tpu's ``_tmajor_call`` / ``_tmajor_biased_call``
    custom VJPs (ops/attention.py:153-228): one ``torch.library`` op,
    ``vast::tmajor_attention`` (``TMAJOR_OP``), so that a selective
    checkpoint policy can name it (models/remat.py). Its backward is
    :func:`self_attention_tmajor_bwd` from the saved (qkv, bias, output)
    alone, softmax and delta recomputed. On CUDA the forward and backward
    kernels run, whatever needs a gradient; there is no other route.
    """
    _check(qkv, bias, heads, lk_true)
    return TMAJOR_OP(qkv, bias, heads, lk_true, float(scale))


@torch.library.custom_op(
    "vast::tmajor_attention", mutates_args=(),
    schema="(Tensor qkv, Tensor? bias, int heads, int lk_true, float scale)"
           " -> Tensor")
def _tmajor_attention(qkv, bias, heads, lk_true, scale):
    """The forward on checked operands: the plain version on the CPU, the
    kernel on CUDA."""
    b, l, total = qkv.shape
    d = total // (3 * heads)
    if qkv.device.type == "cpu":
        return _self_attention_tmajor_plain(qkv, bias, heads=heads,
                                            lk_true=lk_true, scale=scale)
    _check_cuda_operands(qkv, bias)
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


@_tmajor_attention.register_fake
def _(qkv, bias, heads, lk_true, scale):
    b, l, total = qkv.shape
    return qkv.new_empty((b, l, total // 3))


def _tmajor_setup(ctx, inputs, output):
    qkv, bias, heads, lk_true, scale = inputs
    ctx.save_for_backward(qkv, bias, output)
    ctx.args = dict(heads=heads, lk_true=lk_true, scale=scale)


def _tmajor_backward(ctx, grad):
    qkv, bias, out = ctx.saved_tensors
    grad = grad.to(qkv.dtype).contiguous()
    res = self_attention_tmajor_bwd(qkv, out, grad, bias, **ctx.args)
    if bias is None:
        return res, None, None, None, None
    return res[0], res[1], None, None, None


_tmajor_attention.register_autograd(_tmajor_backward,
                                    setup_context=_tmajor_setup)

TMAJOR_OP = torch.ops.vast.tmajor_attention.default


def _check_cuda_operands(qkv, bias, *others):
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    for name, t in (("qkv", qkv),) + others:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bias is not None:
        if bias.dtype != qkv.dtype:
            raise TypeError(f"bias dtype {bias.dtype} != qkv dtype "
                            f"{qkv.dtype}")
        if not bias.is_contiguous():
            raise ValueError("bias must be contiguous")


def _tmajor_bwd_parts_plain(qkv, o, do, bias, heads, lk_true, scale):
    """q, k, p (B, H, L, ·) as :func:`_tmajor_probs_plain`, the cotangent
    do (B, H, L, D) and ds = p (do . v^T - delta), delta = rowsum(do . o),
    in fp32."""
    b, l, total = qkv.shape
    d = total // (3 * heads)
    q, k, v, p = _tmajor_probs_plain(qkv, bias, heads, lk_true, scale)
    of = o.float().view(b, l, heads, d).transpose(1, 2)
    dof = do.float().view(b, l, heads, d).transpose(1, 2)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, v.transpose(-1, -2)) - delta)
    return q, k, p, dof, ds


def _self_attention_tmajor_bwd_plain(qkv, o, do, bias=None, *, heads: int,
                                     lk_true: int = 0, scale: float = 1.0):
    """The gradient in plain PyTorch, in fp32 from the inputs, as the
    Pallas kernel writes it (flash_attention.py:806-838): softmax and
    delta recomputed, ds the cotangent of the score before the scale.
    Returns dqkv in qkv's dtype and, with a bias, (dqkv, dbias), dbias in
    the bias's shape and dtype (summed over the batch for a shared bias).
    """
    b, l, total = qkv.shape
    q, k, p, dof, ds = _tmajor_bwd_parts_plain(qkv, o, do, bias, heads,
                                               lk_true, scale)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dqkv = torch.stack([dq, dk, dv], dim=0).permute(1, 3, 2, 0, 4)
    dqkv = dqkv.reshape(b, l, total).to(qkv.dtype)
    if bias is None:
        return dqkv
    if bias.shape[0] == 1 and b != 1:
        ds = ds.sum(dim=0, keepdim=True)
    return dqkv, ds.to(bias.dtype)


def _self_attention_tmajor_bwd_abs_terms(qkv, o, do, bias=None, *,
                                         heads: int, lk_true: int = 0,
                                         scale: float = 1.0):
    """For each output of the backward, the sum of |terms| of its last
    product, in fp32, (B, H, L, D) each (dbias: (B, H, L, L)): |ds| |k| s
    for dq, |ds|^T |q| s for dk, |p|^T |do| for dv, |ds| for dbias. The
    kernel rounds p or ds to bf16 (relative 2^-8) before that product, so
    it errs by at most 2^-8 of these there; the checks on the card derive
    their tolerances from them."""
    q, k, p, dof, ds = _tmajor_bwd_parts_plain(qkv, o, do, bias, heads,
                                               lk_true, scale)
    ds = ds.abs()
    return {"dq": torch.matmul(ds, k.abs()) * scale,
            "dk": torch.matmul(ds.transpose(-1, -2), q.abs()) * scale,
            "dv": torch.matmul(p.transpose(-1, -2), dof.abs()),
            "dbias": ds}


def self_attention_tmajor_bwd(qkv, o, do, bias=None, *, heads: int,
                              lk_true: int = 0, scale: float = 1.0):
    """Gradient of :func:`self_attention_tmajor` w.r.t. qkv (and the bias).

    qkv and the bias as the forward took them, ``o`` its output and
    ``do`` the output's cotangent, (B, L, H*D) in qkv's dtype. Softmax and
    delta = rowsum(do . o) are recomputed from these. Returns dqkv in
    qkv's fused per-head [dq | dk | dv] layout and dtype; with a bias,
    (dqkv, dbias), where dbias is the raw per-score cotangent ds in the
    bias's shape and dtype (summed over the batch for a (1, H, L, L)
    bias, as vast_tpu's attention.py:140-142 reduces a broadcast bias).
    Keys at and beyond ``lk_true`` get zero gradients.
    """
    b, l, d = _check(qkv, bias, heads, lk_true)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (b, l, heads * d) or t.dtype != qkv.dtype \
                or t.device != qkv.device:
            raise ValueError(f"{name} must be {(b, l, heads * d)} "
                             f"{qkv.dtype} on {qkv.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if qkv.device.type == "cpu":
        return _self_attention_tmajor_bwd_plain(
            qkv, o, do, bias, heads=heads, lk_true=lk_true, scale=scale)
    _check_cuda_operands(qkv, bias, ("o", o), ("do", do))
    dev = qkv.device
    dqkv = torch.empty_like(qkv)
    dbias = None
    if bias is not None:
        # keys past lk_true's last tile are not written by the kernel
        alloc = torch.zeros if 0 < lk_true < l else torch.empty
        dbias = alloc((b, heads, l, l), dtype=bias.dtype, device=dev)
    lse = torch.empty((b, heads, l), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse)
    bias_stride = 0 if bias is None or bias.shape[0] == 1 else bias.stride(0)

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    with torch.cuda.device(dev):
        err = _kernel("vast_tmajor_attention_bwd")(
            ptr(qkv), ptr(o), ptr(do), ptr(bias), ptr(dqkv), ptr(dbias),
            ptr(lse), ptr(delta), _DTYPE_CODES[qkv.dtype], b, l, heads, d,
            lk_true or l, bias_stride, float(scale),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"tmajor attention backward launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["tmajor_attention_bwd" if bias is None
             else "tmajor_attention_bwd_bias"] += 1
    if bias is None:
        return dqkv
    if bias.shape[0] == 1 and b != 1:
        dbias = dbias.float().sum(dim=0, keepdim=True).to(bias.dtype)
    return dqkv, dbias


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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        raise NotImplementedError(
            "the head-major kernel has no backward yet (vast_tpu's "
            "flash_attention_bwd, Pallas rows 7-9)")
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
    "vast_tmajor_attention_bwd": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_void_p],
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
