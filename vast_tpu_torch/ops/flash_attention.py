"""Attention kernels: the CUDA kernels and their plain twins.

Counterparts of ``vast_tpu.ops.flash_attention``'s kernels, all built
from ``csrc/flash_attention.cu``:

* :func:`self_attention_tmajor` (token-major fused qkv, with and without
  a score bias) replaces the Pallas kernels ``_tmajor_fwd_kernel``
  (flash_attention.py:762) and ``_tmajor_fwd_kernel_bias`` (:789), in
  bf16 through the Hopper body (wgmma fed by the copy engine) wherever
  the copy engine can read qkv and the bias (:func:`_sm90_ok`); it is
  differentiable, writing the lse while autograd records, its gradient
  being
* :func:`self_attention_tmajor_bwd`, which replaces
  ``_tmajor_bwd_kernel`` (:795) and ``_tmajor_bwd_kernel_bias`` (:841)
  and reads the forward's lse where it is given;
* :func:`flash_attention` (head-major q, k, v) replaces the forward
  kernels of ``flash_attention`` (:156): ``_single_kernel_nolse`` (:87)
  and ``_looped_kernel_nolse`` (:137) without a gradient to record,
  ``_single_kernel`` (:52) and ``_looped_kernel`` (:94), which add the
  lse, with one; in bf16 through the Hopper body (wgmma fed by the copy
  engine) wherever the copy engine can read q, k and v
  (:func:`_sm90_ok`); it is differentiable, its gradient being
* :func:`flash_attention_bwd`, which replaces the kernels of
  ``flash_attention_bwd`` (:462): the fused ``_bwd_fused_kernel(_nods)``
  (:321, :363) and the tiled ``_bwd_dkv_kernel`` (:372) and
  ``_bwd_dq_kernel(_nods)`` (:413, :451).

Both backwards take the Hopper body in bf16 (wgmma fed by the copy
engine: ``attention_bwd_dq_sm90_kernel``, then
``attention_bwd_dkv_sm90_kernel``) wherever the copy engine can read
their operands (:func:`_sm90_ok`), and the mma.sync / CUDA-core
bodies otherwise.

Each wrapper launches its kernel for CUDA tensors and raises on anything
it does not take; it uses its plain version (``_..._plain``) only for
CPU tensors. ``LAUNCHES`` counts kernel launches, so a run can show that
its path went through the kernels. The two kernels of the token-major
layout probe (``attention_dma``, ``attention_sect``) are built from the
same source; their wrappers are in
``vast_tpu_torch/scripts/bench_tmajor_variants.py`` and count here too,
their Hopper bodies' rules beside :func:`_sm90_ok` (:func:`_strip_ok`).

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
            # of those two, the launches of the Hopper body (wgmma + TMA)
            "tmajor_attention_fwd_sm90": 0,
            "tmajor_attention_bwd": 0, "tmajor_attention_bwd_bias": 0,
            # of those two, the launches given the forward's lse
            "tmajor_attention_bwd_lse": 0,
            "flash_attention_fwd": 0, "flash_attention_fwd_lse": 0,
            # of those two, the launches of the Hopper body (wgmma + TMA)
            "flash_attention_fwd_sm90": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_dbias": 0,
            # of the backwards, the launches of the Hopper body (wgmma + TMA)
            "tmajor_attention_bwd_sm90": 0, "flash_attention_bwd_sm90": 0,
            # the token-major layout probe (scripts/bench_tmajor_variants.py)
            "attention_dma": 0, "attention_sect": 0,
            # of those two, the launches of their Hopper bodies (wgmma +
            # TMA: the resident strip, the shared forward body)
            "attention_dma_sm90": 0, "attention_sect_sm90": 0,
            # of the head-major forwards and backwards, the window
            # attention's (ops/window_attention.py: its own kernels)
            "window_attention_fwd": 0, "window_attention_bwd": 0}

MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _tmajor_scores_plain(qkv, bias, heads, lk_true, scale):
    """q, k, v (B, H, L, D) of a fused token-major qkv and the scaled,
    biased and masked scores s (B, H, L, L), in fp32."""
    b, l, total = qkv.shape
    d = total // (3 * heads)
    x = qkv.float().view(b, l, heads, 3, d).permute(3, 0, 2, 1, 4)
    q, k, v = x[0], x[1], x[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if lk_true:
        s[..., lk_true:] = float("-inf")
    return q, k, v, s


def _lse_plain(s):
    """Each row's logsumexp of the scores s, (..., L) fp32; +inf for a row
    with no finite score (as the kernels write it)."""
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(torch.isneginf(lse), float("inf"), lse)


def _tmajor_probs_plain(qkv, bias, heads, lk_true, scale, lse=None):
    """q, k, v (B, H, L, D) of a fused token-major qkv and the softmax p
    (B, H, L, L) of the scaled, biased and masked scores, in fp32: p =
    exp(s - lse) from a given ``lse`` (B, H, L), as the backward reads
    the forward's."""
    q, k, v, s = _tmajor_scores_plain(qkv, bias, heads, lk_true, scale)
    if lse is None:
        return q, k, v, torch.softmax(s, dim=-1)
    return q, k, v, torch.exp(s - lse.float()[..., None])


def _self_attention_tmajor_plain(qkv, bias=None, *, heads: int,
                                 lk_true: int = 0, scale: float = 1.0,
                                 return_lse: bool = False):
    """The same function in plain PyTorch, computed in fp32 from the
    inputs; returns the input dtype, and with ``return_lse`` also the lse
    (B, H, L) fp32."""
    b, l, total = qkv.shape
    _, _, v, s = _tmajor_scores_plain(qkv, bias, heads, lk_true, scale)
    o = torch.matmul(torch.softmax(s, dim=-1), v)       # (B, H, L, D)
    o = o.transpose(1, 2).reshape(b, l, total // 3).to(qkv.dtype)
    return (o, _lse_plain(s)) if return_lse else o


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
    checkpoint policy can name it (models/remat.py). Without a gradient
    to record it runs the forward alone; with one, the forward that also
    writes the lse (B, H, L), which the op saves with its output, and its
    backward is :func:`self_attention_tmajor_bwd` from the saved (qkv,
    bias, output, lse), p = exp(s - lse) and delta recomputed (vast_tpu
    recomputes the row statistics too). On CUDA the forward and backward
    kernels run, whatever needs a gradient; there is no other route.
    """
    _check(qkv, bias, heads, lk_true)
    need_lse = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (qkv, bias))
    return TMAJOR_OP(qkv, bias, heads, lk_true, float(scale), need_lse)[0]


def _tmajor_fwd_launch(symbol, qkv, bias, heads, lk_true, scale, need_lse):
    """One launch of the token-major forward entry ``symbol``
    (``vast_tmajor_attention_fwd`` or ``..._sm90``) on checked CUDA
    operands: (out, lse), the lse empty unless ``need_lse``. Raises if the
    entry refuses the operands or the launch fails. Counts nothing: the
    op counts its launches."""
    b, l, total = qkv.shape
    d = total // (3 * heads)
    out = torch.empty((b, l, heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, l) if need_lse else (0,),
                      dtype=torch.float32, device=qkv.device)
    bias_stride = 0 if bias is None or bias.shape[0] == 1 else bias.stride(0)
    with torch.cuda.device(qkv.device):
        err = _kernel(symbol)(
            _ptr(qkv), _ptr(bias), _ptr(out), _ptr(lse if need_lse else None),
            _DTYPE_CODES[qkv.dtype], b, l, heads, d, lk_true or l,
            bias_stride, float(scale), _stream())
    if err:
        raise RuntimeError(f"tmajor attention kernel launch failed "
                           f"({symbol}): CUDA error {err}")
    return out, lse


@torch.library.custom_op(
    "vast::tmajor_attention", mutates_args=(),
    schema="(Tensor qkv, Tensor? bias, int heads, int lk_true, float scale, "
           "bool need_lse) -> (Tensor, Tensor)")
def _tmajor_attention(qkv, bias, heads, lk_true, scale, need_lse):
    """The forward on checked operands: the plain version on the CPU, a
    kernel on CUDA. The lse is empty unless ``need_lse``. bf16 operands
    that the copy engine can read (:func:`_sm90_ok` of qkv and the bias)
    take the Hopper body, the rest (fp32, D not a multiple of 8, a bias
    whose rows are not 16-byte multiples) the mma.sync / CUDA-core
    bodies; decided before the launch, and a failed launch raises:
    neither falls back to the other."""
    if qkv.device.type == "cpu":
        if need_lse:
            return _self_attention_tmajor_plain(
                qkv, bias, heads=heads, lk_true=lk_true, scale=scale,
                return_lse=True)
        return (_self_attention_tmajor_plain(qkv, bias, heads=heads,
                                             lk_true=lk_true, scale=scale),
                qkv.new_empty(0, dtype=torch.float32))
    _check_cuda_operands(qkv, bias)
    d = qkv.shape[2] // (3 * heads)
    sm90 = _sm90_ok(d, qkv) if bias is None else _sm90_ok(d, qkv, bias)
    out, lse = _tmajor_fwd_launch(
        "vast_tmajor_attention_fwd_sm90" if sm90 else
        "vast_tmajor_attention_fwd", qkv, bias, heads, lk_true, scale,
        need_lse)
    LAUNCHES["tmajor_attention_fwd" if bias is None
             else "tmajor_attention_fwd_bias"] += 1
    if sm90:
        LAUNCHES["tmajor_attention_fwd_sm90"] += 1
    return out, lse


@_tmajor_attention.register_fake
def _(qkv, bias, heads, lk_true, scale, need_lse):
    b, l, total = qkv.shape
    return (qkv.new_empty((b, l, total // 3)),
            qkv.new_empty((b, heads, l) if need_lse else (0,),
                          dtype=torch.float32))


def _tmajor_setup(ctx, inputs, output):
    qkv, bias, heads, lk_true, scale, _ = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(qkv, bias, o, lse)
    ctx.args = dict(heads=heads, lk_true=lk_true, scale=scale)


def _tmajor_backward(ctx, grad, _):
    qkv, bias, out, lse = ctx.saved_tensors
    grad = grad.to(qkv.dtype).contiguous()
    res = self_attention_tmajor_bwd(qkv, out, grad, bias,
                                    lse=lse if lse.numel() else None,
                                    **ctx.args)
    if bias is None:
        return res, None, None, None, None, None
    return res[0], res[1], None, None, None, None


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


def _tmajor_bwd_parts_plain(qkv, o, do, bias, heads, lk_true, scale,
                            lse=None):
    """q, k, p (B, H, L, ·) as :func:`_tmajor_probs_plain` (from ``lse``
    where given), the cotangent do (B, H, L, D) and ds = p (do . v^T -
    delta), delta = rowsum(do . o), in fp32."""
    b, l, total = qkv.shape
    d = total // (3 * heads)
    q, k, v, p = _tmajor_probs_plain(qkv, bias, heads, lk_true, scale, lse)
    of = o.float().view(b, l, heads, d).transpose(1, 2)
    dof = do.float().view(b, l, heads, d).transpose(1, 2)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, v.transpose(-1, -2)) - delta)
    return q, k, p, dof, ds


def _self_attention_tmajor_bwd_plain(qkv, o, do, bias=None, *, heads: int,
                                     lk_true: int = 0, scale: float = 1.0,
                                     lse=None):
    """The gradient in plain PyTorch, in fp32 from the inputs, as the
    Pallas kernel writes it (flash_attention.py:806-838): softmax (or p =
    exp(s - lse) from a given forward's ``lse``) and delta recomputed, ds
    the cotangent of the score before the scale. Returns dqkv in qkv's
    dtype and, with a bias, (dqkv, dbias), dbias in the bias's shape and
    dtype (summed over the batch for a shared bias).
    """
    b, l, total = qkv.shape
    q, k, p, dof, ds = _tmajor_bwd_parts_plain(qkv, o, do, bias, heads,
                                               lk_true, scale, lse)
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
                              lk_true: int = 0, scale: float = 1.0,
                              lse=None):
    """Gradient of :func:`self_attention_tmajor` w.r.t. qkv (and the bias).

    qkv and the bias as the forward took them, ``o`` its output and
    ``do`` the output's cotangent, (B, L, H*D) in qkv's dtype; ``lse``
    the forward's (B, H, L) fp32, or None. delta = rowsum(do . o) is
    recomputed, and p = exp(s - lse) from the given lse; without one the
    row statistics are recomputed too (the dQ kernel sweeps the keys once
    more for them, as vast_tpu's backward does). Returns dqkv in
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
    if lse is not None and (tuple(lse.shape) != (b, heads, l)
                            or lse.device != qkv.device):
        raise ValueError(f"lse must be {(b, heads, l)} on {qkv.device}, got "
                         f"{tuple(lse.shape)} on {lse.device}")
    if qkv.device.type == "cpu":
        return _self_attention_tmajor_bwd_plain(
            qkv, o, do, bias, heads=heads, lk_true=lk_true, scale=scale,
            lse=lse)
    _check_cuda_operands(qkv, bias, ("o", o), ("do", do))
    if lse is not None and lse.dtype != torch.float32:
        raise TypeError(f"the kernels read an fp32 lse, got {lse.dtype}")
    # decided before the launch; a refused or failed launch raises
    # (q, k and v lie D apart in qkv's rows, 3D a head: the copy engine
    # reads them wherever it reads qkv)
    sm90 = _sm90_ok(d, qkv, o, do)
    dqkv, dbias = _tmajor_bwd_launch(
        "vast_tmajor_attention_bwd_sm90" if sm90 else
        "vast_tmajor_attention_bwd", qkv, o, do, bias, heads, lk_true, scale,
        lse)
    LAUNCHES["tmajor_attention_bwd" if bias is None
             else "tmajor_attention_bwd_bias"] += 1
    if sm90:
        LAUNCHES["tmajor_attention_bwd_sm90"] += 1
    if lse is not None:
        LAUNCHES["tmajor_attention_bwd_lse"] += 1
    if bias is None:
        return dqkv
    if bias.shape[0] == 1 and b != 1:
        dbias = dbias.float().sum(dim=0, keepdim=True).to(bias.dtype)
    return dqkv, dbias


def _tmajor_bwd_launch(symbol, qkv, o, do, bias, heads, lk_true, scale,
                       lse=None):
    """One launch of the token-major backward entry ``symbol``
    (``vast_tmajor_attention_bwd`` or ``..._sm90``) on checked CUDA
    operands, given the forward's ``lse`` or (None) sweeping for it:
    (dqkv, dbias), dbias (B, H, L, L) unreduced, None without a bias.
    Raises if the entry refuses the operands or the launch fails. Counts
    nothing: the wrapper counts its launches."""
    b, l, total = qkv.shape
    d = total // (3 * heads)
    dev = qkv.device
    dqkv = torch.empty_like(qkv)
    dbias = None
    if bias is not None:
        # keys past lk_true's last tile are not written by the kernel
        alloc = torch.zeros if 0 < lk_true < l else torch.empty
        dbias = alloc((b, heads, l, l), dtype=bias.dtype, device=dev)
    given = lse is not None
    if not given:                     # scratch, written by the dQ kernel
        lse = torch.empty((b, heads, l), dtype=torch.float32, device=dev)
    else:
        lse = lse.contiguous()
        if lse.data_ptr() % 16:
            lse = lse.clone()          # the copy engine reads it from 16 B
    delta = torch.empty((b, heads, l), dtype=torch.float32, device=dev)
    bias_stride = 0 if bias is None or bias.shape[0] == 1 else bias.stride(0)
    with torch.cuda.device(dev):
        err = _kernel(symbol)(
            _ptr(qkv), _ptr(o), _ptr(do), _ptr(bias), _ptr(dqkv),
            _ptr(dbias), _ptr(lse), _ptr(delta), int(given),
            _DTYPE_CODES[qkv.dtype], b, l, heads, d, lk_true or l,
            bias_stride, float(scale), _stream())
    if err:
        raise RuntimeError(f"tmajor attention backward launch failed "
                           f"({symbol}): CUDA error {err}")
    return dqkv, dbias


def _flash_scores_plain(q, k, bias, scale, lk_true):
    """The scaled, biased and masked scores (B, H, Lq, Lk) in fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if lk_true:
        s[..., lk_true:] = float("-inf")
    return s


def _flash_attention_plain(q, k, v, bias=None, *, scale: float = 1.0,
                           lk_true: int = 0, return_lse: bool = False):
    """The same function in plain PyTorch, computed in fp32 from the
    inputs; returns q's dtype. A row with no finite score gives zeros.
    With ``return_lse`` also the lse (B, H, Lq) fp32: m + log(l), as
    vast_tpu's kernel writes it (flash_attention.py:84), and +inf for a
    row with no finite score."""
    s = _flash_scores_plain(q, k, bias, scale, lk_true)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p / torch.where(l == 0, 1.0, l), v.float()).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.where(l > 0, m + torch.log(l), float("inf"))[..., 0]


def _flash_bwd_parts_plain(q, k, v, bias, o, lse, do, scale, lk_true):
    """p = exp(s - lse) from the saved lse, the cotangent do and ds = p
    (do . v^T - delta), delta = rowsum(do . o), (B, H, Lq, .) in fp32."""
    s = _flash_scores_plain(q, k, bias, scale, lk_true)
    p = torch.exp(s - lse.float()[..., None])
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, v.float().transpose(-1, -2)) - delta)
    return p, dof, ds


def _flash_attention_bwd_plain(q, k, v, bias, o, lse, do, *,
                               scale: float = 1.0, lk_true: int = 0,
                               return_dbias: bool = False):
    """The gradient in plain PyTorch, in fp32 from the inputs, as the
    Pallas kernels write it (flash_attention.py:335-360): p from the
    saved lse, ds the cotangent of the score before the scale. Returns
    dq, dk, dv in the inputs' dtype, and with ``return_dbias`` the raw ds
    (B, H, Lq, Lk) fp32."""
    p, dof, ds = _flash_bwd_parts_plain(q, k, v, bias, o, lse, do, scale,
                                        lk_true)
    dq = (torch.matmul(ds, k.float()) * scale).to(q.dtype)
    dk = (torch.matmul(ds.transpose(-1, -2), q.float()) * scale).to(k.dtype)
    dv = torch.matmul(p.transpose(-1, -2), dof).to(v.dtype)
    return (dq, dk, dv, ds) if return_dbias else (dq, dk, dv)


def _flash_attention_bwd_abs_terms(q, k, v, bias, o, lse, do, *,
                                   scale: float = 1.0, lk_true: int = 0):
    """For each output of the head-major backward, the sum of |terms|
    that make it, in fp32. ds = p (dp - delta) is itself a difference of
    two sums of D products, so its terms are dsa = p (|do| |v|^T +
    |delta|), which bounds its rounding where dp and delta cancel; then
    dsa |k| s for dq, dsa^T |q| s for dk, |p|^T |do| for dv and dsa for
    dbias. The kernel rounds p or ds to bf16 (relative 2^-8) before the
    last product, so it errs by at most 2^-8 of these there; the checks
    on the card derive their tolerances from them."""
    p, dof, _ = _flash_bwd_parts_plain(q, k, v, bias, o, lse, do, scale,
                                       lk_true)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dsa = p * (torch.matmul(dof.abs(), v.float().abs().transpose(-1, -2))
               + delta.abs())
    return {"dq": torch.matmul(dsa, k.float().abs()) * scale,
            "dk": torch.matmul(dsa.transpose(-1, -2), q.float().abs())
            * scale,
            "dv": torch.matmul(p.transpose(-1, -2), dof.abs()),
            "dbias": dsa}


def _check_flash(q, k, v, bias, lk_true):
    """(B, H, Lq, Lk, D) of operands the head-major kernels take; raises
    on anything else."""
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
    if any(t is not None and t.shape[-1] > 1 and t.stride(-1) != 1
           for t in (q, k, v, bias)):
        # the kernels' rule, held on every device: the CPU's plain version
        # takes any strides, but a caller must not rely on that
        raise ValueError("the last axis of q, k, v and bias must be "
                         "contiguous")
    if bias is not None:
        if bias.dim() != 4 or bias.shape[-1] != lk:
            raise ValueError(f"bias {tuple(bias.shape)} is not 4-D over "
                             f"{lk} keys")
        bias.expand(b, h, lq, lk)              # raises if not broadcastable
        if bias.device != q.device:
            raise ValueError("bias and q are on different devices")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v are on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    return b, h, lq, lk, d


def _empty_like_layout(t, dtype=None):
    """An empty tensor of ``t``'s shape whose memory order follows ``t``'s
    strides (the last axis innermost): a head-major view of token-major
    projections gets a token-major buffer, so the output projection and
    autograd read it without a copy."""
    order = sorted(range(t.dim() - 1), key=lambda i: -t.stride(i))
    return torch.empty_permuted(t.shape, order + [t.dim() - 1],
                                dtype=dtype or t.dtype, device=t.device)


def _strides(*tensors):
    """(batch, head, row) element strides of each tensor, zeros for None,
    as a C array for the kernels."""
    st = [s for t in tensors
          for s in ((0, 0, 0) if t is None else t.stride()[:3])]
    return (ctypes.c_longlong * len(st))(*st)


def flash_attention(q, k, v, bias=None, *, scale: float = 1.0,
                    lk_true: int = 0, return_lse: bool = False):
    """Attention over head-major (B, H, L, D) tensors, differentiable.

    q (B, H, Lq, D), k and v (B, H, Lk, D); returns (B, H, Lq, D) in q's
    dtype, its memory in the order of q's strides, and with
    ``return_lse`` also the lse (B, H, Lq) fp32. ``scale`` multiplies the
    fp32 scores (the JAX function takes q already scaled, i.e. scale 1);
    ``bias``, 4-D and broadcastable to (B, H, Lq, Lk), in fp32 or q's
    dtype, is added after the scale; keys at and beyond ``lk_true`` (when
    non-zero) are masked. Any strides are taken as long as the last axis
    is contiguous: the kernels read BERT's token-major projections and
    CLIP's packed in_proj output as they are.

    One ``torch.library`` op, ``vast::flash_attention`` (``FLASH_OP``),
    the counterpart of vast_tpu's ``_flash_fwd`` custom VJP
    (ops/attention.py:121-150), so that a selective checkpoint policy can
    name it (models/remat.py). Without a gradient to record it runs the
    forward without the lse (JAX's primal); with one, the forward with
    the lse, and its backward is :func:`flash_attention_bwd` from the
    saved lse. A bias that requires no gradient (a mask) gets none and ds
    is never written; a learned bias gets ds summed over its broadcast
    axes (attention.py:136-143).
    """
    _check_flash(q, k, v, bias, lk_true)
    need_lse = return_lse or (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias)))
    o, lse = FLASH_OP(q, k, v, bias, float(scale), lk_true, need_lse)
    return (o, lse) if return_lse else o


def _sm90_ok(d, *tensors):
    """Whether the Hopper bodies (wgmma, every tile brought by the copy
    engine) take these operands of head width ``d``: the head-major
    forward's q, k and v, the token-major forward's qkv (and bias), the
    head-major backward's q, k, v, o and do, or the token-major
    backward's qkv, o and do. bf16, d a multiple of 8 up to 128, every
    stride but the last (contiguous) a non-zero multiple of 8 elements (16
    bytes), every base 16-byte aligned. The outputs, laid out as their
    inputs (:func:`_empty_like_layout`, or dqkv like qkv), then take the
    epilogues' bf16 pairs too. Decided from dtype, shape, strides and
    data_ptr alone, before any launch; the C entries check the same and
    refuse the rest."""
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        return False
    for t in tensors:              # loops: asked on every call, host-paced
        if t.dtype != torch.bfloat16 or t.data_ptr() % 16:
            return False
        for s in t.stride()[:-1]:
            if s == 0 or s % 8:
                return False
    return True


# the resident strip's room for the keys of a head (rows of K, and of V),
# by the padded head width: 64 at D <= 64, else 128
STRIP_MAX_ROWS = {64: 768, 128: 320}


def _strip_rows(kend):
    """The rows the resident strip gives ``kend`` keys: 128 a key tile
    but the last, which takes 16, 64 or 128 as its keys need (wgmma's N)."""
    full = (kend - 1) // 128 * 128
    rest = kend - full
    return full + (16 if rest <= 16 else 64 if rest <= 64 else 128)


def _strip_ok(d, kend, qkv):
    """Whether the layout probe's resident strip
    (``attention_fwd_strip_sm90_kernel``, through
    ``vast_tmajor_dma_attention_fwd_sm90``) takes a fused qkv of head width
    ``d`` with keys masked from ``kend``: the Hopper bodies' rule
    (:func:`_sm90_ok`) and a head's K and V that fit in shared memory
    (:data:`STRIP_MAX_ROWS`: 320 keys at D above 64, 768 at and below).
    Decided before any launch; the C entry checks the same (strip_takes)
    and refuses the rest."""
    return (_sm90_ok(d, qkv) and 0 < kend
            and _strip_rows(kend) <= STRIP_MAX_ROWS[64 if d <= 64 else 128])


def _flash_fwd_args(q, k, v, bias, out, lse, scale, lk_true):
    """The arguments of either head-major forward entry
    (``vast_flash_attention_fwd`` or ``..._sm90``) for these tensors; a
    ``bias`` broadcast to (B, H, Lq, Lk) already, ``lse`` None for
    none."""
    b, h, lq, d = q.shape
    return (_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), _ptr(lse),
            _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[q.dtype if bias is None else bias.dtype],
            b, h, lq, d, lk_true or k.shape[2], _strides(q, k, v, out, bias),
            float(scale), _stream())


def _flash_fwd_launch(symbol, q, k, v, bias, scale, lk_true, need_lse):
    """One launch of the head-major forward entry ``symbol`` on CUDA
    operands: (out, lse), the lse empty unless ``need_lse``. Raises if
    the entry refuses the operands or the launch fails. Counts nothing:
    the op counts its launches."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if bias is not None:
        bias = bias.expand(b, h, lq, lk)
    operands = (q, k, v) if bias is None else (q, k, v, bias)
    if any(t.stride(-1) != 1 for t in operands):
        raise ValueError("the last axis of q, k, v and bias must be "
                         "contiguous")
    if bias is not None and bias.dtype not in (torch.float32, q.dtype):
        raise TypeError(f"bias dtype {bias.dtype}: float32 or {q.dtype}")
    out = _empty_like_layout(q)
    lse = torch.empty((b, h, lq) if need_lse else (0,), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel(symbol)(*_flash_fwd_args(
            q, k, v, bias, out, lse if need_lse else None, scale, lk_true))
    if err:
        raise RuntimeError(f"flash attention kernel launch failed "
                           f"({symbol}): CUDA error {err}")
    return out, lse


@torch.library.custom_op(
    "vast::flash_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? bias, float scale, "
           "int lk_true, bool need_lse) -> (Tensor, Tensor)")
def _flash_attention_op(q, k, v, bias, scale, lk_true, need_lse):
    """The forward on checked operands: the plain version on the CPU, a
    kernel on CUDA. The lse is empty unless ``need_lse``. Operands that
    the copy engine can read in bf16 (:func:`_sm90_ok`) take the
    Hopper body, the rest (fp32, D not a multiple of 8, odd strides) the
    mma.sync / CUDA-core bodies; decided before the launch, and a failed
    launch raises: neither falls back to the other."""
    if q.device.type == "cpu":
        if need_lse:
            return _flash_attention_plain(q, k, v, bias, scale=scale,
                                          lk_true=lk_true, return_lse=True)
        return (_flash_attention_plain(q, k, v, bias, scale=scale,
                                       lk_true=lk_true),
                q.new_empty(0, dtype=torch.float32))
    sm90 = _sm90_ok(q.shape[-1], q, k, v)
    out, lse = _flash_fwd_launch(
        "vast_flash_attention_fwd_sm90" if sm90 else
        "vast_flash_attention_fwd", q, k, v, bias, scale, lk_true, need_lse)
    LAUNCHES["flash_attention_fwd_lse" if need_lse
             else "flash_attention_fwd"] += 1
    if sm90:
        LAUNCHES["flash_attention_fwd_sm90"] += 1
    return out, lse


@_flash_attention_op.register_fake
def _(q, k, v, bias, scale, lk_true, need_lse):
    b, h, lq, _ = q.shape
    return (_empty_like_layout(q),
            q.new_empty((b, h, lq) if need_lse else (0,),
                        dtype=torch.float32))


def _flash_setup(ctx, inputs, output):
    q, k, v, bias, scale, lk_true, _ = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, bias, o, lse)
    ctx.args = dict(scale=scale, lk_true=lk_true)


def _flash_backward(ctx, grad, _):
    q, k, v, bias, o, lse = ctx.saved_tensors
    bias_grad = bias is not None and ctx.needs_input_grad[3]
    do = grad.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    res = flash_attention_bwd(q, k, v, bias, o, lse, do,
                              return_dbias=bias_grad, **ctx.args)
    dbias = None
    if bias_grad:
        ds = res[3]
        axes = tuple(i for i in range(4)
                     if bias.shape[i] == 1 and ds.shape[i] != 1)
        dbias = (ds.sum(dim=axes, keepdim=True) if axes else ds
                 ).to(bias.dtype)
    return res[0], res[1], res[2], dbias, None, None, None


_flash_attention_op.register_autograd(_flash_backward,
                                      setup_context=_flash_setup)

FLASH_OP = torch.ops.vast.flash_attention.default


def flash_attention_bwd(q, k, v, bias, o, lse, do, *, scale: float,
                        lk_true: int = 0, return_dbias: bool = False):
    """Gradient of :func:`flash_attention` w.r.t. q, k and v (and the
    bias's raw ds), the counterpart of vast_tpu's ``flash_attention_bwd``
    (flash_attention.py:462).

    q, k, v and the bias as the forward took them, ``o`` its output,
    ``lse`` its lse (B, H, Lq) fp32 and ``do`` the output's cotangent
    (B, H, Lq, D) in q's dtype, any strides with a contiguous last axis.
    p = exp(s - lse) from the saved lse, delta = rowsum(do . o) and ds =
    p (do . v^T - delta). Returns dq, dk, dv in the input dtype, each in
    the memory order of its input's strides, and with ``return_dbias``
    also ds (B, H, Lq, Lk) fp32 (the caller reduces it over the bias's
    broadcast axes). Keys at and beyond ``lk_true`` get zero gradients.
    """
    b, h, lq, lk, d = _check_flash(q, k, v, bias, lk_true)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (b, h, lq, d) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{name} must be {(b, h, lq, d)} {q.dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if tuple(lse.shape) != (b, h, lq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be {(b, h, lq)} float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if return_dbias and bias is None:
        raise ValueError("return_dbias needs a bias")
    if q.device.type == "cpu":
        return _flash_attention_bwd_plain(q, k, v, bias, o, lse, do,
                                          scale=scale, lk_true=lk_true,
                                          return_dbias=return_dbias)
    if bias is not None:
        # the kernel reads an fp32 bias (a mask bias is one already); a
        # cast of the unbroadcast bias keeps its broadcast strides
        bias = bias.float().expand(b, h, lq, lk)
    operands = [t for t in (q, k, v, o, do, bias) if t is not None]
    if any(t.stride(-1) != 1 for t in operands):
        raise ValueError("the last axis of q, k, v, o, do and bias must be "
                         "contiguous")
    # decided before the launch; a refused or failed launch raises
    sm90 = _sm90_ok(d, q, k, v, o, do)
    dq, dk, dv, dbias = _flash_bwd_launch(
        "vast_flash_attention_bwd_sm90" if sm90 else
        "vast_flash_attention_bwd", q, k, v, bias, o, lse, do, scale,
        lk_true, return_dbias)
    LAUNCHES["flash_attention_bwd_dbias" if return_dbias
             else "flash_attention_bwd"] += 1
    if sm90:
        LAUNCHES["flash_attention_bwd_sm90"] += 1
    return (dq, dk, dv, dbias) if return_dbias else (dq, dk, dv)


def _flash_bwd_launch(symbol, q, k, v, bias, o, lse, do, scale, lk_true,
                      return_dbias):
    """One launch of the head-major backward entry ``symbol``
    (``vast_flash_attention_bwd`` or ``..._sm90``) on checked CUDA
    operands, ``bias`` fp32 and broadcast to (B, H, Lq, Lk) already, every
    last axis contiguous: (dq, dk, dv, dbias), dbias None unless
    ``return_dbias``. Raises if the entry refuses the operands or the
    launch fails. Counts nothing: the wrapper counts its launches."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dev = q.device
    dq, dk, dv = (_empty_like_layout(t) for t in (q, k, v))
    dbias = None
    if return_dbias:
        # keys past lk_true's last tile are not written by the kernel
        alloc = torch.zeros if 0 < lk_true < lk else torch.empty
        dbias = alloc((b, h, lq, lk), dtype=torch.float32, device=dev)
    lse = lse.contiguous()
    if lse.data_ptr() % 16:
        lse = lse.clone()              # the copy engine reads it from 16 B
    delta = torch.empty_like(lse)
    with torch.cuda.device(dev):
        err = _kernel(symbol)(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(bias),
            _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dbias), _ptr(lse),
            _ptr(delta), _DTYPE_CODES[q.dtype], b, h, lq, lk, d,
            lk_true or lk,
            _strides(q, k, v, o, do, dq, dk, dv, bias, dbias),
            float(scale), _stream())
    if err:
        raise RuntimeError(f"flash attention backward launch failed "
                           f"({symbol}): CUDA error {err}")
    return dq, dk, dv, dbias


# qkv, out, dtype, B, L, H, D, kend, stream
_PROBE_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]
# q, k, v, bias, out, lse, dtype, bias_dtype, B, H, Lq, D, kend, strides,
# scale, stream: both head-major forward entries
_HMAJOR_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
# qkv, bias, out, lse, dtype, B, L, H, D, kend, bias_batch_stride, scale,
# stream: both token-major forward entries
_TMAJOR_FWD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
# qkv, o, dout, bias, dqkv, dbias, lse, delta, lse_given, dtype, B, L, H,
# D, kend, bias_batch_stride, scale, stream: both token-major backward
# entries
_TMAJOR_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
# q, k, v, o, dout, bias, dq, dk, dv, dbias, lse, delta, dtype, B, H, Lq,
# Lk, D, kend, strides, scale, stream: both head-major backward entries
_HMAJOR_BWD_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
_ARGTYPES = {
    "vast_tmajor_attention_fwd": _TMAJOR_FWD_ARGS,
    "vast_tmajor_attention_fwd_sm90": _TMAJOR_FWD_ARGS,
    "vast_tmajor_attention_bwd": _TMAJOR_BWD_ARGS,
    "vast_tmajor_attention_bwd_sm90": _TMAJOR_BWD_ARGS,
    "vast_flash_attention_fwd": _HMAJOR_FWD_ARGS,
    "vast_flash_attention_fwd_sm90": _HMAJOR_FWD_ARGS,
    "vast_flash_attention_bwd": _HMAJOR_BWD_ARGS,
    "vast_flash_attention_bwd_sm90": _HMAJOR_BWD_ARGS,
    "vast_tmajor_dma_attention_fwd": _PROBE_ARGS,
    "vast_tmajor_dma_attention_fwd_sm90": _PROBE_ARGS,
    "vast_tmajor_sect_attention_fwd": _PROBE_ARGS,
    "vast_tmajor_sect_attention_fwd_sm90": _PROBE_ARGS,
}


def _kernel(symbol: str):
    from vast_tpu_torch.build import load

    fn = getattr(load("flash_attention"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn
