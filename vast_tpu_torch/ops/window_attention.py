"""Window attention: the (shifted) window blocks of Swin and Video Swin.

No counterpart in ``vast_tpu``, whose window blocks (models/swin.py:113-123,
models/videoswin.py:114-122) add the (1, H, n, n) bias table to the
region mask tiled over every window of the batch and hand that (B nW, H,
n, n) sum to the general attention. :func:`window_attention` computes the
same function from the table and the region labels of one clip's
windows, so that on the card no tensor of the windows' scores' size
exists, forward or backward:

* the kernels (``csrc/flash_attention.cu``, "Window attention for
  Hopper") read the table per window and the mask as labels, and sum the
  backward's ds over the windows into the table's (H, n, n) gradient
  themselves, in a fixed order;
* one ``torch.library`` op, ``vast::window_attention`` (``WINDOW_OP``),
  so that a selective checkpoint policy can name it (models/remat.py);
  without a gradient to record its forward writes no lse.

The route is read from what the call observes, first rule first: a
window the general rule sends to the plain route (``ops.attention.
_plain_route``: Swin's 49 tokens) keeps today's materialised plain
route, with the same numbers; a CUDA call in another type than bf16
(fp32: the sharded towers' checks) takes the general op on the
materialised sum, whose mma.sync / CUDA-core bodies serve that type; a
bf16 CUDA call launches the window kernels, on contiguous copies of q, k
and v where the copy engine cannot read their views, and raises where the
kernels cannot take its shape (a head width above 64 or not a multiple
of 8, a window of tokens not a multiple of 4) or a launch fails; a CPU
call runs the op's plain version, the same fp32 function as the general
plain route on the table-plus-mask sum, built inside.

A shifted block's mask is an equivalence: two tokens of a window attend
where they lie in one region of the rolled clip. :func:`region_labels`
turns it, once per cached mask, into a label per token (the first token
of its region), exact whatever the mask's regions.
"""

from __future__ import annotations

import ctypes

import torch

from vast_tpu_torch.ops import flash_attention as fa
from vast_tpu_torch.ops.attention import (NEG_INF, _plain_route,
                                          multi_head_attention_hmajor)

MAX_HEAD_DIM = 64          # the window kernels' one 64-column box
_TILE = 64                 # rows and keys of the table gradient's tiles


def region_labels(mask):
    """(nW, n) int32 labels of an (nW, n, n) bool region mask (True =
    attend): each token's first token that it attends, so that two tokens
    attend exactly where their labels are equal. Raises if the mask is
    not such an equivalence."""
    if mask.dim() != 3 or mask.shape[1] != mask.shape[2]:
        raise ValueError(f"mask must be (nW, n, n), got {tuple(mask.shape)}")
    labels = mask.to(torch.int8).argmax(dim=-1).to(torch.int32)
    if not torch.equal(labels[:, :, None] == labels[:, None, :],
                       mask.bool()):
        raise ValueError("the mask is not an equivalence of regions")
    return labels


def _label_mask(labels):
    return labels[:, :, None] == labels[:, None, :]


def _window_bias_plain(bias, labels, windows):
    """The additive fp32 bias of every window: the (H, n, n) table plus
    -1e30 where the labels differ, (windows, H, n, n) (or (1, H, n, n)
    without labels), as ``ops.attention._prepare_bias`` sums the table and
    the tiled mask."""
    full = bias.float()[None]
    if labels is None:
        return full
    mb = torch.where(_label_mask(labels), 0.0, NEG_INF).float()
    return full + mb[:, None].repeat(windows // labels.shape[0], 1, 1, 1)


def _window_shape_ok(n, d):
    """Whether the window kernels take windows of ``n`` tokens at head
    width ``d``: the Hopper bodies' widths (``flash_attention._sm90_ok``:
    a multiple of 8) within one 64-column box, and table rows the copy
    engine reads (n a multiple of 4). The C entries check the same, with
    the operands' type, strides and bases, and refuse the rest."""
    return d <= MAX_HEAD_DIM and n % 4 == 0 and fa._sm90_ok(d)


def _readable(t, d):
    """``t``, or a contiguous copy where the copy engine cannot read the
    view (``flash_attention._sm90_ok``: strides in 16 bytes, a 16-byte
    base)."""
    if fa._sm90_ok(d, t):
        return t
    t = t.contiguous()
    return t if fa._sm90_ok(d, t) else t.clone()


def _check(q, k, v, bias, labels):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (W, H, n, D) alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    w, h, n, _ = q.shape
    if tuple(bias.shape) != (h, n, n) or not bias.is_floating_point():
        raise ValueError(f"bias must be a float ({h}, {n}, {n}) table, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if labels is not None and (
            labels.dim() != 2 or labels.shape[1] != n
            or labels.dtype != torch.int32 or w % labels.shape[0]):
        raise ValueError(f"labels must be int32 (nW, {n}) with nW "
                         f"dividing {w}, got {tuple(labels.shape)} "
                         f"{labels.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype} "
                         f"differ")
    if any(t is not None and t.device != q.device
           for t in (k, v, bias, labels)):
        raise ValueError("the operands are on different devices")


def window_attention(q, k, v, bias, labels=None, *, scale: float):
    """Attention inside each window, differentiable.

    q, k, v (W, H, n, D) head-major, any strides with a contiguous last
    axis (views of the packed qkv), W = clips x nW windows in the order of
    the window partition. ``bias`` the gathered (H, n, n) table (this
    rank's heads under tp); ``labels`` None or the (nW, n) int32 region
    labels of one clip's windows (:func:`region_labels`), window w reading
    row w % nW. Scores are q . k^T times ``scale`` plus the bias in fp32,
    masked where the labels differ. Returns (W, H, n, D) in q's dtype.
    The route is read from the call (module docstring).
    """
    _check(q, k, v, bias, labels)
    w, _, n, d = q.shape
    cuda = q.device.type == "cuda"
    if _plain_route(n, n, d) or (cuda and q.dtype != torch.bfloat16):
        mask = None
        if labels is not None:
            mask = _label_mask(labels)[:, None].repeat(
                w // labels.shape[0], 1, 1, 1)
        return multi_head_attention_hmajor(q, k, v, bias=bias[None],
                                           mask=mask, scale=scale)
    if cuda:
        if not _window_shape_ok(n, d):
            raise ValueError(f"the window kernels take D a multiple of 8 up "
                             f"to {MAX_HEAD_DIM} and windows of a multiple "
                             f"of 4 tokens, got n {n}, D {d}")
        q, k, v = (_readable(t, d) for t in (q, k, v))
    need_lse = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, bias))
    return WINDOW_OP(q, k, v, bias, labels, float(scale), need_lse)[0]


def _strides(*tensors):
    """(window, head, row) element strides of 8 operands (zeros for
    None), as a C array for the kernels."""
    st = [s for t in tensors
          for s in ((0, 0, 0) if t is None else t.stride()[:3])]
    st += [0] * (24 - len(st))
    return (ctypes.c_longlong * 24)(*st)


def _table_arg(bias):
    """The table as the kernels read it: fp32, contiguous, 16-byte
    aligned (the copy engine reads its rows)."""
    table = bias.float().contiguous()
    return table.clone() if table.data_ptr() % 16 else table


def _labels_arg(labels, n_windows):
    """The labels as the kernels read them (contiguous, in 8-byte pairs)
    and the windows of a clip."""
    if labels is None:
        return None, n_windows
    labels = labels.contiguous()
    return (labels.clone() if labels.data_ptr() % 8 else labels,
            labels.shape[0])


def _window_fwd_launch(q, k, v, bias, labels, scale, need_lse):
    """One launch of the window forward on CUDA operands the kernels take:
    (out, lse), the lse empty unless ``need_lse``. Raises if the entry
    refuses them or the launch fails. Counts nothing: the op counts."""
    w, h, n, d = q.shape
    out = fa._empty_like_layout(q)
    lse = torch.empty((w, h, n) if need_lse else (0,), dtype=torch.float32,
                      device=q.device)
    table = _table_arg(bias)
    labels, n_win = _labels_arg(labels, w)
    with torch.cuda.device(q.device):
        err = _kernel("vast_window_attention_fwd_sm90")(
            fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(table),
            fa._ptr(labels), fa._ptr(out), fa._ptr(lse if need_lse else None),
            fa._DTYPE_CODES[q.dtype], w, h, n, d, n_win,
            _strides(q, k, v, out), float(scale), fa._stream())
    if err:
        raise RuntimeError(f"window attention forward launch failed: CUDA "
                           f"error {err}")
    return out, lse


@torch.library.custom_op(
    "vast::window_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor? labels, "
           "float scale, bool need_lse) -> (Tensor, Tensor)")
def _window_attention_op(q, k, v, bias, labels, scale, need_lse):
    """The forward on checked operands: the plain version on the CPU, the
    window kernel on CUDA (the wrapper sends nothing else here). The lse
    is empty unless ``need_lse``."""
    if q.device.type == "cpu":
        full = _window_bias_plain(bias, labels, q.shape[0])
        if need_lse:
            return fa._flash_attention_plain(q, k, v, full, scale=scale,
                                             return_lse=True)
        return (fa._flash_attention_plain(q, k, v, full, scale=scale),
                q.new_empty(0, dtype=torch.float32))
    out, lse = _window_fwd_launch(q, k, v, bias, labels, scale, need_lse)
    fa.LAUNCHES["flash_attention_fwd_lse" if need_lse
                else "flash_attention_fwd"] += 1
    fa.LAUNCHES["window_attention_fwd"] += 1
    return out, lse


@_window_attention_op.register_fake
def _(q, k, v, bias, labels, scale, need_lse):
    w, h, n, _ = q.shape
    return (fa._empty_like_layout(q),
            q.new_empty((w, h, n) if need_lse else (0,),
                        dtype=torch.float32))


def _window_setup(ctx, inputs, output):
    q, k, v, bias, labels, scale, _ = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, bias, labels, o, lse)
    ctx.scale = scale


def _window_backward(ctx, grad, _):
    q, k, v, bias, labels, o, lse = ctx.saved_tensors
    do = grad.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    dq, dk, dv, dtable = window_attention_bwd(
        q, k, v, bias, labels, o, lse, do, scale=ctx.scale,
        want_dbias=ctx.needs_input_grad[3])
    dbias = None if dtable is None else dtable.to(bias.dtype)
    return dq, dk, dv, dbias, None, None, None


_window_attention_op.register_autograd(_window_backward,
                                       setup_context=_window_setup)

WINDOW_OP = torch.ops.vast.window_attention.default


def window_attention_bwd(q, k, v, bias, labels, o, lse, do, *,
                         scale: float, want_dbias: bool = True):
    """Gradient of :func:`window_attention`'s op: q, k, v, the bias and
    labels as the forward took them, ``o`` its output, ``lse`` its (W, H,
    n) fp32 lse and ``do`` the output's cotangent. Returns (dq, dk, dv,
    dbias): dq, dk, dv in the inputs' dtype, each in its input's memory
    order, and dbias the (H, n, n) fp32 sum over the windows of ds = p
    (do . v^T - delta), None unless ``want_dbias``."""
    w, h, n, d = q.shape
    if q.device.type == "cpu":
        full = _window_bias_plain(bias, labels, w)
        res = fa._flash_attention_bwd_plain(q, k, v, full, o, lse, do,
                                            scale=scale,
                                            return_dbias=want_dbias)
        return (*res[:3], res[3].sum(dim=0) if want_dbias else None)
    if not fa._sm90_ok(d, do):
        do = do.contiguous()
    if not fa._sm90_ok(d, o):
        o = o.contiguous()
    lse = lse.contiguous()
    if lse.data_ptr() % 16:
        lse = lse.clone()               # the copy engine reads it from 16 B
    dq, dk, dv = (fa._empty_like_layout(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    table = _table_arg(bias)
    labels, n_win = _labels_arg(labels, w)
    dtable = partial = None
    per, chunks = 1, 1
    if want_dbias:
        per, chunks = dtable_chunks(
            w, h, n, torch.cuda.get_device_properties(
                q.device).multi_processor_count)
        dtable = torch.empty((h, n, n), dtype=torch.float32, device=q.device)
        partial = dtable if chunks == 1 else torch.empty(
            (chunks, h, n, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel("vast_window_attention_bwd_sm90")(
            fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(o), fa._ptr(do),
            fa._ptr(table), fa._ptr(labels), fa._ptr(dq), fa._ptr(dk),
            fa._ptr(dv), fa._ptr(dtable), fa._ptr(partial), fa._ptr(lse),
            fa._ptr(delta), fa._DTYPE_CODES[q.dtype], w, h, n, d, n_win,
            per, chunks, _strides(q, k, v, o, do, dq, dk, dv), float(scale),
            fa._stream())
    if err:
        raise RuntimeError(f"window attention backward launch failed: CUDA "
                           f"error {err}")
    fa.LAUNCHES["flash_attention_bwd_dbias" if want_dbias
                else "flash_attention_bwd"] += 1
    fa.LAUNCHES["window_attention_bwd"] += 1
    return dq, dk, dv, dtable


def dtable_chunks(windows: int, heads: int, n: int, sms: int):
    """(windows a chunk, chunks) of the table gradient's partial sums:
    enough (head, 64 x 64 tile, chunk) items for at least four a worker
    (two warpgroups an SM), and of the chunk counts up to four times that
    least one, the one whose busiest worker runs the fewest windows (the
    fewer chunks on a tie), every chunk holding at least one window."""
    tiles = heads * (-(-n // _TILE)) ** 2
    workers = 2 * sms
    least = max(1, min(windows, -(-4 * workers // tiles)))
    best = None
    for want in range(least, min(windows, 4 * least) + 1):
        per = -(-windows // want)
        chunks = -(-windows // per)
        busiest = -(-chunks * tiles // workers) * per
        if best is None or (busiest, chunks) < best[0]:
            best = (busiest, chunks), per
    per = best[1]
    return per, -(-windows // per)


# q, k, v, table, labels, out, lse, dtype, W, H, n, D, n_win, strides,
# scale, stream
_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
# q, k, v, o, dout, table, labels, dq, dk, dv, dtable, partial, lse,
# delta, dtype, W, H, n, D, n_win, per_chunk, chunks, strides, scale,
# stream
_BWD_ARGS = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
_ARGTYPES = {"vast_window_attention_fwd_sm90": _FWD_ARGS,
             "vast_window_attention_bwd_sm90": _BWD_ARGS}


def _kernel(symbol: str):
    from vast_tpu_torch.build import load

    fn = getattr(load("flash_attention"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn
