"""The token-major layout probe: where the cost of cutting 88-wide heads
out of a fused qkv row lands, on the card.

The counterpart of ``scripts/bench_tmajor_variants.py``. Four layouts of
the same data at EVA01-g's flagship attention (B 256 = 32 clips x 8
frames, Lp 272, H 16, D 88, bf16, keys masked past 257, scale 1):

  cur    - the fused per-head [q|k|v] layout through the token-major
           forward (``ops.flash_attention.self_attention_tmajor``): in
           bf16 its Hopper body, wgmma fed by the copy engine through
           tensor maps over each head's strips.
  sect   - the section-major layout [Q_all | K_all | V_all]: in bf16
           cur's Hopper body (the same instantiation) through tensor maps
           of the section-major views, so that cur against sect is the
           layout alone; fp32 the mma.sync / CUDA-core body at those
           offsets (:func:`attention_sect`).
  dma    - the fused layout, each head's strips brought into shared
           memory by the copy engine: in bf16 the resident strip, a
           Hopper body (wgmma) that keeps each head's K and V in shared
           memory while its query tiles run, so that cur against dma is
           the streaming ring against a resident strip on one kind of
           body; fp32 and kend above its room the mma.sync / CUDA-core
           body (:func:`attention_dma`).
  pad128 - the fused layout zero-padded to D 128 through cur's op (the
           TPU's head packing has no counterpart: the kernel reads any
           D <= 128).

    python3 -m vast_tpu_torch.scripts.bench_tmajor_variants
    python3 -m vast_tpu_torch.scripts.bench_tmajor_variants --device cpu \\
        --batch 4 --length 24 --heads 2 --head-dim 16 --lk-true 20

print a JSON line with the device (on CUDA with ``nvidia-smi``'s name and
power limit line), then one per variant: ``fwd_ms`` and ``fwd_bwd_ms``,
or ``"fwd_bwd": "n/a: ..."`` for the two raw kernels, which have no
autograd rule (as the Pallas calls have none). Times are CUDA events
around ``--iters`` back-to-back calls after one warm-up call; on the CPU
(``--device cpu``, the plain versions: a functional check) the host
clock. Each variant's first two rows are held against cur's (atol 2e-2,
as the JAX script holds them).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from vast_tpu_torch.device import resolve_device
from vast_tpu_torch.ops import flash_attention as fa
from vast_tpu_torch.ops.attention import NEG_INF    # the JAX script's mask

B, LP, H, D = 256, 272, 16, 88
LK_TRUE = 257
PAD_D = 128
VARIANTS = ("cur", "sect", "dma", "pad128")
NO_GRAD = ("n/a: a raw kernel with no autograd rule, as the Pallas call "
           "has none")
CROSS_ATOL = 2e-2


def _softmax_av_plain(q, k, v, lk_true):
    """``_softmax_av`` (scripts/bench_tmajor_variants.py:62) over (B, H, L,
    D) operands, in its order: scores in fp32, masked to ``lk_true`` keys
    (0: none), max, exp, sum, p / l rounded to v's dtype and its product
    with v accumulated in fp32. Returns fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if lk_true:
        s[..., lk_true:] = NEG_INF
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.matmul((p / l).to(v.dtype).float(), v.float())


def qkv_views(qkv, heads, section_major=False):
    """(3, B, H, L, D) views of q, k and v in a (B, L, 3*H*D) qkv: fused
    per head [q|k|v], or section-major [Q_all | K_all | V_all]."""
    b, l, total = qkv.shape
    d = total // (3 * heads)
    if section_major:
        return qkv.view(b, l, 3, heads, d).permute(2, 0, 3, 1, 4)
    return qkv.view(b, l, heads, 3, d).permute(3, 0, 2, 1, 4)


def _plain(qkv, heads, lk_true, section_major):
    q, k, v = qkv_views(qkv, heads, section_major)
    b, h, l, d = q.shape
    o = _softmax_av_plain(q, k, v, lk_true)
    return o.transpose(1, 2).reshape(b, l, h * d).to(qkv.dtype)


def _attention_dma_plain(qkv, *, heads: int, lk_true: int = 0):
    """:func:`attention_dma` in plain PyTorch."""
    return _plain(qkv, heads, lk_true, section_major=False)


def _attention_sect_plain(qkv, *, heads: int, lk_true: int = 0):
    """:func:`attention_sect` in plain PyTorch."""
    return _plain(qkv, heads, lk_true, section_major=True)


# the probe kernels' C entries: the Hopper bodies (wgmma, the copy engine)
# and the mma.sync / CUDA-core ones for what those do not take
DMA_SM90 = "vast_tmajor_dma_attention_fwd_sm90"
DMA_MMA = "vast_tmajor_dma_attention_fwd"
SECT_SM90 = "vast_tmajor_sect_attention_fwd_sm90"
SECT_MMA = "vast_tmajor_sect_attention_fwd"


def _launch(symbol, qkv, heads, lk_true, hint=""):
    """One launch of the probe entry ``symbol`` on a checked CUDA qkv: the
    output (B, L, H*D). Raises if the entry refuses qkv or the launch
    fails. Counts nothing: the wrappers count their launches."""
    b, l, total = qkv.shape
    d = total // (3 * heads)
    fa._check_cuda_operands(qkv, None)
    out = torch.empty((b, l, heads * d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = fa._kernel(symbol)(fa._ptr(qkv), fa._ptr(out),
                                 fa._DTYPE_CODES[qkv.dtype], b, l, heads, d,
                                 lk_true or l, fa._stream())
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}"
                           + hint)
    return out


def _route(key, qkv, heads, lk_true, plain, entry, hint=""):
    """Both wrappers' route: the checks, the plain version on the CPU, else
    one launch of the C entry that ``entry()`` picks, counted in
    ``LAUNCHES[key]`` and, for a Hopper body, ``LAUNCHES[key + "_sm90"]``
    too."""
    fa._check(qkv, None, heads, lk_true)
    if qkv.device.type == "cpu":
        with torch.no_grad():
            return plain(qkv, heads=heads, lk_true=lk_true)
    symbol = entry()
    out = _launch(symbol, qkv, heads, lk_true, hint)
    fa.LAUNCHES[key] += 1
    if symbol in (DMA_SM90, SECT_SM90):
        fa.LAUNCHES[key + "_sm90"] += 1
    return out


def dma_entry(qkv, heads, lk_true=0):
    """The C entry :func:`attention_dma` launches for a CUDA ``qkv``:
    the resident strip (``DMA_SM90``) where :func:`fa._strip_ok` takes qkv
    and its kend, else the mma.sync / CUDA-core body fed by the copy
    engine (``DMA_MMA``). Decided before the launch from dtype, shape,
    strides and data_ptr."""
    l, total = qkv.shape[1:]
    return DMA_SM90 if fa._strip_ok(total // (3 * heads), lk_true or l,
                                    qkv) else DMA_MMA


def sect_entry(qkv, heads):
    """The C entry :func:`attention_sect` launches for a CUDA ``qkv``: the
    shared Hopper forward body (``SECT_SM90``) where :func:`fa._sm90_ok`
    takes qkv, else the strided mma.sync / CUDA-core body
    (``SECT_MMA``)."""
    return SECT_SM90 if fa._sm90_ok(qkv.shape[2] // (3 * heads), qkv) \
        else SECT_MMA


def attention_dma(qkv, *, heads: int, lk_true: int = 0):
    """softmax(q . k^T) . v per head of a fused token-major qkv (B, L,
    H*3*D), unscaled, keys at and past ``lk_true`` (when non-zero) masked;
    returns (B, L, H*D) in qkv's dtype (fp32 or bf16).

    The counterpart of the JAX script's ``attention_dma`` (:78). On CUDA
    every route brings each head's strips into shared memory with the
    copy engine (:func:`dma_entry`): bf16 that the copy engine can read,
    with a kend whose K and V fit in shared memory, takes the resident
    strip (``attention_fwd_strip_sm90_kernel``: wgmma, each head's K and V
    resident while its query tiles run; counted in
    ``LAUNCHES["attention_dma_sm90"]`` too); fp32 and longer keys the
    mma.sync / CUDA-core body (``attention_fwd_tma_kernel``), which raises
    where the copy engine cannot read the strips (D times the element
    size, or the row, not a multiple of 16 bytes; qkv not 16-byte
    aligned). Neither gives way to the other after a refusal. On the CPU
    the plain version. No autograd: the output records no gradient, as
    the raw Pallas call has no AD rule.
    """
    return _route("attention_dma", qkv, heads, lk_true, _attention_dma_plain,
                  lambda: dma_entry(qkv, heads, lk_true),
                  " (the copy engine reads rows of D x itemsize bytes, a "
                  "multiple of 16, from a 16-byte-aligned qkv)")


def attention_sect(qkv, *, heads: int, lk_true: int = 0):
    """The same function over the section-major layout (B, L, [Q_all |
    K_all | V_all]): head i's q at i*D, k at H*D + i*D, v at 2*H*D + i*D.

    The counterpart of the JAX script's ``attention_sect`` (:130,
    ``_sect_kernel`` :118). On CUDA (:func:`sect_entry`) bf16 that the
    copy engine can read takes the shared Hopper forward body
    (``attention_fwd_sm90_kernel``, cur's instantiation, through tensor
    maps of the section-major views; counted in
    ``LAUNCHES["attention_sect_sm90"]`` too), the rest the strided
    mma.sync / CUDA-core forward (``self_attention_tmajor``'s body for
    views the copy engine cannot read) at those offsets; on the CPU the
    plain version. No autograd, as :func:`attention_dma`.
    """
    return _route("attention_sect", qkv, heads, lk_true,
                  _attention_sect_plain, lambda: sect_entry(qkv, heads))


def make_inputs(b=B, lp=LP, heads=H, d=D, device=None):
    """The probe's data as the JAX script's ``main`` builds it (:182-193):
    RandomState(0) normals x 0.05 as the fused (B, Lp, H*3*D) bf16 qkv,
    the same values in the section-major layout, and zero-padded to D 128
    (H*3*128). On ``device`` (None: the GPU)."""
    dev = resolve_device(device)
    rs = np.random.RandomState(0)
    host = (rs.randn(b, lp, heads * 3 * d) * 0.05).astype(np.float32)
    fused = torch.from_numpy(host).to(dev).to(torch.bfloat16)
    del host
    per_head = fused.view(b, lp, heads, 3, d)
    pad = fused.new_zeros(b, lp, heads, 3, PAD_D)
    pad[..., :d] = per_head
    return {"fused": fused,
            "sect": per_head.transpose(2, 3).reshape(b, lp, 3 * heads * d),
            "pad128": pad.view(b, lp, heads * 3 * PAD_D)}


def device_line(dev):
    """The device a run is on; on CUDA its name and count and the raw
    ``nvidia-smi --query-gpu=name,power.limit`` line."""
    if dev.type != "cuda":
        return {"device": str(dev)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return {"device": str(dev), "name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi[dev.index or 0]}


def _time_ms(fn, iters, dev):
    """Milliseconds per call of ``fn``: one warm-up call, then ``iters``
    back-to-back calls between two CUDA events (the host clock on the
    CPU)."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters


def _variant_forwards(inputs, heads, lk_true):
    """name -> (the variant's forward of one input, that input, whether
    the forward has an autograd rule)."""
    def tmajor(x):
        return fa.self_attention_tmajor(x, heads=heads, lk_true=lk_true,
                                        scale=1.0)

    return {
        "cur": (tmajor, inputs["fused"], True),
        "sect": (lambda x: attention_sect(x, heads=heads, lk_true=lk_true),
                 inputs["sect"], False),
        "dma": (lambda x: attention_dma(x, heads=heads, lk_true=lk_true),
                inputs["fused"], False),
        "pad128": (tmajor, inputs["pad128"], True),
    }


def run(variants=VARIANTS, *, b=B, lp=LP, heads=H, d=D, lk_true=LK_TRUE,
        iters=20, device=None, inputs=None, emit=None):
    """Time each variant's forward, and its forward + backward where it
    has an autograd rule, on ``device`` (None: the GPU) over ``inputs``
    (None: :func:`make_inputs` at the shape), after holding its first two
    rows against cur's. ``emit`` takes each record (default: print it as a
    JSON line): the device first, then one per variant with ``calls``, the
    forward and backward calls the variant made. A variant that fails
    gives an ``error`` record and the others go on, as in the JAX script.
    Returns the variant records."""
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}: "
                         f"{list(VARIANTS)}")
    dev = resolve_device(device)
    if inputs is None:
        inputs = make_inputs(b, lp, heads, d, dev)
    if emit is None:
        def emit(rec):
            print(json.dumps(rec), flush=True)
    emit(device_line(dev))
    _, lp, total = inputs["fused"].shape
    d = total // (3 * heads)
    forwards = _variant_forwards(inputs, heads, lk_true)
    ref_small, records = None, []
    for name in variants:
        fwd, x, has_grad = forwards[name]
        calls = {"fwd": 0, "bwd": 0}

        def counted(t, fwd=fwd, calls=calls):
            calls["fwd"] += 1
            return fwd(t)

        try:
            small = counted(x)[:2].float()
            if name == "pad128":
                small = small.view(2, lp, heads, PAD_D)[..., :d].reshape(
                    2, lp, heads * d)
            if name == "cur":
                ref_small = small
            elif ref_small is not None:
                err = (small - ref_small).abs().max().item()
                if not err <= CROSS_ATOL:
                    raise AssertionError(f"first two rows differ from cur's "
                                         f"by {err} > {CROSS_ATOL}")
            rec = {"variant": name,
                   "fwd_ms": _time_ms(lambda: counted(x), iters, dev)}
            if has_grad:
                leaf = x.detach().requires_grad_(True)

                def step(leaf=leaf, calls=calls, counted=counted):
                    # jax.grad of sum(fwd(x).astype(f32) ** 2), as the JAX
                    # script times it
                    calls["bwd"] += 1
                    loss = counted(leaf).float().square().sum()
                    return torch.autograd.grad(loss, leaf)[0]

                rec["fwd_bwd_ms"] = _time_ms(step, iters, dev)
            else:
                rec["fwd_bwd"] = NO_GRAD
            rec["calls"] = dict(calls)
        except Exception as e:  # noqa: BLE001 - each variant independent
            rec = {"variant": name, "error": f"{type(e).__name__}: {e}"[:400]}
        emit(rec)
        records.append(rec)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: the plain versions, a "
                         "functional check")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--length", type=int, default=LP)
    ap.add_argument("--heads", type=int, default=H)
    ap.add_argument("--head-dim", type=int, default=D)
    ap.add_argument("--lk-true", type=int, default=LK_TRUE)
    args = ap.parse_args(argv)
    records = run(args.variants.split(","), b=args.batch, lp=args.length,
                  heads=args.heads, d=args.head_dim, lk_true=args.lk_true,
                  iters=args.iters, device=args.device)
    return 1 if any("error" in r for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
