"""The attention backward's costs around its kernels, on the card.

Three measurements, each printing JSON lines after the device's
(``nvidia-smi``'s name and power limit first, as chip_smoke.py prints
them):

  host  - the host's time to issue one bf16 backward at each path shape
          (EVA01-g 64 x 257 x 16 x 88; BEATs 8 x 256 x 12 x 64 with its
          bias and ds; CLIP-L/14-336 64 x 577 x 16 x 64, packed; AST 8 x
          257 x 12 x 64): through the public wrapper, and through each C
          entry the checkout has, called alone on outputs allocated once.
          The queue is drained before each call, so a call returns once
          its launches are queued: the median, mean and 90th percentile
          of ``--calls`` calls, microseconds.
  kd    - EVA01-g's backward on the Hopper body as built (D 88: the
          products over D issue 6 k-steps, 96 deep) against a build with
          ``-DVAST_BWD_KD96=0`` (8 k-steps, 128 deep), in turns (cut,
          full, full, cut; CUDA events around back-to-back calls) with the
          profiler's device ms per launch of the dQ and dK/dV kernels and
          the largest difference between the two builds' gradients.
  train - chip_smoke.py's two train phases (the flagship ret%tva step and
          the CLIP-L/14-336 + AST step, each timed in three blocks of five
          steps and profiled once) from the checkout, and over each phase
          (17 steps) the host's seconds and calls in the two backward
          wrappers, in each C entry and in the garbage collector.

``--tree DIR`` imports vast_tpu_torch and chip_smoke.py from another
checkout (a parent commit unpacked beside this one), so that both are
measured within one call on one card; ``kd`` needs this checkout's build.

    python3 vast_tpu_torch/scripts/bench_bwd.py host kd
    python3 vast_tpu_torch/scripts/bench_bwd.py --tree ../parent host train
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 0
# (name, layout, B, L, H, D, scale, bias)
SHAPES = (("eva01g", "tmajor", 64, 257, 16, 88, 1.0, False),
          ("beats", "tmajor", 8, 256, 12, 64, 64 ** -0.5, True),
          ("clip_l14_336", "packed", 64, 577, 16, 64, 0.125, False),
          ("ast", "token_major", 8, 257, 12, 64, 0.125, False))
KD96_OFF = ("VAST_BWD_KD96=0",)


def emit(obj):
    print(json.dumps(obj), flush=True)


def inputs(torch, fa, shape, gen):
    """The backward's operands at ``shape`` as the path lays them out, bf16:
    token-major (qkv, o, do, bias), or head-major (q, k, v, o, lse, do) as
    views of CLIP's packed projection or of AST's token-major ones."""
    _, layout, b, l, h, d, scale, has_bias = shape

    def randn(*s):
        return torch.randn(*s, device="cuda", generator=gen).to(
            torch.bfloat16)

    if layout == "tmajor":
        qkv = randn(b, l, h * 3 * d)
        bias = randn(b, h, l, l) if has_bias else None
        o = fa._self_attention_tmajor_plain(qkv, bias, heads=h, scale=scale)
        return qkv, o, randn(b, l, h * d), bias
    if layout == "packed":
        q, k, v = (t.transpose(1, 2) for t in randn(b, l, 3, h, d).unbind(2))
    else:
        q, k, v = (randn(b, l, h, d).transpose(1, 2) for _ in range(3))
    o, lse = fa._flash_attention_plain(q, k, v, scale=scale, return_lse=True)
    return q, k, v, o, lse, randn(b, l, h, d).transpose(1, 2)


def entry_call(torch, fa, fn, shape, ops):
    """A call of the C entry ``fn`` on ``ops`` with its outputs and scratch
    allocated once (the entry's own host time), and those outputs (dqkv
    first, or dq). Checks that it launches."""
    _, layout, b, l, h, d, scale, _ = shape
    if layout == "tmajor":
        qkv, o, do, bias = ops
        outs = (torch.empty_like(qkv),
                None if bias is None else torch.empty_like(bias))
        stat = [torch.empty(b, h, l, device="cuda") for _ in range(2)]
        args = [fa._ptr(t) for t in (qkv, o, do, bias, *outs, *stat)] + [
            fa._DTYPE_CODES[qkv.dtype], b, l, h, d, l,
            0 if bias is None else bias.stride(0), float(scale),
            fa._stream()]
    else:
        q, k, v, o, lse, do = ops
        outs = [torch.empty(b, h, l, d, device="cuda", dtype=q.dtype)
                for _ in range(3)]
        delta = torch.empty_like(lse)
        args = [fa._ptr(t) for t in (q, k, v, o, do, None, *outs, None,
                                     lse, delta)] + [
            fa._DTYPE_CODES[q.dtype], b, h, l, l, d, l,
            fa._strides(q, k, v, o, do, *outs, None, None), float(scale),
            fa._stream()]
    err = fn(*args)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"{shape[0]}: the entry returned CUDA error {err}")
    return (lambda: fn(*args)), outs


def host_us(torch, fn, calls):
    """Host microseconds of one call of ``fn`` issued on an empty queue."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    times.sort()
    return {"median_us": statistics.median(times),
            "mean_us": statistics.fmean(times),
            "p90_us": times[int(0.9 * (len(times) - 1))]}


def mode_host(torch, fa, calls):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for shape in SHAPES:
        name, layout, b, l, h, d, scale, _ = shape
        ops = inputs(torch, fa, shape, gen)
        if layout == "tmajor":
            qkv, o, do, bias = ops
            fns = {"wrapper": lambda: fa.self_attention_tmajor_bwd(
                qkv, o, do, bias, heads=h, scale=scale)}
            symbols = ("vast_tmajor_attention_bwd_sm90",
                       "vast_tmajor_attention_bwd")
        else:
            q, k, v, o, lse, do = ops
            fns = {"wrapper": lambda: fa.flash_attention_bwd(
                q, k, v, None, o, lse, do, scale=scale)}
            symbols = ("vast_flash_attention_bwd_sm90",
                       "vast_flash_attention_bwd")
        for sym in symbols:
            if sym in fa._ARGTYPES:
                fns[sym] = entry_call(torch, fa, fa._kernel(sym), shape,
                                      ops)[0]
        before = dict(fa.LAUNCHES)
        emit({"mode": "host", "at": name, "calls": calls,
              "host": {k: host_us(torch, fn, calls) for k, fn in fns.items()},
              "wrapper_launches": {k: n - before[k]
                                   for k, n in fa.LAUNCHES.items()
                                   if n != before[k]}})
        del ops, fns
        torch.cuda.empty_cache()


def mode_kd(torch, fa, cs):
    from vast_tpu_torch import build

    sym = "vast_tmajor_attention_bwd_sm90"
    libs = {"kd96": build.load("flash_attention"),
            "kd128": build.load("flash_attention", KD96_OFF)}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shape = SHAPES[0]
    ops = inputs(torch, fa, shape, gen)
    fns, dqkv = {}, {}
    for key, lib in libs.items():
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = fa._ARGTYPES[sym], ctypes.c_int
        fns[key], outs = entry_call(torch, fa, fn, shape, ops)
        dqkv[key] = outs[0]
    turns = {key: [] for key in fns}
    for key in ("kd96", "kd128", "kd128", "kd96"):
        turns[key].append(cs.time_ms(torch, fns[key]))
    emit({"mode": "kd", "at": shape[0],
          "shape": dict(zip(("b", "l", "h", "d"), shape[2:6])),
          "ms_in_turns": turns,
          "device_ms": {key: cs.bwd_device_ms(torch, fn)
                        for key, fn in fns.items()},
          "max_abs_diff": (dqkv["kd96"].float() - dqkv["kd128"].float()
                           ).abs().max().item()})


class HostTally:
    """Host seconds and calls, while active, of the backward wrappers, of
    every C entry (each one ``fa._kernel`` hands out) and of the garbage
    collector by generation."""

    WRAPPERS = ("self_attention_tmajor_bwd", "flash_attention_bwd")

    def __init__(self, fa):
        self.fa, self.tally, self.gc_t0 = fa, {}, 0.0

    def add(self, name, seconds):
        c = self.tally.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += seconds

    def timed(self, name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(name, time.perf_counter() - t0)
        return run

    def on_gc(self, phase, info):
        if phase == "start":
            self.gc_t0 = time.perf_counter()
        else:
            self.add(f"gc_gen{info['generation']}",
                     time.perf_counter() - self.gc_t0)

    def __enter__(self):
        self.saved = {n: getattr(self.fa, n)
                      for n in self.WRAPPERS + ("_kernel",)}
        for n in self.WRAPPERS:
            setattr(self.fa, n, self.timed(n, self.saved[n]))
        kernel = self.saved["_kernel"]
        self.fa._kernel = lambda symbol: self.timed(symbol, kernel(symbol))
        gc.callbacks.append(self.on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self.on_gc)
        for n, fn in self.saved.items():
            setattr(self.fa, n, fn)

    def summary(self):
        return {n: {"calls": c, "host_s": t, "us_per_call": t / c * 1e6}
                for n, (c, t) in sorted(self.tally.items())}


def mode_train(torch, np, fa, cs):
    for phase in (cs.phase_train, cs.phase_train_clip_ast):
        with HostTally(fa) as tally:
            phase(torch, np)
        emit({"mode": "train_host", "phase": phase.__name__,
              "host": tally.summary()})
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modes", nargs="+", choices=("host", "kd", "train"))
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose vast_tpu_torch and "
                         "chip_smoke.py are measured (this one by default)")
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_bwd: no CUDA GPU; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vast_tpu_torch.ops import flash_attention as fa

    for mod in (cs, fa):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, "
                               f"not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_device(torch)
    cs.phase_build()
    emit({"tree": tree, "modes": args.modes})
    for mode in args.modes:
        if mode == "host":
            mode_host(torch, fa, args.calls)
        elif mode == "kd":
            mode_kd(torch, fa, cs)
        else:
            mode_train(torch, np, fa, cs)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
