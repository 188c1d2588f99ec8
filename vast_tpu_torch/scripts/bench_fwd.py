"""The Hopper forward of this checkout against another version's, on the card.

The head-major Hopper entry (``vast_flash_attention_fwd_sm90``) runs the
forward body that the token-major entry shares (csrc/flash_attention.cu,
"The forward for Hopper"), so a change to that body for the token-major
shapes must leave the head-major paths no slower. This script builds
``--parent FILE`` (another version of csrc/flash_attention.cu, such as a
parent commit's) beside the checkout's source (the two builds in
parallel) and, at each head-major path's shape, calls both builds' entry
on the same inputs in turns (parent, change, change, parent, ``--rounds``
times): CUDA events around back-to-back calls (chip_smoke.py's
``time_ms``) and the profiler's device ms per launch (chip_smoke.py's
``device_ms``), each taken in those turns. It prints one JSON line a
shape: every reading, the medians, the change's median device time over
the parent's, and the largest difference between the two outputs.
Shapes: CLIP-L/14-336's 64 x 16 x 577^2 x 64 (packed), AST's 8 x 12 x
257^2 x 64, and the flagship and CLIP + AST reranks (4 x 12, 320 x 2312
and 640 x 4873), bf16.

    python3 vast_tpu_torch/scripts/bench_fwd.py \
        --parent PARENT/vast_tpu_torch/csrc/flash_attention.cu [--rounds 3]

The device's line (chip_smoke.py's, with ``nvidia-smi``'s name and power
limit) comes first. It needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 0
SYMBOL = "vast_flash_attention_fwd_sm90"
# the head-major paths' shapes: (B, H, Lq, Lk, D, scale, views)
SHAPES = {
    "clip_l14_336": (64, 16, 577, 577, 64, 0.125, "packed"),
    "ast": (8, 12, 257, 257, 64, 0.125, "token_major"),
    "flagship_rerank": (4, 12, 320, 2312, 64, 0.125, "token_major"),
    "clip_ast_rerank": (4, 12, 640, 4873, 64, 0.125, "token_major")}


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_source(build, path):
    """``path`` (a version of csrc/flash_attention.cu) built with the
    package's flags into the build directory; nvcc's output."""
    import subprocess

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    target = os.path.join(build.BUILD_DIR, "flash_attention-parent.so")
    proc = subprocess.run([build._nvcc(), *build._flags(()), "-o", target,
                           path], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}")
    return target


def hmajor_args(torch, fa, shape, gen):
    """The head-major Hopper entry's arguments at a SHAPES shape (bf16
    views as the path makes them, the output allocated once), the output
    and the inputs."""
    b, h, lq, lk, d, scale, views = shape

    def randn(*s):
        return torch.randn(*s, device="cuda", generator=gen).to(
            torch.bfloat16)

    if views == "packed":
        q, k, v = (t.transpose(1, 2) for t in
                   randn(b, lq, 3, h, d).unbind(2))
    else:
        q, k, v = (randn(b, n, h, d).transpose(1, 2) for n in (lq, lk, lk))
    out = fa._empty_like_layout(q)
    return fa._flash_fwd_args(q, k, v, None, out, None, scale, 0), out, (
        q, k, v)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="another version of csrc/flash_attention.cu whose "
                         "head-major Hopper entry is measured beside this "
                         "one's")
    ap.add_argument("--rounds", type=int, default=3,
                    help="rounds of turns (parent, change, change, parent)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("bench_fwd: no CUDA GPU; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vast_tpu_torch import build
    from vast_tpu_torch.ops import flash_attention as fa

    cs.phase_device(torch)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        parent = pool.submit(build_source, build,
                             os.path.abspath(args.parent))
        log = build.build("flash_attention")
        libs = {"parent": ctypes.CDLL(parent.result()),
                "change": build.load("flash_attention")}
    emit({"builds": list(libs), "seconds": time.perf_counter() - t0,
          "spills": [ln.strip() for ln in log.splitlines() if "spill" in ln
                     and " 0 bytes spill stores" not in ln]})
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    turns = ("parent", "change", "change", "parent") * args.rounds
    for name, shape in SHAPES.items():
        cargs, out, _keep = hmajor_args(torch, fa, shape, gen)
        fns, outs = {}, {}
        for key, lib in libs.items():
            fn = getattr(lib, SYMBOL)
            fn.argtypes, fn.restype = fa._ARGTYPES[SYMBOL], ctypes.c_int
            fns[key] = lambda fn=fn: fn(*cargs)
            err = fns[key]()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{key} {SYMBOL}: CUDA error {err}")
            outs[key] = out.clone()
        ms = {k: [] for k in fns}
        dev = {k: [] for k in fns}
        for k in turns:
            ms[k].append(cs.time_ms(torch, fns[k]))
        for k in turns:
            dev[k].append(cs.device_ms(torch, fns[k]))
        med = {k: statistics.median(v) for k, v in ms.items()}
        dev_med = {k: None if None in v else statistics.median(v)
                   for k, v in dev.items()}
        emit({"parent_ab": name, "shape": dict(zip(
                  ("b", "h", "lq", "lk", "d", "scale", "views"), shape)),
              "turns": list(turns), "ms_in_turns": ms,
              "device_ms_in_turns": dev, "ms_median": med,
              "device_ms_median": dev_med,
              "change_over_parent": med["change"] / med["parent"],
              "change_over_parent_device": None if None in dev_med.values()
              else dev_med["change"] / dev_med["parent"],
              "max_abs_diff_from_parent":
                  (outs["change"].float() - outs["parent"].float()).abs()
                  .max().item()})
        del out, outs, _keep
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
