"""Training cells of a configuration with a Video Swin vision tower.

The train runner's (``runners/train.py``) set-up, pool, window and
check, with what differs for this tower: the FLOPs and the attention
launches of a step come from ``counts/window_attention.py``, the
reference is ``reference/videoswin_ref.py``'s, and the faults that the
limits are calibrated against are the half batch and two of this
model's own, the shifted blocks' region mask dropped or their roll
undone (the vision tower trains at ``learning_rate``, so the clip_lr
fault has nothing to act on).
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import harness, weights
from benchmark.counts import attention as attn_counts
from benchmark.counts import window_attention
from benchmark.reference import train_ref
from benchmark.runners.train import _half, checked_setup, reference_batches
from benchmark.trace import traced


def run(ctx) -> dict:
    from vast_tpu_torch.ops import flash_attention as fa

    device, tr, cfg = ctx.device, ctx.traffic, ctx.cfg
    one_step, holder, pool, got = checked_setup(ctx)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - ctx.t_start

    i, times, totals = tr["checked_steps"], [], []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        m = one_step(i)
        times.append(time.perf_counter() - ts)
        totals.append(m["total_loss"])
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    failed = sum(not math.isfinite(float(x)) for x in totals)
    dev = harness.device_info(device)
    clips = tr["batch_size"] * len(times)
    harness.log(f"window: {len(times)} steps, {window_s:.3f} s, "
                f"{clips / window_s:.4f} clips/s")

    obs = {"kind": "train", "step_s": times, "window_s": window_s,
           "steps": len(times), "unit_s": window_s / len(times),
           "flops_per_step": window_attention.train_step(cfg, tr),
           "device_name": dev["kind"]}
    if ctx.trace:
        before = dict(fa.LAUNCHES)
        n = tr["profiled_steps"]
        with traced(device) as tw:
            for _ in range(n):
                one_step(i)
                i += 1
        launched = sum(fa.LAUNCHES[k] - before[k]
                       for k in attn_counts.LAUNCH_KEYS)
        per_step = window_attention.step_launches(cfg, tr["batch_size"],
                                                  tr["frames"])
        obs["trace"], obs["profiled"] = tw["summary"], n
        obs["window_launches"] = per_step * n
        obs["attention_launches_counted"] = launched
        harness.log(f"traced: {n} steps, {tw['summary']['wall_s']:.3f} s, "
                    f"{n * tr['batch_size'] / tw['summary']['wall_s']:.4f} "
                    f"clips/s under the profiler; attention launches "
                    f"{launched} counted, {len(per_step) * n} from shapes")

    holder.clear()
    del one_step
    harness.free(device)
    t_ref = time.perf_counter()
    ref = reference_readings(ctx, pool, device)
    harness.log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    numbers = train_ref.compare(got, ref)
    for k, v in train_ref.worst_by_group(got, ref).items():
        harness.log(f"worst {k} (not compared): {v!r}")
    checks = {k: {"value": v, "limit": ctx.limits[k]}
              for k, v in numbers.items()}
    return {"attempted": len(times), "failed": failed, "device": dev,
            "e2e": {"train_clips_per_s": clips / window_s,
                    "setup_s": setup_s},
            "obs": obs, "checks": checks}


def reference_readings(ctx, pool, device, fp8: bool = False,
                       half_batch: bool = False, shift_mask: bool = True,
                       roll: bool = True) -> dict:
    """The reference's readings of the checked steps (``fp8``: the
    control; ``half_batch``: the fault of a step that leaves out half of
    the batch; ``shift_mask`` False: the fault of shifted blocks without
    their region mask; ``roll`` False: of shifted blocks that do not roll
    the clip)."""
    from benchmark.reference.videoswin_ref import VastVideoSwinRef

    harness.reference_backends(device)
    cfg, tr = ctx.cfg, ctx.traffic
    ref = VastVideoSwinRef(cfg, fp8, shift_mask, roll).to(device)
    weights.init_weights(ref, ctx.seed, device)
    batches, gens = reference_batches(ctx, pool, device)
    if half_batch:
        batches = [_half(b) for b in batches]
    out = train_ref.run_reference(ref, batches, gens, cfg["run_cfg"],
                                  cfg["vision_encoder_type"],
                                  tr["num_train_steps"])
    del ref
    harness.free(device)
    return out


VARIANTS = (("control_fp8", {"fp8": True}),
            ("fault_half_batch", {"half_batch": True}),
            ("fault_no_shift_mask", {"shift_mask": False}),
            ("fault_no_roll", {"roll": False}))


def calibrate(ctx, controls: bool):
    """The readings that the limits are set from (``run.py
    --calibrate``), as ``runners/train.py``'s with this tower's
    reference and faults."""
    one_step, holder, pool, got = checked_setup(ctx)
    holder.clear()
    del one_step
    harness.free(ctx.device)
    ref = reference_readings(ctx, pool, ctx.device)
    yield {"kind": "program", **train_ref.compare(got, ref),
           **train_ref.worst_by_group(got, ref)}
    for name, kw in VARIANTS if controls else ():
        other = reference_readings(ctx, pool, ctx.device, **kw)
        yield {"kind": name, **train_ref.compare(other, ref),
               **train_ref.worst_by_group(other, ref)}
