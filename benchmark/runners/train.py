"""Training cells: the program's train step over a pool of batches.

Set-up builds the step (``vast_tpu_torch.training.step.make_train_step``)
with its model and optimizer state from the seed and drives it through
the mix's checked steps, which warm up every shape and whose losses,
first gradients and parameter changes the reference later follows. The
window then runs the same step on, batch after batch from a pool of
distinct batches in pinned host memory, each copied to the card as a
loader hands it over, each step synchronised as ``pipeline.train``
does. The rate is all the window's clips over all its time.

With ``--trace 1`` a few more steps run under the profiler after the
window.
"""

from __future__ import annotations

import math
import time

import torch
from torch.profiler import record_function

from benchmark import generator, harness, weights
from benchmark.counts import attention as attn_counts
from benchmark.counts import flops
from benchmark.reference import train_ref
from benchmark.trace import traced

STEP_STREAM = 1000          # generator streams of the step generators


def make_pool(ctx, device, pin: bool) -> list:
    """The mix's distinct batches, drawn on the card from the seed and
    kept in (pinned) host memory."""
    tr, cfg = ctx.traffic, ctx.cfg
    g = generator.generator(ctx.seed, 0, device)
    vocab = cfg["bert"]["vocab_size"]
    pool = []
    for _ in range(tr["pool_batches"]):
        b = generator.clip_batch(tr["batch_size"], tr, cfg, vocab, g, device)
        neg_c, neg_t = generator.negatives(tr["batch_size"], g, device)
        b |= {"itm_neg_cond_idx": neg_c, "itm_neg_text_idx": neg_t}
        host = {k: v.cpu() for k, v in b.items()}
        if pin:
            host = {k: v.pin_memory() for k, v in host.items()}
        pool.append(host)
    return pool


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator a step draws its randomness from."""
    return generator.generator(seed, STEP_STREAM + step, "cpu")


def build(ctx, device):
    from vast_tpu_torch.training.optimizer import build_optimizer
    from vast_tpu_torch.training.step import (create_train_state,
                                              make_train_step)

    cfg, tr = ctx.cfg, ctx.traffic
    model = harness.build_program(cfg, device, torch.bfloat16, torch.float32)
    weights.init_weights(model, ctx.seed, device)
    opt, _ = build_optimizer(
        model, cfg["run_cfg"],
        {"vision_encoder_type": cfg["vision_encoder_type"]},
        tr["num_train_steps"])
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, tr["task"],
                           vision_transforms=tr["vision_transforms"])
    return model, opt, state, step


def checked_setup(ctx):
    """The program's step built from the seed and driven through the
    mix's checked steps; returns the step's runner and the readings the
    reference follows."""
    device, tr = ctx.device, ctx.traffic
    model, opt, state, step = build(ctx, device)
    pool = make_pool(ctx, device, device.type == "cuda")
    holder = {"state": state, "model": model, "opt": opt}

    def one_step(i: int):
        host = pool[i % len(pool)]
        with record_function("bench.h2d"):
            batch = {k: v.to(device, non_blocking=True)
                     for k, v in host.items()}
        with record_function("bench.step"):
            holder["state"], m = step(holder["state"], batch,
                                      step_generator(ctx.seed, i))
        harness.sync(device)
        return m

    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = {"losses": []}
    for i in range(tr["checked_steps"]):
        if i == 0:
            keep_condition(model, got)
        m = one_step(i)
        if i == 0:
            del model.get_feature
        got["losses"].append({k: float(m[k]) for k in ("loss_itc",
                                                       "loss_itm")})
        if i == 0:
            # the first gradient as the optimizer took it: mu = (1 - b1) g
            got["grad_norms"] = train_ref.leaf_norms(
                {n: mu / (1.0 - opt.b1) for n, mu in opt.mu.items()})
    got["change_norms"] = train_ref.leaf_norms(
        {n: p.detach() - start[n] for n, p in model.named_parameters()})
    del start, model, opt, state
    harness.free(device)
    return one_step, holder, pool, got


def keep_condition(model, got: dict) -> None:
    """Keep a copy of the condition sequence that the next step's forward
    computes (the model's feature cache, ``get_feature``): the one of
    the subtask's modalities together, e.g. ``condition_feats_vas``."""
    feature = model.get_feature
    prefix = "condition_feats_"

    def get_feature(batch, key, cache, generator=None):
        out = feature(batch, key, cache, generator)
        if key.startswith(prefix) and len(key) - len(prefix) > 1:
            got["cond"] = out.detach().clone()
        return out

    model.get_feature = get_feature


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
           "flops_per_step": flops.train_step(cfg, tr),
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
        per_step = attn_counts.tower_launches(cfg, tr["batch_size"],
                                              tr["frames"], True)
        obs["trace"], obs["profiled"] = tw["summary"], n
        obs["attention_launches"] = per_step * n
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


def reference_batches(ctx, pool, device) -> tuple:
    n = ctx.traffic["checked_steps"]
    batches = [{k: v.to(device) for k, v in pool[i % len(pool)].items()}
               for i in range(n)]
    gens = [step_generator(ctx.seed, i) for i in range(n)]
    return batches, gens


def reference_readings(ctx, pool, device, fp8: bool = False,
                       half_batch: bool = False,
                       clip_lr_scale: float = 1.0) -> dict:
    """The reference's readings of the checked steps (``fp8``: the
    control; ``half_batch``: the fault of a step that leaves out half of
    the batch and takes the mean over the rest; ``clip_lr_scale``: the
    fault of a wrong learning rate for the vision tower alone)."""
    from benchmark.reference.vast_ref import VastRef

    harness.reference_backends(device)
    cfg, tr = ctx.cfg, ctx.traffic
    run_cfg = dict(cfg["run_cfg"])
    run_cfg["clip_lr"] *= clip_lr_scale
    ref = VastRef(cfg, fp8).to(device)
    weights.init_weights(ref, ctx.seed, device)
    batches, gens = reference_batches(ctx, pool, device)
    if half_batch:
        batches = [_half(b) for b in batches]
    out = train_ref.run_reference(ref, batches, gens, run_cfg,
                                  cfg["vision_encoder_type"],
                                  tr["num_train_steps"])
    del ref
    harness.free(device)
    return out


def _half(batch: dict) -> dict:
    n = batch["caption_tokens"].shape[0] // 2
    out = {k: v[:n] for k, v in batch.items() if not k.startswith("itm_")}
    for k in ("itm_neg_cond_idx", "itm_neg_text_idx"):
        out[k] = batch[k][:, :n] % n
    return out


VARIANTS = (("control_fp8", {"fp8": True}),
            ("fault_half_batch", {"half_batch": True}),
            ("fault_clip_lr_x10", {"clip_lr_scale": 10.0}))


def calibrate(ctx, controls: bool):
    """The readings that the limits are set from (``run.py
    --calibrate``): the program's numbers on this seed, after the same
    set-up as a run's and with no window, and with ``controls`` also
    those of the control and of each fault, each the reference put in
    the program's place."""
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
