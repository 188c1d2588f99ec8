#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero with no result line:

1. device   - a CUDA GPU must be present; its name and power limit (the
              raw ``nvidia-smi --query-gpu=name,power.limit`` line too).
2. build    - nvcc builds the kernel source of the path and reports
              ptxas' register and shared-memory use.
3. kernels  - each kernel at the main path's shapes, in bf16 and fp32,
              against its plain PyTorch version on the same inputs, with
              the tolerances and their reasons; kernel, plain and library
              (SDPA, a yardstick the port never calls) times by CUDA
              events, and the bound from bytes and operations.
4. tiny     - a tiny fp32 VASTModel on the GPU (kernels) against the same
              weights on the CPU (plain versions): ret%tva features, and
              grouped ITM scores at a shape that takes the head-major
              kernel.
5. slice    - the flagship model (EVA01-g 40 layers + BEATs 12 + BERT 12,
              bf16, random weights from a seeded generator) runs the port's
              ``evaluate_ret`` over 16 synthetic clips in batches of 8:
              features, ITC, the ITM rerank of the top 8, R@k. The kernel
              launch counters are zeroed just before and read just after
              the first of three timed runs (clips/s: the median of the
              three, after a warm-up run); they must read 40 per
              EVA forward, 12 per BEATs forward, and 12 (one per BERT
              layer) per rerank call whose folded query takes the
              head-major kernel. A second run, synchronised at its stage
              edges, gives seconds per stage.
6. profile  - one more evaluate_ret under torch.profiler: device time by
              kernel and the device's idle share of the wall time.

Then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Imports nothing of JAX or of ``vast_tpu``.
"""

import json
import math
import statistics
import subprocess
import sys
import time

SEED = 0
N_CLIPS, BATCH, FRAMES, TEXT_LEN, TOP_K = 16, 8, 8, 40, 8
RUNS = 3                             # timed evaluate_ret runs of the slice
WAVE_SAMPLES = 1024 * 160 + 400      # 1024 fbank frames at 16 kHz

COND_TOKENS = FRAMES * 257 + 256     # EVA tokens of 8 frames + BEATs'
RERANK_CANDS = 4                     # rerank_scores' conds_per_call
# texts per candidate in the rerank: 16 texts x top 8 over 16 candidates
RERANK_TEXTS = N_CLIPS * TOP_K // N_CLIPS

# published dense peaks of the card this script is written for (NVIDIA's
# data sheet, H100 SXM at 700 W): bf16 tensor and fp32 CUDA-core FLOP/s,
# HBM bytes/s. Any other card raises: a bound from another part's peaks
# would be wrong.
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 67e12, 3.35e12)}

# Pallas kernel replaced, and the shapes the main path gives the kernel
KERNELS = {
    "tmajor_attention_fwd": dict(
        replaces="vast_tpu/ops/flash_attention.py:762", layout="tmajor",
        b=BATCH * FRAMES, lq=257, lk=257, h=16, d=88, scale=1.0,
        bias=False),
    "tmajor_attention_fwd_bias": dict(
        replaces="vast_tpu/ops/flash_attention.py:789", layout="tmajor",
        b=BATCH, lq=256, lk=256, h=12, d=64, scale=64 ** -0.5, bias=True),
    # BERT's grouped rerank: the texts of one candidate folded into the
    # query, over that candidate's cross K/V
    "flash_attention_fwd": dict(
        replaces="vast_tpu/ops/flash_attention.py:87", layout="hmajor",
        b=RERANK_CANDS, lq=RERANK_TEXTS * TEXT_LEN, lk=COND_TOKENS, h=12,
        d=64, scale=64 ** -0.5, bias=False),
}
SOURCE = "vast_tpu_torch/csrc/flash_attention.cu"


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def peaks_for(name):
    check(name in PEAKS, f"no published peaks for {name!r}: the bounds "
          f"are defined for {sorted(PEAKS)}")
    return PEAKS[name]


def time_ms(torch, fn, reps=30, warmup=5):
    """Median of ``reps`` single-call CUDA-event timings after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device(torch):
    check(torch.cuda.is_available(), "no CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    bf16_peak, fp32_peak, hbm = peaks_for(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "peaks": {"bf16_flops": bf16_peak, "fp32_flops": fp32_peak,
                    "hbm_bytes_per_s": hbm},
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name


def phase_build():
    from vast_tpu_torch import build

    t0 = time.perf_counter()
    log = build.build("flash_attention")
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "compiled": bool(log), "ptxas": ptxas})


def kernel_case(torch, spec, dtype, gen):
    """Inputs at ``spec``'s shapes and the kernel, plain and library calls
    on them. The library call (SDPA) is a yardstick the port never makes;
    ``as_out`` brings its result to the kernel's layout for its error."""
    import torch.nn.functional as F

    from vast_tpu_torch.ops import flash_attention as fa

    b, lq, lk, h, d = (spec[k] for k in ("b", "lq", "lk", "h", "d"))
    scale = spec["scale"]

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    if spec["layout"] == "tmajor":
        qkv = randn(b, lq, h, 3, d)
        if scale == 1.0:
            qkv[:, :, :, 0] *= d ** -0.5              # q scale baked in
        qkv = qkv.reshape(b, lq, h * 3 * d).to(dtype)
        bias = randn(b, h, lq, lq).to(dtype) if spec["bias"] else None
        q, k, v = qkv.view(b, lq, h, 3, d).permute(3, 0, 2, 1, 4)
        return dict(
            inputs=[qkv] + ([bias] if spec["bias"] else []), v=v,
            run=lambda: fa.self_attention_tmajor(qkv, bias, heads=h,
                                                 scale=scale),
            plain=lambda: fa._self_attention_tmajor_plain(
                qkv, bias, heads=h, scale=scale),
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=scale),
            as_out=lambda o: o.transpose(1, 2).reshape(b, lq, h * d))
    # head-major views of token-major projections, as BERT passes them
    q = randn(b, lq, h, d).to(dtype).transpose(1, 2)
    k = randn(b, lk, h, d).to(dtype).transpose(1, 2)
    v = randn(b, lk, h, d).to(dtype).transpose(1, 2)
    return dict(
        inputs=[q, k, v], v=v,
        run=lambda: fa.flash_attention(q, k, v, scale=scale),
        plain=lambda: fa._flash_attention_plain(q, k, v, scale=scale),
        library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                       scale=scale),
        as_out=lambda o: o)


def phase_kernels(torch, device_name):
    bf16_peak, fp32_peak, hbm = peaks_for(device_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for name, spec in KERNELS.items():
        for dtype in (torch.bfloat16, torch.float32):
            case = kernel_case(torch, spec, dtype, gen)
            out = case["run"]()
            torch.cuda.synchronize()
            ref = case["plain"]().float()
            diff = out.float() - ref
            err = diff.abs().max().item()
            ref_max = ref.abs().max().item()
            rms_rel = (diff.square().mean().sqrt()
                       / ref.square().mean().sqrt()).item()
            if dtype == torch.bfloat16:
                # the plain version computes in fp32 from the same bf16
                # inputs; the kernel also rounds p (<= 1) to bf16 for p.v,
                # <= 2^-8 x max |v| in the output, and both round the
                # output to bf16 once (one ulp, <= 2^-7 x max |out|)
                v_max = case["v"].float().abs().max().item()
                tol = ref_max * 2 ** -7 + v_max * 2 ** -8
                why = ("one bf16 ulp of max |out| (2^-7) plus bf16 rounding "
                       "of p (2^-8 x max |v|)")
                # each of the two roundings errs by at most 2^-8 relative,
                # less in rms; a dropped or misweighted key costs percents
                rms_tol = 2 ** -6
                rms_why = ("four times bf16's unit roundoff 2^-8: output "
                           "and p rounding each add at most 2^-8 relative")
            else:
                tol = 2e-5 * max(ref_max, 1.0)
                why = (f"fp32 with another summation order over "
                       f"<= {spec['lk']} keys")
                rms_tol = 1e-5
                rms_why = "fp32: rounding noise is ~1e-7 relative"
            check(math.isfinite(err) and err <= tol,
                  f"{name} {dtype}: max abs err {err} > {tol}")
            check(math.isfinite(rms_rel) and rms_rel <= rms_tol,
                  f"{name} {dtype}: rms error / rms(ref) {rms_rel} > "
                  f"{rms_tol}")

            lib_err = (case["as_out"](case["library"]()).float()
                       - ref).abs().max().item()
            nbytes = sum(t.numel() * t.element_size()
                         for t in case["inputs"] + [out])
            flops = 4.0 * spec["b"] * spec["h"] * spec["lq"] * spec["lk"] \
                * spec["d"]
            peak = bf16_peak if dtype == torch.bfloat16 else fp32_peak
            t_bytes, t_ops = nbytes / hbm * 1e3, flops / peak * 1e3
            row = {
                "phase": "kernels", "name": name,
                "dtype": str(dtype).replace("torch.", ""),
                "shape": {k: spec[k] for k in ("b", "lq", "lk", "h", "d")}
                | {"bias": "per-sample" if spec["bias"] else None},
                "max_abs_err": err, "max_rel_err": err / ref_max,
                "tolerance": tol, "tolerance_reason": why,
                "rms_rel_err": rms_rel, "rms_tolerance": rms_tol,
                "rms_tolerance_reason": rms_why,
                "library_max_abs_err": lib_err,
                "kernel_ms": time_ms(torch, case["run"]),
                "plain_ms": time_ms(torch, case["plain"]),
                "library_ms": time_ms(torch, case["library"]),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops,
            }
            emit(row)
            results[(name, dtype)] = row
    return results


def tiny_config():
    from vast_tpu_torch.models.beats import BeatsConfig
    from vast_tpu_torch.models.bert import BertConfig
    from vast_tpu_torch.models.eva_vit import EvaVitConfig
    from vast_tpu_torch.models.vast import VASTConfig

    return VASTConfig(
        contra_dim=16, max_vision_sample_num=2, vision_resolution=32,
        audio_melbins=16, audio_target_length=64,
        vision_cfg=EvaVitConfig(image_size=32, patch_size=8, width=32,
                                layers=2, head_width=8, mlp_ratio=2.0),
        audio_cfg=BeatsConfig(input_patch_size=8, embed_dim=24,
                              encoder_embed_dim=32, encoder_layers=2,
                              encoder_ffn_embed_dim=64,
                              encoder_attention_heads=4, conv_pos=16,
                              conv_pos_groups=4, num_buckets=32,
                              max_distance=64),
        bert_cfg=BertConfig(vocab_size=170, hidden_size=32,
                            num_hidden_layers=2, num_attention_heads=4,
                            intermediate_size=64,
                            max_position_embeddings=96))


def phase_tiny(torch, np):
    """Kernels inside the model on the GPU vs plain versions on the CPU."""
    from vast_tpu_torch.convert.from_jax import init_random_
    from vast_tpu_torch.models.vast import VASTModel
    from vast_tpu_torch.ops import flash_attention as fa

    cfg = tiny_config()
    cpu = init_random_(VASTModel(cfg, device="cpu"),
                       torch.Generator().manual_seed(SEED))
    gpu = VASTModel(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(SEED)
    batch = {"vision_frames": rs.randint(0, 256, (3, 2, 40, 48, 3),
                                         ).astype(np.uint8),
             "audio_waveforms": (rs.randn(3, 63 * 160 + 400) * 3000
                                 ).astype(np.float32),
             "caption_tokens": rs.randint(106, 170, (3, 12)).astype(np.int32),
             "caption_attention_mask": np.ones((3, 12), np.int32)}
    outs = []
    with torch.inference_mode():
        for model in (cpu, gpu):
            tb = {k: torch.from_numpy(v).to(model.device)
                  for k, v in batch.items()}
            outs.append(model(tb, "ret%tva"))
    row = {"phase": "tiny", "tolerance_rel": 1e-4,
           "tolerance_reason": "fp32 on both sides (TF32 off), other "
                               "summation orders through 2+2+2 layers"}
    for key in ("feat_t", "feat_cond_tva", "condition_feats_tva"):
        ref, got = outs[0][key], outs[1][key].cpu()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        row[key] = rel
        check(math.isfinite(rel) and rel <= 1e-4,
              f"tiny {key}: relative error {rel}")

    # 8 texts of 12 tokens per candidate over 200 condition tokens: the
    # folded query (96 rows) takes the head-major kernel in every layer
    groups, texts, cond_len = 2, 8, 200
    cond = rs.randn(groups, cond_len, 32).astype(np.float32)
    ids = rs.randint(106, 170, (groups * texts, 12)).astype(np.int32)
    scores = []
    before = fa.LAUNCHES["flash_attention_fwd"]
    with torch.inference_mode():
        for model in (cpu, gpu):
            scores.append(model.compute_slice_scores_grouped(
                torch.from_numpy(cond).to(model.device),
                torch.from_numpy(ids).to(model.device),
                torch.ones(ids.shape, dtype=torch.int32,
                           device=model.device)).cpu())
    launched = fa.LAUNCHES["flash_attention_fwd"] - before
    check(launched == cfg.bert_cfg.num_hidden_layers,
          f"grouped scores launched the head-major kernel {launched} times")
    rel = ((scores[1] - scores[0]).abs().max()
           / scores[0].abs().max()).item()
    row["grouped_itm_scores"] = rel
    check(math.isfinite(rel) and rel <= 1e-4,
          f"tiny grouped scores: relative error {rel}")
    emit(row)


def synthetic_batches(np):
    rs = np.random.RandomState(SEED)
    batches = []
    for s in range(0, N_CLIPS, BATCH):
        ids = [f"clip{i:03d}" for i in range(s, s + BATCH)]
        batches.append({
            "vision_frames": rs.randint(0, 256, (BATCH, FRAMES, 224, 224, 3),
                                        ).astype(np.uint8),
            "audio_waveforms": (rs.randn(BATCH, WAVE_SAMPLES) * 2 ** 15
                                ).astype(np.float32),
            "caption_tokens": rs.randint(1000, 20000, (BATCH, TEXT_LEN)
                                         ).astype(np.int32),
            "caption_attention_mask": np.ones((BATCH, TEXT_LEN), np.int32),
            "ids": ids, "ids_txt": ids,
        })
    return batches


def phase_slice(torch, np):
    from vast_tpu_torch.convert.from_jax import init_random_
    from vast_tpu_torch.evaluation.evaluation_mm import evaluate_ret
    from vast_tpu_torch.models.vast import VASTConfig, VASTModel
    from vast_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg = VASTConfig(dtype=torch.bfloat16)
    model = VASTModel(cfg)                       # device None -> the GPU
    init_random_(model, torch.Generator(device="cuda").manual_seed(SEED))
    model.eval()
    batches = synthetic_batches(np)
    run_cfg = {"itm_rerank_num": TOP_K}
    setup_s = time.perf_counter() - t0

    def timed_run():
        t0 = time.perf_counter()
        log = evaluate_ret(model, ["tva"], batches, run_cfg,
                           vision_transforms="crop_flip")
        torch.cuda.synchronize()
        return log, time.perf_counter() - t0

    timed_run()                 # first-call costs at every shape of the run
    torch.cuda.reset_peak_memory_stats()
    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    log, wall = timed_run()
    launches = dict(fa.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()
    walls = [wall] + [timed_run()[1] for _ in range(RUNS - 1)]

    n_batches = len(batches)
    want = {"tmajor_attention_fwd": 40 * n_batches,
            "tmajor_attention_fwd_bias": 12 * n_batches}
    got = {k: launches[k] for k in want}
    check(got == want, f"launches {got} != {want} (40 per EVA forward, 12 "
          f"per BEATs forward, none from BERT)")
    # 16 texts x top 8 = 128 pairs over at most 16 candidates, so some
    # candidate has >= 8 texts and its rerank call a folded query of
    # >= 320 rows over 2312 keys, off the plain route: at least one call
    # launches the head-major kernel, once per BERT layer
    n_flash = launches["flash_attention_fwd"]
    check(n_flash >= 12 and n_flash % 12 == 0,
          f"head-major kernel launched {n_flash} times (12 per rerank call "
          f"with >= 8 texts on a candidate, at least one such call)")

    timings = {}                     # stage times, from a separate run
    evaluate_ret(model, ["tva"], batches, run_cfg,
                 vision_transforms="crop_flip", timings=timings)
    for part in log.values():
        for key, val in part.items():
            if key.endswith(("_r1", "_ravg")):
                check(0.0 <= val <= 100.0, f"{key} = {val}")

    # the outputs themselves: finite, on the GPU, of the expected shapes
    with torch.inference_mode():
        tb = {k: torch.from_numpy(v).cuda() for k, v in batches[0].items()
              if isinstance(v, np.ndarray)}
        out = model(tb, "ret%tva")
    shapes = {"feat_t": (BATCH, 512), "feat_cond_tva": (BATCH, 512),
              "condition_feats_tva": (BATCH, COND_TOKENS, 768)}
    for key, shape in shapes.items():
        t = out[key]
        check(t.is_cuda and tuple(t.shape) == shape
              and bool(torch.isfinite(t.float()).all()),
              f"{key}: {t.device} {tuple(t.shape)} finite="
              f"{bool(torch.isfinite(t.float()).all())}")
    emit({"phase": "slice", "clips": N_CLIPS, "batch": BATCH,
          "frames": FRAMES, "top_k": TOP_K, "dtype": "bfloat16",
          "clips_per_s": N_CLIPS / statistics.median(walls),
          "clips_per_s_runs": [N_CLIPS / w for w in walls], "wall_s": walls,
          "stage_s": timings, "setup_s": setup_s,
          "max_memory_allocated": peak_mem, "launches": launches,
          "metrics": log})
    return launches, model, batches, run_cfg


def phase_profile(torch, model, batches, run_cfg):
    """Device time by kernel over one more evaluate_ret of the 16 clips
    (torch.profiler, CUPTI), and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    from vast_tpu_torch.evaluation.evaluation_mm import evaluate_ret

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate_ret(model, ["tva"], batches, run_cfg,
                     vision_transforms="crop_flip")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    emit({"phase": "profile", "wall_s": wall,
          "device_busy_s": busy_us / 1e6,
          "device_idle_share": 1.0 - busy_us / 1e6 / wall,
          "top_kernels": [{"name": e.key[:120], "count": e.count,
                           "device_ms": e.self_device_time_total / 1e3}
                          for e in top]})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    import vast_tpu_torch  # noqa: F401  (fails at once outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device(torch)
    phase_build()
    results = phase_kernels(torch, name)
    phase_tiny(torch, np)
    launches, model, batches, run_cfg = phase_slice(torch, np)
    phase_profile(torch, model, batches, run_cfg)
    kernels = []
    for kname, k in KERNELS.items():
        r = results[(kname, torch.bfloat16)]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": k["replaces"], "launches": launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
