#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero with no result line:

1. device   - a CUDA GPU must be present; its name and power limit (the
              raw ``nvidia-smi --query-gpu=name,power.limit`` line too).
2. build    - nvcc builds the kernel source of the path and reports
              ptxas' register and shared-memory use.
3. kernels  - each kernel at the main paths' shapes, in bf16 and fp32,
              against its plain PyTorch version on the same inputs, with
              the tolerances and their reasons; kernel, plain and library
              (SDPA, forward or backward, a yardstick the port never
              calls) times by CUDA events, and the bound from bytes and
              operations. The backward kernels' errors are given for dq,
              dk, dv and dbias separately, the lse forward's for o and
              lse. One row per (kernel, shape): the flagship's EVA01,
              BEATs and rerank shapes; CLIP-L/14-336's (64 images x 16
              heads x 577 x 64, read out of the packed projection), AST's
              (8 x 12 x 257 x 64), the CLIP + AST rerank's 640 queries
              over 4873 keys; and shapes no path reaches (the lse variant
              at 4873 keys, the backward with a bias's ds). A bf16
              head-major forward must take the Hopper body (wgmma fed by
              the copy engine: one flash_attention_fwd_sm90 launch), an
              fp32 one the CUDA-core body; each head-major forward row
              also gives the profiler's device time per launch
              (device_ms). A bf16 backward (token-major or head-major)
              must take the Hopper backward (wgmma fed by the copy engine:
              one tmajor_attention_bwd_sm90 or flash_attention_bwd_sm90
              launch), an fp32 one the CUDA-core body; each backward row
              gives the profiler's device time per call, and of its dQ and
              dK/dV kernels apart.
4. tiny     - a tiny fp32 VASTModel on the GPU (kernels) against the same
              weights on the CPU (plain versions): ret%tva features, and
              grouped ITM scores at a shape that takes the head-major
              kernel; then one train step on each (under the 'attn'
              checkpoint policy, injected ITM negatives): losses, every
              gradient and every parameter after the step.
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
7. train    - the flagship model again, with fp32 parameters and bf16
              compute, 'attn' checkpointing and bf16 Adam moments (the
              train program of bench.py:367-400, 473-477), takes one
              warm-up step, then three timed blocks of five ret%tva train
              steps on one synthetic batch of 8 clips, each block
              synchronised only at its end (as bench.py:394-399 times):
              train clips/s from the median block, the host's time to
              issue each block, peak memory, losses, the global gradient
              norm, which LR groups moved, and exact launch counts per
              step over the first block (40 EVA and 12 BEATs attention
              forwards, as many backwards, all 52 on the Hopper backward:
              the forward is not re-run in the recompute). One more step
              under torch.profiler gives the idle share and the top
              kernels.
8. tiny_clip_ast  - phase 4 for a tiny CLIP + AST model whose towers have
              257 tokens, so that their attention takes the head-major
              kernels: features, then one 'attn' train step (the lse
              forward and the backward, 4 launches each; fp32, so not
              the Hopper body).
9. slice_clip_ast - phase 5 for CLIP-L/14-336 (24 layers, 8 frames at
              336 px) + AST (12 layers, 1024 fbank frames) + BERT, bf16,
              top k 16, so that every text reranks every clip: exactly 48
              head-major forwards in CLIP, 24 in AST and 48 in the rerank
              (4 calls x 12 layers, 640 queries over 4873 keys) per run,
              every one through the Hopper body, and no token-major
              launch.
10. train_clip_ast - phase 7 for that model (clip_lr on CLIP's tower):
              exactly 24 + 12 lse forwards and as many backwards per step,
              all through the Hopper bodies, nothing else launched; then
              one profiled step.
11. tmajor_variants - the token-major layout probe
              (``vast_tpu_torch.scripts.bench_tmajor_variants``) at its full
              shape (B 256, Lp 272, H 16, D 88, lk_true 257, bf16): its
              ``run`` with the counters zeroed (exactly one launch per call
              of each variant's wrapper, cur's and pad128's backwards on
              the Hopper backward), each variant's fwd and fwd+bwd
              times, bound and SDPA time; cur, dma and sect in turns at its
              shape and at EVA's slice shape, with the profiler's device
              times; then the two kernels of its own (attention_dma
              through the copy engine, attention_sect) in bf16 and fp32
              against their plain versions and against cur.
12. hmajor_turns - the head-major forward's two bf16 bodies in turns
              (sm90, mma, mma, sm90; the mma.sync body's C entry called
              directly, a yardstick only) at CLIP 577^2, AST 257^2, the
              flagship rerank and the CLIP + AST rerank, with and without
              the lse: CUDA-event times and the profiler's device time per
              launch of each, and SDPA's time.
13. bwd_turns - the backward's two bf16 bodies in turns (sm90, mma, mma,
              sm90; the mma.sync body's C entries called directly, a
              yardstick only) at EVA01-g's and BEATs' (bias and ds)
              token-major shapes, CLIP-L/14-336's packed one, AST's and
              the 640 x 4873 one: CUDA-event times, the profiler's device
              time per launch of the dQ kernel and of the dK/dV kernel
              apart, SDPA's backward alone, and the largest difference
              between the two bodies' gradients.

Then the ``{"kernels": [...]}`` line (each row's launches from its path's
counted run: the slice for forwards, the train step for lse forwards and
backwards, the probe's run for its two kernels; 0 for the rows no path
reaches; each row names its bf16 body) and, last, the ``{"ok": true,
...}`` line. Imports nothing of JAX or of ``vast_tpu``.
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
TRAIN_RUNS, TRAIN_STEPS = 3, 5       # timed blocks of unsynchronised
                                     # train steps, after a warm-up step
WAVE_SAMPLES = 1024 * 160 + 400      # 1024 fbank frames at 16 kHz

COND_TOKENS = FRAMES * 257 + 256     # EVA tokens of 8 frames + BEATs'
RERANK_CANDS = 4                     # rerank_scores' conds_per_call
# texts per candidate in the rerank: 16 texts x top 8 over 16 candidates
RERANK_TEXTS = N_CLIPS * TOP_K // N_CLIPS

# the CLIP-L/14-336 + AST configuration: 577 tokens a frame, 257 a clip
CA = dict(vision_encoder_type="clip_vit_large_14_336px",
          vision_resolution=336, audio_encoder_type="ast")
CA_TOP_K = 16                        # every text reranks every clip
CA_COND_TOKENS = FRAMES * 577 + 257  # 4873
CA_RERANK_TEXTS = N_CLIPS * CA_TOP_K // N_CLIPS     # 16: Lq 640

# published dense peaks of the card this script is written for (NVIDIA's
# data sheet, H100 SXM at 700 W): bf16 tensor and fp32 CUDA-core FLOP/s,
# HBM bytes/s. Any other card raises: a bound from another part's peaks
# would be wrong.
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 67e12, 3.35e12)}

PALLAS = "vast_tpu/ops/flash_attention.py"
PROBE = "scripts/bench_tmajor_variants.py"
# one row per (kernel, shape): the Pallas kernel replaced, the layout of
# the inputs and the shapes a path gives the kernel ("at"); "path" names
# the phase whose counted run gives the row's launches (None: no path
# reaches the shape)
KERNELS = [
    dict(name="tmajor_attention_fwd", at="eva01g", path="slice",
         replaces=f"{PALLAS}:762", layout="tmajor", b=BATCH * FRAMES,
         lq=257, lk=257, h=16, d=88, scale=1.0, bias=False),
    dict(name="tmajor_attention_fwd_bias", at="beats", path="slice",
         replaces=f"{PALLAS}:789", layout="tmajor", b=BATCH, lq=256,
         lk=256, h=12, d=64, scale=64 ** -0.5, bias=True),
    # BERT's grouped rerank: the texts of one candidate folded into the
    # query, over that candidate's cross K/V
    dict(name="flash_attention_fwd", at="flagship_rerank", path="slice",
         replaces=f"{PALLAS}:87", layout="hmajor", views="token_major",
         b=RERANK_CANDS, lq=RERANK_TEXTS * TEXT_LEN, lk=COND_TOKENS, h=12,
         d=64, scale=64 ** -0.5, bias=False),
    # the train step's backward of EVA's and BEATs' attention
    dict(name="tmajor_attention_bwd", at="eva01g", path="train",
         replaces=f"{PALLAS}:795", layout="tmajor_bwd", b=BATCH * FRAMES,
         lq=257, lk=257, h=16, d=88, scale=1.0, bias=False),
    dict(name="tmajor_attention_bwd_bias", at="beats", path="train",
         replaces=f"{PALLAS}:841", layout="tmajor_bwd", b=BATCH, lq=256,
         lk=256, h=12, d=64, scale=64 ** -0.5, bias=True),
    # CLIP-L/14-336 and AST inference, and the CLIP + AST rerank (Lk >
    # 4096: vast_tpu's looped kernel)
    dict(name="flash_attention_fwd", at="clip_l14_336", path="slice_clip_ast",
         replaces=f"{PALLAS}:87", layout="hmajor", views="packed",
         b=BATCH * FRAMES, lq=577, lk=577, h=16, d=64, scale=0.125,
         bias=False),
    dict(name="flash_attention_fwd", at="ast", path="slice_clip_ast",
         replaces=f"{PALLAS}:87", layout="hmajor", views="token_major",
         b=BATCH, lq=257, lk=257, h=12, d=64, scale=0.125, bias=False),
    dict(name="flash_attention_fwd", at="clip_ast_rerank",
         path="slice_clip_ast", replaces=f"{PALLAS}:137", layout="hmajor",
         views="token_major", b=RERANK_CANDS,
         lq=CA_RERANK_TEXTS * TEXT_LEN, lk=CA_COND_TOKENS, h=12, d=64,
         scale=0.125, bias=False),
    # their training: the forward with the lse, and the backward (AST's
    # shape takes vast_tpu's fused kernel, CLIP's its tiled pair)
    dict(name="flash_attention_fwd_lse", at="clip_l14_336",
         path="train_clip_ast", replaces=f"{PALLAS}:52", layout="hmajor",
         views="packed", lse=True, b=BATCH * FRAMES, lq=577, lk=577, h=16,
         d=64, scale=0.125, bias=False),
    dict(name="flash_attention_fwd_lse", at="ast", path="train_clip_ast",
         replaces=f"{PALLAS}:52", layout="hmajor", views="token_major",
         lse=True, b=BATCH, lq=257, lk=257, h=12, d=64, scale=0.125,
         bias=False),
    dict(name="flash_attention_bwd", at="clip_l14_336",
         path="train_clip_ast", replaces=f"{PALLAS}:372",
         replaces_also=[f"{PALLAS}:451"], layout="hmajor_bwd",
         views="packed", b=BATCH * FRAMES, lq=577, lk=577, h=16, d=64,
         scale=0.125, bias=False),
    dict(name="flash_attention_bwd", at="ast", path="train_clip_ast",
         replaces=f"{PALLAS}:363", layout="hmajor_bwd", views="token_major",
         b=BATCH, lq=257, lk=257, h=12, d=64, scale=0.125, bias=False),
    # no path: the lse forward and backward at 4873 keys (vast_tpu's
    # _looped_kernel and tiled backward), and the backward with a learned
    # bias's ds (its _bwd_fused_kernel and _bwd_dq_kernel)
    dict(name="flash_attention_fwd_lse", at="long_keys_4873", path=None,
         replaces=f"{PALLAS}:94", layout="hmajor", views="token_major",
         lse=True, b=RERANK_CANDS, lq=CA_RERANK_TEXTS * TEXT_LEN,
         lk=CA_COND_TOKENS, h=12, d=64, scale=0.125, bias=False),
    dict(name="flash_attention_bwd", at="long_keys_4873", path=None,
         replaces=f"{PALLAS}:372", replaces_also=[f"{PALLAS}:451"],
         layout="hmajor_bwd", views="token_major", b=RERANK_CANDS,
         lq=CA_RERANK_TEXTS * TEXT_LEN, lk=CA_COND_TOKENS, h=12, d=64,
         scale=0.125, bias=False),
    dict(name="flash_attention_bwd_dbias", at="biased_257", path=None,
         replaces=f"{PALLAS}:321", layout="hmajor_bwd",
         views="token_major", b=BATCH, lq=257, lk=257, h=12, d=64,
         scale=0.125, bias=True),
    dict(name="flash_attention_bwd_dbias", at="biased_577", path=None,
         replaces=f"{PALLAS}:413", replaces_also=[f"{PALLAS}:372"],
         layout="hmajor_bwd", views="token_major", b=2, lq=577, lk=577,
         h=16, d=64, scale=0.125, bias=True),
    # the token-major layout probe's two kernels on its data (phase
    # tmajor_variants; lk is its lk_true): the fused layout through the
    # copy engine, and the section-major layout
    dict(name="attention_dma", at="probe", path="tmajor_variants",
         replaces=f"{PROBE}:78", layout="probe", views="fused", b=256,
         lq=272, lk=257, h=16, d=88, scale=1.0, bias=False),
    dict(name="attention_sect", at="probe", path="tmajor_variants",
         replaces=f"{PROBE}:118", layout="probe", views="section_major",
         b=256, lq=272, lk=257, h=16, d=88, scale=1.0, bias=False),
]
GRADS = ("dq", "dk", "dv", "dbias")
SOURCE = "vast_tpu_torch/csrc/flash_attention.cu"
# the bf16 body of each row's layout (the kernels line names it)
BODIES = {
    "tmajor": "attention_fwd_mma_kernel (mma.sync, cp.async)",
    "hmajor": "attention_fwd_sm90_kernel (wgmma, copy engine)",
    "tmajor_bwd": "attention_bwd_dq_sm90_kernel + "
                  "attention_bwd_dkv_sm90_kernel (wgmma, copy engine)",
    "probe": {"attention_dma": "attention_fwd_tma_kernel (mma.sync, copy "
                               "engine)",
              "attention_sect": "attention_fwd_mma_kernel (mma.sync, "
                                "cp.async)"},
}
BODIES["hmajor_bwd"] = BODIES["tmajor_bwd"]


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def peaks_for(name):
    check(name in PEAKS, f"no published peaks for {name!r}: the bounds "
          f"are defined for {sorted(PEAKS)}")
    return PEAKS[name]


def time_ms(torch, fn, reps=20, rounds=5, warmup=5):
    """Milliseconds per call of ``fn``: ``reps`` back-to-back calls
    between two CUDA events, so that the host's time to launch each call
    hides behind the device's work wherever the device is the slower
    (between single calls it would count as device time); the median of
    ``rounds`` such blocks, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def profiled_kernels(torch, fn, calls=10, tries=3):
    """The profiler's (CUPTI) records of the kernels of ``calls`` calls of
    ``fn``, by name; a session that recorded no kernel at all (which
    happened on the H100 now and then, as did sessions that recorded only
    some launches) is run again, up to ``tries`` sessions, and [] if none
    recorded one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            return kernels
    return []


def mean_device_ms(kernels):
    """Device ms per launch over ``kernels`` (profiler records): the mean
    over the launches recorded; None (not measured) for none."""
    seen = sum(e.count for e in kernels)
    return sum(e.self_device_time_total for e in kernels) / seen / 1e3 \
        if seen else None


def device_ms(torch, fn, calls=10):
    """The profiler's device time per kernel launch of ``fn`` (one launch
    a call), ms, over ``calls`` calls (:func:`profiled_kernels`); None
    where the profiler recorded none."""
    return mean_device_ms(profiled_kernels(torch, fn, calls))


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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def hmajor_inputs(torch, spec, dtype, gen):
    """q, k, v (B, H, L, D) as the path lays them out: views of CLIP's
    packed (B, L, 3, H, D) projection, or of token-major (B, L, H, D)
    projections (AST's, BERT's); the cotangent do as the output
    projection's autograd gives it (token-major); a learned per-sample
    fp32 bias where the row has one."""
    b, lq, lk, h, d = (spec[k] for k in ("b", "lq", "lk", "h", "d"))

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    if spec["views"] == "packed":
        q, k, v = (t.transpose(1, 2) for t in
                   randn(b, lq, 3, h, d).unbind(2))
    else:
        q, k, v = (randn(b, n, h, d).transpose(1, 2) for n in (lq, lk, lk))
    do = randn(b, lq, h, d).transpose(1, 2)
    bias = None
    if spec["bias"]:
        bias = torch.randn(b, h, lq, lk, device="cuda", generator=gen)
    return q, k, v, do, bias


def fwd_case(torch, spec, dtype, gen):
    """Inputs at ``spec``'s shapes and the kernel, plain and library calls
    on them. The library call (SDPA) is a yardstick the port never makes;
    ``as_out`` brings its result to the kernel's layout for its error."""
    import torch.nn.functional as F

    from vast_tpu_torch.ops import flash_attention as fa

    b, lq, h, d = (spec[k] for k in ("b", "lq", "h", "d"))
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
            inputs=[qkv, bias], v=v,
            run=lambda: fa.self_attention_tmajor(qkv, bias, heads=h,
                                                 scale=scale),
            plain=lambda: fa._self_attention_tmajor_plain(
                qkv, bias, heads=h, scale=scale),
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=scale),
            as_out=lambda o: o.transpose(1, 2).reshape(b, lq, h * d))
    q, k, v, _, _ = hmajor_inputs(torch, spec, dtype, gen)
    lse = bool(spec.get("lse"))
    return dict(
        inputs=[q, k, v], v=v,
        run=lambda: fa.flash_attention(q, k, v, scale=scale,
                                       return_lse=lse),
        plain=lambda: fa._flash_attention_plain(q, k, v, scale=scale,
                                                return_lse=lse),
        library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                       scale=scale),
        as_out=lambda o: o)


def fwd_kernel_row(torch, spec, dtype, gen, case=None):
    """A forward kernel against its plain version, and the times of both
    and of the library call, on ``case`` (default: :func:`fwd_case`'s).
    ``case["p_roundings"]``: how many of the two round the softmax weights
    to bf16 (1: the kernel alone)."""
    from vast_tpu_torch.ops import flash_attention as fa

    case = case or fwd_case(torch, spec, dtype, gen)
    sm90_before = fa.LAUNCHES["flash_attention_fwd_sm90"]
    out = case["run"]()
    torch.cuda.synchronize()
    sm90 = fa.LAUNCHES["flash_attention_fwd_sm90"] - sm90_before
    label = f"{spec['name']} at {spec['at']} {dtype}"
    if spec["layout"] == "hmajor":
        # q, k, v as the path lays them out: bf16 takes the Hopper body
        want = int(dtype == torch.bfloat16)
        check(sm90 == want, f"{label}: {sm90} launches of the Hopper body, "
              f"want {want}")
    ref = case["plain"]()
    lse = ref_lse = None
    if spec.get("lse"):
        (out, lse), (ref, ref_lse) = out, ref
    ref = ref.float()
    diff = out.float() - ref
    err = diff.abs().max().item()
    ref_max = ref.abs().max().item()
    rms_rel = (diff.square().mean().sqrt()
               / ref.square().mean().sqrt()).item()
    if dtype == torch.bfloat16:
        # the plain version computes in fp32 from the same bf16 inputs;
        # the kernel also rounds p (<= 1) to bf16 for p.v, <= 2^-8 x max
        # |v| in the output, and both round the output to bf16 once (one
        # ulp, <= 2^-7 x max |out|)
        v_max = case["v"].float().abs().max().item()
        rounds = case.get("p_roundings", 1)
        tol = ref_max * 2 ** -7 + v_max * 2 ** -8 * rounds
        why = ("one bf16 ulp of max |out| (2^-7) plus bf16 rounding of p "
               "(2^-8 x max |v|" + (", on each side)" if rounds > 1 else ")"))
        # each of the two roundings errs by at most 2^-8 relative, less in
        # rms; a dropped or misweighted key costs percents
        rms_tol = 2 ** -6
        rms_why = ("four times bf16's unit roundoff 2^-8: output and p "
                   "rounding each add at most 2^-8 relative")
    else:
        tol = 2e-5 * max(ref_max, 1.0)
        why = f"fp32 with another summation order over <= {spec['lk']} keys"
        rms_tol = 1e-5
        rms_why = "fp32: rounding noise is ~1e-7 relative"
    check(math.isfinite(err) and err <= tol,
          f"{label}: max abs err {err} > {tol}")
    check(math.isfinite(rms_rel) and rms_rel <= rms_tol,
          f"{label}: rms error / rms(ref) {rms_rel} > {rms_tol}")
    errors = {"o": {"max_abs_err": err, "tolerance": tol,
                    "tolerance_reason": why, "rms_rel_err": rms_rel,
                    "rms_tolerance": rms_tol,
                    "rms_tolerance_reason": rms_why}}
    if lse is not None:
        # the scores are fp32 sums of exact products of the same inputs
        # on both sides, so the lse differs by fp32 rounding alone
        lse_err = (lse - ref_lse).abs().max().item()
        lse_tol = 1e-5 * max(ref_lse.abs().max().item(), 1.0)
        check(math.isfinite(lse_err) and lse_err <= lse_tol,
              f"{label}: lse max abs err {lse_err} > {lse_tol}")
        errors["lse"] = {"max_abs_err": lse_err, "tolerance": lse_tol,
                         "tolerance_reason": "fp32 rounding of the scores: "
                                             "1e-5 x max |lse|"}
    lib_err = (case["as_out"](case["library"]()).float()
               - ref).abs().max().item()
    del ref, diff, ref_lse
    flops = 4.0 * spec["b"] * spec["h"] * spec["lq"] * spec["lk"] * spec["d"]
    r = dict(errors=errors, max_abs_err=err, library_max_abs_err=lib_err,
             kernel_ms=time_ms(torch, case["run"]),
             plain_ms=time_ms(torch, case["plain"]),
             library_ms=time_ms(torch, case["library"]), library_note=None,
             bytes=nbytes(*case["inputs"], out, lse), flops=flops)
    if spec["layout"] == "hmajor":
        # the op alone launches no other kernel: device time per launch
        r["device_ms"] = device_ms(torch, case["run"])
        r["sm90_launches"] = sm90
    return r


def grad_errors(torch, got, ref, scales, dtype, label):
    """Errors of each gradient against its plain version, each within 1.1
    x 2^-8 of max(|ref| + the sum of |terms| of its last product) in bf16
    (5e-5 of it in fp32) and an rms of 2^-6 (1e-5)."""
    errors = {}
    for name in got:
        diff = got[name] - ref[name]
        err = diff.abs().max().item()
        span = (ref[name].abs() + scales[name]).max().item()
        rms_rel = (diff.square().mean()
                   / ref[name].square().mean().clamp_min(1e-30)).sqrt().item()
        if dtype == torch.bfloat16:
            tol, rms_tol = 1.1 * 2 ** -8 * span, 2 ** -6
        else:
            tol, rms_tol = 5e-5 * max(span, 1e-6), 1e-5
        check(math.isfinite(err) and err <= tol,
              f"{label} {name}: max abs err {err} > {tol}")
        check(math.isfinite(rms_rel) and rms_rel <= rms_tol,
              f"{label} {name}: rms error / rms(ref) {rms_rel} > {rms_tol}")
        errors[name] = {"max_abs_err": err, "tolerance": tol,
                        "rms_rel_err": rms_rel, "rms_tolerance": rms_tol}
    return errors


def sdpa_backward_ms(torch, q, k, v, bias, do, scale):
    """SDPA's backward alone on the same values (head-major leaves; a bias
    as its additive mask, in q's type as SDPA asks: the head-major rows'
    fp32 bias rounded to bf16), or None and why where the backend gives no
    bias gradient."""
    import torch.nn.functional as F

    inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    mask = None
    if bias is not None:
        mask = bias.detach().to(q.dtype, copy=True).requires_grad_(True)
        inputs.append(mask)
    try:
        out = F.scaled_dot_product_attention(*inputs[:3], attn_mask=mask,
                                             scale=scale)
        return time_ms(torch, lambda: torch.autograd.grad(
            out, inputs, do, retain_graph=True)), None
    except RuntimeError as e:        # a backend without the bias gradient
        return None, f"SDPA gives no bias gradient here: {e}"[:300]


def split_grads(torch, res, heads, bias):
    """(dqkv[, dbias]) -> {dq, dk, dv[, dbias]} as fp32 (B, H, L, D)."""
    dqkv = res if bias is None else res[0]
    b, l, total = dqkv.shape
    x = dqkv.float().view(b, l, heads, 3, total // (3 * heads))
    out = {n: x[:, :, :, i].transpose(1, 2) for i, n in enumerate(GRADS[:3])}
    if bias is not None:
        out["dbias"] = res[1].float()
    return out


def bwd_device_ms(torch, fn, calls=10):
    """The profiler's device time per launch of each kernel of ``fn`` (a
    backward: its dQ kernel, then its dK/dV kernel), ms, by kernel ("dq",
    "dkv"), over ``calls`` calls, as :func:`device_ms`; each None where
    the profiler recorded none."""
    kernels = profiled_kernels(torch, fn, calls)
    return {part: mean_device_ms([e for e in kernels
                                  if f"attention_bwd_{part}_" in e.key])
            for part in ("dq", "dkv")}


def total_ms(by_kernel):
    """The sum of :func:`bwd_device_ms`'s times; None if one is None."""
    return None if None in by_kernel.values() else sum(by_kernel.values())


def check_sm90_bwd(torch, fa, key, fn, dtype, label):
    """``fn()`` (one backward), checking that it launched the Hopper body
    (one ``key`` launch) in bf16 and not in fp32; returns its result."""
    before = fa.LAUNCHES[key]
    res = fn()
    torch.cuda.synchronize()
    sm90 = fa.LAUNCHES[key] - before
    want = int(dtype == torch.bfloat16)
    check(sm90 == want, f"{label}: {sm90} launches of the Hopper backward, "
          f"want {want}")
    return res


def tmajor_bwd_inputs(torch, spec, dtype, gen):
    """qkv, bias, the forward's output o and a cotangent do at a token-major
    backward row's shape."""
    from vast_tpu_torch.ops import flash_attention as fa

    b, l, h, d = (spec[k] for k in ("b", "lq", "h", "d"))
    scale = spec["scale"]
    qkv = torch.randn(b, l, h, 3, d, device="cuda", generator=gen)
    if scale == 1.0:
        qkv[:, :, :, 0] *= d ** -0.5                  # q scale baked in
    qkv = qkv.reshape(b, l, h * 3 * d).to(dtype)
    bias = None
    if spec["bias"]:
        bias = torch.randn(b, h, l, l, device="cuda", generator=gen).to(dtype)
    o = fa._self_attention_tmajor_plain(qkv, bias, heads=h, scale=scale)
    do = torch.randn(b, l, h * d, device="cuda", generator=gen).to(dtype)
    return qkv, bias, o, do


def tmajor_bwd_row(torch, spec, dtype, gen):
    """The token-major backward against its plain version."""
    from vast_tpu_torch.ops import flash_attention as fa

    b, l, h, d = (spec[k] for k in ("b", "lq", "h", "d"))
    scale = spec["scale"]
    qkv, bias, o, do = tmajor_bwd_inputs(torch, spec, dtype, gen)

    def run():
        return fa.self_attention_tmajor_bwd(qkv, o, do, bias, heads=h,
                                            scale=scale)

    def plain():
        return fa._self_attention_tmajor_bwd_plain(qkv, o, do, bias,
                                                   heads=h, scale=scale)

    label = f"{spec['replaces']} {dtype}"
    got = split_grads(torch, check_sm90_bwd(
        torch, fa, "tmajor_attention_bwd_sm90", run, dtype, label), h, bias)
    ref = split_grads(torch, plain(), h, bias)
    scales = fa._self_attention_tmajor_bwd_abs_terms(qkv, o, do, bias,
                                                     heads=h, scale=scale)
    errors = grad_errors(torch, got, ref, scales, dtype, label)
    del scales, ref, got
    q, k, v = qkv.view(b, l, h, 3, d).permute(3, 0, 2, 1, 4)
    library_ms, library_note = sdpa_backward_ms(
        torch, q, k, v, bias, do.view(b, l, h, d).transpose(1, 2), scale)
    by_kernel = bwd_device_ms(torch, run)
    return dict(errors=errors, kernel_ms=time_ms(torch, run),
                plain_ms=time_ms(torch, plain), library_ms=library_ms,
                library_note=library_note,
                device_ms=total_ms(by_kernel),
                device_ms_by_kernel=by_kernel,
                sm90_launches=int(dtype == torch.bfloat16),
                bytes=nbytes(qkv, o, do, qkv, bias, bias),
                # five L x L x D products per (batch, head)
                flops=10.0 * b * h * l * l * d)


def hmajor_bwd_row(torch, spec, dtype, gen):
    """The head-major backward against its plain version, from the plain
    forward's output and lse."""
    from vast_tpu_torch.ops import flash_attention as fa

    scale = spec["scale"]
    q, k, v, do, bias = hmajor_inputs(torch, spec, dtype, gen)
    o, lse = fa._flash_attention_plain(q, k, v, bias, scale=scale,
                                       return_lse=True)
    with_ds = bias is not None

    def run():
        return fa.flash_attention_bwd(q, k, v, bias, o, lse, do,
                                      scale=scale, return_dbias=with_ds)

    def plain():
        return fa._flash_attention_bwd_plain(q, k, v, bias, o, lse, do,
                                             scale=scale,
                                             return_dbias=with_ds)

    label = f"{spec['name']} at {spec['at']} {dtype}"
    got = {n: g.float() for n, g in zip(GRADS, check_sm90_bwd(
        torch, fa, "flash_attention_bwd_sm90", run, dtype, label))}
    ref = {n: g.float() for n, g in zip(GRADS, plain())}
    scales = fa._flash_attention_bwd_abs_terms(q, k, v, bias, o, lse, do,
                                               scale=scale)
    errors = grad_errors(torch, got, ref, scales, dtype, label)
    dbias = got.get("dbias")
    del scales, ref, got
    library_ms, library_note = sdpa_backward_ms(torch, q, k, v, bias, do,
                                                scale)
    b, lq, lk, h, d = (spec[n] for n in ("b", "lq", "lk", "h", "d"))
    by_kernel = bwd_device_ms(torch, run)
    return dict(errors=errors, kernel_ms=time_ms(torch, run),
                plain_ms=time_ms(torch, plain), library_ms=library_ms,
                library_note=library_note,
                device_ms=total_ms(by_kernel),
                device_ms_by_kernel=by_kernel,
                sm90_launches=int(dtype == torch.bfloat16),
                # q, k, v, o, do, lse (and the bias) read once; dq, dk, dv
                # (and ds, fp32) written once
                bytes=nbytes(q, k, v, o, do, lse, bias, q, k, v, dbias),
                flops=10.0 * b * h * lq * lk * d)


def bound(torch, device_name, nbytes_, flops, dtype):
    """The least time the card could take, ms, and what bounds it: the
    bytes over the memory rate, or the operations over the peak rate of
    ``dtype``."""
    bf16_peak, fp32_peak, hbm = peaks_for(device_name)
    peak = bf16_peak if dtype == torch.bfloat16 else fp32_peak
    t_bytes, t_ops = nbytes_ / hbm * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_row(torch, device_name, phase, spec, dtype, r):
    """The emitted row of one kernel measurement ``r`` at ``spec``."""
    bound_ms, bound_by = bound(torch, device_name, r["bytes"], r["flops"],
                               dtype)
    row = {
        "phase": phase, "name": spec["name"], "at": spec["at"],
        "replaces": spec["replaces"],
        "dtype": str(dtype).replace("torch.", ""),
        "shape": {k: spec[k] for k in ("b", "lq", "lk", "h", "d")}
        | {"bias": "per-sample" if spec["bias"] else None,
           "views": spec.get("views")},
        "errors": r["errors"],
        "max_abs_err": max(e["max_abs_err"] for e in r["errors"].values()),
        "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "library_ms": r["library_ms"], "library_note": r["library_note"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": r["bytes"], "flops": r["flops"],
    }
    for key in ("library_max_abs_err", "device_ms", "device_ms_by_kernel",
                "sm90_launches"):
        if key in r:
            row[key] = r[key]
    return row


def phase_kernels(torch, device_name):
    """Every row of KERNELS but the probe's (phase tmajor_variants)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for i, spec in enumerate(KERNELS):
        if spec["layout"] == "probe":
            continue
        for dtype in (torch.bfloat16, torch.float32):
            if spec["layout"] == "tmajor_bwd":
                r = tmajor_bwd_row(torch, spec, dtype, gen)
            elif spec["layout"] == "hmajor_bwd":
                r = hmajor_bwd_row(torch, spec, dtype, gen)
            else:
                r = fwd_kernel_row(torch, spec, dtype, gen)
            row = kernel_row(torch, device_name, "kernels", spec, dtype, r)
            emit(row)
            rows[(i, dtype)] = row
            torch.cuda.empty_cache()
    return rows


def phase_hmajor_turns(torch):
    """The head-major forward's two bf16 bodies in turns (sm90, mma, mma,
    sm90; each :func:`time_ms`) at each path shape of KERNELS, with and
    without the lse, and the profiler's device time per launch of each:
    the Hopper body against the mma.sync one, whose C entry is called
    directly as a yardstick (the op takes it only for operands the copy
    engine cannot read), within one call on one card."""
    import torch.nn.functional as F

    from vast_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entries = {"sm90": "vast_flash_attention_fwd_sm90",
               "mma": "vast_flash_attention_fwd"}
    for spec in KERNELS:
        if spec["name"] != "flash_attention_fwd":
            continue
        q, k, v, _, _ = hmajor_inputs(torch, spec, torch.bfloat16, gen)
        scale = spec["scale"]
        for lse in (False, True):
            fns = {body: (lambda e=entry: fa._flash_fwd_launch(
                e, q, k, v, None, scale, 0, lse)) for body, entry in
                entries.items()}
            outs = {body: fn()[0].float() for body, fn in fns.items()}
            turns = {body: [] for body in fns}
            for body in ("sm90", "mma", "mma", "sm90"):
                turns[body].append(time_ms(torch, fns[body]))
            emit({"phase": "hmajor_turns", "at": spec["at"], "lse": lse,
                  "shape": {key: spec[key] for key in
                            ("b", "lq", "lk", "h", "d", "views")},
                  "ms_in_turns": turns,
                  "device_ms": {body: device_ms(torch, fn)
                                for body, fn in fns.items()},
                  "sdpa_ms": time_ms(torch, lambda: (
                      F.scaled_dot_product_attention(q, k, v, scale=scale))),
                  "bodies_max_abs_diff": (outs["sm90"] - outs["mma"]
                                          ).abs().max().item()})
        del q, k, v, outs
        torch.cuda.empty_cache()


def phase_bwd_turns(torch):
    """The backward's two bf16 bodies in turns (sm90, mma, mma, sm90; each
    :func:`time_ms`) at EVA01-g's and BEATs' token-major shapes and at the
    head-major shapes of KERNELS without a bias (CLIP, AST, 4873 keys):
    the Hopper body against the mma.sync one, whose C entries are called
    directly as a yardstick (the wrappers take it only for operands the
    copy engine cannot read), within one call on one card; the profiler's
    device time per launch of each body's dQ and dK/dV kernels, SDPA's
    backward alone, and the largest difference between the bodies'
    gradients."""
    from vast_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16 = torch.bfloat16
    for spec in KERNELS:
        if spec["layout"] == "tmajor_bwd":
            h, scale = spec["h"], spec["scale"]
            qkv, bias, o, do = tmajor_bwd_inputs(torch, spec, bf16, gen)
            fns = {body: (lambda e=entry: fa._tmajor_bwd_launch(
                e, qkv, o, do, bias, h, 0, scale)) for body, entry in (
                ("sm90", "vast_tmajor_attention_bwd_sm90"),
                ("mma", "vast_tmajor_attention_bwd"))}
            b, l, d = spec["b"], spec["lq"], spec["d"]
            q, k, v = qkv.view(b, l, h, 3, d).permute(3, 0, 2, 1, 4)
            sdpa = (q, k, v, bias, do.view(b, l, h, d).transpose(1, 2))
        elif spec["layout"] == "hmajor_bwd" and not spec["bias"]:
            scale = spec["scale"]
            q, k, v, do, _ = hmajor_inputs(torch, spec, bf16, gen)
            o, lse = fa._flash_attention_plain(q, k, v, scale=scale,
                                               return_lse=True)
            fns = {body: (lambda e=entry: fa._flash_bwd_launch(
                e, q, k, v, None, o, lse, do, scale, 0, False)) for
                body, entry in (("sm90", "vast_flash_attention_bwd_sm90"),
                                ("mma", "vast_flash_attention_bwd"))}
            sdpa = (q, k, v, None, do)
        else:
            continue
        outs = {body: [g.float() for g in fn() if g is not None]
                for body, fn in fns.items()}
        turns = {body: [] for body in fns}
        for body in ("sm90", "mma", "mma", "sm90"):
            turns[body].append(time_ms(torch, fns[body]))
        sdpa_ms, sdpa_note = sdpa_backward_ms(torch, *sdpa, scale)
        emit({"phase": "bwd_turns", "name": spec["name"], "at": spec["at"],
              "shape": {key: spec[key] for key in
                        ("b", "lq", "lk", "h", "d", "bias")}
              | {"views": spec.get("views")},
              "ms_in_turns": turns,
              "device_ms": {body: bwd_device_ms(torch, fn)
                            for body, fn in fns.items()},
              "sdpa_backward_ms": sdpa_ms, "sdpa_note": sdpa_note,
              "bodies_max_abs_diff": max(
                  (a - b).abs().max().item()
                  for a, b in zip(outs["sm90"], outs["mma"]))})
        del fns, outs, sdpa
        torch.cuda.empty_cache()


def probe_case(torch, spec, inputs, dtype):
    """A probe kernel's case for :func:`fwd_kernel_row` on the probe's data
    in ``dtype``: the wrapper, its plain version (which rounds p / l to
    bf16 as the kernel rounds p) and SDPA on the same q, k, v views over
    the first lk_true keys at scale 1, a yardstick the port never calls."""
    import torch.nn.functional as F

    from vast_tpu_torch.scripts import bench_tmajor_variants as tv

    b, lq, lk, h, d = (spec[k] for k in ("b", "lq", "lk", "h", "d"))
    sect = spec.get("views") == "section_major"
    x = inputs["sect" if sect else "fused"].to(dtype)
    q, k, v = tv.qkv_views(x, h, section_major=sect)
    kernel = getattr(tv, spec["name"])
    plain = getattr(tv, "_" + spec["name"] + "_plain")
    return dict(
        inputs=[x], v=v, p_roundings=2,
        run=lambda: kernel(x, heads=h, lk_true=lk),
        plain=lambda: plain(x, heads=h, lk_true=lk),
        library=lambda: F.scaled_dot_product_attention(
            q, k[:, :, :lk], v[:, :, :lk], scale=1.0),
        as_out=lambda o: o.transpose(1, 2).reshape(b, lq, h * d))


def probe_turns(torch, tv, inputs, heads, lk):
    """The layouts' forwards in turns (cur, dma, sect, sect, dma, cur,
    cur, dma, sect; each :func:`time_ms`) at the probe's shape and at
    EVA's slice shape (B 64, L 257, no mask: the probe's first rows), so
    that row 1's cp.async body and the copy engine's are compared within
    one call on one card; and each one's device time per launch (one a
    call) by the profiler (:func:`device_ms`; None if not measured)."""
    from vast_tpu_torch.ops import flash_attention as fa

    for b, l, lk_true in ((tv.B, tv.LP, lk), (64, 257, 0)):
        fused = inputs["fused"][:b, :l].contiguous()
        sect = inputs["sect"][:b, :l].contiguous()
        fns = {"cur": lambda: fa.self_attention_tmajor(
                   fused, heads=heads, lk_true=lk_true),
               "dma": lambda: tv.attention_dma(fused, heads=heads,
                                               lk_true=lk_true),
               "sect": lambda: tv.attention_sect(sect, heads=heads,
                                                 lk_true=lk_true)}
        turns = {k: [] for k in fns}
        for k in ("cur", "dma", "sect", "sect", "dma", "cur", "cur", "dma",
                  "sect"):
            turns[k].append(time_ms(torch, fns[k]))
        emit({"phase": "tmajor_variants_turns", "b": b, "l": l,
              "lk_true": lk_true, "ms_in_turns": turns,
              "device_ms": {k: device_ms(torch, fn)
                            for k, fn in fns.items()}})


def phase_tmajor_variants(torch, device_name):
    """The port's layout probe at its full shape: its ``run`` with the
    launch counters zeroed just before and read just after (one launch
    per wrapper call: its dma and sect kernels, cur's and pad128's
    token-major forward and backward), then per variant the bound and
    SDPA's time, the layouts in turns (:func:`probe_turns`), then the
    rows of its two kernels (bf16 and fp32, against their plain versions
    and against cur). Returns those rows and the run's launches."""
    import torch.nn.functional as F

    from vast_tpu_torch.ops import flash_attention as fa
    from vast_tpu_torch.scripts import bench_tmajor_variants as tv

    heads, lk = tv.H, tv.LK_TRUE
    t0 = time.perf_counter()
    inputs = tv.make_inputs()                 # the probe's data, on the card
    torch.cuda.synchronize()
    inputs_s = time.perf_counter() - t0
    zero_launches(fa)
    records = tv.run(heads=heads, lk_true=lk, inputs=inputs,
                     emit=lambda rec: emit({"phase": "tmajor_variants"} | rec))
    launches = dict(fa.LAUNCHES)
    check(all("error" not in r for r in records),
          f"probe variants failed: {records}")
    calls = {r["variant"]: r["calls"] for r in records}
    want = {k: 0 for k in launches} | {
        "attention_dma": calls["dma"]["fwd"],
        "attention_sect": calls["sect"]["fwd"],
        "tmajor_attention_fwd": calls["cur"]["fwd"] + calls["pad128"]["fwd"],
        "tmajor_attention_bwd": calls["cur"]["bwd"] + calls["pad128"]["bwd"],
        # both layouts' backwards take the Hopper body
        "tmajor_attention_bwd_sm90": calls["cur"]["bwd"]
        + calls["pad128"]["bwd"]}
    check(launches == want, f"probe launches {launches} != one per call "
          f"{want}")

    for rec in records:
        layout = {"cur": "fused", "dma": "fused"}.get(rec["variant"],
                                                      rec["variant"])
        x = inputs[layout]
        q, k, v = tv.qkv_views(x, heads, section_major=layout == "sect")
        b, _, lp, d = q.shape
        bound_ms, bound_by = bound(
            torch, device_name, nbytes(x) + b * lp * heads * d * 2,
            4.0 * b * heads * lp * lk * d, torch.bfloat16)
        sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k[:, :, :lk], v[:, :, :lk], scale=1.0))
        emit({"phase": "tmajor_variants_summary"} | rec
             | {"bound_ms": bound_ms, "bound_by": bound_by,
                "sdpa_ms": sdpa_ms})
    probe_turns(torch, tv, inputs, heads, lk)

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        cur_small = fa.self_attention_tmajor(
            inputs["fused"].to(dtype), heads=heads, lk_true=lk)[:2].float()
        for i, spec in enumerate(KERNELS):
            if spec["layout"] != "probe":
                continue
            case = probe_case(torch, spec, inputs, dtype)
            r = fwd_kernel_row(torch, spec, dtype, None, case)
            cur_err = (case["run"]()[:2].float()
                       - cur_small).abs().max().item()
            check(cur_err <= tv.CROSS_ATOL, f"{spec['name']} {dtype}: first "
                  f"two rows {cur_err} from cur's > {tv.CROSS_ATOL}")
            row = kernel_row(torch, device_name, "tmajor_variants_kernels",
                             spec, dtype, r) | {"cur_max_abs_err": cur_err}
            emit(row)
            rows[(i, dtype)] = row
            torch.cuda.empty_cache()
    emit({"phase": "tmajor_variants_time", "inputs_s": inputs_s,
          "seconds": time.perf_counter() - t0})
    return rows, launches


def tiny_bert(**remat):
    from vast_tpu_torch.models.bert import BertConfig

    return BertConfig(vocab_size=170, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64,
                      max_position_embeddings=96, hidden_dropout_prob=0.0,
                      **remat)


def tiny_config(remat_policy="none"):
    """The tiny model of the tests, with no dropout (so that a train step
    draws nothing at random) and every encoder under ``remat_policy``."""
    from vast_tpu_torch.models.beats import BeatsConfig
    from vast_tpu_torch.models.eva_vit import EvaVitConfig
    from vast_tpu_torch.models.vast import VASTConfig

    remat = dict(remat=remat_policy != "none", remat_policy=remat_policy)
    return VASTConfig(
        contra_dim=16, max_vision_sample_num=2, vision_resolution=32,
        audio_melbins=16, audio_target_length=64,
        vision_cfg=EvaVitConfig(image_size=32, patch_size=8, width=32,
                                layers=2, head_width=8, mlp_ratio=2.0,
                                **remat),
        audio_cfg=BeatsConfig(input_patch_size=8, embed_dim=24,
                              encoder_embed_dim=32, encoder_layers=2,
                              encoder_ffn_embed_dim=64,
                              encoder_attention_heads=4, conv_pos=16,
                              conv_pos_groups=4, num_buckets=32,
                              max_distance=64, **remat),
        bert_cfg=tiny_bert(**remat))


def tiny_clip_ast_config(remat_policy="none"):
    """A tiny CLIP + AST model whose towers take the head-major kernels:
    patches of 2 give 16 x 16 + 1 = 257 tokens a frame and 8 x 32 + 1 =
    257 a clip (Lq * Lk >= 128^2); at the tests' TINY_CLIP / TINY_AST
    sizes (17 tokens) they would stay on the plain route."""
    from vast_tpu_torch.models.ast import AstConfig
    from vast_tpu_torch.models.clip_vit import ClipVitConfig
    from vast_tpu_torch.models.vast import VASTConfig

    remat = dict(remat=remat_policy != "none", remat_policy=remat_policy)
    return VASTConfig(
        vision_encoder_type="clip_vit_base_16", audio_encoder_type="ast",
        contra_dim=16, max_vision_sample_num=2, vision_resolution=32,
        audio_melbins=16, audio_target_length=64,
        vision_cfg=ClipVitConfig(image_size=32, patch_size=2, width=32,
                                 layers=2, heads=4, **remat),
        audio_cfg=AstConfig(hidden_size=32, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=64,
                            audio_melbins=16, audio_target_length=64,
                            patch_size=2, **remat),
        bert_cfg=tiny_bert(**remat))


def tiny_batch(np, rs, mask_tail=False, distinct=False):
    """Three clips of noise frames and waveform, and captions. With
    ``distinct`` the clips differ in brightness and loudness: a CLS token
    over 257 tokens averages 256 patches, so clips of equal statistics
    give equal features (cosine 1.0000 between clips) and the ITC
    gradient cancels, fp32 then erring by 1.9e-4 of a tensor's largest
    gradient against fp64 (tests/test_torch_clip_ast.py
    ``test_tiny_clip_ast_step_conditioning``)."""
    mask = np.ones((3, 12), np.int32)
    if mask_tail:
        mask[0, 9:] = 0
    level = np.array([0.25, 0.6, 1.0]) if distinct else np.ones(3)
    frames = rs.randint(0, 256, (3, 2, 40, 48, 3))
    return {"vision_frames": (frames * level[:, None, None, None, None]
                              ).astype(np.uint8),
            # one 64-frame clip: the training clip choice has one option
            "audio_waveforms": (rs.randn(3, 63 * 160 + 400) * 3000
                                * (4 * level if distinct else level)[:, None]
                                ).astype(np.float32),
            "caption_tokens": rs.randint(106, 170, (3, 12)).astype(np.int32),
            "caption_attention_mask": mask}


def tiny_features(torch, np, config, launched_want, distinct=False):
    """ret%tva features of ``config``'s model, seeded weights, on the GPU
    (kernels) against the CPU (plain versions); the models."""
    from vast_tpu_torch.convert.from_jax import init_random_
    from vast_tpu_torch.models.vast import VASTModel
    from vast_tpu_torch.ops import flash_attention as fa

    cfg = config()
    cpu = init_random_(VASTModel(cfg, device="cpu"),
                       torch.Generator().manual_seed(SEED))
    gpu = VASTModel(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = tiny_batch(np, np.random.RandomState(SEED), distinct=distinct)
    outs, launched = [], {}
    with torch.inference_mode():
        for model in (cpu, gpu):
            before = dict(fa.LAUNCHES)
            tb = {k: torch.from_numpy(v).to(model.device)
                  for k, v in batch.items()}
            outs.append(model(tb, "ret%tva"))
            launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    want = {k: launched_want.get(k, 0) for k in fa.LAUNCHES}
    check(launched == want, f"tiny features launches {launched} != {want}")
    row = {"tolerance_rel": 1e-4,
           "tolerance_reason": "fp32 on both sides (TF32 off), other "
                               "summation orders through 2+2+2 layers",
           "launches": launched}
    for key in ("feat_t", "feat_cond_tva", "condition_feats_tva"):
        ref, got = outs[0][key], outs[1][key].cpu()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        row[key] = rel
        check(math.isfinite(rel) and rel <= 1e-4,
              f"tiny {key}: relative error {rel}")
    return row, cpu, gpu


def phase_tiny(torch, np):
    """Kernels inside the model on the GPU vs plain versions on the CPU."""
    from vast_tpu_torch.ops import flash_attention as fa

    row, cpu, gpu = tiny_features(
        torch, np, tiny_config,
        {"tmajor_attention_fwd": 2, "tmajor_attention_fwd_bias": 2})
    rs = np.random.RandomState(SEED + 3)
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
    check(launched == cpu.cfg.bert_cfg.num_hidden_layers,
          f"grouped scores launched the head-major kernel {launched} times")
    rel = ((scores[1] - scores[0]).abs().max()
           / scores[0].abs().max()).item()
    row["grouped_itm_scores"] = rel
    check(math.isfinite(rel) and rel <= 1e-4,
          f"tiny grouped scores: relative error {rel}")
    row["train_step"] = tiny_train_step(
        torch, np, tiny_config,
        {"tmajor_attention_fwd": 2, "tmajor_attention_fwd_bias": 2,
         "tmajor_attention_bwd": 2, "tmajor_attention_bwd_bias": 2})
    emit({"phase": "tiny"} | row)


def phase_tiny_clip_ast(torch, np):
    """The same for a tiny CLIP + AST model, its attention through the
    head-major kernels: 2 + 2 forwards for the features, and in the train
    step 2 + 2 lse forwards and backwards."""
    row, _, _ = tiny_features(torch, np, tiny_clip_ast_config,
                              {"flash_attention_fwd": 4}, distinct=True)
    row["train_step"] = tiny_train_step(
        torch, np, tiny_clip_ast_config,
        {"flash_attention_fwd_lse": 4, "flash_attention_bwd": 4},
        distinct=True)
    emit({"phase": "tiny_clip_ast"} | row)


TINY_RUN_CFG = {"learning_rate": 1e-3, "clip_lr": 2e-4}


def tiny_train_inputs(torch, np, temperature=0.07, gain_offset=1.0,
                      config=tiny_config, distinct=False):
    """The CPU model (tiny, 'attn' policy, seeded weights) and the batch
    of the tiny train step, with the ITM negatives injected and no other
    draw. Every weight is drawn from N(0, 0.02); then the temperature is
    set to ``temperature`` (None: left as drawn) and ``gain_offset`` is
    added to every LayerNorm gain, near the model's own initialisation.
    With the temperature and gains as drawn, fp32 itself moves the
    gradients by up to 1e-2 of their tensor's largest against fp64, on
    the CPU alone (tests/test_torch_train_step.py
    ``test_tiny_step_conditioning``), so no check between two fp32
    devices can be tight there. ``config``: the model's configuration
    for a remat policy; ``distinct``: as :func:`tiny_batch`."""
    from vast_tpu_torch.convert.from_jax import init_random_
    from vast_tpu_torch.models.vast import VASTModel

    cpu = init_random_(VASTModel(config("attn"), device="cpu"),
                       torch.Generator().manual_seed(SEED + 1))
    with torch.no_grad():
        if temperature is not None:
            cpu.contra_temp.fill_(temperature)
        for mod in cpu.modules():
            if isinstance(mod, torch.nn.LayerNorm):
                mod.weight.add_(gain_offset)
    batch = tiny_batch(np, np.random.RandomState(SEED + 1), mask_tail=True,
                       distinct=distinct)
    batch |= {"itm_neg_cond_idx": np.array([[2, 0, 1]]),
              "itm_neg_text_idx": np.array([[1, 2, 0]])}
    return cpu, batch


def tiny_step(torch, model, batch):
    """One train step of ``model`` on the numpy ``batch``; its metrics as
    floats. Gradients stay in ``.grad``, parameters are updated."""
    from vast_tpu_torch.training.optimizer import build_optimizer
    from vast_tpu_torch.training.step import (create_train_state,
                                              make_train_step)

    opt, _ = build_optimizer(
        model, TINY_RUN_CFG,
        {"vision_encoder_type": model.cfg.vision_encoder_type}, 20)
    step = make_train_step(model, opt, "ret%tva")
    tb = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
    _, m = step(create_train_state(model, opt), tb,
                torch.Generator().manual_seed(SEED))
    return {k: v.item() for k, v in m.items()}


# parameters whose gradient is rounding noise on both sides: softmax
# ignores a bias added to every key alike (CLIP packs its key bias into
# the middle third of in_proj_bias)
KEY_BIASES = ("k_proj.bias", "self.key.bias", "attention.linears.1.bias")


def tiny_train_step(torch, np, config, launches_want, distinct=False):
    """One train step of a tiny model under the 'attn' policy on the GPU
    (kernels) and on the CPU (plain versions), from the same weights and
    batch (:func:`tiny_train_inputs`); exactly ``launches_want`` on the
    GPU, nothing else."""
    from vast_tpu_torch.models.vast import VASTModel
    from vast_tpu_torch.ops import flash_attention as fa

    cpu, batch = tiny_train_inputs(torch, np, config=config,
                                   distinct=distinct)
    gpu = VASTModel(cpu.cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    metrics, launched = [], {}
    for model in (cpu, gpu):
        before = dict(fa.LAUNCHES)
        metrics.append(tiny_step(torch, model, batch))
        launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    want = {k: launches_want.get(k, 0) for k in fa.LAUNCHES}
    check(launched == want, f"tiny train step launches {launched} != {want}")
    out = {"launches": launched, "losses_cpu": metrics[0],
           "losses_gpu": metrics[1]}
    for k in metrics[0]:
        rel = abs(metrics[1][k] - metrics[0][k]) / abs(metrics[0][k])
        check(math.isfinite(rel) and rel <= 1e-4,
              f"tiny train {k}: relative error {rel}")
    grad_err = param_err = 0.0
    gparams = dict(gpu.named_parameters())
    for n, p in cpu.named_parameters():
        q = gparams[n]
        check((p.grad is None) == (q.grad is None), f"{n}: grad presence")
        if p.grad is not None:
            # fp32 on both sides (TF32 off), other summation orders: fp32
            # against fp64 on the CPU reads 7.2e-6 for the flagship's tiny
            # step and 3.2e-5 for CLIP + AST's, so two fp32 runs differ by
            # less than twice that (tests/test_torch_train_step.py and
            # tests/test_torch_clip_ast.py, *_conditioning). Relative to the
            # tensor's largest gradient, floored at 1e-3 for tensors whose
            # gradient is rounding noise (a key bias, which softmax
            # ignores)
            rel = ((q.grad.cpu() - p.grad).abs().max()
                   / max(p.grad.abs().max().item(), 1e-3)).item()
            check(math.isfinite(rel) and rel <= 1e-4, f"{n}: grad {rel}")
            grad_err = max(grad_err, rel)
        # one Adam update, g / (|g| + eps) times lr = 1e-3: where |g| is
        # near eps = 1e-6, a gradient difference within the tolerance
        # above moves it by a fraction of lr, so 10% of lr. A key bias's
        # gradient is rounding noise on both sides (softmax ignores it):
        # only the update's bound, lr, holds there. (The update rule
        # itself is held against optax by tests/test_torch_train.py.)
        tol = torch.full(p.shape, 1e-4)
        if n.endswith(KEY_BIASES):
            tol[:] = 1e-3
        elif n.endswith("in_proj_bias"):
            third = p.shape[0] // 3
            tol[third:2 * third] = 1e-3
        err = (q.detach().cpu() - p.detach()).abs()
        check(bool((err <= tol).all()),
              f"{n}: parameter after the step differs by {err.max().item()}")
        param_err = max(param_err, err.max().item())
    out |= {"grad_max_rel_err": grad_err, "grad_tolerance_rel": 1e-4,
            "param_max_abs_err": param_err, "param_tolerance_abs": 1e-4}
    return out


def synthetic_batches(np, resolution=224):
    rs = np.random.RandomState(SEED)
    batches = []
    for s in range(0, N_CLIPS, BATCH):
        ids = [f"clip{i:03d}" for i in range(s, s + BATCH)]
        batches.append({
            "vision_frames": rs.randint(
                0, 256, (BATCH, FRAMES, resolution, resolution, 3),
            ).astype(np.uint8),
            "audio_waveforms": (rs.randn(BATCH, WAVE_SAMPLES) * 2 ** 15
                                ).astype(np.float32),
            "caption_tokens": rs.randint(1000, 20000, (BATCH, TEXT_LEN)
                                         ).astype(np.int32),
            "caption_attention_mask": np.ones((BATCH, TEXT_LEN), np.int32),
            "ids": ids, "ids_txt": ids,
        })
    return batches


def zero_launches(fa):
    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0


class TowerLaunches:
    """Counts the launches of ``key`` inside the model's vision and audio
    towers while active (the methods are wrapped on the instance); the
    rest of a run's launches of ``key`` are the rerank's."""

    def __init__(self, fa, model, key):
        self.fa, self.model, self.key = fa, model, key
        self.counts = {"vision": 0, "audio": 0}

    def _wrap(self, tower, fn):
        def run(*args, **kwargs):
            before = self.fa.LAUNCHES[self.key]
            out = fn(*args, **kwargs)
            self.counts[tower] += self.fa.LAUNCHES[self.key] - before
            return out
        return run

    def __enter__(self):
        m = self.model
        m.forward_vision_encoder = self._wrap("vision",
                                              m.forward_vision_encoder)
        m.forward_audio_encoder = self._wrap("audio", m.forward_audio_encoder)
        return self.counts

    def __exit__(self, *exc):
        del self.model.forward_vision_encoder
        del self.model.forward_audio_encoder


def run_slice(torch, np, phase, cfg, top_k, resolution, cond_tokens):
    """``evaluate_ret`` over 16 synthetic clips, bf16 random weights: the
    counted and timed runs, stage times and output checks. Returns the
    emitted row's fields, the launches of the counted run and those of
    the forward kernel by stage (vision, audio, rerank), and the model."""
    from vast_tpu_torch.convert.from_jax import init_random_
    from vast_tpu_torch.evaluation.evaluation_mm import evaluate_ret
    from vast_tpu_torch.models.vast import VASTModel
    from vast_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    model = VASTModel(cfg)                       # device None -> the GPU
    init_random_(model, torch.Generator(device="cuda").manual_seed(SEED))
    model.eval()
    batches = synthetic_batches(np, resolution)
    run_cfg = {"itm_rerank_num": top_k}
    setup_s = time.perf_counter() - t0

    def timed_run():
        t0 = time.perf_counter()
        log = evaluate_ret(model, ["tva"], batches, run_cfg,
                           vision_transforms="crop_flip")
        torch.cuda.synchronize()
        return log, time.perf_counter() - t0

    timed_run()                 # first-call costs at every shape of the run
    torch.cuda.reset_peak_memory_stats()
    with TowerLaunches(fa, model, "flash_attention_fwd") as by_stage:
        zero_launches(fa)
        log, wall = timed_run()
        launches = dict(fa.LAUNCHES)
    by_stage["rerank"] = (launches["flash_attention_fwd"]
                          - by_stage["vision"] - by_stage["audio"])
    peak_mem = torch.cuda.max_memory_allocated()
    walls = [wall] + [timed_run()[1] for _ in range(RUNS - 1)]

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
              "condition_feats_tva": (BATCH, cond_tokens, 768)}
    for key, shape in shapes.items():
        t = out[key]
        check(t.is_cuda and tuple(t.shape) == shape
              and bool(torch.isfinite(t.float()).all()),
              f"{key}: {t.device} {tuple(t.shape)} finite="
              f"{bool(torch.isfinite(t.float()).all())}")
    row = {"phase": phase, "clips": N_CLIPS, "batch": BATCH,
           "frames": FRAMES, "resolution": resolution, "top_k": top_k,
           "dtype": "bfloat16",
           "clips_per_s": N_CLIPS / statistics.median(walls),
           "clips_per_s_runs": [N_CLIPS / w for w in walls], "wall_s": walls,
           "stage_s": timings, "setup_s": setup_s,
           "max_memory_allocated": peak_mem, "launches": launches,
           "flash_attention_fwd_by_stage": by_stage, "metrics": log}
    return row, launches, by_stage, model, batches, run_cfg


def phase_slice(torch, np):
    from vast_tpu_torch.models.vast import VASTConfig

    row, launches, _, model, batches, run_cfg = run_slice(
        torch, np, "slice", VASTConfig(dtype=torch.bfloat16), TOP_K, 224,
        COND_TOKENS)
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
    check(launches["flash_attention_fwd_sm90"] == n_flash,
          f"{launches['flash_attention_fwd_sm90']} of {n_flash} head-major "
          f"forwards took the Hopper body: want all")
    emit(row)
    return launches, model, batches, run_cfg


def phase_slice_clip_ast(torch, np):
    """CLIP-L/14-336 + AST ret%tva inference: exact head-major launches
    per run, 48 in CLIP (2 batches x 24 layers), 24 in AST and 48 in the
    rerank (16 texts on each of 16 candidates: 4 calls of 4 candidates x
    12 BERT layers, a folded query of 640 rows over 4873 keys); nothing
    token-major."""
    from vast_tpu_torch.models.vast import VASTConfig

    row, launches, by_stage, model, batches, _ = run_slice(
        torch, np, "slice_clip_ast", VASTConfig(dtype=torch.bfloat16, **CA),
        CA_TOP_K, 336, CA_COND_TOKENS)
    # every head-major forward through the Hopper body
    want = {k: 0 for k in launches} | {"flash_attention_fwd": 120,
                                       "flash_attention_fwd_sm90": 120}
    check(launches == want and by_stage == {"vision": 48, "audio": 24,
                                            "rerank": 48},
          f"launches {launches}, by stage {by_stage}: want {want} and "
          f"48 / 24 / 48")
    emit(row)
    del model, batches
    return launches, by_stage


def profile_run(torch, phase, fn):
    """``fn()`` under torch.profiler (CUPTI): device time by kernel, and
    the device's busy and idle share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    emit({"phase": phase, "wall_s": wall,
          "device_busy_s": busy_us / 1e6,
          "device_idle_share": 1.0 - busy_us / 1e6 / wall,
          "top_kernels": [{"name": e.key[:120], "count": e.count,
                           "device_ms": e.self_device_time_total / 1e3}
                          for e in top]})


def phase_profile(torch, model, batches, run_cfg):
    """One more evaluate_ret of the 16 clips under the profiler."""
    from vast_tpu_torch.evaluation.evaluation_mm import evaluate_ret

    profile_run(torch, "profile", lambda: evaluate_ret(
        model, ["tva"], batches, run_cfg, vision_transforms="crop_flip"))


def train_batch(torch, np, resolution=224):
    """One synthetic training batch of 8 clips on the card: uint8 frames
    (8 at ``resolution``), 1024 fbank frames of waveform, 40-token
    captions."""
    rs = np.random.RandomState(SEED + 2)
    batch = {
        "vision_frames": rs.randint(
            0, 256, (BATCH, FRAMES, resolution, resolution, 3),
        ).astype(np.uint8),
        "audio_waveforms": (rs.randn(BATCH, WAVE_SAMPLES) * 2 ** 15
                            ).astype(np.float32),
        "caption_tokens": rs.randint(1000, 20000, (BATCH, TEXT_LEN)
                                     ).astype(np.int32),
        "caption_attention_mask": np.ones((BATCH, TEXT_LEN), np.int32)}
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def run_train(torch, np, phase, cfg_kw, resolution, launches_per_step):
    """A train program of bench.py:367-400: fp32 parameters, bf16
    compute, 'attn' checkpointing, AdamW with bf16 moments; one warm-up
    step, three timed blocks of five unsynchronised steps, exact launch
    counts per step over the first block, then one profiled step. In
    that block the head-major lse forward's launches are also counted by
    tower and the backward's by query length."""
    from vast_tpu_torch.convert.from_jax import init_random_
    from vast_tpu_torch.models.vast import VASTConfig, VASTModel
    from vast_tpu_torch.ops import flash_attention as fa
    from vast_tpu_torch.training.optimizer import (build_optimizer,
                                                   global_norm)
    from vast_tpu_torch.training.step import (create_train_state,
                                              make_train_step)

    t0 = time.perf_counter()
    cfg = VASTConfig(dtype=torch.bfloat16, param_dtype=torch.float32,
                     checkpointing=True, remat_policy="attn", **cfg_kw)
    model = VASTModel(cfg)                       # device None -> the GPU
    init_random_(model, torch.Generator(device="cuda").manual_seed(SEED))
    run_cfg = {"learning_rate": 1e-4, "clip_lr": 5e-7,
               "adam_mu_dtype": "bfloat16", "adam_nu_dtype": "bfloat16"}
    opt, labels = build_optimizer(
        model, run_cfg, {"vision_encoder_type": cfg.vision_encoder_type},
        1000)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, "ret%tva")
    batch = train_batch(torch, np, resolution)
    gen = torch.Generator().manual_seed(SEED)
    n_params = sum(p.numel() for p in model.parameters())
    setup_s = time.perf_counter() - t0

    state, m = step(state, batch, gen)           # warm-up
    torch.cuda.synchronize()
    groups = sorted(set(labels.values()))
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    torch.cuda.reset_peak_memory_stats()
    bwd_by_lq = {}
    bwd = fa.flash_attention_bwd

    def tallied_bwd(q, *args, **kwargs):
        bwd_by_lq[q.shape[2]] = bwd_by_lq.get(q.shape[2], 0) + 1
        return bwd(q, *args, **kwargs)

    def block():
        # as bench.py times its steps: no synchronisation until the
        # block's end; the host's own time to issue the block beside it
        nonlocal state
        t1 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state, m = step(state, batch, gen)
            metrics.append(m)
        dispatch.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)

    walls, dispatch, metrics = [], [], []
    with TowerLaunches(fa, model, "flash_attention_fwd_lse") as lse_by_tower:
        fa.flash_attention_bwd = tallied_bwd
        zero_launches(fa)
        block()
        launches = dict(fa.LAUNCHES)
        fa.flash_attention_bwd = bwd
    for _ in range(TRAIN_RUNS - 1):
        block()
    losses = [{k: v.item() for k, v in m.items()} for m in metrics]
    peak_mem = torch.cuda.max_memory_allocated()

    want = {k: launches_per_step.get(k, 0) * TRAIN_STEPS for k in launches}
    check(launches == want, f"{phase} launches {launches} != {want} (per "
          f"step {launches_per_step}: the forward is not re-run in the "
          f"'attn' recompute)")
    for row in losses:
        for k, v in row.items():
            check(math.isfinite(v), f"{phase} {k} = {v}")
    grads = [p.grad for p in params.values() if p.grad is not None]
    grad_norm = global_norm(grads).item()
    check(math.isfinite(grad_norm) and grad_norm > 0,
          f"global gradient norm {grad_norm}")
    moved = {g: False for g in groups}
    for n, p in params.items():
        if not moved[labels[n]] and not torch.equal(p.detach(), before[n]):
            moved[labels[n]] = True
    check(all(moved.values()), f"parameters moved by group: {moved}")
    del before, grads
    emit({"phase": phase, "batch": BATCH, "frames": FRAMES,
          "resolution": resolution, "text_len": TEXT_LEN,
          "dtype": "bfloat16", "param_dtype": "float32",
          "remat_policy": cfg.remat_policy, "adam_moments": "bfloat16",
          "params": n_params, "steps_per_run": TRAIN_STEPS,
          "clips_per_s": BATCH * TRAIN_STEPS / statistics.median(walls),
          "clips_per_s_runs": [BATCH * TRAIN_STEPS / w for w in walls],
          "run_s": walls, "host_dispatch_s": dispatch, "setup_s": setup_s,
          "max_memory_allocated": peak_mem, "launches": launches,
          "launches_per_step": {k: v // TRAIN_STEPS
                                for k, v in launches.items()},
          "flash_attention_fwd_lse_by_tower_per_step": {
              k: v // TRAIN_STEPS for k, v in lse_by_tower.items()},
          "flash_attention_bwd_by_lq_per_step": {
              str(k): v // TRAIN_STEPS for k, v in bwd_by_lq.items()},
          "losses": losses, "grad_global_norm": grad_norm,
          "groups_moved": moved})
    profile_run(torch, phase + "_profile", lambda: step(state, batch, gen))
    return launches, lse_by_tower, bwd_by_lq


def phase_train(torch, np):
    """The flagship train step (bench.py:367-400): 40 EVA and 12 BEATs
    attention forwards and backwards per step, every backward through the
    Hopper body."""
    launches, _, _ = run_train(
        torch, np, "train", {}, 224,
        {"tmajor_attention_fwd": 40, "tmajor_attention_fwd_bias": 12,
         "tmajor_attention_bwd": 40, "tmajor_attention_bwd_bias": 12,
         # every backward through the Hopper body
         "tmajor_attention_bwd_sm90": 40 + 12})
    return launches


def phase_train_clip_ast(torch, np):
    """The CLIP-L/14-336 + AST train step: 24 CLIP and 12 AST lse forwards
    and backwards per step, all through the Hopper bodies (BERT's attention
    takes the plain route)."""
    launches, lse_by_tower, bwd_by_lq = run_train(
        torch, np, "train_clip_ast", CA, 336,
        {"flash_attention_fwd_lse": 36, "flash_attention_fwd_sm90": 36,
         "flash_attention_bwd": 36, "flash_attention_bwd_sm90": 24 + 12})
    n = TRAIN_STEPS
    check(lse_by_tower == {"vision": 24 * n, "audio": 12 * n}
          and bwd_by_lq == {577: 24 * n, 257: 12 * n},
          f"lse forwards by tower {lse_by_tower} and backwards by query "
          f"length {bwd_by_lq} over {n} steps")
    return lse_by_tower, bwd_by_lq


def body_of(spec):
    body = BODIES[spec["layout"]]
    return body[spec["name"]] if isinstance(body, dict) else body


def kernels_line(bf16_rows, launches_at):
    """The ``kernels`` entries: each row of KERNELS with its bf16
    measurements (``bf16_rows``, in KERNELS' order) and its launches on
    its path (``launches_at`` by (name, at); 0 for a shape no path
    reaches)."""
    line = []
    for spec, r in zip(KERNELS, bf16_rows):
        key = (spec["name"], spec["at"])
        check((key in launches_at) == (spec["path"] is not None),
              f"{key}: launches on its path")
        line.append({
            "name": spec["name"], "at": spec["at"], "route": "cuda",
            "source": SOURCE, "replaces": spec["replaces"],
            "replaces_also": spec.get("replaces_also", []),
            "path": spec["path"], "launches": launches_at.get(key, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "body": body_of(spec), "device_ms": r.get("device_ms"),
            "device_ms_by_kernel": r.get("device_ms_by_kernel")})
    return line


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
    rows = phase_kernels(torch, name)
    phase_hmajor_turns(torch)
    phase_bwd_turns(torch)
    probe_rows, probe_launches = phase_tmajor_variants(torch, name)
    rows |= probe_rows
    torch.cuda.empty_cache()
    phase_tiny(torch, np)
    launches, model, batches, run_cfg = phase_slice(torch, np)
    phase_profile(torch, model, batches, run_cfg)
    del model, batches
    torch.cuda.empty_cache()
    train_launches = phase_train(torch, np)
    torch.cuda.empty_cache()
    phase_tiny_clip_ast(torch, np)
    _, ca_by_stage = phase_slice_clip_ast(torch, np)
    torch.cuda.empty_cache()
    ca_lse_by_tower, ca_bwd_by_lq = phase_train_clip_ast(torch, np)
    # each row's launches on its path's counted run (a train block: five
    # steps); the rows of shapes no path reaches have none
    launches_at = {
        ("tmajor_attention_fwd", "eva01g"): launches["tmajor_attention_fwd"],
        ("tmajor_attention_fwd_bias", "beats"):
            launches["tmajor_attention_fwd_bias"],
        ("flash_attention_fwd", "flagship_rerank"):
            launches["flash_attention_fwd"],
        ("tmajor_attention_bwd", "eva01g"):
            train_launches["tmajor_attention_bwd"],
        ("tmajor_attention_bwd_bias", "beats"):
            train_launches["tmajor_attention_bwd_bias"],
        ("flash_attention_fwd", "clip_l14_336"): ca_by_stage["vision"],
        ("flash_attention_fwd", "ast"): ca_by_stage["audio"],
        ("flash_attention_fwd", "clip_ast_rerank"): ca_by_stage["rerank"],
        ("flash_attention_fwd_lse", "clip_l14_336"): ca_lse_by_tower["vision"],
        ("flash_attention_fwd_lse", "ast"): ca_lse_by_tower["audio"],
        ("flash_attention_bwd", "clip_l14_336"): ca_bwd_by_lq[577],
        ("flash_attention_bwd", "ast"): ca_bwd_by_lq[257],
        ("attention_dma", "probe"): probe_launches["attention_dma"],
        ("attention_sect", "probe"): probe_launches["attention_sect"],
    }
    emit({"kernels": kernels_line(
        [rows[(i, torch.bfloat16)] for i in range(len(KERNELS))],
        launches_at)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
