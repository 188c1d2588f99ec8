#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero with no result line:

1. device   - a CUDA GPU must be present; its name and power limit (the
              raw ``nvidia-smi --query-gpu=name,power.limit`` line too).
2. build    - nvcc builds the kernel source of the path, its five parts
              at once (vast_tpu_torch/build.py), and reports ptxas'
              register and shared-memory use.
3. kernels  - each kernel at the main paths' shapes, in bf16 and fp32,
              against its plain PyTorch version on the same inputs, with
              the tolerances and their reasons; kernel, plain and library
              (SDPA, forward or backward, a yardstick the port never
              calls) times by CUDA events (the plain versions' and the
              fp32 rows' over fewer calls), and the bound from bytes and
              operations. The backward kernels' errors are given for dq,
              dk, dv and dbias separately, the lse forward's for o and
              lse. One row per (kernel, shape): the flagship's EVA01,
              BEATs and rerank shapes; CLIP-L/14-336's (64 images x 16
              heads x 577 x 64, read out of the packed projection), AST's
              (8 x 12 x 257 x 64), the CLIP + AST rerank's 640 queries
              over 4873 keys; and shapes no path reaches (the lse variant
              at 4873 keys, the backward with a bias's ds); the remaining
              towers' (bigE's D 112, EVA02-L's and B's 257 and 197 x 64,
              VideoSwin's 392-token windows with a bias) and the
              pretraining validation's rerank (640 x 2382); a tp rank's
              heads (EVA01-g 8 x 88 and BEATs 6 x 64 on 4 clips, forward
              and backward; the 640 x 4438 rerank at 6 heads). A bf16
              forward must take the Hopper body (wgmma fed by the copy
              engine: one flash_attention_fwd_sm90 or
              tmajor_attention_fwd_sm90 launch), an fp32 one the CUDA-core
              body; each forward row also gives the profiler's device
              time per launch (device_ms). A bf16 backward (token-major
              or head-major) must take the Hopper backward (wgmma fed by
              the copy engine:
              one tmajor_attention_bwd_sm90 or flash_attention_bwd_sm90
              launch), an fp32 one the CUDA-core body; each backward row
              gives the profiler's device time per call, and of its dQ and
              dK/dV kernels apart.
4. tiny     - a tiny fp32 VASTModel on the GPU (kernels) against the same
              weights on the CPU (plain versions): ret%tva features, and
              grouped ITM scores at a shape that takes the head-major
              kernel; then one train step on each (under the 'attn'
              checkpoint policy, injected ITM negatives): losses, every
              gradient and every parameter after the step; and ret%tvas,
              the subtitle stream's features and the ITC + ITM losses.
5. slice    - the flagship model (EVA01-g 40 layers + BEATs 12 + BERT 12,
              bf16, random weights from a seeded generator) runs the port's
              ``evaluate_ret`` over 16 synthetic clips in batches of 8:
              features, ITC, the ITM rerank of the top 8, R@k. The kernel
              launch counters are zeroed just before and read just after
              the first of three timed runs (clips/s: the median of the
              three, after a warm-up run); they must read 40 per
              EVA forward, 12 per BEATs forward, and 12 (one per BERT
              layer) per rerank call whose folded query takes the
              head-major kernel; every EVA and BEATs forward must take
              the Hopper body (tmajor_attention_fwd_sm90). A second run,
              synchronised at its stage edges, gives seconds per stage.
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
              forwards, all 52 on the Hopper body, and as many
              backwards, all 52 on the Hopper backward and given the
              forward's lse: the forward is not re-run in the
              recompute). One more step
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
              of each variant's wrapper; every bf16 dma and sect call on
              its Hopper body, attention_fwd_strip_sm90_kernel and
              attention_fwd_sm90_kernel; cur's and pad128's backwards on
              the Hopper backward), each variant's fwd and fwd+bwd
              times, bound and SDPA time; cur, dma and sect in turns at its
              shape and at EVA's slice shape (and
              cur, sect as four launches of 64 batch rows), with the
              profiler's device times, SDPA's and the bound's share;
              strip_turns: the
              resident strip against attention_fwd_tma_kernel (mma.sync
              fed by the copy engine, its C entry called as a yardstick)
              in turns at both shapes; then the two kernels of its own
              (attention_dma, attention_sect) in bf16 and fp32 against
              their plain versions and against cur, with device times.
12. hmajor_turns - the head-major forward's two bf16 bodies in turns
              (sm90, mma, mma, sm90; the mma.sync body's C entry called
              directly, a yardstick only) at CLIP 577^2, AST 257^2, the
              flagship rerank and the CLIP + AST rerank, with and without
              the lse: CUDA-event times and the profiler's device time per
              launch of each, and SDPA's time.
13. tmajor_turns - the token-major forward's two bf16 bodies in turns
              (sm90, mma, mma, sm90; the mma.sync body's C entry called
              directly, a yardstick only) at EVA01-g's shape, BEATs' with
              its per-sample bias and the layout probe's (256 x 272,
              lk_true 257): CUDA-event times, the profiler's device time
              per launch of each, SDPA's events and device time per call,
              the bound, the ratio to SDPA and the share of the bound,
              and the largest difference between the two bodies.
14. bwd_turns - the backward's two bf16 bodies in turns (sm90, mma, mma,
              sm90; the mma.sync body's C entries called directly, a
              yardstick only) at EVA01-g's and BEATs' (bias and ds)
              token-major shapes, each also given the forward's lse
              beside the call that sweeps for it, CLIP-L/14-336's packed
              one, AST's and the 640 x 4873 one: CUDA-event times, the
              profiler's device time per launch of the dQ kernel and of
              the dK/dV kernel apart, SDPA's backward alone, and the
              largest difference between the bodies' gradients.
14b. window_kernels - the window attention's kernels
              (ops/window_attention.py, "Window attention for Hopper" in
              the kernel source) at the four stages of the cell
              videoswin_ret_train (8 clips of 16 frames at 224 px, a 16 x
              56 x 56 token grid: 1,024 / 256 / 64 / 16 windows of 392
              tokens at D 32, 4 to 32 heads, the shifted blocks' region
              labels), bf16: the forward with its lse and the backward
              (dQ, dK/dV, the table's partial sums and their reduction),
              each output checked against the plain version (the kernel
              rows' bf16 limits; the table's gradient within 2^-16 of its
              sums of |terms|), CUDA-event times, the profiler's device
              time by kernel, the least time by
              benchmark/counts/window_attention.window_work, the plain
              version's time, the general op on the materialised
              table-plus-mask sum (the route before these kernels) and
              SDPA on it (bf16) as the library yardstick. The rows'
              launches are those train_towers and slice_towers count by
              stage on VideoSwin's own path.
15. cli_ret_tvas - the port's CLI (``vast_tpu_torch.run.main``, in
              process) on the released retrieval-msrvtt.json (ret%tvas:
              EVA01-g 40 layers, BEATs 12, BERT-base; random seeded
              weights) over a synthetic MSR-VTT-shaped set under a
              temporary VAST_DATA: 32 train and 16 test clips, a caption
              and a 60-word subtitle each, 16 JPEG frames a clip
              (vision_format video_frame: the machine has no video
              decoder; the decoders line says what it found) and a 10.3 s
              wav. Reduced by flags only: batch 8 (train and test),
              'attn' checkpointing, 6 steps, valid_freq 1. first_eval at
              step 0, evaluations and saves after steps 4 and 6, then
              ``--mode testing --checkpoint model_step_6.pt``, whose R@k
              must equal the run's at step 6. Exact launch counts per
              evaluation (80 EVA and 24 BEATs forwards on the Hopper
              body; 48 head-major ones, all at 640 queries over 4438
              keys: row 6) and per train step (52 forwards, 52 backwards
              given the lse, all on the Hopper bodies); the saved model
              reloaded with no key missing or unexpected, a moment per
              trainable tensor in the saved
              optimizer; seconds per stage, train and eval clips/s
              (host-paced), peak memory, the checkpoint's bytes and save
              seconds, and one profiled train step's idle share.
16. tiny_cap_qa (right after tiny) - captioning and QA on the tiny fp32
              model, the GPU against the same weights on the CPU:
              cap%tvas and qa%tvas losses with injected masks, every
              gradient and one 'attn' train step (2 + 2 token-major
              forwards and backwards); the logits of a padded QA prompt's
              prefill and of three teacher-forced decode windows over the
              KV cache; the tokens of greedy and beam-3 generation for
              captions and the QA prompts, which must be equal. Decoding
              launches no kernel (BERT's attentions take the plain route).
17. cli_cap_tvas (after cli_ret_tvas, over its clips) - the port's CLI
              on the released caption-msrvtt.json (cap%tvas), reduced as
              cli_ret_tvas is but to 1 step at a learning rate of 1e-6
              (at 1e-4 the captions turn empty): first_eval at step 0, an
              evaluation and a save after the step, then ``--mode
              testing`` from model_step_1.pt, whose captions and metrics
              must equal the run's at step 1. The losses exactly
              {loss_cap, total_loss}; per step 52 forwards and 52
              backwards on the Hopper bodies, given the lse; per
              evaluation 40 + 12 token-major forwards a batch and no
              head-major launch; one caption per test clip; Bleu_1-4,
              METEOR (which scorer ran), ROUGE_L and CIDEr in [0, 100].
              Printed: the steps' seconds, each evaluation's seconds split
              into condition features and decode, its decode steps and
              generated tokens/s, the saves, the peak memory; the testing
              run's first generate call under the profiler (device time
              by kernel, idle share: cli_cap_tvas_decode_profile).
18. cli_qa_tvas - the same on the released VQA-msrvtt.json (qa%tvas, 8
              eval frames), 1 step: {loss_qa, total_loss}, the accuracy
              in [0, 100], one answer per test clip, and testing from
              model_step_1.pt reproducing the answers and the accuracy.

19. slice_towers (after train_clip_ast) - phase 5's evaluate_ret
              (ret%tva with BEATs, 16 clips, top k 8, bf16) for each
              remaining vision tower at full width: EVA02-B/16 and L/14
              (rope: the head-major kernel at 197 and 257 tokens),
              EVA02-bigE/14 (64 layers, width 1792, 4.4 B parameters; the
              token-major kernel at D 112), Swin-B and Swin-L (49-token
              windows: the plain route) and VideoSwin (the whole clip;
              392-token windows at D 32: the window kernels with the
              relative bias and the shift's region labels): clips/s (two
              runs after a warm-up), peak memory and exact launches by
              stage (VideoSwin's window forwards by its stages' heads).
20. train_towers - phase 7's train program for EVA02-L/14 and for
              VideoSwin with BEATs: a warm-up step and two blocks of five,
              LayerNorm gains + 1 after the seeded init; exact launches a
              step (24 head-major lse forwards and backwards, VideoSwin's
              through the window kernels, the table's gradient summed
              there, 2 / 2 / 18 / 2 by stage; BEATs' 12 and 12), the loss
              falling from
              the first block to the last, one profiled step.
21. cli_pretrain (last, over cli_ret_tvas' clips) - the port's CLI on a
              copy of the released pretrain_vast.json (EVA01-g, BEATs,
              BERT-base): vast27m and valor1m as annotation sets of the
              JPEG frame directories, laion400m as three tar shards of
              JPEG images (a corrupt member among them) through the
              srcindexed stream, the ret%tvas MSR-VTT validation at 8
              frames. Reduced by flags only: batch 8, 'attn', 6 steps
              (every set drawn), valid_freq 1. Exact launches per step by
              its set's task and per evaluation (row 5 at 640 x 2382 in the
              rerank), finite losses, the loaders' kinds, saves,
              ``--mode testing`` from model_step_6.pt with equal R@k; then
              3 steps each of ``--optim adam`` and ``--optim adamax`` on
              a depth-2 copy at full width.
22. ddp_step (after train_towers) - data parallel: ret%tvas at full width
              (EVA01-g/14, BEATs, BERT-base; 8, 4 and 4 layers), fp32,
              one AdamW step of the global batch of 8 clips through
              DistributedDataParallel in spawned ranks: a world of one
              under NCCL (the reference), then two ranks sharing the card
              over gloo (VAST_DIST_BACKEND=gloo), and two ranks over NCCL
              on two cards where the machine has them. The losses, every
              averaged gradient (by group) and the updated parameters
              against the reference within the stated fp32 tolerances;
              every rank the same gradient; rows 1-4 exactly as counted
              per rank (the fp32 bodies); step seconds, the gradient
              all-reduce's seconds in flight and peak memory per rank.
23. cli_ddp_ret_tvas (last, over cli_ret_tvas' clips) - the port's CLI
              under ``python -m torch.distributed.run --standalone
              --nproc_per_node 2 -m vast_tpu_torch.run``, two ranks sharing
              the card over gloo: the released retrieval-msrvtt.json at
              full width and ddp_step's depth, bf16, 3 steps of the global
              batch 8, evaluations and saves after steps 1 and 3; every
              rank's summary line with the same losses, DDP's own
              all-reduce seconds (steps 1-2) and rows 1-4 and 6 exactly as
              counted, one checkpoint pair written by rank 0
              that loads into one process, and ``--mode testing`` under two
              ranks and one with equal R@k.
24. shard_step (after ddp_step) - parameter sharding: ddp_step's model,
              batch and step on create_mesh(dp=1, fsdp=2, tp=2) through
              shard_state(fsdp=True, tp=True), four spawned ranks sharing
              the card over gloo (and four over NCCL on four cards where
              the machine has them), against ddp_step's saved reference
              within its tolerances (every gradient and parameter gathered
              whole); each rank's parameter and moment bytes exactly as
              the plan gives them, its towers on their tp heads (EVA01-g
              8, BEATs 6, BERT 6), rows 1-4 as one rank launches them;
              step seconds and peak memory per rank.
25. shard_towers (after shard_step) - the towers split over tp last:
              CLIP-L/14-336 + AST (8 and 4 layers), VideoSwin + BEATs and
              Swin-B + BEATs (two blocks a stage, every stage; BEATs 4
              layers), each with 4 BERT layers, full width, fp32, 'attn',
              one ret%tva step of ddp_batch (336 px for CLIP): a world of
              one under NCCL (the reference), then four spawned ranks
              over gloo on create_mesh(dp=1, fsdp=2, tp=2) (and over NCCL
              on four cards where the machine has them). Losses, every
              gradient and parameter within ddp_step's tolerances; every
              rank's losses equal, its bytes as planned, its towers on
              their tp heads by stage, its launches (rows 2, 4, 5, 7-9,
              the fp32 entries) as one rank's at those heads; CLIP +
              AST's evaluate_ret over 16 clips (the rerank: row 6 at 640
              x 4873, 6 heads) with ITC and ITM scores within 2^-8 of the
              reference's largest entry.
26. remat_offload (after shard_towers) - ddp_step's model and batch in one
              process, one forward and backward under 'attn',
              'attn_offload', 'dots' and 'dots_offload': each offload
              policy's losses and gradients against its policy's within
              ddp_step's tolerances, the bytes its cache moved to pinned
              host memory, its peak device memory lower.
27. shard_train (last, over cli_ret_tvas' clips) - pipeline.train with
              mesh=create_mesh(dp=1, fsdp=2, tp=2) in four spawned ranks
              over gloo: the released retrieval-msrvtt.json with
              run_cfg.fsdp and tp at ddp_step's depth, bf16, 3 steps of
              the global batch 8, one evaluation and one save; the saved
              model_step_3.pt equal to the ranks' whole tensors and
              loading into an unsharded model with no key missing or
              unexpected; pipeline.test of it unsharded on the same mesh
              giving the sharded evaluation's scores within the stated
              bf16 tolerance (R@k but across near-ties); rows 1-4 and 6
              (the 640 x 4438 rerank at 6 heads) exactly as counted.
28. adam (after train_clip_ast) - the optimizer's multi-tensor kernel
              (csrc/multi_tensor_adam.cu) at the parameter sets and run_cfg
              of the benchmark's two configurations (1.25 B and 0.53 B fp32
              parameters, fp32 moments, AdamW): one update with the launch
              counter zeroed just before (one launch over every trainable
              tensor), then the per-tensor loop on the CPU from the same
              state (on the card the loop divides by a host scalar as a
              product with its reciprocal): moments within 2 ulps,
              parameters within 2 of (an ulp of the parameter + an ulp
              of its step: the CPU's sqrt is not always correctly
              rounded);
              the update's time by CUDA events, the kernel's device time,
              the loop's and the library's fused AdamW (a yardstick the
              port never calls), against the bound of 28 bytes a
              parameter. Every train phase (7, 10, 20) also counts one
              launch of it a step, every tensor updated by it; ddp_step,
              shard_step and shard_train one a step on every rank.

Then the seconds of every phase (``{"phase_seconds": {...}}``), the
``{"kernels": [...]}`` line (each row's launches from its path's
counted run: the slice for forwards, the train step for lse forwards and
backwards, the probe's run for its two kernels, the CLI's training run
for the 16-frame rerank, the towers' slice and train runs for their
shapes, the pretraining run for its rerank, rank 0 of shard_train and
of shard_towers for a tp rank's heads; 0 for the rows no path
reaches; each row names its bf16 body and its launches on the other new
paths; the optimizer's kernel a row a configuration, its launches those
of train and train_clip_ast) and, last, the ``{"ok": true,
...}`` line. Imports nothing of JAX or of ``vast_tpu``.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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

# the cli_ret_tvas phase: the released retrieval-msrvtt.json (ret%tvas,
# 8 train and 16 eval frames, 70 subtitle tokens) over 32 train and 16
# test clips of synthetic MSR-VTT-shaped data
CLI_TRAIN_CLIPS, CLI_TEST_CLIPS, CLI_STEPS = 32, 16, 6
CLI_EVAL_FRAMES, CLI_SUBTITLE_LEN = 16, 70
TVAS_COND_TOKENS = CLI_EVAL_FRAMES * 257 + 256 + CLI_SUBTITLE_LEN   # 4438
# rerank_scores: top min(itm_rerank_num 50, 16 clips) = 16 clips per text,
# so each clip's segment holds all 16 texts (texts_per_seg 32), and
# conds_per_call 4 segments share a call: 4 calls of 640 queries
TVAS_RERANK_TEXTS = CLI_TEST_CLIPS
CLI_RERANK_CALLS = CLI_TEST_CLIPS // RERANK_CANDS
# phase shard_train's clips a data rank a step (the global 8 over fsdp 2)
SHARD_CLIPS = 4

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
# reaches the shape); "turns" False: not timed against the mma.sync body
# in the turns phases (the shapes added after them)
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
    # the ret%tvas evaluation at MSR-VTT's 16 frames (phase cli_ret_tvas):
    # 16 texts of a candidate over its 16 x 257 + 256 + 70 = 4438
    # condition tokens (Lk > 4096: vast_tpu's looped kernel)
    dict(name="flash_attention_fwd", at="tvas_rerank", path="cli_ret_tvas",
         replaces=f"{PALLAS}:137", layout="hmajor", views="token_major",
         b=RERANK_CANDS, lq=TVAS_RERANK_TEXTS * TEXT_LEN,
         lk=TVAS_COND_TOKENS, h=12, d=64, scale=0.125, bias=False),
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
    # the remaining towers (phases slice_towers and train_towers; bf16):
    # EVA02-bigE's fused qkv at D 112 (inference only: its backward on no
    # path); EVA02-L/14's and B/16's attention after rope, head-major
    # views of token-major projections (B/16's training on no path);
    # VideoSwin's first-stage windows, 8 clips x 64 windows of 8 x 7 x 7
    # tokens, 4 heads of 32, with the relative bias and shift mask as one
    # learned fp32 bias (its ds in training): no path since the window
    # kernels (phase window_kernels) serve these blocks
    dict(turns=False, name="tmajor_attention_fwd", at="bige", path="slice_towers",
         replaces=f"{PALLAS}:762", layout="tmajor", b=BATCH * FRAMES,
         lq=257, lk=257, h=16, d=112, scale=1.0, bias=False),
    dict(turns=False, name="tmajor_attention_bwd", at="bige", path=None,
         replaces=f"{PALLAS}:795", layout="tmajor_bwd", b=BATCH * FRAMES,
         lq=257, lk=257, h=16, d=112, scale=1.0, bias=False),
    dict(turns=False, name="flash_attention_fwd", at="eva02_l", path="slice_towers",
         replaces=f"{PALLAS}:87", layout="hmajor", views="token_major",
         b=BATCH * FRAMES, lq=257, lk=257, h=16, d=64, scale=0.125,
         bias=False),
    dict(turns=False, name="flash_attention_fwd", at="eva02_b", path="slice_towers",
         replaces=f"{PALLAS}:87", layout="hmajor", views="token_major",
         b=BATCH * FRAMES, lq=197, lk=197, h=12, d=64, scale=0.125,
         bias=False),
    dict(turns=False, name="flash_attention_fwd", at="videoswin", path=None,
         replaces=f"{PALLAS}:87", layout="hmajor", views="packed",
         b=BATCH * 64, lq=392, lk=392, h=4, d=32, scale=32 ** -0.5,
         bias=True),
    dict(turns=False, name="flash_attention_fwd_lse", at="eva02_l", path="train_towers",
         replaces=f"{PALLAS}:52", layout="hmajor", views="token_major",
         lse=True, b=BATCH * FRAMES, lq=257, lk=257, h=16, d=64,
         scale=0.125, bias=False),
    dict(turns=False, name="flash_attention_fwd_lse", at="eva02_b", path=None,
         replaces=f"{PALLAS}:52", layout="hmajor", views="token_major",
         lse=True, b=BATCH * FRAMES, lq=197, lk=197, h=12, d=64,
         scale=0.125, bias=False),
    dict(turns=False, name="flash_attention_fwd_lse", at="videoswin", path=None,
         replaces=f"{PALLAS}:52", layout="hmajor", views="packed", lse=True,
         b=BATCH * 64, lq=392, lk=392, h=4, d=32, scale=32 ** -0.5,
         bias=True),
    dict(turns=False, name="flash_attention_bwd", at="eva02_l", path="train_towers",
         replaces=f"{PALLAS}:363", layout="hmajor_bwd", views="token_major",
         b=BATCH * FRAMES, lq=257, lk=257, h=16, d=64, scale=0.125,
         bias=False),
    dict(turns=False, name="flash_attention_bwd", at="eva02_b", path=None,
         replaces=f"{PALLAS}:363", layout="hmajor_bwd", views="token_major",
         b=BATCH * FRAMES, lq=197, lk=197, h=12, d=64, scale=0.125,
         bias=False),
    dict(turns=False, name="flash_attention_bwd_dbias", at="videoswin",
         path=None, replaces=f"{PALLAS}:321", layout="hmajor_bwd",
         views="packed", b=BATCH * 64, lq=392, lk=392, h=4, d=32,
         scale=32 ** -0.5, bias=True),
    # pretraining's MSR-VTT validation (phase cli_pretrain): 16 texts of
    # a candidate over 8 x 257 + 256 + 70 = 2382 condition tokens
    dict(turns=False, name="flash_attention_fwd", at="pretrain_rerank",
         path="cli_pretrain", replaces=f"{PALLAS}:87", layout="hmajor",
         views="token_major", b=RERANK_CANDS,
         lq=TVAS_RERANK_TEXTS * TEXT_LEN, lk=FRAMES * 257 + 256 + 70, h=12,
         d=64, scale=0.125, bias=False),
    # parameter sharding (phase shard_train, bf16): a tp rank's heads
    # (tp 2: EVA01-g's 8 of 16, BEATs' 6 of 12, BERT's 6 of 12) on its
    # data rank's clips (fsdp 2: 4 of the global 8, 8 frames each), and
    # the ret%tvas rerank's 640 x 4438 (Lk > 4096: the looped kernel)
    dict(turns=False, name="tmajor_attention_fwd", at="eva01g_tp2",
         path="shard_train", replaces=f"{PALLAS}:762", layout="tmajor",
         b=SHARD_CLIPS * FRAMES, lq=257, lk=257, h=8, d=88, scale=1.0,
         bias=False),
    dict(turns=False, name="tmajor_attention_fwd_bias", at="beats_tp2",
         path="shard_train", replaces=f"{PALLAS}:789", layout="tmajor",
         b=SHARD_CLIPS, lq=256, lk=256, h=6, d=64, scale=64 ** -0.5,
         bias=True),
    dict(turns=False, name="tmajor_attention_bwd", at="eva01g_tp2",
         path="shard_train", replaces=f"{PALLAS}:795", layout="tmajor_bwd",
         b=SHARD_CLIPS * FRAMES, lq=257, lk=257, h=8, d=88, scale=1.0,
         bias=False),
    dict(turns=False, name="tmajor_attention_bwd_bias", at="beats_tp2",
         path="shard_train", replaces=f"{PALLAS}:841", layout="tmajor_bwd",
         b=SHARD_CLIPS, lq=256, lk=256, h=6, d=64, scale=64 ** -0.5,
         bias=True),
    dict(turns=False, name="flash_attention_fwd", at="tvas_rerank_tp2",
         path="shard_train", replaces=f"{PALLAS}:137", layout="hmajor",
         views="token_major", b=RERANK_CANDS,
         lq=TVAS_RERANK_TEXTS * TEXT_LEN, lk=TVAS_COND_TOKENS, h=6, d=64,
         scale=0.125, bias=False),
    # the towers' tp split (phase shard_towers, fp32 there): a tp rank's
    # heads (CLIP-L/14-336's 8 of 16, AST's 6 of 12, VideoSwin's first
    # stage's 2 of 4, BERT's 6 of 12) on its data rank's 4 clips (8
    # frames each; VideoSwin's 64 windows a clip); CLIP + AST's rerank
    # of 16 texts a candidate over 8 x 577 + 257 = 4873 condition tokens
    dict(turns=False, name="flash_attention_fwd", at="clip_l14_336_tp2",
         path="shard_towers", replaces=f"{PALLAS}:87", layout="hmajor",
         views="packed", b=SHARD_CLIPS * FRAMES, lq=577, lk=577, h=8, d=64,
         scale=0.125, bias=False),
    dict(turns=False, name="flash_attention_fwd_lse", at="clip_l14_336_tp2",
         path="shard_towers", replaces=f"{PALLAS}:52", layout="hmajor",
         views="packed", lse=True, b=SHARD_CLIPS * FRAMES, lq=577, lk=577,
         h=8, d=64, scale=0.125, bias=False),
    dict(turns=False, name="flash_attention_bwd", at="clip_l14_336_tp2",
         path="shard_towers", replaces=f"{PALLAS}:372",
         replaces_also=[f"{PALLAS}:451"], layout="hmajor_bwd",
         views="packed", b=SHARD_CLIPS * FRAMES, lq=577, lk=577, h=8, d=64,
         scale=0.125, bias=False),
    dict(turns=False, name="flash_attention_fwd", at="ast_tp2",
         path="shard_towers", replaces=f"{PALLAS}:87", layout="hmajor",
         views="token_major", b=SHARD_CLIPS, lq=257, lk=257, h=6, d=64,
         scale=0.125, bias=False),
    dict(turns=False, name="flash_attention_fwd_lse", at="ast_tp2",
         path="shard_towers", replaces=f"{PALLAS}:52", layout="hmajor",
         views="token_major", lse=True, b=SHARD_CLIPS, lq=257, lk=257, h=6,
         d=64, scale=0.125, bias=False),
    dict(turns=False, name="flash_attention_bwd", at="ast_tp2",
         path="shard_towers", replaces=f"{PALLAS}:363", layout="hmajor_bwd",
         views="token_major", b=SHARD_CLIPS, lq=257, lk=257, h=6, d=64,
         scale=0.125, bias=False),
    dict(turns=False, name="flash_attention_fwd_lse", at="videoswin_tp2",
         path="shard_towers", replaces=f"{PALLAS}:52", layout="hmajor",
         views="packed", lse=True, b=SHARD_CLIPS * 64, lq=392, lk=392, h=2,
         d=32, scale=32 ** -0.5, bias=True),
    dict(turns=False, name="flash_attention_bwd_dbias", at="videoswin_tp2",
         path="shard_towers", replaces=f"{PALLAS}:321", layout="hmajor_bwd",
         views="packed", b=SHARD_CLIPS * 64, lq=392, lk=392, h=2, d=32,
         scale=32 ** -0.5, bias=True),
    dict(turns=False, name="flash_attention_fwd", at="clip_ast_rerank_tp2",
         path="shard_towers", replaces=f"{PALLAS}:137", layout="hmajor",
         views="token_major", b=RERANK_CANDS, lq=CA_RERANK_TEXTS * TEXT_LEN,
         lk=CA_COND_TOKENS, h=6, d=64, scale=0.125, bias=False),
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
    "tmajor": "attention_fwd_sm90_kernel (wgmma, copy engine)",
    "hmajor": "attention_fwd_sm90_kernel (wgmma, copy engine)",
    "tmajor_bwd": "attention_bwd_dq_sm90_kernel + "
                  "attention_bwd_dkv_sm90_kernel (wgmma, copy engine)",
    "probe": {"attention_dma": "attention_fwd_strip_sm90_kernel (wgmma, "
                               "copy engine, K/V resident)",
              "attention_sect": "attention_fwd_sm90_kernel (wgmma, copy "
                                "engine)"},
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


# time_ms's depth for what the kernel rows time but no path runs: the
# plain versions and the fp32 rows (the CUDA-core bodies, 10-30x slower);
# at time_ms' defaults they alone would take the script past its 600 s
LIGHT_TIMING = dict(reps=5, rounds=3, warmup=2)


def timing(torch, dtype):
    """time_ms's depth for a kernel row of ``dtype``: bf16 rows over
    time_ms' defaults, fp32 rows LIGHT_TIMING."""
    return {} if dtype == torch.bfloat16 else LIGHT_TIMING


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


def call_device_ms(torch, fn, calls=10):
    """The profiler's device time per call of ``fn``, ms: every kernel of
    ``calls`` calls (:func:`profiled_kernels`) over the calls, for a
    library call that may launch more than one kernel; None where the
    profiler recorded none."""
    kernels = profiled_kernels(torch, fn, calls)
    return sum(e.self_device_time_total for e in kernels) / calls / 1e3 \
        if kernels else None


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


def qkv_bytes(q, k, v, kend):
    """The bytes of q and of k's and v's first ``kend`` keys, (B, H, L, D)
    views: what a forward must read of them (keys past kend are masked,
    and the copy engine's maps stop there)."""
    return nbytes(q, k[:, :, :kend], v[:, :, :kend])


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
    q, k, v, _, bias = hmajor_inputs(torch, spec, dtype, gen)
    lse = bool(spec.get("lse"))
    return dict(
        inputs=[q, k, v, bias], v=v,
        run=lambda: fa.flash_attention(q, k, v, bias, scale=scale,
                                       return_lse=lse),
        plain=lambda: fa._flash_attention_plain(q, k, v, bias, scale=scale,
                                                return_lse=lse),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=None if bias is None else bias.to(dtype),
            scale=scale),
        as_out=lambda o: o)


def fwd_kernel_row(torch, spec, dtype, gen, case=None):
    """A forward kernel against its plain version, and the times of both
    and of the library call, on ``case`` (default: :func:`fwd_case`'s).
    ``case["p_roundings"]``: how many of the two round the softmax weights
    to bf16 (1: the kernel alone)."""
    from vast_tpu_torch.ops import flash_attention as fa

    case = case or fwd_case(torch, spec, dtype, gen)
    # the Hopper body's counter of the row's op
    sm90_key = {"hmajor": "flash_attention_fwd_sm90",
                "tmajor": "tmajor_attention_fwd_sm90",
                "probe": spec["name"] + "_sm90"}.get(spec["layout"])
    sm90_before = fa.LAUNCHES.get(sm90_key, 0)
    out = case["run"]()
    torch.cuda.synchronize()
    sm90 = fa.LAUNCHES.get(sm90_key, 0) - sm90_before
    label = f"{spec['name']} at {spec['at']} {dtype}"
    if sm90_key:
        # q, k, v (qkv and bias) as the path lays them out: bf16 takes the
        # Hopper body
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
    depth = timing(torch, dtype)
    r = dict(errors=errors, max_abs_err=err, library_max_abs_err=lib_err,
             kernel_ms=time_ms(torch, case["run"], **depth),
             plain_ms=time_ms(torch, case["plain"], **LIGHT_TIMING),
             library_ms=time_ms(torch, case["library"], **depth),
             library_note=None,
             bytes=case.get("read_bytes", 0) + nbytes(*case["inputs"], out,
                                                      lse), flops=flops)
    if sm90_key:
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


def sdpa_backward_ms(torch, q, k, v, bias, do, scale, depth=None):
    """SDPA's backward alone on the same values (head-major leaves; a bias
    as its additive mask, in q's type as SDPA asks: the head-major rows'
    fp32 bias rounded to bf16), or None and why where the backend gives no
    bias gradient."""
    import torch.nn.functional as F

    depth = depth or {}
    inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    mask = None
    if bias is not None:
        mask = bias.detach().to(q.dtype, copy=True).requires_grad_(True)
        inputs.append(mask)
    try:
        out = F.scaled_dot_product_attention(*inputs[:3], attn_mask=mask,
                                             scale=scale)
        return time_ms(torch, lambda: torch.autograd.grad(
            out, inputs, do, retain_graph=True), **depth), None
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
    """qkv, bias, the forward's output o, its lse and a cotangent do at a
    token-major backward row's shape."""
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
    o, lse = fa._self_attention_tmajor_plain(qkv, bias, heads=h,
                                             scale=scale, return_lse=True)
    do = torch.randn(b, l, h * d, device="cuda", generator=gen).to(dtype)
    return qkv, bias, o, lse, do


def tmajor_bwd_row(torch, spec, dtype, gen):
    """The token-major backward, given the forward's lse as the train
    step gives it, against its plain version."""
    from vast_tpu_torch.ops import flash_attention as fa

    b, l, h, d = (spec[k] for k in ("b", "lq", "h", "d"))
    scale = spec["scale"]
    qkv, bias, o, lse, do = tmajor_bwd_inputs(torch, spec, dtype, gen)

    def run():
        return fa.self_attention_tmajor_bwd(qkv, o, do, bias, heads=h,
                                            scale=scale, lse=lse)

    def plain():
        return fa._self_attention_tmajor_bwd_plain(qkv, o, do, bias,
                                                   heads=h, scale=scale,
                                                   lse=lse)

    label = f"{spec['replaces']} {dtype}"
    got = split_grads(torch, check_sm90_bwd(
        torch, fa, "tmajor_attention_bwd_sm90", run, dtype, label), h, bias)
    ref = split_grads(torch, plain(), h, bias)
    scales = fa._self_attention_tmajor_bwd_abs_terms(qkv, o, do, bias,
                                                     heads=h, scale=scale)
    errors = grad_errors(torch, got, ref, scales, dtype, label)
    del scales, ref, got
    q, k, v = qkv.view(b, l, h, 3, d).permute(3, 0, 2, 1, 4)
    depth = timing(torch, dtype)
    library_ms, library_note = sdpa_backward_ms(
        torch, q, k, v, bias, do.view(b, l, h, d).transpose(1, 2), scale,
        depth)
    by_kernel = bwd_device_ms(torch, run)
    return dict(errors=errors, kernel_ms=time_ms(torch, run, **depth),
                plain_ms=time_ms(torch, plain, **LIGHT_TIMING),
                library_ms=library_ms,
                library_note=library_note,
                device_ms=total_ms(by_kernel),
                device_ms_by_kernel=by_kernel,
                sm90_launches=int(dtype == torch.bfloat16),
                # qkv, o, do, lse (and the bias) read once; dqkv (and ds)
                # written once
                bytes=nbytes(qkv, o, do, lse, qkv, bias, bias),
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
    depth = timing(torch, dtype)
    library_ms, library_note = sdpa_backward_ms(torch, q, k, v, bias, do,
                                                scale, depth)
    b, lq, lk, h, d = (spec[n] for n in ("b", "lq", "lk", "h", "d"))
    by_kernel = bwd_device_ms(torch, run)
    return dict(errors=errors, kernel_ms=time_ms(torch, run, **depth),
                plain_ms=time_ms(torch, plain, **LIGHT_TIMING),
                library_ms=library_ms,
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
        if spec["name"] != "flash_attention_fwd" or not spec.get("turns",
                                                                 True):
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


# tmajor_turns' shapes: (at, B, L, H, D, scale, a per-sample bias,
# lk_true): rows 1 and 2 of KERNELS, and the layout probe's data shape
TMAJOR_TURNS = (("eva01g", BATCH * FRAMES, 257, 16, 88, 1.0, False, 0),
                ("beats", BATCH, 256, 12, 64, 64 ** -0.5, True, 0),
                ("probe", 256, 272, 16, 88, 1.0, False, 257))


def phase_tmajor_turns(torch, device_name):
    """The token-major forward's two bf16 bodies in turns (sm90, mma, mma,
    sm90; each :func:`time_ms`) at TMAJOR_TURNS' shapes, and the
    profiler's device time per launch of each: the Hopper body against
    the mma.sync one, whose C entry is called directly as a yardstick (the
    op takes it only for operands the copy engine cannot read), within
    one call on one card; SDPA's events and device time per call (over
    the first lk_true keys), the bound (q, k and v's first kend keys, the
    bias's and the output moved once; 4 B H L kend D operations), the Hopper body's device time
    over SDPA's and the bound's share of it."""
    import torch.nn.functional as F

    from vast_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for at, b, l, h, d, scale, has_bias, lk in TMAJOR_TURNS:
        qkv = torch.randn(b, l, h, 3, d, device="cuda", generator=gen)
        if scale == 1.0:
            qkv[:, :, :, 0] *= d ** -0.5              # q scale baked in
        qkv = qkv.reshape(b, l, h * 3 * d).to(torch.bfloat16)
        bias = torch.randn(b, h, l, l, device="cuda", generator=gen).to(
            torch.bfloat16) if has_bias else None
        fns = {body: (lambda e=entry: fa._tmajor_fwd_launch(
            e, qkv, bias, h, lk, scale, False)) for body, entry in (
            ("sm90", "vast_tmajor_attention_fwd_sm90"),
            ("mma", "vast_tmajor_attention_fwd"))}
        outs = {body: fn()[0].float() for body, fn in fns.items()}
        turns = {body: [] for body in fns}
        for body in ("sm90", "mma", "mma", "sm90"):
            turns[body].append(time_ms(torch, fns[body]))
        kend = lk or l
        q, k, v = qkv.view(b, l, h, 3, d).permute(3, 0, 2, 1, 4)
        mask = None if bias is None else bias[..., :kend]

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k[:, :, :kend], v[:, :, :kend], attn_mask=mask,
                scale=scale)

        dev = {body: device_ms(torch, fn) for body, fn in fns.items()}
        sdpa_dev = call_device_ms(torch, sdpa)
        bound_ms, bound_by = bound(
            torch, device_name,
            qkv_bytes(q, k, v, kend) + nbytes(mask) + b * l * h * d * 2,
            4.0 * b * h * l * kend * d, torch.bfloat16)
        emit({"phase": "tmajor_turns", "at": at,
              "shape": {"b": b, "l": l, "h": h, "d": d, "lk_true": lk,
                        "bias": "per-sample" if has_bias else None},
              "ms_in_turns": turns, "device_ms": dev,
              "sdpa_ms": time_ms(torch, sdpa), "sdpa_device_ms": sdpa_dev,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "sm90_over_sdpa_device": None if None in (dev["sm90"], sdpa_dev)
              else dev["sm90"] / sdpa_dev,
              "bound_share_of_sm90_device": None if dev["sm90"] is None
              else bound_ms / dev["sm90"],
              "bodies_max_abs_diff": (outs["sm90"] - outs["mma"]
                                      ).abs().max().item()})
        del qkv, bias, outs, q, k, v, mask
        torch.cuda.empty_cache()


def phase_bwd_turns(torch):
    """The backward's two bf16 bodies in turns (sm90, mma, mma, sm90; each
    :func:`time_ms`) at EVA01-g's and BEATs' token-major shapes and at the
    head-major shapes of KERNELS without a bias (CLIP, AST, 4873 keys):
    the Hopper body against the mma.sync one, whose C entries are called
    directly as a yardstick (the wrappers take it only for operands the
    copy engine cannot read), within one call on one card; at the
    token-major shapes each body also given the forward's lse ("_lse",
    as the train step calls it) beside the call that sweeps the keys for
    it (sm90, sm90_lse, mma, mma_lse, mma_lse, mma, sm90_lse, sm90); the
    profiler's device time per launch of each body's dQ and dK/dV
    kernels, SDPA's backward alone, and the largest difference between
    the bodies' gradients (and between each body's two calls)."""
    from vast_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16 = torch.bfloat16
    for spec in KERNELS:
        order = ("sm90", "mma", "mma", "sm90")
        if not spec.get("turns", True):
            continue
        if spec["layout"] == "tmajor_bwd":
            h, scale = spec["h"], spec["scale"]
            qkv, bias, o, lse, do = tmajor_bwd_inputs(torch, spec, bf16,
                                                      gen)
            fns = {body + tag: (lambda e=entry, s=given: fa._tmajor_bwd_launch(
                e, qkv, o, do, bias, h, 0, scale, s)) for body, entry in (
                ("sm90", "vast_tmajor_attention_bwd_sm90"),
                ("mma", "vast_tmajor_attention_bwd")) for tag, given in (
                ("", None), ("_lse", lse))}
            order = ("sm90", "sm90_lse", "mma", "mma_lse", "mma_lse", "mma",
                     "sm90_lse", "sm90")
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
        for body in order:
            turns[body].append(time_ms(torch, fns[body]))
        sdpa_ms, sdpa_note = sdpa_backward_ms(torch, *sdpa, scale)

        def max_diff(a, b):
            return max((x - y).abs().max().item()
                       for x, y in zip(outs[a], outs[b]))
        emit({"phase": "bwd_turns", "name": spec["name"], "at": spec["at"],
              "shape": {key: spec[key] for key in
                        ("b", "lq", "lk", "h", "d", "bias")}
              | {"views": spec.get("views")},
              "ms_in_turns": turns,
              "device_ms": {body: bwd_device_ms(torch, fn)
                            for body, fn in fns.items()},
              "sdpa_backward_ms": sdpa_ms, "sdpa_note": sdpa_note,
              "bodies_max_abs_diff": max_diff("sm90", "mma"),
              "lse_given_max_abs_diff": {
                  body: max_diff(body, body + "_lse")
                  for body in ("sm90", "mma") if body + "_lse" in outs}})
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
        inputs=[], read_bytes=qkv_bytes(q, k, v, lk), v=v, p_roundings=2,
        run=lambda: kernel(x, heads=h, lk_true=lk),
        plain=lambda: plain(x, heads=h, lk_true=lk),
        library=lambda: F.scaled_dot_product_attention(
            q, k[:, :, :lk], v[:, :, :lk], scale=1.0),
        as_out=lambda o: o.transpose(1, 2).reshape(b, lq, h * d))


def probe_bound(torch, device_name, q, k, v, kend):
    """The bound of one forward over (B, H, L, D) views, keys masked from
    ``kend``: q and k's and v's first kend keys read, the output written,
    4 B H L kend D operations."""
    b, h, l, d = q.shape
    return bound(torch, device_name,
                 qkv_bytes(q, k, v, kend) + b * l * h * d * 2,
                 4.0 * b * h * l * kend * d, torch.bfloat16)


def probe_turns(torch, tv, inputs, heads, lk, device_name):
    """The layouts' forwards in turns (cur, dma, sect, sect, dma, cur,
    cur, dma, sect; each :func:`time_ms`) at the probe's shape and at
    EVA's slice shape (B 64, L 257, no mask: the probe's first rows), so
    that cur against sect is the layout alone (one body) and
    cur against dma the streaming ring against the resident strip, within
    one call on one card; at the probe's shape cur and sect also as four
    launches of 64 batch rows on views of the same tensors (the same
    addresses, shorter launches: "cur_4x64", "sect_4x64"). Each one's
    device time per call by the profiler (:func:`device_ms` times the
    launches a call; None if not measured), SDPA's events and device time
    per call on the same q, k, v views over the first kend keys, the
    bound, and each variant's device time over SDPA's and the bound's
    share of it."""
    import torch.nn.functional as F

    from vast_tpu_torch.ops import flash_attention as fa

    def quarters(fn, x, lk_true):
        return lambda: [fn(x[i:i + tv.B // 4], heads=heads, lk_true=lk_true)
                        for i in range(0, tv.B, tv.B // 4)]

    for b, l, lk_true in ((tv.B, tv.LP, lk), (64, 257, 0)):
        fused = inputs["fused"][:b, :l].contiguous()
        sect = inputs["sect"][:b, :l].contiguous()
        fns = {"cur": lambda: fa.self_attention_tmajor(
                   fused, heads=heads, lk_true=lk_true),
               "dma": lambda: tv.attention_dma(fused, heads=heads,
                                               lk_true=lk_true),
               "sect": lambda: tv.attention_sect(sect, heads=heads,
                                                 lk_true=lk_true)}
        order = ["cur", "dma", "sect", "sect", "dma", "cur", "cur", "dma",
                 "sect"]
        if (b, l) == (tv.B, tv.LP):
            fns["cur_4x64"] = quarters(fa.self_attention_tmajor, fused,
                                       lk_true)
            fns["sect_4x64"] = quarters(tv.attention_sect, sect, lk_true)
            order += ["cur_4x64", "sect_4x64", "sect_4x64", "cur_4x64"]
        turns = {k: [] for k in fns}
        for k in order:
            turns[k].append(time_ms(torch, fns[k]))
        kend = lk_true or l
        q, k, v = tv.qkv_views(fused, heads)

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k[:, :, :kend], v[:, :, :kend], scale=1.0)

        # per launch (robust to a session that records only some launches),
        # times the launches a call
        dev = {name: device_ms(torch, fn) for name, fn in fns.items()}
        for name in ("cur_4x64", "sect_4x64"):
            if dev.get(name) is not None:
                dev[name] *= 4
        sdpa_dev = call_device_ms(torch, sdpa)
        bound_ms, bound_by = probe_bound(torch, device_name, q, k, v, kend)
        emit({"phase": "tmajor_variants_turns", "b": b, "l": l,
              "lk_true": lk_true, "ms_in_turns": turns, "device_ms": dev,
              "sdpa_ms": time_ms(torch, sdpa), "sdpa_device_ms": sdpa_dev,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "sect_over_cur_device": None if None in (
                  dev["sect"], dev["cur"]) else dev["sect"] / dev["cur"],
              "over_sdpa_device": {
                  name: None if None in (t, sdpa_dev) else t / sdpa_dev
                  for name, t in dev.items()},
              "bound_share_of_device": {
                  name: None if t is None else bound_ms / t
                  for name, t in dev.items()}})
        del fused, sect, q, k, v
        torch.cuda.empty_cache()


def strip_turns(torch, tv, inputs, heads, lk, device_name):
    """attention_dma's two bf16 bodies in turns (sm90, mma, mma, sm90;
    each :func:`time_ms`) at the probe's shape and EVA's: the resident
    strip against attention_fwd_tma_kernel (mma.sync fed by the copy
    engine), both through their C entries, the latter a yardstick only
    (the wrapper takes it for fp32 and longer keys); the profiler's device
    time per launch of each, the bound's share of it and the largest
    difference between the two outputs."""
    for b, l, lk_true in ((tv.B, tv.LP, lk), (64, 257, 0)):
        fused = inputs["fused"][:b, :l].contiguous()
        fns = {body: (lambda e=entry: tv._launch(e, fused, heads, lk_true))
               for body, entry in (("sm90", tv.DMA_SM90),
                                   ("mma", tv.DMA_MMA))}
        outs = {body: fn().float() for body, fn in fns.items()}
        turns = {body: [] for body in fns}
        for body in ("sm90", "mma", "mma", "sm90"):
            turns[body].append(time_ms(torch, fns[body]))
        dev = {body: device_ms(torch, fn) for body, fn in fns.items()}
        q, k, v = tv.qkv_views(fused, heads)
        bound_ms, bound_by = probe_bound(torch, device_name, q, k, v,
                                         lk_true or l)
        emit({"phase": "strip_turns", "b": b, "l": l, "lk_true": lk_true,
              "ms_in_turns": turns, "device_ms": dev, "bound_ms": bound_ms,
              "bound_by": bound_by,
              "bound_share_of_device": {
                  body: None if t is None else bound_ms / t
                  for body, t in dev.items()},
              "bodies_max_abs_diff": (outs["sm90"] - outs["mma"]
                                      ).abs().max().item()})
        del fused, outs, q, k, v
        torch.cuda.empty_cache()


def phase_tmajor_variants(torch, device_name):
    """The port's layout probe at its full shape: its ``run`` with the
    launch counters zeroed just before and read just after (one launch
    per wrapper call: its dma and sect kernels, each on its Hopper body,
    cur's and pad128's token-major forward and backward), then per
    variant the bound and SDPA's time, the layouts in turns
    (:func:`probe_turns`), the resident strip against the mma.sync body
    (:func:`strip_turns`), then the rows of its two kernels (bf16 and
    fp32, against their plain versions and against cur, with the
    profiler's device time). Returns those rows and the run's
    launches."""
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
        # every bf16 call of the two at the probe's shape on their Hopper
        # bodies: the resident strip, the shared forward body
        "attention_dma_sm90": calls["dma"]["fwd"],
        "attention_sect_sm90": calls["sect"]["fwd"],
        "tmajor_attention_fwd": calls["cur"]["fwd"] + calls["pad128"]["fwd"],
        "tmajor_attention_bwd": calls["cur"]["bwd"] + calls["pad128"]["bwd"],
        # both layouts' forwards and backwards take the Hopper bodies, and
        # each backward gets its forward's lse
        "tmajor_attention_fwd_sm90": calls["cur"]["fwd"]
        + calls["pad128"]["fwd"],
        "tmajor_attention_bwd_sm90": calls["cur"]["bwd"]
        + calls["pad128"]["bwd"],
        "tmajor_attention_bwd_lse": calls["cur"]["bwd"]
        + calls["pad128"]["bwd"]}
    check(launches == want, f"probe launches {launches} != one per call "
          f"{want}")

    for rec in records:
        layout = {"cur": "fused", "dma": "fused"}.get(rec["variant"],
                                                      rec["variant"])
        x = inputs[layout]
        q, k, v = tv.qkv_views(x, heads, section_major=layout == "sect")
        bound_ms, bound_by = probe_bound(torch, device_name, q, k, v, lk)
        sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k[:, :, :lk], v[:, :, :lk], scale=1.0))
        emit({"phase": "tmajor_variants_summary"} | rec
             | {"bound_ms": bound_ms, "bound_by": bound_by,
                "sdpa_ms": sdpa_ms})
    probe_turns(torch, tv, inputs, heads, lk, device_name)
    strip_turns(torch, tv, inputs, heads, lk, device_name)

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


def tiny_batch(np, rs, mask_tail=False, distinct=False, subtitle=False):
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
    batch = {"vision_frames": (frames * level[:, None, None, None, None]
                               ).astype(np.uint8),
             # one 64-frame clip: the training clip choice has one option
             "audio_waveforms": (rs.randn(3, 63 * 160 + 400) * 3000
                                 * (4 * level if distinct else level)[:, None]
                                 ).astype(np.float32),
             "caption_tokens": rs.randint(106, 170, (3, 12)).astype(np.int32),
             "caption_attention_mask": mask}
    if subtitle:                     # 12 tokens, the last 4 of one padding
        sub_mask = np.ones((3, 12), np.int32)
        sub_mask[1, 8:] = 0
        batch |= {"subtitle_tokens": rs.randint(106, 170, (3, 12)
                                                ).astype(np.int32),
                  "subtitle_attention_mask": sub_mask}
    return batch


def tiny_features(torch, np, config, launched_want, distinct=False,
                  subtask="tva"):
    """ret%``subtask`` features of ``config``'s model, seeded weights, on
    the GPU (kernels) against the CPU (plain versions); the models."""
    from vast_tpu_torch.convert.from_jax import init_random_
    from vast_tpu_torch.models.vast import VASTModel
    from vast_tpu_torch.ops import flash_attention as fa

    cfg = config()
    cpu = init_random_(VASTModel(cfg, device="cpu"),
                       torch.Generator().manual_seed(SEED))
    gpu = VASTModel(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = tiny_batch(np, np.random.RandomState(SEED), distinct=distinct,
                       subtitle="s" in subtask)
    outs, launched = [], {}
    with torch.inference_mode():
        for model in (cpu, gpu):
            before = dict(fa.LAUNCHES)
            tb = {k: torch.from_numpy(v).to(model.device)
                  for k, v in batch.items()}
            outs.append(model(tb, f"ret%{subtask}"))
            launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    want = {k: launched_want.get(k, 0) for k in fa.LAUNCHES}
    check(launched == want, f"tiny features launches {launched} != {want}")
    row = {"tolerance_rel": 1e-4,
           "tolerance_reason": "fp32 on both sides (TF32 off), other "
                               "summation orders through 2+2+2 layers",
           "launches": launched}
    for key in ("feat_t", f"feat_cond_{subtask}",
                f"condition_feats_{subtask}"):
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
         "tmajor_attention_bwd": 2, "tmajor_attention_bwd_bias": 2,
         # fp32: the CUDA-core bodies, the forward's lse handed over
         "tmajor_attention_bwd_lse": 4})
    row["ret_tvas"] = tiny_tvas(torch, np)
    emit({"phase": "tiny"} | row)


def tiny_tvas(torch, np):
    """ret%tvas, the subtitle stream's features and the ITC + ITM losses
    (injected negatives), on the GPU against the CPU. The subtitle's
    70-token BERT pass takes the plain route: the kernels launched are
    EVA's and BEATs' (2 + 2 forwards a pass)."""
    from vast_tpu_torch.models.vast import VASTModel

    row, _, _ = tiny_features(
        torch, np, tiny_config,
        {"tmajor_attention_fwd": 2, "tmajor_attention_fwd_bias": 2},
        subtask="tvas")
    # the losses from tiny_train_inputs' weights (temperature 0.07,
    # LayerNorm gains near 1), where fp32 on two devices agrees
    cpu, batch = tiny_train_inputs(torch, np)
    gpu = VASTModel(cpu.cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch |= tiny_batch(np, np.random.RandomState(SEED + 1), mask_tail=True,
                        subtitle=True)
    losses = []
    with torch.no_grad():
        for model in (cpu, gpu):
            tb = {k: torch.from_numpy(v).to(model.device)
                  for k, v in batch.items()}
            losses.append({k: v.item() for k, v in
                           model(tb, "ret%tvas", compute_loss=True).items()})
    check(losses[0].keys() == {"loss_itc", "loss_itm"}, f"{losses[0]}")
    for k in losses[0]:
        rel = abs(losses[1][k] - losses[0][k]) / abs(losses[0][k])
        check(math.isfinite(rel) and rel <= 1e-4,
              f"tiny ret%tvas {k}: relative error {rel}")
        row[f"{k}_rel_err"] = rel
    return row | {"losses_cpu": losses[0], "losses_gpu": losses[1]}


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


def tiny_step(torch, model, batch, task="ret%tva"):
    """One train step of ``task`` for ``model`` on the numpy ``batch``;
    its metrics as floats. Gradients stay in ``.grad``, parameters are
    updated."""
    from vast_tpu_torch.training.optimizer import build_optimizer
    from vast_tpu_torch.training.step import (create_train_state,
                                              make_train_step)

    opt, _ = build_optimizer(
        model, TINY_RUN_CFG,
        {"vision_encoder_type": model.cfg.vision_encoder_type}, 20)
    step = make_train_step(model, opt, task)
    tb = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
    _, m = step(create_train_state(model, opt), tb,
                torch.Generator().manual_seed(SEED))
    return {k: v.item() for k, v in m.items()}


# parameters whose gradient is rounding noise on both sides: softmax
# ignores a bias added to every key alike (CLIP packs its key bias into
# the middle third of in_proj_bias)
KEY_BIASES = ("k_proj.bias", "self.key.bias", "attention.linears.1.bias")


def tiny_train_step(torch, np, config, launches_want, distinct=False,
                    task="ret%tva", inputs=None):
    """One train step of ``task`` for a tiny model under the 'attn' policy
    on the GPU (kernels) and on the CPU (plain versions), from the same
    weights and batch (``inputs``, else :func:`tiny_train_inputs`);
    exactly ``launches_want`` on the GPU, nothing else."""
    from vast_tpu_torch.models.vast import VASTModel
    from vast_tpu_torch.ops import flash_attention as fa

    cpu, batch = inputs or tiny_train_inputs(torch, np, config=config,
                                             distinct=distinct)
    gpu = VASTModel(cpu.cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    metrics, launched = [], {}
    for model in (cpu, gpu):
        before = dict(fa.LAUNCHES)
        metrics.append(tiny_step(torch, model, batch, task))
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


def tiny_tokens(np, rs, length, pad_row, pad_from):
    """Three rows of [CLS] and tiny-vocabulary ids, one row padded."""
    ids = rs.randint(106, 170, (3, length)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((3, length), np.int32)
    ids[pad_row, pad_from:] = mask[pad_row, pad_from:] = 0
    return ids, mask


def tiny_masked(np, rs, ids, mask):
    """Masked tokens and labels by mask_tokens' rules, drawn on the host:
    a GPU's generator draws other positions than a CPU's, so the GPU-CPU
    comparison injects them (the ``*_masked_*`` keys)."""
    sel = (rs.rand(*ids.shape) < 0.6) & (mask > 0)
    sel[:, 0] = False
    sel[np.arange(len(ids)), mask.sum(1) - 1] = True
    kind = rs.rand(*ids.shape)
    masked = np.where(sel & (kind < 0.8), 103, ids)
    masked = np.where(sel & (kind >= 0.9), rs.randint(106, 170, ids.shape),
                      masked)
    return masked.astype(np.int32), np.where(sel, ids, -100).astype(np.int32)


def tiny_cap_qa_inputs(torch, np):
    """:func:`tiny_train_inputs`' model and batch with a subtitle, a
    question (one row padded), an answer (one row padded) and injected
    masks of the caption and the answer."""
    cpu, batch = tiny_train_inputs(torch, np)
    batch |= tiny_batch(np, np.random.RandomState(SEED + 1), mask_tail=True,
                        subtitle=True)
    rs = np.random.RandomState(SEED + 4)
    batch["caption_tokens"][:, 0] = 101
    q, qm = tiny_tokens(np, rs, 12, 1, 7)
    a, am = tiny_tokens(np, rs, 6, 2, 4)
    batch |= {"question_tokens": q, "question_attention_mask": qm,
              "answer_tokens": a, "answer_attention_mask": am}
    for key in ("caption", "answer"):
        batch[f"{key}_masked_tokens"], batch[f"{key}_masked_labels"] = \
            tiny_masked(np, rs, batch[f"{key}_tokens"],
                        batch[f"{key}_attention_mask"])
    return cpu, batch


def tiny_qa_prompt(np):
    """Three questions of 6 tokens (two rows padded) and BOS."""
    ids, mask = tiny_tokens(np, np.random.RandomState(SEED + 5), 6, 1, 3)
    ids[2, 5:] = mask[2, 5:] = 0
    ones = np.ones((3, 1), np.int32)
    return (np.concatenate([ids, 101 * ones], 1),
            np.concatenate([mask, ones], 1))


def tiny_decode(torch, np, model, batch):
    """On ``model``: the condition sequences of cap%tvas, the logits of a
    padded QA prompt's prefill and of three teacher-forced 2-token windows
    over the cache, and the tokens of greedy and beam-3 generation for
    captions (length penalty 0.6) and the QA prompts (1.0)."""
    from vast_tpu_torch.models.bert import init_cache
    from vast_tpu_torch.models.generation import (GenerationConfig,
                                                  _prefill_mask, generate)

    dev = model.device
    enc = model.multimodal_encoder
    prompt, pmask = (torch.from_numpy(x).to(dev) for x in tiny_qa_prompt(np))
    with torch.inference_mode():
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        cond = model(tb, "cap%tvas")["condition_feats_tvas"]
        b, p = prompt.shape
        total = p + 4
        m3 = torch.nn.functional.pad(_prefill_mask(pmask), (0, total - p))
        kv = enc.precompute_cross_kv(cond)
        logits, cache = enc(prompt, cache=init_cache(enc.cfg, b, total,
                                                     device=dev),
                            cache_index=0, cross_kv=kv, decode_self_mask=m3)
        dec_mask = torch.cat([pmask, torch.ones_like(pmask[:, :total - p])],
                             dim=1)
        out = {"prefill": logits.cpu()}
        rs = np.random.RandomState(SEED + 6)
        for i in range(3):
            w = torch.from_numpy(rs.randint(106, 170, (b, 2))).to(dev)
            logits, cache = enc(w, cache=cache, cache_index=p - 1 + i,
                                cache_mask=dec_mask, cross_kv=kv)
            out[f"window_{i}"] = logits.cpu()
        for name, kw, qa in (
                ("greedy", {}, False),
                ("beam3_lp0.6", dict(num_beams=3, length_penalty=0.6), False),
                ("qa_greedy", {}, True),
                ("qa_beam3_lp1.0", dict(num_beams=3, length_penalty=1.0),
                 True)):
            extra = dict(prompt_ids=prompt, prompt_mask=pmask) if qa else {}
            out[name] = generate(model, cond, GenerationConfig(
                max_new_tokens=8, **kw), **extra).cpu()
    return out


TINY_DECODE_TOKENS = ("greedy", "beam3_lp0.6", "qa_greedy", "qa_beam3_lp1.0")


TINY_STEP_LAUNCHES = {"tmajor_attention_fwd": 2, "tmajor_attention_fwd_bias": 2,
                      "tmajor_attention_bwd": 2,
                      "tmajor_attention_bwd_bias": 2,
                      # fp32: the CUDA-core bodies, the lse handed over
                      "tmajor_attention_bwd_lse": 4}


def tiny_cap_qa_step(torch, np, task):
    """``task``'s losses (injected masks), every gradient and one train
    step of the tiny model under 'attn', the GPU against the CPU."""
    return tiny_train_step(torch, np, tiny_config, TINY_STEP_LAUNCHES,
                           task=task, inputs=tiny_cap_qa_inputs(torch, np))


def tiny_cap_qa_decode(torch, np):
    """:func:`tiny_decode` on the GPU against the CPU, from the same
    weights: logits within 1e-4 of their largest, every token equal, and
    no launch but the condition's EVA and BEATs forwards (BERT's
    attentions take the plain route). The matrices are drawn from N(0,
    0.2) here: at N(0, 0.02) the condition barely reaches the logits and
    every row and beam decodes alike. fp32 against fp64 on the CPU reads
    within 8e-7 of the largest logit there, every token equal."""
    from vast_tpu_torch.models.vast import VASTModel
    from vast_tpu_torch.ops import flash_attention as fa

    cpu, batch = tiny_cap_qa_inputs(torch, np)
    with torch.no_grad():
        for p in cpu.parameters():
            if p.dim() >= 2:
                p.mul_(10.0)
    gpu = VASTModel(cpu.cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    ref = tiny_decode(torch, np, cpu, batch)
    before = dict(fa.LAUNCHES)
    got = tiny_decode(torch, np, gpu, batch)
    launched = {k: v - before[k] for k, v in fa.LAUNCHES.items()
                if v != before[k]}
    want = {"tmajor_attention_fwd": 2, "tmajor_attention_fwd_bias": 2}
    check(launched == want, f"tiny decode launches {launched} != {want}")
    errs = {}
    for k, v in ref.items():
        if k in TINY_DECODE_TOKENS:
            check(torch.equal(got[k], v),
                  f"tiny {k} tokens: GPU {got[k].tolist()} != CPU "
                  f"{v.tolist()}")
            continue
        errs[k] = ((got[k] - v).abs().max() / v.abs().max()).item()
        check(math.isfinite(errs[k]) and errs[k] <= 1e-4,
              f"tiny decode {k} logits: relative error {errs[k]}")
    return {"logits_rel_err": errs, "tolerance_rel": 1e-4,
            "launches": launched,
            "tokens": {k: ref[k].tolist() for k in TINY_DECODE_TOKENS}}


def phase_tiny_cap_qa(torch, np):
    """Captioning and QA on a tiny fp32 model, the GPU (kernels) against
    the same weights on the CPU (plain versions): cap%tvas and qa%tvas
    losses with injected masks, every gradient and one train step; the
    logits of a prefill and of teacher-forced decode windows; and the
    tokens of greedy and beam-3 generation for captions and padded QA
    prompts, which must be equal."""
    emit({"phase": "tiny_cap_qa",
          "cap%tvas": tiny_cap_qa_step(torch, np, "cap%tvas"),
          "qa%tvas": tiny_cap_qa_step(torch, np, "qa%tvas"),
          "decode": tiny_cap_qa_decode(torch, np)})


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
    """Counts each key's launches inside the model's vision and audio
    towers while active (the methods are wrapped on the instance): a dict
    per tower of the keys launched there."""

    def __init__(self, fa, model):
        self.fa, self.model = fa, model
        self.counts = {"vision": {}, "audio": {}}

    def _wrap(self, tower, fn):
        def run(*args, **kwargs):
            before = dict(self.fa.LAUNCHES)
            out = fn(*args, **kwargs)
            counts = self.counts[tower]
            for k, v in self.fa.LAUNCHES.items():
                if v != before[k]:
                    counts[k] = counts.get(k, 0) + v - before[k]
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


class WindowLaunches:
    """Counts the window kernels' launches by head count while active
    (``ops.window_attention``'s forward launch and backward are wrapped in
    their module): {"fwd": {heads: launches}, "bwd": {heads: launches}}.
    Video Swin-B's four stages have 4, 8, 16 and 32 heads, so the heads
    name the stage."""

    def __init__(self):
        from vast_tpu_torch.ops import window_attention as wa

        self.wa, self.saved = wa, None
        self.counts = {"fwd": {}, "bwd": {}}

    def _wrap(self, kind, fn):
        def run(q, *args, **kwargs):
            out = fn(q, *args, **kwargs)
            tally = self.counts[kind]
            tally[q.shape[1]] = tally.get(q.shape[1], 0) + 1
            return out
        return run

    def __enter__(self):
        wa = self.wa
        self.saved = wa._window_fwd_launch, wa.window_attention_bwd
        wa._window_fwd_launch = self._wrap("fwd", self.saved[0])
        wa.window_attention_bwd = self._wrap("bwd", self.saved[1])
        return self.counts

    def __exit__(self, *exc):
        self.wa._window_fwd_launch, self.wa.window_attention_bwd = self.saved


def run_slice(torch, np, phase, cfg, top_k, resolution, cond_tokens,
              runs=RUNS, stages=True):
    """``evaluate_ret`` over 16 synthetic clips, bf16 random weights: the
    counted and timed runs (``runs`` of them after a warm-up), stage times
    (a separate run, where ``stages``) and output checks. Returns the
    emitted row's fields, the launches of the counted run and those by
    stage (vision, audio, rerank: a dict each of the keys launched
    there), the window kernels' launches by head count (WindowLaunches)
    and the model."""
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
    with TowerLaunches(fa, model) as by_stage, \
            WindowLaunches() as windows:
        zero_launches(fa)
        log, wall = timed_run()
        launches = dict(fa.LAUNCHES)
    rest = {k: v - by_stage["vision"].get(k, 0) - by_stage["audio"].get(k, 0)
            for k, v in launches.items()}
    by_stage["rerank"] = {k: v for k, v in rest.items() if v}
    peak_mem = torch.cuda.max_memory_allocated()
    walls = [wall] + [timed_run()[1] for _ in range(runs - 1)]

    timings = {}                     # stage times, from a separate run
    if stages:
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
           "launches_by_stage": by_stage,
           "window_launches_by_heads": windows, "metrics": log}
    return row, launches, by_stage, windows, model, batches, run_cfg


def phase_slice(torch, np):
    from vast_tpu_torch.models.vast import VASTConfig

    row, launches, _, _, model, batches, run_cfg = run_slice(
        torch, np, "slice", VASTConfig(dtype=torch.bfloat16), TOP_K, 224,
        COND_TOKENS)
    n_batches = len(batches)
    want = {"tmajor_attention_fwd": 40 * n_batches,
            "tmajor_attention_fwd_bias": 12 * n_batches,
            # every one through the Hopper body
            "tmajor_attention_fwd_sm90": 52 * n_batches}
    got = {k: launches[k] for k in want}
    check(got == want, f"launches {got} != {want} (40 per EVA forward, 12 "
          f"per BEATs forward, none from BERT, all on the Hopper body)")
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

    row, launches, by_stage, _, model, batches, _ = run_slice(
        torch, np, "slice_clip_ast", VASTConfig(dtype=torch.bfloat16, **CA),
        CA_TOP_K, 336, CA_COND_TOKENS)
    # every head-major forward through the Hopper body
    want = {k: 0 for k in launches} | {"flash_attention_fwd": 120,
                                       "flash_attention_fwd_sm90": 120}
    fwd = {s: c.get("flash_attention_fwd", 0) for s, c in by_stage.items()}
    check(launches == want and fwd == {"vision": 48, "audio": 24,
                                       "rerank": 48},
          f"launches {launches}, by stage {by_stage}: want {want} and "
          f"48 / 24 / 48")
    emit(row)
    del model, batches
    return launches, fwd


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


def run_train(torch, np, phase, cfg_kw, resolution, launches_per_step,
              blocks=TRAIN_RUNS, gain_offset=0.0, warmup_ratio=0.1):
    """A train program of bench.py:367-400: fp32 parameters, bf16
    compute, 'attn' checkpointing, AdamW with bf16 moments; one warm-up
    step, ``blocks`` timed blocks of five unsynchronised steps, exact
    launch counts per step over the first block, then one profiled step.
    In that block the head-major lse forward's launches are also counted
    by tower, the backward's by query length and the window kernels' by
    head count (WindowLaunches). ``gain_offset`` is added
    to every LayerNorm gain after the seeded init (near 0 from N(0,
    0.02), every feature near one point and no loss moves);
    ``warmup_ratio`` of the 1000-step schedule (0: the learning rate at
    its full value from the first step). The batch's
    deterministic loss (no dropout, fixed ITM negatives: each clip's
    neighbour) is read before the warm-up step and after the last block;
    the row says whether it fell."""
    from vast_tpu_torch.convert.from_jax import init_random_
    from vast_tpu_torch.models.vast import VASTConfig, VASTModel
    from vast_tpu_torch.ops import flash_attention as fa
    from vast_tpu_torch.training import optimizer as optim_mod
    from vast_tpu_torch.training.optimizer import (build_optimizer,
                                                   global_norm)
    from vast_tpu_torch.training.step import (create_train_state,
                                              make_train_step)

    # one launch of the optimizer's kernel a step, over every tensor
    launches_per_step = {"multi_tensor_adam": 1} | launches_per_step
    t0 = time.perf_counter()
    cfg = VASTConfig(dtype=torch.bfloat16, param_dtype=torch.float32,
                     checkpointing=True, remat_policy="attn", **cfg_kw)
    model = VASTModel(cfg)                       # device None -> the GPU
    init_random_(model, torch.Generator(device="cuda").manual_seed(SEED))
    if gain_offset:
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.LayerNorm):
                    m.weight.add_(gain_offset)
    run_cfg = {"learning_rate": 1e-4, "clip_lr": 5e-7,
               "warmup_ratio": warmup_ratio,
               "adam_mu_dtype": "bfloat16", "adam_nu_dtype": "bfloat16"}
    opt, labels = build_optimizer(
        model, run_cfg, {"vision_encoder_type": cfg.vision_encoder_type},
        1000)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, "ret%tva")
    batch = train_batch(torch, np, resolution)
    gen = torch.Generator().manual_seed(SEED)
    n_params = sum(p.numel() for p in model.parameters())
    neighbour = torch.roll(torch.arange(BATCH, device="cuda"), 1)[None]
    fixed = batch | {"itm_neg_cond_idx": neighbour,
                     "itm_neg_text_idx": neighbour}

    def fixed_loss():
        with torch.no_grad():
            out = model(fixed, "ret%tva", compute_loss=True)
        return sum(v.float() for v in out.values()).item()

    loss_before = fixed_loss()
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
    with TowerLaunches(fa, model) as by_tower, \
            WindowLaunches() as windows:
        fa.flash_attention_bwd = tallied_bwd
        zero_launches(fa)
        zero_launches(optim_mod)
        block()
        launches = dict(fa.LAUNCHES) | optim_mod.LAUNCHES
        fa.flash_attention_bwd = bwd
    lse_by_tower = {t: c.get("flash_attention_fwd_lse", 0)
                    for t, c in by_tower.items()}
    for _ in range(blocks - 1):
        block()
    losses = [{k: v.item() for k, v in m.items()} for m in metrics]
    peak_mem = torch.cuda.max_memory_allocated()

    want = {k: launches_per_step.get(k, 0) * TRAIN_STEPS for k in launches}
    check(launches == want, f"{phase} launches {launches} != {want} (per "
          f"step {launches_per_step}: the forward is not re-run in the "
          f"'attn' recompute)")
    check(opt.last_counts == {"tensors": len(opt.params), "launches": 1},
          f"{phase}: the optimizer's kernel updated {opt.last_counts} of "
          f"{len(opt.params)} tensors")
    for row in losses:
        for k, v in row.items():
            check(math.isfinite(v), f"{phase} {k} = {v}")
    loss_after = fixed_loss()
    falls = loss_after < loss_before
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
          "window_launches_by_heads_per_step": {
              kind: {str(h): v // TRAIN_STEPS for h, v in c.items()}
              for kind, c in windows.items()},
          "warmup_ratio": warmup_ratio,
          "losses": losses, "fixed_batch_loss": [loss_before, loss_after],
          "loss_falls": falls,
          "layernorm_gain_offset": gain_offset,
          "grad_global_norm": grad_norm, "groups_moved": moved})
    profile_run(torch, phase + "_profile", lambda: step(state, batch, gen))
    return launches, lse_by_tower, bwd_by_lq, windows, falls


def phase_train(torch, np):
    """The flagship train step (bench.py:367-400): 40 EVA and 12 BEATs
    attention forwards and backwards per step, every one through the
    Hopper bodies, every backward given its forward's lse."""
    launches, _, _, _, _ = run_train(
        torch, np, "train", {}, 224,
        {"tmajor_attention_fwd": 40, "tmajor_attention_fwd_bias": 12,
         "tmajor_attention_bwd": 40, "tmajor_attention_bwd_bias": 12,
         # every forward and backward through the Hopper bodies, every
         # backward given its forward's lse
         "tmajor_attention_fwd_sm90": 40 + 12,
         "tmajor_attention_bwd_sm90": 40 + 12,
         "tmajor_attention_bwd_lse": 40 + 12})
    return launches


def phase_train_clip_ast(torch, np):
    """The CLIP-L/14-336 + AST train step: 24 CLIP and 12 AST lse forwards
    and backwards per step, all through the Hopper bodies (BERT's attention
    takes the plain route)."""
    launches, lse_by_tower, bwd_by_lq, _, _ = run_train(
        torch, np, "train_clip_ast", CA, 336,
        {"flash_attention_fwd_lse": 36, "flash_attention_fwd_sm90": 36,
         "flash_attention_bwd": 36, "flash_attention_bwd_sm90": 24 + 12})
    n = TRAIN_STEPS
    check(lse_by_tower == {"vision": 24 * n, "audio": 12 * n}
          and bwd_by_lq == {577: 24 * n, 257: 12 * n},
          f"lse forwards by tower {lse_by_tower} and backwards by query "
          f"length {bwd_by_lq} over {n} steps")
    return lse_by_tower, bwd_by_lq, launches["multi_tensor_adam"]


# the optimizer's kernel at the parameter sets of the benchmark's two
# configurations (benchmark/configs), with their run_cfg: fp32 parameters
# and moments, AdamW over six groups
ADAM_CONFIGS = ("vast_evaclip01g_beats", "vast_clipl336_ast")
ADAM_SOURCE = "vast_tpu_torch/csrc/multi_tensor_adam.cu"
ADAM_ULPS = 2        # the kernel against the per-tensor loop, each element
ADAM_FLOPS = 16      # fp32 operations an element of the AdamW update


def ulps(torch, got, want):
    """The largest distance between ``got`` and ``want`` (fp32 or bf16)
    in units in the last place of their dtype, a device scalar."""
    def ordered(x):
        bits, mask = ((torch.int16, 0x7FFF) if x.dtype == torch.bfloat16
                      else (torch.int32, 0x7FFFFFFF))
        i = x.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, -(i & mask), i)

    return (ordered(got) - ordered(want)).abs().max()


def ulp(torch, x):
    """The distance from each element of ``x`` to the next float of its
    dtype away from zero."""
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def adam_model(torch, name):
    """Benchmark configuration ``name``'s model on the card (fp32
    parameters, its own init), ``GroupedAdam`` from the configuration's
    run_cfg, and a seeded gradient for every parameter."""
    from vast_tpu_torch.models.vast import VASTConfig, VASTModel
    from vast_tpu_torch.training.optimizer import build_optimizer

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "benchmark", "configs",
                           f"{name}.json")) as f:
        cfg = json.load(f)
    m = {k: cfg[k] for k in ("vision_encoder_type", "audio_encoder_type",
                             "vision_resolution", "audio_melbins",
                             "audio_target_length", "contra_dim",
                             "itm_ratio", "max_vision_sample_num",
                             "max_caption_len", "beam_size")}
    m |= {"vision_cfg": cfg["vision"], "audio_cfg": cfg["audio"],
          "bert_cfg": cfg["bert"]}
    model = VASTModel(VASTConfig.from_model_cfg(
        m, dtype=torch.bfloat16, param_dtype=torch.float32), device="cuda")
    opt, _ = build_optimizer(model, cfg["run_cfg"], {
        "vision_encoder_type": cfg["vision_encoder_type"]}, 1000)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        for p in opt.params.values():
            p.grad = torch.randn(p.shape, device="cuda",
                                 generator=gen) * 1e-3
    return model, opt


def fused_adamw(torch, opt):
    """The library's fused AdamW over ``opt``'s tensors, one
    ``torch._fused_adamw_`` call a group (its LR and weight decay): a
    yardstick the port never calls. It updates mu as a lerp and decays
    the weight before the step, so its values are not compared."""
    from vast_tpu_torch.training.optimizer import EPS

    groups = {}
    for n, label in opt.labels.items():
        if n in opt.params:
            groups.setdefault(label, []).append(n)
    step = torch.tensor(float(opt.count), device="cuda")
    calls = []
    for label, names in groups.items():
        group = label.removesuffix("_nd")
        calls.append((
            [opt.params[n] for n in names],
            [opt.params[n].grad for n in names],
            [opt.mu[n] for n in names], [opt.nu[n] for n in names],
            [step] * len(names),
            dict(lr=opt.lr(group, opt.count), beta1=opt.b1, beta2=opt.b2,
                 weight_decay=(0.0 if label.endswith("_nd")
                               else opt.weight_decay),
                 eps=EPS, amsgrad=False, maximize=False)))

    @torch.no_grad()
    def run():
        for p, g, mu, nu, st, kw in calls:
            torch._fused_adamw_(p, g, mu, nu, [], st, **kw)

    return run


def phase_adam(torch, device_name):
    """The optimizer's kernel at both benchmark configurations' parameter
    sets: after two warm-up updates (the build, the tables), one update
    through the kernel with its launch counter zeroed just before (one
    launch, every trainable tensor), then the per-tensor loop on the CPU
    from the same state, tensor by tensor, element by element: moments
    within ADAM_ULPS of the kernel's, parameters within ADAM_ULPS of an
    ulp of the parameter plus an ulp of its step. Then
    times: the kernel's update by CUDA events (reps back to back, so the
    host's pass over the gradients hides behind the device's work where
    the device is slower) and the host's ms of a call; the kernel's device
    ms (profiler); the loop's; the library's fused AdamW over the same
    tensors; the bound, 28 bytes a parameter with fp32 moments."""
    from vast_tpu_torch.training import optimizer as optim_mod

    rows = {}
    for name in ADAM_CONFIGS:
        model, opt = adam_model(torch, name)
        params = opt.params
        for _ in range(2):
            opt.step()
        snap = {n: (p.detach().clone(), opt.mu[n].clone(),
                    opt.nu[n].clone()) for n, p in params.items()}
        zero_launches(optim_mod)
        opt.step()
        launches = optim_mod.LAUNCHES["multi_tensor_adam"]
        counts = dict(opt.last_counts)
        check(launches == 1 and counts == {"tensors": len(params),
                                           "launches": 1},
              f"adam {name}: {launches} launches, counts {counts} for "
              f"{len(params)} tensors")
        k = opt.count
        c1, c2 = 1.0 - opt.b1 ** k, 1.0 - opt.b2 ** k
        worst = dict.fromkeys(("param", "mu", "nu", "param_and_step"), 0)
        abs_err = 0.0
        with torch.no_grad():
            for n, p in params.items():
                card = (p, opt.mu[n], opt.nu[n])
                got = [t.cpu() for t in card]
                # the loop on the CPU: on the card it divides by a host
                # scalar as a product with its reciprocal, an ulp off
                cpu = [t.cpu() for t in snap.pop(n)]
                before = cpu[0].clone()
                opt.params[n], opt.mu[n], opt.nu[n] = cpu
                try:
                    opt._update_plain(n, p.grad.cpu(), None, k, c1, c2)
                finally:
                    opt.params[n], opt.mu[n], opt.nu[n] = card
                for key, a, b in zip(worst, got, cpu):
                    worst[key] = max(worst[key], ulps(torch, a, b).item())
                diff = (got[0] - cpu[0]).abs()
                abs_err = max(abs_err, diff.max().item())
                # the CPU's sqrt is not always correctly rounded (up to
                # 0.56 ulp), so its step may be an ulp off, which is many
                # ulps of a parameter near zero: the parameter's error in
                # units of (an ulp of it + an ulp of its step)
                worst["param_and_step"] = max(
                    worst["param_and_step"],
                    (diff / (ulp(torch, cpu[0])
                             + ulp(torch, cpu[0] - before))).max().item())
        check(max(worst["mu"], worst["nu"], worst["param_and_step"])
              <= ADAM_ULPS, f"adam {name}: kernel against the loop, ulps "
              f"{worst}")
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step()
            host.append((time.perf_counter() - t0) * 1e3)
        kernel_ms = time_ms(torch, opt.step, reps=5, rounds=5, warmup=2)
        dev = mean_device_ms([e for e in profiled_kernels(torch, opt.step, 5)
                              if "multi_tensor_adam" in e.key])

        @torch.no_grad()
        def plain():
            opt.count += 1
            k = opt.count
            c1, c2 = 1.0 - opt.b1 ** k, 1.0 - opt.b2 ** k
            for n, p in params.items():
                opt._update_plain(n, p.grad, None, k, c1, c2)

        plain_ms = time_ms(torch, plain, reps=1, rounds=3, warmup=1)
        library_note = ("torch._fused_adamw_, a call a group; mu as a "
                        "lerp, the weight decayed before the step")
        try:
            library = fused_adamw(torch, opt)
            library_ms = time_ms(torch, library, reps=5, rounds=5, warmup=2)
            library_dev = call_device_ms(torch, library, 5)
        except (AttributeError, RuntimeError, TypeError) as e:
            library_ms = library_dev = None
            library_note = f"not measured: {type(e).__name__}: {e}"
        n_params = sum(p.numel() for p in params.values())
        moment_bytes = (next(iter(opt.mu.values())).element_size()
                        + next(iter(opt.nu.values())).element_size())
        nbytes = n_params * (3 * 4 + 2 * moment_bytes)
        flops = n_params * ADAM_FLOPS
        bound_ms, bound_by = bound(torch, device_name, nbytes, flops,
                                   torch.float32)
        row = {"phase": "adam", "at": name, "params": n_params,
               "tensors": len(params), "chunks": opt._fused.n_chunks,
               "moments": str(next(iter(opt.mu.values())).dtype),
               "launches": launches, "counts": counts, "max_ulps": worst,
               "max_abs_err": abs_err, "kernel_ms": kernel_ms,
               "host_ms": statistics.median(host), "device_ms": dev,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_device_ms": library_dev,
               "library_note": library_note, "bytes": nbytes,
               "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": None if dev is None else bound_ms / dev}
        emit(row)
        rows[name] = row
        del model, opt, params
        torch.cuda.empty_cache()
    return rows


def adam_counts(opt):
    """The optimizer kernel's launches since they were zeroed, the
    tensors its last update gave the kernel and the trainable tensors."""
    from vast_tpu_torch.training import optimizer as optim_mod

    return {"kernel_launches": optim_mod.LAUNCHES["multi_tensor_adam"],
            "tensors": opt.last_counts["tensors"],
            "trainable": len(opt.params)}


def adam_rows(rows, launches_at):
    """The ``kernels`` entries of the optimizer's kernel: phase adam's
    ``rows`` by configuration, each with its launches on its path's
    counted run (``launches_at``: configuration -> (phase, launches))."""
    line = []
    for at, r in rows.items():
        path, launches = launches_at[at]
        line.append({
            "name": "multi_tensor_adam", "at": at, "route": "cuda",
            "source": ADAM_SOURCE, "replaces": None, "replaces_also": [],
            "path": path, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "body": "multi_tensor_adam_kernel", "device_ms": r["device_ms"],
            "device_ms_by_kernel": None, "launches_by_path": {}})
    return line


CLI_WORDS = ("a man woman dog cat is run walk play ball park red blue green "
             "car bike street water beach sing music guitar drum bird talk "
             "jump ride eat food table chair room house tree sky sun rain "
             "snow boy girl child people crowd two three with at near over "
             "under small big fast slow video audio").split()


def decoders():
    """Which host decoders this machine has: the repo's native runtime
    (its JPEG and FFmpeg paths), decord, the ffmpeg CLI and PIL."""
    import importlib.util
    import shutil

    out = {"ffmpeg": shutil.which("ffmpeg") is not None,
           "decord": importlib.util.find_spec("decord") is not None,
           "pil": importlib.util.find_spec("PIL") is not None}
    try:
        import runtime
        out["runtime"] = bool(runtime.available())
        out["runtime_media"] = bool(out["runtime"]
                                    and runtime.media_available())
    except ImportError as e:
        out["runtime"] = out["runtime_media"] = False
        out["runtime_error"] = str(e)
    return out


def write_msrvtt(np, root):
    """A synthetic MSR-VTT under ``root``/msrvtt: ret_train.json (32
    clips) and ret_test.json (16), each clip with a caption and a
    60-word subtitle from the tiny vocabulary; 16 JPEG frames a clip at
    MSR-VTT's 320 x 240 (smooth seeded noise) under videos/<id>/; a
    16 kHz mono wav of 10.3 s under audios/<id>.wav (1024 fbank frames:
    BEATs' whole input). For captioning and QA over the same clips
    (``write_cap_qa``): cap_train.json, cap_test.json and
    cap_test_coco.json, qa_train.json and qa_test.json."""
    import wave

    from PIL import Image

    rs = np.random.RandomState(SEED + 9)
    base = os.path.join(root, "msrvtt")
    for sub in ("annotations", "videos", "audios"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    annos = {"ret_train": [], "ret_test": []}
    n = CLI_TRAIN_CLIPS + CLI_TEST_CLIPS
    t = np.arange(164800) / 16000.0
    for i in range(n):
        vid = f"video{i}"
        split = "ret_train" if i < CLI_TRAIN_CLIPS else "ret_test"
        annos[split].append({
            "video_id": vid,
            "desc": " ".join(rs.choice(CLI_WORDS, 10)),
            "subtitle": " ".join(rs.choice(CLI_WORDS, 60))})
        frame_dir = os.path.join(base, "videos", vid)
        os.makedirs(frame_dir, exist_ok=True)
        for f in range(CLI_EVAL_FRAMES):
            small = (rs.rand(12, 16, 3) * 255).astype(np.uint8)
            Image.fromarray(small).resize((320, 240), Image.BILINEAR).save(
                os.path.join(frame_dir, f"{f:03d}.jpg"), quality=90)
        tone = (np.sin(2 * np.pi * (150 + 20 * i) * t) * 3000
                + rs.randn(t.size) * 300).astype(np.int16)
        with wave.open(os.path.join(base, "audios", vid + ".wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(tone.tobytes())
    annos |= write_cap_qa(np, annos["ret_train"], annos["ret_test"])
    for split, rows in annos.items():
        with open(os.path.join(base, "annotations", split + ".json"),
                  "w") as f:
            json.dump(rows, f)


CAP_REFS = 3                         # references a test clip in the annfile


def write_cap_qa(np, train, test):
    """The captioning and QA annotations of the clips of ``train`` and
    ``test`` (ret_*'s rows, with their subtitles): captions of 10 words,
    ``CAP_REFS`` references a test clip in COCO format (the first is the
    clip's caption), questions of 8 words and one-word answers, all from
    ``CLI_WORDS``."""
    rs = np.random.RandomState(SEED + 10)

    def words(n):
        return " ".join(rs.choice(CLI_WORDS, n))

    out = {"cap_train": [], "cap_test": [], "qa_train": [], "qa_test": []}
    coco = []
    for split, rows in (("train", train), ("test", test)):
        for r in rows:
            vid, sub = r["video_id"], r["subtitle"]
            refs = [words(10) for _ in range(CAP_REFS)]
            out[f"cap_{split}"].append({"video_id": vid, "desc": refs[0],
                                        "subtitle": sub})
            out[f"qa_{split}"].append({"video_id": vid,
                                       "question": words(8),
                                       "answer": str(rs.choice(CLI_WORDS)),
                                       "subtitle": sub})
            if split == "test":
                coco += [{"image_id": vid, "caption": c, "id": len(coco) + j}
                         for j, c in enumerate(refs)]
    out["cap_test_coco"] = {"annotations": coco}
    return out


def released_config(root, name, depth=None):
    """A copy under ``root`` of the released finetune config ``name`` with
    ``vision_format: video_frame`` (the JPEG frame directories of
    ``write_msrvtt``); its path. ``depth`` ({"vision", "audio", "bert"}
    layers): the towers cut to it at full width."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "vast_tpu", "configs", "finetune_cfg",
                           name)) as f:
        cfg = json.load(f)
    for d in cfg["data_cfg"]["train"] + cfg["data_cfg"]["val"]:
        d["vision_format"] = "video_frame"
    if depth:
        cfg["model_cfg"] |= {
            "vision_cfg": {"layers": depth["vision"]},
            "audio_cfg": {"encoder_layers": depth["audio"]},
            "bert_cfg": {"num_hidden_layers": depth["bert"]}}
        name = name.replace(".json", "-depth{vision}-{audio}-{bert}.json"
                            .format(**depth))
    path = os.path.join(root, name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def write_vocab(path, size=30522):
    """A vocab.txt of BERT-base's ``size`` ids: the built-in tiny
    vocabulary at its ids (the released special-token ids, the words of
    ``CLI_WORDS`` whole), then fillers ``w<id>``. Every id the model can
    generate then decodes to a word of its own, not to [UNK], and the
    tiny vocabulary's texts tokenize as before."""
    from vast_tpu_torch.data.tokenizer import tiny_tokenizer

    words = sorted(tiny_tokenizer().vocab, key=tiny_tokenizer().vocab.get)
    words += [f"w{i}" for i in range(len(words), size)]
    with open(path, "w") as f:
        f.write("\n".join(words) + "\n")


class msrvtt_data:
    """``write_msrvtt`` and ``write_vocab`` into a temporary directory,
    named by ``VAST_DATA`` and ``VAST_TPU_VOCAB`` while the context lasts;
    yields ``(root, seconds to write it)``. The directory goes at the
    end."""

    ENV = ("VAST_DATA", "VAST_TPU_VOCAB")

    def __init__(self, np):
        self.np = np

    def __enter__(self):
        import tempfile

        self.root = tempfile.mkdtemp(prefix="vast_cli_msrvtt_")
        self.old = {k: os.environ.get(k) for k in self.ENV}
        t0 = time.perf_counter()
        write_msrvtt(self.np, self.root)
        vocab = os.path.join(self.root, "vocab.txt")
        write_vocab(vocab)
        os.environ.update(VAST_DATA=self.root, VAST_TPU_VOCAB=vocab)
        return self.root, time.perf_counter() - t0

    def __exit__(self, *exc):
        import shutil

        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(self.root, ignore_errors=True)


class CliCounters:
    """Counts of the CLI run, hooked into the pipeline's module names:
    kernel launches per evaluation and per train step, the head-major
    forwards by (Lq, Lk), each evaluation's and save's seconds, each
    evaluation's seconds by stage, decode steps and generated tokens (not
    pad), the checkpoint's bytes, the step metrics, and one step under
    the profiler."""

    def __init__(self, torch, profile_step, profile_decode=None):
        from vast_tpu_torch.evaluation import evaluation_mm
        from vast_tpu_torch.models import generation
        from vast_tpu_torch.ops import attention
        from vast_tpu_torch.ops import flash_attention as fa
        from vast_tpu_torch.training import pipeline, saver

        self.torch, self.fa = torch, fa
        self.mods = {(pipeline, "evaluate_mm"), (pipeline, "make_train_step"),
                     (attention, "flash_attention"),
                     (saver.ModelSaver, "save"),
                     (generation, "_bert_step"), (evaluation_mm, "generate")}
        self.saved = {(m, n): getattr(m, n) for m, n in self.mods}
        self.evals, self.steps, self.saves, self.metrics = [], [], [], []
        self.tasks = []                  # the task string of each step
        self.step_s = []
        self.hmajor_shapes = {}
        self.decode_steps = self.generated = 0
        self.profile_step = profile_step
        # the phase name under which the first generate call is profiled
        self.profile_decode = profile_decode

    def _delta(self, fn):
        before = dict(self.fa.LAUNCHES)
        out = fn()
        return out, {k: v - before[k] for k, v in self.fa.LAUNCHES.items()
                     if v != before[k]}

    def __enter__(self):
        from vast_tpu_torch.evaluation import evaluation_mm
        from vast_tpu_torch.models import generation
        from vast_tpu_torch.ops import attention
        from vast_tpu_torch.training import pipeline, saver

        torch = self.torch
        evaluate, make = pipeline.evaluate_mm, pipeline.make_train_step
        flash, save = attention.flash_attention, saver.ModelSaver.save
        bert_step, generate = generation._bert_step, evaluation_mm.generate

        def counted_evaluate(*a, **k):
            stages = k.get("timings")
            stages = {} if stages is None else stages
            before = dict(stages)
            steps, tokens = self.decode_steps, self.generated
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, launched = self._delta(lambda: evaluate(*a, **k))
            torch.cuda.synchronize()
            self.evals.append({
                "step": a[4], "launches": launched,
                "seconds": time.perf_counter() - t0,
                "stage_s": {n: v - before.get(n, 0.0)
                            for n, v in stages.items()
                            if v != before.get(n)},
                "decode_steps": self.decode_steps - steps,
                "generated_tokens": self.generated - tokens})
            return out

        def counted_bert_step(*a, **k):
            self.decode_steps += 1
            return bert_step(*a, **k)

        def counted_generate(*a, **k):
            if self.profile_decode:
                res = []
                profile_run(torch, self.profile_decode,
                            lambda: res.append(generate(*a, **k)))
                self.profile_decode, toks = None, res[0]
            else:
                toks = generate(*a, **k)
            self.generated += int((toks != a[2].pad_id).sum())
            return toks

        def counted_make(*a, **k):
            step = make(*a, **k)
            task = a[2] if len(a) > 2 else k["task"]

            def run(state, batch, gen):
                self.tasks.append(task)
                res = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if len(self.steps) == self.profile_step:
                    profile_run(torch, "cli_ret_tvas_step_profile",
                                lambda: res.append(step(state, batch, gen)))
                    out, launched = res[0], {}
                else:
                    out, launched = self._delta(
                        lambda: step(state, batch, gen))
                torch.cuda.synchronize()
                self.step_s.append(time.perf_counter() - t0)
                self.steps.append(launched)
                self.metrics.append(out[1])
                return out
            return run

        def counted_flash(q, k, *a, **kw):
            key = (q.shape[2], k.shape[2])
            self.hmajor_shapes[key] = self.hmajor_shapes.get(key, 0) + 1
            return flash(q, k, *a, **kw)

        def timed_save(sv, state, step, *a, **k):
            t0 = time.perf_counter()
            save(sv, state, step, *a, **k)
            self.saves.append({
                "step": step, "seconds": time.perf_counter() - t0,
                "bytes": {kind: os.path.getsize(sv.path(kind, step))
                          for kind in ("model", "optimizer")}})

        pipeline.evaluate_mm, pipeline.make_train_step = (counted_evaluate,
                                                          counted_make)
        attention.flash_attention = counted_flash
        saver.ModelSaver.save = timed_save
        generation._bert_step = counted_bert_step
        evaluation_mm.generate = counted_generate
        return self

    def __exit__(self, *exc):
        for (m, n), fn in self.saved.items():
            setattr(m, n, fn)


def phase_cli_ret_tvas(torch, np, root, data_s):
    """``python -m vast_tpu_torch.run`` in-process through its ``main``:
    the released retrieval-msrvtt.json (ret%tvas; EVA01-g 40 layers,
    BEATs 12, BERT-base, random seeded weights) over the synthetic
    MSR-VTT-shaped set under ``root`` (``write_msrvtt``, which took
    ``data_s`` seconds). first_eval at step 0, 6 train steps (evaluations
    and saves after steps 4 and 6: valid_steps = 6 // 1 - 1 = 5), then
    ``--mode testing --checkpoint model_step_6.pt``, whose R@k must equal
    the training run's at step 6. Launch counts per evaluation (EVA 40 a
    batch of 8 clips x 16 frames, BEATs 12, the rerank's 4 calls x 12
    BERT layers of 640 queries over 4438 keys) and per train step (52
    forwards and 52 backwards on the Hopper bodies, each backward given
    its forward's lse); the saved model reloads with no key missing or
    unexpected and the optimizer file holds a moment per trainable
    tensor."""
    import shutil

    from vast_tpu_torch import run
    from vast_tpu_torch.ops import flash_attention as fa

    found = decoders()
    check(found["pil"], f"no decoder for the video_frame route: {found}")
    emit({"phase": "cli_ret_tvas_decoders", **found,
          "route": "video_frame",
          "why": "no ffmpeg CLI, no decord and no native media runtime "
                 "on this machine for video_rawvideo (mp4); PIL decodes "
                 "16-frame JPEG directories, vision_format video_frame in "
                 "a copy of the released config"
          if not (found["ffmpeg"] or found["decord"]
                  or found["runtime_media"]) else
          "one route for every machine: JPEG frame directories, decoded "
          "by PIL or the native runtime"})
    try:
        cfg_path = released_config(root, "retrieval-msrvtt.json")
        out_dir = os.path.join(root, "output")
        reduced = ["--train_batch_size", "8", "--test_batch_size", "8",
                   "--checkpointing", "true",
                   "--num_train_steps", str(CLI_STEPS),
                   "--valid_freq", "1", "--output_dir", out_dir]
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        with CliCounters(torch, profile_step=2) as cc:
            zero_launches(fa)
            t0 = time.perf_counter()
            state, logged = run.main(["--config", cfg_path] + reduced,
                                     timings=timings)
            train_wall = time.perf_counter() - t0
            launches = dict(fa.LAUNCHES)
        peak_mem = torch.cuda.max_memory_allocated()
        n_trainable = sum(p.requires_grad for p in state.model.parameters())
        losses = [{k: v.item() for k, v in m.items()} for m in cc.metrics]
        ckpt = os.path.join(out_dir, "ckpt", f"model_step_{CLI_STEPS}.pt")
        # the saved step's weights back into the model that saved them
        reload = run.load_checkpoint(state.model, ckpt)
        del state
        torch.cuda.empty_cache()

        opt_file = os.path.join(out_dir, "ckpt",
                                f"optimizer_step_{CLI_STEPS}.pt")
        saved_opt = torch.load(opt_file, map_location="cpu", mmap=True,
                               weights_only=True)
        n_mu, n_nu = (len(saved_opt["optimizer"][k]) for k in ("mu", "nu"))
        saved_step = saved_opt["step"]
        del saved_opt
        test_timings = {}
        with CliCounters(torch, profile_step=-1) as tc:
            t0 = time.perf_counter()
            tested = run.main(["--config", cfg_path, "--mode", "testing",
                               "--checkpoint", ckpt] + reduced,
                              timings=test_timings)
            test_wall = time.perf_counter() - t0
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(os.path.join(root, "output"), ignore_errors=True)

    # the losses: finite, ITC and ITM of ret%tvas at every step
    check(len(losses) == CLI_STEPS, f"{len(losses)} train steps")
    for row in losses:
        check(row.keys() == {"loss_itc", "loss_itm", "total_loss"}
              and all(math.isfinite(v) for v in row.values()),
              f"step losses {row}")
    # per evaluation: two batches of 8 clips x 16 frames; 4 rerank calls
    n_batches = CLI_TEST_CLIPS // 8
    rerank = CLI_RERANK_CALLS * 12
    want_eval = {"tmajor_attention_fwd": 40 * n_batches,
                 "tmajor_attention_fwd_bias": 12 * n_batches,
                 "tmajor_attention_fwd_sm90": 52 * n_batches,
                 "flash_attention_fwd": rerank,
                 "flash_attention_fwd_sm90": rerank}
    evals = cc.evals + tc.evals
    check(len(cc.evals) == 3 and [e["step"] for e in cc.evals]
          == [0, CLI_STEPS - 2, CLI_STEPS] and len(tc.evals) == 1,
          f"evaluations at {[e['step'] for e in evals]}")
    for e in evals:
        check(e["launches"] == want_eval,
              f"evaluation launches {e['launches']} != {want_eval}")
    want_shapes = {(TVAS_RERANK_TEXTS * TEXT_LEN, TVAS_COND_TOKENS):
                   rerank * len(cc.evals)}
    check(cc.hmajor_shapes == want_shapes and tc.hmajor_shapes ==
          {k: rerank for k in want_shapes},
          f"head-major forwards by (Lq, Lk) {cc.hmajor_shapes} (training "
          f"run), {tc.hmajor_shapes} (testing): want {rerank} an "
          f"evaluation at {next(iter(want_shapes))}")
    # per train step (the profiled one is counted in the total only)
    want_step = {"tmajor_attention_fwd": 40, "tmajor_attention_fwd_bias": 12,
                 "tmajor_attention_bwd": 40, "tmajor_attention_bwd_bias": 12,
                 "tmajor_attention_fwd_sm90": 52,
                 "tmajor_attention_bwd_sm90": 52,
                 "tmajor_attention_bwd_lse": 52}
    counted = [st for i, st in enumerate(cc.steps) if i != 2]
    for st in counted:
        check(st == want_step, f"train step launches {st} != {want_step}")
    want_total = {k: want_step.get(k, 0) * CLI_STEPS
                  + want_eval.get(k, 0) * len(cc.evals) for k in launches}
    check(launches == want_total,
          f"the training run's launches {launches} != {want_total}")
    # the checkpoint: every key reloads, a moment per trainable tensor
    check(not reload.missing_keys and not reload.unexpected_keys,
          f"reload of {ckpt}: {reload}")
    check(n_mu == n_nu == n_trainable and saved_step == CLI_STEPS,
          f"optimizer file: {n_mu} / {n_nu} moments, step {saved_step}; "
          f"{n_trainable} trainable tensors")
    # testing from the saved .pt reproduces the run's R@k at that step
    key = next(iter(tested))
    at_step = {name[len(key) + 1:]: hist[str(CLI_STEPS)]
               for name, hist in logged.items()}
    check(tested[key] == at_step,
          f"testing R@k {tested[key]} != training's at step {CLI_STEPS} "
          f"{at_step}")
    for part in tested[key].values():
        for k, v in part.items():
            if k.endswith(("_r1", "_ravg")):
                check(0.0 <= v <= 100.0, f"{k} = {v}")
    # steady state: the steps after the first (its one-off costs) but the
    # profiled one
    steady = [t for i, t in enumerate(cc.step_s) if i not in (0, 2)]
    eval_s = sum(e["seconds"] for e in cc.evals[1:])
    emit({"phase": "cli_ret_tvas", "config": "vast_tpu/configs/finetune_cfg/"
          "retrieval-msrvtt.json", "route": "video_frame",
          "reduced": {"train_batch_size": [64, 8], "test_batch_size": [64, 8],
                      "checkpointing": [False, True],
                      "num_train_steps": ["3.6 epochs", CLI_STEPS],
                      "valid_freq": [10, 1],
                      "vision_format": ["video_rawvideo", "video_frame"],
                      "clips": {"train": CLI_TRAIN_CLIPS,
                                "test": CLI_TEST_CLIPS}},
          "data_s": data_s, "train_run_s": train_wall,
          "test_run_s": test_wall, "stage_s": timings,
          "test_stage_s": test_timings,
          "step_s": cc.step_s,
          "train_clips_per_s": 8 / statistics.median(steady),
          "eval_clips_per_s": CLI_TEST_CLIPS * (len(cc.evals) - 1) / eval_s,
          "rates": "host-paced, each step and evaluation synchronised at "
                   "its edges; train: 8 clips over the median step after "
                   "the first, the profiled one left out; eval: 16 clips "
                   "an evaluation after the first",
          "eval_s": [e["seconds"] for e in evals],
          "max_memory_allocated": peak_mem, "saves": cc.saves,
          "launches": launches, "launches_per_eval": want_eval,
          "launches_per_step": want_step,
          "hmajor_by_lq_lk": {f"{a}x{b}": n
                              for (a, b), n in cc.hmajor_shapes.items()},
          "losses": losses, "metrics_at_step": at_step,
          "metrics_testing": tested[key]})
    return {"tvas_rerank": launches["flash_attention_fwd_sm90"]}


# the cli_cap_tvas and cli_qa_tvas phases: the released captioning and
# QA configs over write_msrvtt's clips; the fewest steps that give an
# evaluation and a save after training (captioning two, so that one step
# is past the first's one-off costs)
CLI_GEN = {
    "cap": {"config": "caption-msrvtt.json", "task": "cap%tvas",
            "dset": "caption_msrvtt", "steps": 1, "loss": "loss_cap",
            "max_new_tokens": 40,
            "metrics": ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                        "ROUGE_L", "CIDEr")},
    "qa": {"config": "VQA-msrvtt.json", "task": "qa%tvas",
           "dset": "VQA_msrvtt", "steps": 1, "loss": "loss_qa",
           "max_new_tokens": 10, "metrics": ("accuracy",)},
}


def generated_rows(out_dir, kind, step):
    """The captions (cap) or answers (qa) that the evaluation at ``step``
    wrote under ``out_dir``."""
    spec = CLI_GEN[kind]
    if kind == "cap":
        path = os.path.join(out_dir, f"results_test_{spec['dset']}",
                            f"step_{step}_tvas.json")
    else:
        path = os.path.join(out_dir, "predict_answers",
                            f"step{step}_pred_{spec['dset']}_tvas.json")
    with open(path) as f:
        return json.load(f)


def phase_cli_generation(torch, np, root, kind):
    """``python -m vast_tpu_torch.run`` in process on the released
    caption-msrvtt.json (``kind`` "cap": cap%tvas, beam 3 over at most 40
    tokens, Bleu/METEOR/ROUGE_L/CIDEr against a COCO annfile) or
    VQA-msrvtt.json ("qa": qa%tvas, beam 3 over at most 10 tokens after
    the question, exact-match accuracy) over ``write_msrvtt``'s clips,
    reduced by flags as cli_ret_tvas is: first_eval at step 0, an
    evaluation and a save after each of ``CLI_GEN[kind]["steps"]`` steps
    (at a learning rate of 1e-6), then ``--mode testing --checkpoint``
    the last save, whose metrics and
    captions or answers must equal the run's at that step (its first
    generate call under the profiler). Exact launch
    counts per evaluation (40 EVA and 12 BEATs forwards a batch on the
    Hopper body, no head-major launch: BERT's decode and its
    cross-attention take the plain route) and per train step (52
    forwards, 52 backwards given the lse, all on the Hopper bodies)."""
    import shutil

    from vast_tpu_torch import run
    from vast_tpu_torch.evaluation.metrics.coco_eval import meteor_source
    from vast_tpu_torch.ops import flash_attention as fa

    from vast_tpu_torch.training import pipeline

    spec = CLI_GEN[kind]
    steps = spec["steps"]
    out_dir = os.path.join(root, f"output_{kind}")
    init = pipeline.init_params

    def init_gains_near_one(model, opts):
        """The run's seeded N(0, 0.02) weights with 1 added to every
        LayerNorm gain: with gains near 0 the fusion encoder's output is
        near 0 and the logits are the decoder bias, so every clip would
        decode to the same caption."""
        init(model, opts)
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, torch.nn.LayerNorm):
                    mod.weight.add_(1.0)
        return model

    # at the released learning rate (1e-4) one AdamW step moves every
    # caption to [SEP] first, and the re-test would compare empty strings
    reduced = ["--train_batch_size", "8", "--test_batch_size", "8",
               "--checkpointing", "true", "--num_train_steps", str(steps),
               "--valid_freq", "1", "--learning_rate", "1e-6",
               "--output_dir", out_dir]
    try:
        cfg_path = released_config(root, spec["config"])
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        pipeline.init_params = init_gains_near_one
        with CliCounters(torch, profile_step=-1) as cc:
            zero_launches(fa)
            t0 = time.perf_counter()
            state, logged = run.main(["--config", cfg_path] + reduced,
                                     timings=timings)
            train_wall = time.perf_counter() - t0
            launches = dict(fa.LAUNCHES)
        pipeline.init_params = init
        peak_mem = torch.cuda.max_memory_allocated()
        losses = [{k: v.item() for k, v in m.items()} for m in cc.metrics]
        del state
        torch.cuda.empty_cache()
        trained = generated_rows(out_dir, kind, steps)
        ckpt = os.path.join(out_dir, "ckpt", f"model_step_{steps}.pt")
        test_timings = {}
        with CliCounters(torch, profile_step=-1,
                         profile_decode=f"cli_{kind}_tvas_decode_profile"
                         ) as tc:
            t0 = time.perf_counter()
            tested = run.main(["--config", cfg_path, "--mode", "testing",
                               "--checkpoint", ckpt] + reduced,
                              timings=test_timings)
            test_wall = time.perf_counter() - t0
        retested = generated_rows(out_dir, kind, 0)
        torch.cuda.empty_cache()
    finally:
        pipeline.init_params = init
        shutil.rmtree(out_dir, ignore_errors=True)

    phase = f"cli_{kind}_tvas"
    check(len(losses) == steps, f"{phase}: {len(losses)} train steps")
    for row in losses:
        check(row.keys() == {spec["loss"], "total_loss"}
              and all(math.isfinite(v) for v in row.values()),
              f"{phase}: step losses {row}")
    n_batches = CLI_TEST_CLIPS // 8
    want_eval = {"tmajor_attention_fwd": 40 * n_batches,
                 "tmajor_attention_fwd_bias": 12 * n_batches,
                 "tmajor_attention_fwd_sm90": 52 * n_batches}
    want_step = {"tmajor_attention_fwd": 40, "tmajor_attention_fwd_bias": 12,
                 "tmajor_attention_bwd": 40, "tmajor_attention_bwd_bias": 12,
                 "tmajor_attention_fwd_sm90": 52,
                 "tmajor_attention_bwd_sm90": 52,
                 "tmajor_attention_bwd_lse": 52}
    evals = cc.evals + tc.evals
    check([e["step"] for e in cc.evals] == list(range(steps + 1))
          and len(tc.evals) == 1,
          f"{phase}: evaluations at {[e['step'] for e in evals]}")
    for e in evals:
        check(e["launches"] == want_eval,
              f"{phase}: evaluation launches {e['launches']} != {want_eval}")
        most = n_batches * spec["max_new_tokens"]
        check(0 < e["decode_steps"] <= most,
              f"{phase}: {e['decode_steps']} decode steps (at most {most})")
    check(not cc.hmajor_shapes and not tc.hmajor_shapes,
          f"{phase}: head-major forwards {cc.hmajor_shapes} "
          f"{tc.hmajor_shapes}")
    for st in cc.steps:
        check(st == want_step,
              f"{phase}: train step launches {st} != {want_step}")
    want_total = {k: want_step.get(k, 0) * steps
                  + want_eval.get(k, 0) * len(cc.evals) for k in launches}
    check(launches == want_total,
          f"{phase}: the training run's launches {launches} != {want_total}")
    # one caption or answer per test clip, in the loader's order
    check(len(trained) == CLI_TEST_CLIPS
          and (kind == "qa" or [r["video_id"] for r in trained]
               == [f"video{CLI_TRAIN_CLIPS + i}"
                   for i in range(CLI_TEST_CLIPS)]),
          f"{phase}: {len(trained)} rows written")
    key = next(iter(tested))
    at_step = {name[len(key) + 1:]: hist[str(steps)]
               for name, hist in logged.items()}
    metrics = tested[key][f"{'cap' if kind == 'cap' else 'vqa'}_tvas"]
    check(set(metrics) == set(spec["metrics"])
          and all(0.0 <= v <= 100.0 for v in metrics.values()),
          f"{phase}: metrics {metrics}")
    # testing from the saved .pt: every metric and every row equal
    check(tested[key] == at_step,
          f"{phase}: testing {tested[key]} != training's at step {steps} "
          f"{at_step}")
    check(retested == trained,
          f"{phase}: testing wrote other rows than the training run's")
    decode = []
    for e in evals:
        dec_s = e["stage_s"].get("decode", 0.0)
        decode.append({"step": e["step"], "seconds": e["seconds"],
                       "stage_s": e["stage_s"],
                       "decode_steps": e["decode_steps"],
                       "generated_tokens": e["generated_tokens"],
                       "generated_tokens_per_s":
                           e["generated_tokens"] / dec_s if dec_s else None})
    emit({"phase": phase,
          "config": f"vast_tpu/configs/finetune_cfg/{spec['config']}",
          "route": "video_frame",
          "reduced": {"train_batch_size": [64, 8],
                      "test_batch_size": [64 if kind == "cap" else 8, 8],
                      "checkpointing": [False, True],
                      "num_train_steps": ["5 epochs" if kind == "cap"
                                          else "4.5 epochs", steps],
                      "valid_freq": [10, 1], "learning_rate": [1e-4, 1e-6],
                      "vision_format": ["video_rawvideo", "video_frame"],
                      "clips": {"train": CLI_TRAIN_CLIPS,
                                "test": CLI_TEST_CLIPS}},
          "train_run_s": train_wall, "test_run_s": test_wall,
          "step_s": cc.step_s, "stage_s": timings,
          "test_stage_s": test_timings, "evaluations": decode,
          "max_memory_allocated": peak_mem, "saves": cc.saves,
          "launches": launches, "launches_per_eval": want_eval,
          "launches_per_step": want_step, "losses": losses,
          "metrics_at_step": at_step, "metrics_testing": tested[key],
          "meteor": meteor_source() if kind == "cap" else None,
          "distinct_texts": len({r["caption"] if kind == "cap" else r
                                 for r in trained}),
          "first_rows": trained[:2]})


# ---------------------------------------------------------------------
# pretraining from the CLI (phase cli_pretrain): pretrain_vast.json
# ---------------------------------------------------------------------

PRETRAIN_TASKS = {"vast27m": "ret%tvas%tvs%tv%ta_cap%tvas%tvs%tv%ta",
                  "valor1m": "ret%tva%tv%ta_cap%tva%tv%ta",
                  "laion400m": "ret%tv_cap%tv"}
# the MetaLoader's seeded draws over 60000 : 25000 : 15000 slots (seed
# 50, the default run config's) read valor1m, vast27m, vast27m, valor1m,
# vast27m, laion400m: six steps draw every set
PRETRAIN_STEPS = 6
LAION_SHARDS, LAION_PER_SHARD = 3, 16
# MSR-VTT's validation at 8 frames: 8 x 257 EVA + 256 BEATs + 70 subtitle
# tokens a clip, the 16 texts of a candidate folded into 640 queries
PRETRAIN_COND_TOKENS = FRAMES * 257 + 256 + CLI_SUBTITLE_LEN      # 2382


def write_pretrain(np, root):
    """Beside write_msrvtt's clips under ``root``: vast27m and valor1m
    annotation sets of its 32 training clips (vast27m with the subtitle
    and the per-modality captions its annotations carry, ``vision_cap``
    and ``audio_cap``; valor1m caption only), their videos/ and audios/
    the same JPEG frame directories and wavs; and laion400m: three tar
    shards of 16 JPEG images (320 x 240, seeded smooth noise), captions
    as .txt members (shards 0 and 2) or laion .json members (shard 1),
    and one corrupt image member."""
    import io
    import tarfile

    from PIL import Image

    rs = np.random.RandomState(SEED + 11)
    base = os.path.join(root, "msrvtt")
    with open(os.path.join(base, "annotations", "ret_train.json")) as f:
        clips = json.load(f)
    for name in ("vast27m", "valor1m"):
        d = os.path.join(root, name)
        os.makedirs(os.path.join(d, "annotations"), exist_ok=True)
        for sub in ("videos", "audios"):
            os.symlink(os.path.join(base, sub), os.path.join(d, sub))
        rows = []
        for c in clips:
            row = {"video_id": c["video_id"], "desc": c["desc"]}
            if name == "vast27m":
                row |= {"subtitle": c["subtitle"],
                        "vision_cap": " ".join(rs.choice(CLI_WORDS, 8)),
                        "audio_cap": " ".join(rs.choice(CLI_WORDS, 6))}
            rows.append(row)
        with open(os.path.join(d, "annotations", "train.json"), "w") as f:
            json.dump(rows, f)
    shards = os.path.join(root, "laion400m", "shards")
    os.makedirs(shards, exist_ok=True)

    def add(tf, name, data):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))

    for s in range(LAION_SHARDS):
        with tarfile.open(os.path.join(shards, f"{s:05d}.tar"), "w") as tf:
            for i in range(LAION_PER_SHARD):
                key = f"{s:05d}{i:04d}"
                buf = io.BytesIO()
                small = (rs.rand(12, 16, 3) * 255).astype(np.uint8)
                Image.fromarray(small).resize((320, 240), Image.BILINEAR
                                              ).save(buf, format="JPEG",
                                                     quality=90)
                data = b"not a jpeg" if (s, i) == (1, 3) else buf.getvalue()
                add(tf, key + ".jpg", data)
                cap = " ".join(rs.choice(CLI_WORDS, 10))
                if s == 1:
                    add(tf, key + ".json", json.dumps(
                        {"caption": cap, "url": "", "key": key}).encode())
                else:
                    add(tf, key + ".txt", cap.encode())


def pretrain_config(root, depth=None):
    """A copy under ``root`` of pretrain_vast.json, its annotation sets'
    ``vision_format`` video_frame (write_msrvtt's JPEG directories);
    ``depth``: every tower cut to that many layers at full width (the
    optimizers' short runs)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "vast_tpu", "configs", "pretrain_cfg",
                           "pretrain_vast.json")) as f:
        cfg = json.load(f)
    for d in cfg["data_cfg"]["train"] + cfg["data_cfg"]["val"]:
        if d["type"] == "annoindexed":
            d["vision_format"] = "video_frame"
    name = "pretrain_vast.json"
    if depth:
        cfg["model_cfg"] |= {"vision_cfg": {"layers": depth},
                             "audio_cfg": {"encoder_layers": depth},
                             "bert_cfg": {"num_hidden_layers": depth}}
        name = f"pretrain_vast_depth{depth}.json"
    path = os.path.join(root, name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def pretrain_step_launches(task):
    """A pretraining step's attention launches: EVA01-g's 40 (one frame)
    and, where a subtask reads audio, BEATs' 12, forward and backward,
    all on the Hopper bodies, every backward given the lse; BERT's
    attentions over 1 x 257 + 256 (+ 70) condition tokens take the plain
    route."""
    from vast_tpu_torch.config import parse_task_string

    subtasks = [st for _, sts in parse_task_string(task) for st in sts]
    audio = 12 if any("a" in st for st in subtasks) else 0
    want = {"tmajor_attention_fwd": 40, "tmajor_attention_bwd": 40,
            "tmajor_attention_fwd_sm90": 40 + audio,
            "tmajor_attention_bwd_sm90": 40 + audio,
            "tmajor_attention_bwd_lse": 40 + audio}
    if audio:
        want |= {"tmajor_attention_fwd_bias": audio,
                 "tmajor_attention_bwd_bias": audio}
    return want


def phase_cli_pretrain(torch, np, root):
    """``python -m vast_tpu_torch.run`` in process on a copy of the
    released pretrain_vast.json (EVA01-g 40 layers, BEATs 12, BERT-base,
    random seeded weights): vast27m (ret%tvas%tvs%tv%ta_cap%...), valor1m
    (ret%tva%tv%ta_cap%...) and the laion400m tar stream (ret%tv_cap%tv)
    in the released 60000 : 25000 : 15000 mix, the ret%tvas MSR-VTT
    validation at 8 frames. Reduced by flags only: batch 8 a set (1024 /
    1024 / 2048) and 8 in validation (64), 'attn' checkpointing, 6 steps
    (every set drawn), valid_freq 1 (evaluations and saves after steps 4
    and 6, first_eval at 0). Then ``--mode testing`` from
    model_step_6.pt, whose R@k must equal the run's; then 3 steps each of
    ``--optim adam`` and ``--optim adamax`` on a depth-2 copy (every tower
    at full width, 2 layers). Exact launch counts per step (by its set's
    task) and per evaluation; finite losses."""
    import shutil

    from vast_tpu_torch import run
    from vast_tpu_torch.ops import flash_attention as fa
    from vast_tpu_torch.training import pipeline

    made = pipeline.create_train_dataloaders
    loaders = {}

    def recording(*a, **k):
        meta = made(*a, **k)
        loaders.update({n.split("--")[1]: type(ld).__name__
                        for n, ld in meta.name2loader.items()})
        return meta

    t0 = time.perf_counter()
    write_pretrain(np, root)
    data_s = time.perf_counter() - t0
    out_dir = os.path.join(root, "output_pretrain")
    reduced = ["--train_batch_size", "8", "--test_batch_size", "8",
               "--checkpointing", "true",
               "--num_train_steps", str(PRETRAIN_STEPS),
               "--valid_freq", "1", "--output_dir", out_dir]
    try:
        cfg_path = pretrain_config(root)
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        pipeline.create_train_dataloaders = recording
        with CliCounters(torch, profile_step=-1) as cc:
            zero_launches(fa)
            t0 = time.perf_counter()
            state, logged = run.main(["--config", cfg_path] + reduced,
                                     timings=timings)
            train_wall = time.perf_counter() - t0
            launches = dict(fa.LAUNCHES)
        pipeline.create_train_dataloaders = made
        peak_mem = torch.cuda.max_memory_allocated()
        losses = [{k: v.item() for k, v in m.items()} for m in cc.metrics]
        del state
        torch.cuda.empty_cache()
        ckpt = os.path.join(out_dir, "ckpt",
                            f"model_step_{PRETRAIN_STEPS}.pt")
        test_timings = {}
        with CliCounters(torch, profile_step=-1) as tc:
            t0 = time.perf_counter()
            tested = run.main(["--config", cfg_path, "--mode", "testing",
                               "--checkpoint", ckpt] + reduced,
                              timings=test_timings)
            test_wall = time.perf_counter() - t0
        shutil.rmtree(out_dir, ignore_errors=True)
        torch.cuda.empty_cache()
        optims = {}
        for name in ("adam", "adamax"):
            small = os.path.join(root, f"output_{name}")
            t0 = time.perf_counter()
            with CliCounters(torch, profile_step=-1) as oc:
                ostate, _ = run.main(
                    ["--config", pretrain_config(root, depth=2),
                     "--optim", name, "--num_train_steps", "3",
                     "--valid_freq", "1", "--train_batch_size", "8",
                     "--test_batch_size", "8", "--output_dir", small])
            moments = [t.float().abs().max().item()
                       for t in ostate.opt.mu.values()]
            optims[name] = {
                "optim": ostate.opt.optim, "updates": ostate.opt.count,
                "seconds": time.perf_counter() - t0, "step_s": oc.step_s,
                "tasks": oc.tasks,
                "losses": [{k: v.item() for k, v in m.items()}
                           for m in oc.metrics],
                "moments_nonzero": sum(m > 0 for m in moments),
                "moments": len(moments)}
            del ostate
            shutil.rmtree(small, ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        pipeline.create_train_dataloaders = made
        shutil.rmtree(out_dir, ignore_errors=True)

    check(loaders == {"vast27m": "BatchLoader", "valor1m": "BatchLoader",
                      "laion400m": "StreamBatchLoader"},
          f"the train loaders {loaders}")
    # every set drawn, each step with its set's task and finite losses
    drawn = [next(n for n, t in PRETRAIN_TASKS.items() if t == task)
             for task in cc.tasks]
    check(len(drawn) == PRETRAIN_STEPS and set(drawn) == set(PRETRAIN_TASKS),
          f"sets drawn per step {drawn}: want all three in "
          f"{PRETRAIN_STEPS} steps")
    for task, row in zip(cc.tasks, losses):
        want_keys = {"loss_itc", "loss_itm", "loss_cap", "total_loss"}
        check(row.keys() == want_keys
              and all(math.isfinite(v) for v in row.values()),
              f"{task} step losses {row}")
    for task, st in zip(cc.tasks, cc.steps):
        want = pretrain_step_launches(task)
        check(st == want, f"{task} step launches {st} != {want}")
    # per evaluation: two batches of 8 clips x 8 frames, the rerank's 4
    # calls x 12 BERT layers of 640 queries over 2382 keys (row 5)
    rerank = CLI_RERANK_CALLS * 12
    want_eval = {"tmajor_attention_fwd": 80, "tmajor_attention_fwd_bias": 24,
                 "tmajor_attention_fwd_sm90": 104,
                 "flash_attention_fwd": rerank,
                 "flash_attention_fwd_sm90": rerank}
    check([e["step"] for e in cc.evals] == [0, PRETRAIN_STEPS - 2,
                                             PRETRAIN_STEPS]
          and len(tc.evals) == 1,
          f"evaluations at {[e['step'] for e in cc.evals + tc.evals]}")
    for e in cc.evals + tc.evals:
        check(e["launches"] == want_eval,
              f"evaluation launches {e['launches']} != {want_eval}")
    shape = (TVAS_RERANK_TEXTS * TEXT_LEN, PRETRAIN_COND_TOKENS)
    check(cc.hmajor_shapes == {shape: rerank * len(cc.evals)},
          f"head-major forwards by (Lq, Lk) {cc.hmajor_shapes}")
    want_total = {k: sum(pretrain_step_launches(t).get(k, 0)
                         for t in cc.tasks)
                  + want_eval.get(k, 0) * len(cc.evals) for k in launches}
    check(launches == want_total,
          f"the run's launches {launches} != {want_total}")
    key = next(iter(tested))
    at_step = {name[len(key) + 1:]: hist[str(PRETRAIN_STEPS)]
               for name, hist in logged.items()}
    check(tested[key] == at_step,
          f"testing R@k {tested[key]} != training's at step "
          f"{PRETRAIN_STEPS} {at_step}")
    for part in tested[key].values():
        for k, v in part.items():
            if k.endswith(("_r1", "_ravg")):
                check(0.0 <= v <= 100.0, f"{k} = {v}")
    for name, o in optims.items():
        # contra_head_s has no subtask: its moments stay zero
        check(o["optim"] == name and o["updates"] == 3
              and o["moments_nonzero"] >= 0.95 * o["moments"]
              and all(math.isfinite(v) for row in o["losses"]
                      for v in row.values()),
              f"--optim {name}: {o}")
    emit({"phase": "cli_pretrain",
          "config": "vast_tpu/configs/pretrain_cfg/pretrain_vast.json",
          "route": "video_frame (vast27m, valor1m, MSR-VTT); tar shards "
                   "of JPEG images (laion400m)",
          "reduced": {"batch_size": [[1024, 1024, 2048], 8],
                      "test_batch_size": [64, 8],
                      "checkpointing": [False, True],
                      "num_train_steps": [100000, PRETRAIN_STEPS],
                      "valid_freq": [10, 1],
                      "vision_format": ["video_rawvideo", "video_frame"],
                      "sets": {"vast27m": 32, "valor1m": 32,
                               "laion400m": LAION_SHARDS * LAION_PER_SHARD
                               - 1, "msrvtt_test": CLI_TEST_CLIPS}},
          "per_modality_captions": "vast27m's vision_cap and audio_cap are "
                                   "in its annotations; neither package's "
                                   "loader reads them, so each subtask "
                                   "pairs with the caption",
          "data_s": data_s, "sets_drawn": drawn,
          "train_run_s": train_wall, "test_run_s": test_wall,
          "step_s": cc.step_s, "stage_s": timings,
          "train_loader_wait_s": timings.get("train_loader_wait"),
          "test_stage_s": test_timings,
          "eval_s": [e["seconds"] for e in cc.evals + tc.evals],
          "max_memory_allocated": peak_mem, "saves": cc.saves,
          "launches": launches, "launches_per_eval": want_eval,
          "losses": losses, "metrics_at_step": at_step,
          "metrics_testing": tested[key], "optimizers": optims,
          "loaders": loaders})
    return {"rerank": cc.hmajor_shapes[shape], "launches": launches}


# ---------------------------------------------------------------------
# the remaining vision towers (phases slice_towers and train_towers)
# ---------------------------------------------------------------------

# each tower with BEATs on ret%tva, 8 frames at 224 px: a frame's tokens
# (EVA02-B/16 197, L/14 and bigE 257; Swin's last 7 x 7 grid 49;
# VideoSwin's T' = 8 grids of 49) and the vision stage's launches in one
# evaluation of two batches: EVA02 through the head-major kernel (rope
# comes between the projection and the attention), bigE the token-major
# one at D 112, Swin's 49-token windows the plain route, VideoSwin's
# 392-token windows the window kernels (24 blocks; counted as head-major
# forwards too, and with no _sm90 count of the general op's)
TOWERS = {
    "evaclip02_base": (197, {"flash_attention_fwd": 2 * 12}),
    "evaclip02_large": (257, {"flash_attention_fwd": 2 * 24}),
    "evaclip02_bige": (257, {"tmajor_attention_fwd": 2 * 64}),
    "swin_base_22k_224": (49, {}),
    "swin_large_22k_224": (49, {}),
    "videoswin": (49, {"flash_attention_fwd": 2 * 24,
                       "window_attention_fwd": 2 * 24}),
}


def phase_slice_towers(torch, np):
    """``evaluate_ret`` (ret%tva, BEATs, BERT-base) over the 16 clips for
    each remaining tower at full width, bf16: clips/s (the median of two
    runs after a warm-up), peak memory, and exact launches by stage:
    the vision tower's as TOWERS says, all on the Hopper bodies; BEATs'
    24 token-major forwards with their bias; the rerank's head-major
    forwards (12 per call whose folded query leaves the plain route);
    VideoSwin's window forwards by stage (head count). Returns each
    tower's launches by stage and VideoSwin's window launches by heads."""
    from vast_tpu_torch.models.vast import VASTConfig

    counts, window_counts = {}, {}
    for vtype, (tokens, vision) in TOWERS.items():
        cfg = VASTConfig(dtype=torch.bfloat16, vision_encoder_type=vtype)
        row, _, by_stage, windows, model, batches, _ = run_slice(
            torch, np, "slice_towers", cfg, TOP_K, 224,
            FRAMES * tokens + 256, runs=2, stages=False)
        want_vision = dict(vision)
        if "window_attention_fwd" not in vision:
            for k, n in vision.items():
                want_vision[k.split("_attention")[0] +
                            "_attention_fwd_sm90"] = n
        want_audio = {"tmajor_attention_fwd_bias": 24,
                      "tmajor_attention_fwd_sm90": 24}
        rerank = by_stage["rerank"]
        n_flash = rerank.get("flash_attention_fwd", 0)
        check(by_stage["vision"] == want_vision
              and by_stage["audio"] == want_audio
              and set(rerank) <= {"flash_attention_fwd",
                                  "flash_attention_fwd_sm90"}
              and n_flash % 12 == 0
              and rerank.get("flash_attention_fwd_sm90", 0) == n_flash,
              f"{vtype} launches by stage {by_stage}: want vision "
              f"{want_vision}, audio {want_audio}, the rerank's in 12s "
              f"on the Hopper body")
        want_windows = {"fwd": {}, "bwd": {}}
        if "window_attention_fwd" in vision:
            want_windows["fwd"] = {h: 2 * depth
                                   for _, h, depth in WINDOW_STAGES}
        check(windows == want_windows,
              f"{vtype} window launches by heads {windows}: want "
              f"{want_windows} (two batches, each stage's blocks)")
        row |= {"tower": vtype,
                "params": sum(p.numel() for p in model.parameters())}
        emit(row)
        counts[vtype] = by_stage
        window_counts[vtype] = windows
        del model, batches, row
        torch.cuda.empty_cache()
    return counts, window_counts["videoswin"]


# Video Swin-B's stages in the cell videoswin_ret_train (8 clips of 16
# frames at 224 px): token grid, heads, blocks a step (half shifted)
WINDOW_STAGES = (((16, 56, 56), 4, 2), ((16, 28, 28), 8, 2),
                 ((16, 14, 14), 16, 18), ((16, 7, 7), 32, 2))
WINDOW_CLIPS = 8


# a step of the towers' train program: BEATs' 12 token-major forwards
# (bias) and backwards given the lse, and the vision tower's 24
# head-major lse forwards and backwards (EVA02-L's on the Hopper bodies;
# VideoSwin's on the window kernels, the table's gradient summed there)
BEATS_STEP = {"tmajor_attention_fwd_bias": 12, "tmajor_attention_bwd_bias": 12,
              "tmajor_attention_fwd_sm90": 12,
              "tmajor_attention_bwd_sm90": 12,
              "tmajor_attention_bwd_lse": 12}
TRAIN_TOWERS = {
    "evaclip02_large": BEATS_STEP | {
        "flash_attention_fwd_lse": 24, "flash_attention_fwd_sm90": 24,
        "flash_attention_bwd": 24, "flash_attention_bwd_sm90": 24},
    "videoswin": BEATS_STEP | {
        "flash_attention_fwd_lse": 24, "window_attention_fwd": 24,
        "flash_attention_bwd_dbias": 24, "window_attention_bwd": 24},
}


def phase_train_towers(torch, np):
    """The train program (bench.py:367-400: fp32 parameters, bf16
    compute, 'attn', bf16 Adam moments) for EVA02-L/14 and VideoSwin with
    BEATs: a warm-up step and two timed blocks of five steps on one batch
    of 8 clips, exact launches per step, LayerNorm gains + 1 after the
    seeded init, no warm-up of the learning rate (under the default 10%
    of 1000 steps the 11 steps run at 1e-6 to 1.1e-5 and move nothing
    past the noise); the batch's deterministic loss must fall.
    VideoSwin's window forwards and backwards a step by stage (head
    count) as WINDOW_STAGES says. Returns each tower's launches over its
    first block and VideoSwin's window launches by heads there."""
    out, windows_at = {}, {}
    for vtype, per_step in TRAIN_TOWERS.items():
        launches, lse_by_tower, bwd_by_lq, windows, falls = run_train(
            torch, np, f"train_towers_{vtype}",
            {"vision_encoder_type": vtype}, 224, per_step, blocks=2,
            gain_offset=1.0, warmup_ratio=0.0)
        n = TRAIN_STEPS
        check(falls and lse_by_tower == {"vision": 24 * n, "audio": 0},
              f"{vtype}: loss falls {falls}; lse forwards by tower "
              f"{lse_by_tower} over {n} steps")
        by_heads = {h: depth * n for _, h, depth in WINDOW_STAGES}
        want = ({"fwd": by_heads, "bwd": by_heads}
                if "window_attention_fwd" in per_step
                else {"fwd": {}, "bwd": {}})
        check(windows == want, f"{vtype}: window launches by heads "
              f"{windows} over {n} steps, want {want}")
        out[vtype], windows_at[vtype] = launches, windows
        torch.cuda.empty_cache()
    return out, windows_at["videoswin"]


# the data-parallel phases: ddp_step holds two ranks' train step against
# one rank's on the same global batch; cli_ddp_ret_tvas runs the CLI
# under torchrun. Full width; depth cut so that two ranks and their
# comparison fit the script's time (PERF.md section 4).
DDP_DEPTH = {"vision": 8, "audio": 4, "bert": 4}
DDP_LR = 1e-4
DDP_TIMEOUT = 900                    # seconds a group of ranks may take
# ddp_step's fp32 tolerances: the losses' relative error; each gradient
# tensor's largest error over its largest entry; a parameter after one
# AdamW step where its gradient is well above that error, in units of lr
# (elsewhere Adam's bound, 2 lr)
DDP_LOSS_RTOL, DDP_GRAD_RTOL, DDP_PARAM_LR_TOL = 1e-5, 1e-3, 1e-2
CLI_DDP_STEPS = 3


def ddp_config(torch):
    """ret%tvas at full width (EVA01-g/14 1408 wide, BEATs, BERT-base),
    ``DDP_DEPTH`` layers, fp32 parameters and compute, 'attn'
    checkpointing, no dropout."""
    import dataclasses

    from vast_tpu_torch.models.beats import BeatsConfig
    from vast_tpu_torch.models.bert import BertConfig
    from vast_tpu_torch.models.eva_vit import EVA_PRESETS
    from vast_tpu_torch.models.vast import VASTConfig

    f32 = torch.float32
    sub = dict(dtype=f32, param_dtype=f32, remat=True, remat_policy="attn")
    return VASTConfig(
        dtype=f32, param_dtype=f32, checkpointing=True, remat_policy="attn",
        max_subtitle_len=CLI_SUBTITLE_LEN,
        vision_cfg=dataclasses.replace(EVA_PRESETS["evaclip01_giant"],
                                       layers=DDP_DEPTH["vision"], **sub),
        audio_cfg=BeatsConfig(encoder_layers=DDP_DEPTH["audio"], **sub),
        bert_cfg=BertConfig(num_hidden_layers=DDP_DEPTH["bert"],
                            hidden_dropout_prob=0.0, **sub))


def ddp_batch(np, resolution=224):
    """The global batch of ``BATCH`` clips (numpy): 8 frames at
    ``resolution`` px,
    1024 fbank frames of waveform, a padded caption and a 70-token
    subtitle; the ITM negatives injected as global indices that cross
    the ranks' halves."""
    rs = np.random.RandomState(SEED + 12)
    # 1023 * 160 + 400 samples: exactly 1024 fbank frames, one clip, so
    # the training forward draws no clip (a draw is per row: the ranks'
    # rows would draw other clips than one process's)
    wave = 1023 * 160 + 400
    cap_mask = np.ones((BATCH, TEXT_LEN), np.int32)
    cap_mask[1::2, TEXT_LEN // 2:] = 0
    sub_mask = np.ones((BATCH, CLI_SUBTITLE_LEN), np.int32)
    sub_mask[::3, 50:] = 0
    return {
        "vision_frames": rs.randint(
            0, 256, (BATCH, FRAMES, resolution, resolution, 3)
        ).astype(np.uint8),
        "audio_waveforms": (rs.randn(BATCH, wave) * 3000).astype(np.float32),
        "caption_tokens": rs.randint(1000, 20000, (BATCH, TEXT_LEN)
                                     ).astype(np.int32),
        "caption_attention_mask": cap_mask,
        "subtitle_tokens": rs.randint(1000, 20000, (BATCH, CLI_SUBTITLE_LEN)
                                      ).astype(np.int32),
        "subtitle_attention_mask": sub_mask,
        "itm_neg_cond_idx": np.roll(np.arange(BATCH), 3)[None],
        "itm_neg_text_idx": np.roll(np.arange(BATCH), 5)[None]}


def ddp_group(name):
    """A parameter's group for the errors by group."""
    return next((g for p, g in (("vision_encoder.", "vision"),
                                ("audio_encoder.", "audio"),
                                ("audio_embeddings.", "audio"),
                                ("multimodal_encoder.", "bert"))
                 if name.startswith(p)), "heads")


class AllreduceClock:
    """Host seconds during which a gradient all-reduce was in flight in
    ``ddp_step``: from a bucket's launch while none was, to the completion
    that leaves none (``timed_allreduce``, the rank's comm hook; the
    intervals overlap the backward). Under gloo that spans the transfers
    through host memory; an NCCL future completes at its launch, so under
    NCCL it counts the launches only."""

    def __init__(self):
        import threading

        self.seconds = 0.0
        self._open = 0
        self._since = 0.0
        self._lock = threading.Lock()

    def launched(self):
        with self._lock:
            if not self._open:
                self._since = time.perf_counter()
            self._open += 1

    def completed(self):
        with self._lock:
            self._open -= 1
            if not self._open:
                self.seconds += time.perf_counter() - self._since


def timed_allreduce(clock, bucket):
    """DDP's default all-reduce (the mean over the ranks), timed by
    ``clock``."""
    import torch.distributed as dist

    clock.launched()
    buf = bucket.buffer().div_(dist.get_world_size())
    fut = dist.all_reduce(buf, async_op=True).get_future()

    def done(f):
        clock.completed()
        return f.value()[0]

    return fut.then(done)


def ddp_model(torch, dev, cfg=None):
    """``ddp_config``'s model (``cfg``: another) from the seeded init
    (LayerNorm gains + 1, temperature 0.07, as the tiny steps: a fp32 run
    is then well conditioned) and its AdamW."""
    from vast_tpu_torch.convert.from_jax import init_random_
    from vast_tpu_torch.models.vast import VASTModel
    from vast_tpu_torch.training.optimizer import build_optimizer

    model = VASTModel(cfg or ddp_config(torch), device=dev)
    init_random_(model, torch.Generator(device=dev).manual_seed(SEED))
    well_conditioned(torch, model)
    opt, _ = build_optimizer(model, {"learning_rate": DDP_LR,
                                     "clip_lr": DDP_LR, "warmup_ratio": 0},
                             {"vision_encoder_type":
                              model.cfg.vision_encoder_type}, 10)
    return model, opt


def well_conditioned(torch, model):
    """LayerNorm gains + 1 and the temperature 0.07 on a seeded init, as
    the tiny steps: fp32 and bf16 runs are then well conditioned."""
    with torch.no_grad():
        model.contra_temp.fill_(0.07)
        for mod in model.modules():
            if isinstance(mod, torch.nn.LayerNorm):
                mod.weight.add_(1.0)


def ddp_rows(torch, np, rank, world, dev, resolution=224):
    """Rank ``rank`` of ``world``'s rows of ``ddp_batch`` on ``dev``, the
    ITM negatives' columns alike."""
    b = BATCH // world
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[:, rank * b:(rank + 1) * b] if k.startswith("itm_neg_")
        else v[rank * b:(rank + 1) * b])).to(dev)
        for k, v in ddp_batch(np, resolution).items()}


def ddp_step_run(torch, np, rank, world, dev, ref_path, save):
    """One ret%tvas train step of this rank through ``data_parallel``
    (its all-reduce timed by ``AllreduceClock``): ``ddp_model``, this
    rank's rows of ``ddp_batch``. ``save`` (the reference run): the
    metrics, gradients and updated parameters are saved to ``ref_path``;
    else rank 0 returns their errors against it."""
    from vast_tpu_torch.ops import flash_attention as fa
    from vast_tpu_torch.parallel import collectives
    from vast_tpu_torch.training import optimizer as optim_mod
    from vast_tpu_torch.training.step import (create_train_state,
                                              data_parallel, make_train_step)

    model, opt = ddp_model(torch, dev)
    ddp = data_parallel(model)
    clock = AllreduceClock()
    ddp.register_comm_hook(clock, timed_allreduce)
    step = make_train_step(model, opt, "ret%tvas", ddp=ddp)
    batch = ddp_rows(torch, np, rank, world, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches(fa)
    zero_launches(optim_mod)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, metrics = step(create_train_state(model, opt), batch,
                      torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    out = {"rank": rank, "world": world, "device": str(dev),
           "step_s": seconds,
           "grad_allreduce_s": clock.seconds,
           "launches": {k: v for k, v in fa.LAUNCHES.items() if v},
           "adam": adam_counts(opt),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "metrics": {k: v.item() for k, v in metrics.items()}}
    named = dict(model.named_parameters())
    # every rank must hold the same averaged gradient: a fingerprint each
    finger = torch.stack([p.grad.double().abs().sum() for p in
                          named.values() if p.grad is not None])
    prints = collectives.all_gather_detached(finger[None])
    out["ranks_agree"] = bool((prints == prints[0]).all())
    if save:
        torch.save({"metrics": out["metrics"],
                    "grads": {n: None if p.grad is None else p.grad.cpu()
                              for n, p in named.items()},
                    "params": {n: p.detach().cpu()
                               for n, p in named.items()}}, ref_path)
        return out
    if rank == 0:
        out |= ddp_errors(torch, named, out["metrics"], torch.load(
            ref_path, map_location=dev, weights_only=True))
    return out


def ddp_errors(torch, named, metrics, ref):
    """Largest relative errors by group against the reference run, and
    the checks of the stated tolerances."""
    errs = {"loss_rel": max(abs(metrics[k] - v) / abs(v)
                            for k, v in ref["metrics"].items())}
    grad, param = {}, {}
    noise, masked = [], 0
    for n, p in named.items():
        g, rg = p.grad, ref["grads"][n]
        check((g is None) == (rg is None), f"{n}: gradient presence")
        gname = ddp_group(n)
        if g is not None:
            top = rg.abs().max().item()
            rel = (g - rg).abs().max().item() / max(top, 1e-30)
            if n.endswith(KEY_BIASES):
                # softmax ignores a bias on every key alike: rounding
                # noise on both sides, reported apart
                noise.append(rel)
            else:
                grad[gname] = max(grad.get(gname, 0.0), rel)
            firm = rg.abs() > max(10 * DDP_GRAD_RTOL * top, 1e-4)
        else:
            firm = torch.zeros_like(p, dtype=torch.bool)
        d = (p.detach() - ref["params"][n]).abs() / DDP_LR
        masked += int(firm.sum())
        param[gname] = max(param.get(gname, 0.0),
                           d[firm].max().item() if firm.any() else 0.0)
        param["bound"] = max(param.get("bound", 0.0), d.max().item())
    errs |= {"grad_max_rel_err_by_group": grad,
             "key_bias_grad_rel_err": max(noise, default=0.0),
             "param_err_in_lr_by_group": param,
             "param_elements_held": masked}
    check(errs["loss_rel"] <= DDP_LOSS_RTOL,
          f"ddp_step losses: relative error {errs['loss_rel']}")
    for k, v in grad.items():
        check(v <= DDP_GRAD_RTOL, f"ddp_step {k} gradients: {v}")
    for k, v in param.items():
        lim = 2.0 + 1e-3 if k == "bound" else DDP_PARAM_LR_TOL
        check(v <= lim, f"ddp_step {k} parameters: {v} lr")
    return errs


def ddp_step_rank(rank, world, backend, port, out, run, args):
    """A spawned rank of ``ddp_step``, ``shard_step`` or ``shard_train``:
    joins the group as torchrun would start it (``VAST_DIST_BACKEND=gloo``
    where ranks share the card), runs ``run`` (the name of one of this
    script's ``*_run`` functions) with ``args`` and writes its JSON to
    ``out % rank``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    os.environ.pop("VAST_DIST_BACKEND", None)
    if backend == "gloo":
        os.environ["VAST_DIST_BACKEND"] = "gloo"
    import numpy as np
    import torch

    from vast_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world, dev = parallel.init_distributed()
    check(torch.distributed.get_backend() == backend, f"rank {rank}: "
          f"{torch.distributed.get_backend()}, not {backend}")
    try:
        result = globals()[run](torch, np, rank, world, dev, *args)
        with open(out % rank, "w") as f:
            json.dump(result, f)
    finally:
        parallel.destroy()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(world, backend, tmp, tag, run, *args):
    """``world`` spawned ``ddp_step_rank`` processes running ``run`` with
    ``args``; their results. A rank that fails or outlasts
    ``DDP_TIMEOUT`` fails the phase, and every rank is stopped."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out = os.path.join(tmp, f"{tag}_%d.json")
    port = free_port()
    procs = [ctx.Process(target=ddp_step_rank,
                         args=(r, world, backend, port, out, run, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DDP_TIMEOUT
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        check(all(c == 0 for c in codes),
              f"{run} {tag}: rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r in range(world):
        with open(out % r) as f:
            results.append(json.load(f))
    return results


def ddp_step_launches():
    """Rows 1-4 a rank launches in one fp32 'attn' step: EVA's forward
    and backward a layer, BEATs' with its bias (the CUDA-core bodies:
    fp32), every backward given its forward's lse."""
    v, a = DDP_DEPTH["vision"], DDP_DEPTH["audio"]
    return {"tmajor_attention_fwd": v, "tmajor_attention_fwd_bias": a,
            "tmajor_attention_bwd": v, "tmajor_attention_bwd_bias": a,
            "tmajor_attention_bwd_lse": v + a}


def phase_ddp_step(torch, np, tmp):
    """Two ranks' ret%tvas train step against one rank's, both through
    ``data_parallel`` on the same global batch of ``BATCH`` clips (each
    rank its half, the ITM negatives global): first a world of one under
    NCCL (the reference: NCCL's init and collectives on the card), then
    two ranks sharing the card over gloo (``VAST_DIST_BACKEND=gloo``),
    and, where the machine shows two cards, two ranks over NCCL on two
    cards. The losses, every parameter's averaged gradient and the
    parameters after the step must match the reference within the fp32
    tolerances stated; every rank must hold the same gradient and launch
    rows 1-4 exactly as counted. The reference stays in ``tmp`` for
    ``shard_step``."""
    ref = os.path.join(tmp, "reference.pt")
    runs = {}
    torch.cuda.empty_cache()
    (one,) = spawn_ranks(1, "nccl", tmp, "reference", "ddp_step_run", ref,
                         True)
    runs["gloo_2_ranks"] = spawn_ranks(2, "gloo", tmp, "gloo",
                                       "ddp_step_run", ref, False)
    if torch.cuda.device_count() >= 2:
        runs["nccl_2_ranks_2_cards"] = spawn_ranks(
            2, "nccl", tmp, "nccl", "ddp_step_run", ref, False)
    want = ddp_step_launches()
    for name, ranks in [("nccl_1_rank", [one])] + list(runs.items()):
        for r in ranks:
            check(r["launches"] == want,
                  f"ddp_step {name} rank {r['rank']}: launches "
                  f"{r['launches']} != {want}")
            check(r["ranks_agree"], f"ddp_step {name}: ranks' gradients")
            check(r["adam"]["kernel_launches"] == 1 and r["adam"]["tensors"]
                  == r["adam"]["trainable"], f"ddp_step {name} rank "
                  f"{r['rank']}: the optimizer's kernel {r['adam']}")
            check(all(math.isfinite(v) for v in r["metrics"].values()),
                  f"ddp_step {name}: metrics {r['metrics']}")
    emit({"phase": "ddp_step", "task": "ret%tvas", "global_batch": BATCH,
          "dtype": "float32", "remat_policy": "attn", "depth": DDP_DEPTH,
          "reduced": {"vision layers": [40, DDP_DEPTH["vision"]],
                      "audio layers": [12, DDP_DEPTH["audio"]],
                      "bert layers": [12, DDP_DEPTH["bert"]]},
          "tolerances": {"loss_rel": DDP_LOSS_RTOL,
                         "grad_rel_to_tensor_max": DDP_GRAD_RTOL,
                         "param_in_lr_where_grad_firm": DDP_PARAM_LR_TOL,
                         "param_bound_in_lr": 2.0},
          "launches_per_rank": want, "reference": one,
          "runs": runs, "cards": torch.cuda.device_count(),
          "cross_card_nccl": "nccl_2_ranks_2_cards" in runs})
    # the launches rank 0 of the gloo pair counted (every rank's held to
    # ``want`` above)
    return runs["gloo_2_ranks"][0]["launches"]


def ddp_cli_config(root):
    """A copy of the released retrieval-msrvtt.json as ``released_config``
    makes it, each tower at ``DDP_DEPTH`` layers (full width) and the
    losses fetched every step; its path."""
    with open(released_config(root, "retrieval-msrvtt.json",
                              DDP_DEPTH)) as f:
        cfg = json.load(f)
    cfg["run_cfg"]["metrics_every"] = 1
    path = os.path.join(root, "retrieval-msrvtt-ddp.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def torchrun(args, nproc, timeout=DDP_TIMEOUT):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc -m vast_tpu_torch.run args`` from the checkout, its ranks
    sharing the card over gloo; returns each rank's ``summary`` lines
    ({kind: {rank: fields}}). A non-zero exit, or a group
    that outlasts ``timeout``, fails the phase; the whole process group
    is killed then."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m", "vast_tpu_torch.run"] + args
    env = dict(os.environ, VAST_DIST_BACKEND="gloo")
    proc = subprocess.Popen(cmd, cwd=here, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        output, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"torchrun {args} outlasted {timeout} s")
    if proc.returncode:
        print(output[-20000:], file=sys.stderr)
        raise RuntimeError(f"torchrun {args}: exit code {proc.returncode}")
    summaries = {}
    for line in output.splitlines():
        _, sep, rest = line.partition(" - vast_tpu_torch -   summary ")
        if not sep:
            continue
        kind, _, rest = rest.partition(" rank ")
        head, _, fields = rest.partition(": ")
        r, _, n = head.partition(" of ")
        check(int(n) == nproc, f"summary of a world of {n}")
        summaries.setdefault(kind, {})[int(r)] = json.loads(fields)
    return summaries


def phase_cli_ddp_ret_tvas(torch, np, root):
    """The port's CLI under torchrun, two ranks sharing the card over
    gloo (``VAST_DIST_BACKEND=gloo``): the released retrieval-msrvtt.json
    (``ddp_cli_config``: full width, ``DDP_DEPTH`` layers, bf16) over
    write_msrvtt's clips, ``CLI_DDP_STEPS`` steps of the global batch 8
    (4 a rank), evaluations and saves after steps 1 and 3 (valid_steps =
    3 // 1 - 1 = 2; the first save is replaced by the second). Every rank
    must log the same losses and launch rows 1-4 and 6 exactly as
    counted; one checkpoint pair must be left, written by rank 0, which
    loads into a one-process port with no key missing or unexpected;
    ``--mode testing`` from it under two ranks and under one (in this
    process) must give equal R@k."""
    import shutil

    from vast_tpu_torch import run
    from vast_tpu_torch.evaluation import evaluation_mm
    from vast_tpu_torch.ops import flash_attention as fa

    cfg_path = ddp_cli_config(root)
    out_dir = os.path.join(root, "output_ddp")
    reduced = ["--train_batch_size", "8", "--test_batch_size", "8",
               "--checkpointing", "true", "--first_eval", "false",
               "--num_train_steps", str(CLI_DDP_STEPS), "--valid_freq", "1",
               "--output_dir", out_dir]
    ckpt = os.path.join(out_dir, "ckpt", f"model_step_{CLI_DDP_STEPS}.pt")
    try:
        t0 = time.perf_counter()
        trained = torchrun(["--config", cfg_path] + reduced, 2)
        train_wall = time.perf_counter() - t0
        files = sorted(os.listdir(os.path.join(out_dir, "ckpt")))
        with open(os.path.join(out_dir, "log", "log.txt")) as f:
            log = f.read()
        # testing in batches of 8 clips in every process (global 16
        # under two ranks): the same GEMM shapes as one process's, so
        # that bf16 rounds every clip's features alike
        t0 = time.perf_counter()
        tested2 = torchrun(["--config", cfg_path, "--mode", "testing",
                            "--checkpoint", ckpt] + reduced
                           + ["--test_batch_size", "16"], 2)
        test2_wall = time.perf_counter() - t0
        # the checkpoint in one process of the port
        opts = run.get_args(["--config", cfg_path] + reduced)
        model = run.pipeline.build_model(opts, "cuda")
        reload = run.load_checkpoint(model, ckpt)
        del model
        torch.cuda.empty_cache()
        zero_launches(fa)
        t0 = time.perf_counter()
        with recorded_scores([]) as scores:
            tested1 = run.main(["--config", cfg_path, "--mode", "testing",
                                "--checkpoint", ckpt] + reduced)
        test1_wall = time.perf_counter() - t0
        launches1 = {k: v for k, v in fa.LAUNCHES.items() if v}
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.rmtree(out_dir + "_test", ignore_errors=True)

    train = trained.get("train", {})
    test = tested2.get("test", {})
    check(sorted(train) == [0, 1] and sorted(test) == [0, 1],
          f"summaries from ranks {sorted(train)} (train), {sorted(test)} "
          f"(test)")
    # every rank logged the same losses (the ranks' means), every step
    losses = [train[r]["losses"] for r in (0, 1)]
    check(losses[0] == losses[1] and len(losses[0]) == CLI_DDP_STEPS,
          f"the ranks' losses {losses}")
    for row in losses[0]:
        check(all(math.isfinite(v) for k, v in row.items()
                  if k not in ("step", "task")), f"losses {row}")
    check(files == [f"model_step_{CLI_DDP_STEPS}.pt",
                    f"optimizer_step_{CLI_DDP_STEPS}.pt"],
          f"checkpoint files {files}")
    check(log.count("saved checkpoint step") == 2
          and "rank 1 of 2" not in log and "summary train rank 0" in log,
          "rank 0 alone writes the log and the two saves")
    check(not reload.missing_keys and not reload.unexpected_keys,
          f"reload of {ckpt}: {reload}")
    # per rank: 4 clips a step, 8 a test shard (2 batches of 4 x 16
    # frames in training, 1 of 8 in testing), the rerank's 16 segments
    # split 8 a rank: 2 calls of 4
    v, a, bert = DDP_DEPTH["vision"], DDP_DEPTH["audio"], DDP_DEPTH["bert"]
    step = {"tmajor_attention_fwd": v, "tmajor_attention_fwd_bias": a,
            "tmajor_attention_fwd_sm90": v + a,
            "tmajor_attention_bwd": v, "tmajor_attention_bwd_bias": a,
            "tmajor_attention_bwd_sm90": v + a,
            "tmajor_attention_bwd_lse": v + a}

    def evaluation(calls, batches=2):
        return {"tmajor_attention_fwd": batches * v,
                "tmajor_attention_fwd_bias": batches * a,
                "tmajor_attention_fwd_sm90": batches * (v + a),
                "flash_attention_fwd": calls * bert,
                "flash_attention_fwd_sm90": calls * bert}

    def total(*parts):
        out = {}
        for n, part in parts:
            for k, c in part.items():
                out[k] = out.get(k, 0) + n * c
        return out

    want_train = total((CLI_DDP_STEPS, step), (2, evaluation(2)))
    want_test = evaluation(2, batches=1)
    for r in (0, 1):
        check(train[r]["launches"] == want_train,
              f"rank {r} training launches {train[r]['launches']} != "
              f"{want_train}")
        check(test[r]["launches"] == want_test,
              f"rank {r} testing launches {test[r]['launches']} != "
              f"{want_test}")
    # DDP's own all-reduce timing: steps 1 to 2, each read at the next
    # synchronised forward
    for r in (0, 1):
        check(train[r]["grad_allreduce_steps"] == CLI_DDP_STEPS - 1
              and train[r]["grad_allreduce_s"] > 0,
              f"rank {r}: all-reduce {train[r]['grad_allreduce_s']} s over "
              f"{train[r]['grad_allreduce_steps']} steps")
    check(launches1 == evaluation(CLI_RERANK_CALLS),
          f"one process's testing launches {launches1}")
    key = next(iter(tested1))
    check(test[0]["eval_log"] == test[1]["eval_log"],
          "the two ranks' R@k")
    # two ranks gather their strided shards rank after rank (clips 0, 2,
    # ..., 14, then 1, 3, ..., 15), and R@k breaks a tie by the clips'
    # order: the random weights' bf16 ITM scores tie often. One process's
    # ITC and rerank score matrices, taken in that order, must give the
    # two ranks' R@k exactly, which holds only where every cell agrees
    check([d for *_, d in scores] == ["forward", "forward"],
          f"one process's score matrices {[d for *_, d in scores]}")
    permuted = {}
    for name, (score, ids, ids_txt, _) in zip(("ret_itc_tvas",
                                               "ret_itm_tvas"), scores):
        order = list(range(0, len(ids), 2)) + list(range(1, len(ids), 2))
        check(ids_txt == ids, "one caption a clip")
        permuted[name] = evaluation_mm._metric_log(
            score[np.ix_(order, order)], [ids[i] for i in order],
            [ids[i] for i in order], "forward")
    check(test[0]["eval_log"][key] == permuted,
          f"R@k under 2 ranks {test[0]['eval_log'][key]} != one process's "
          f"score matrices in the ranks' order {permuted} (in its own "
          f"order {tested1[key]})")
    emit({"phase": "cli_ddp_ret_tvas", "config": "vast_tpu/configs/"
          "finetune_cfg/retrieval-msrvtt.json", "launch": "python -m "
          "torch.distributed.run --standalone --nproc_per_node 2 -m "
          "vast_tpu_torch.run", "backend": "gloo, two ranks on one card "
          "(VAST_DIST_BACKEND=gloo): its all-reduce stages the gradients "
          "through host memory, no NCCL figure",
          "reduced": {"vision layers": [40, v], "audio layers": [12, a],
                      "bert layers": [12, bert],
                      "train_batch_size": [64, 8],
                      "test_batch_size": [64, "8 (testing: 16, 8 a rank)"],
                      "checkpointing": [False, True],
                      "num_train_steps": ["3.6 epochs", CLI_DDP_STEPS],
                      "valid_freq": [10, 1], "first_eval": [True, False],
                      "vision_format": ["video_rawvideo", "video_frame"]},
          "train_run_s": train_wall, "test_run_s": {"2_ranks": test2_wall,
                                                   "1_rank": test1_wall},
          "ranks": {r: {"step_s": train[r]["step_s"],
                        "grad_allreduce_s": train[r]["grad_allreduce_s"],
                        "grad_allreduce_steps":
                            train[r]["grad_allreduce_steps"],
                        "max_memory_allocated":
                            train[r].get("max_memory_allocated"),
                        "launches": train[r]["launches"]} for r in (0, 1)},
          "launches_per_rank": {"step": step, "evaluation": evaluation(2),
                                "testing": want_test},
          "losses": losses[0], "checkpoint": files,
          "r_at_k": {"2_ranks": test[0]["eval_log"][key],
                     "1_rank": tested1[key],
                     "1_rank_in_the_ranks_order": permuted}})
    # the training launches rank 0 counted (both held to ``want_train``)
    return train[0]["launches"]


# parameter sharding (phases shard_step and shard_train): four ranks on
# a (dp, fsdp, tp) mesh of 1 x 2 x 2, sharing the card over gloo (and
# over NCCL on four cards where the machine has them); ddp_step's model,
# batch and tolerances for the step, the released retrieval config at
# DDP_DEPTH for the run
SHARD_MESH = {"dp": 1, "fsdp": 2, "tp": 2}
SHARD_WORLD = 4
SHARD_STEPS = 3
# a tp rank's heads of each tower (tp 2; heads_by_stage)
SHARD_HEADS = {"vision": [8], "audio": [6], "bert": [6]}
# shard_train's bf16 score matrices, sharded against the unsharded
# re-test, both on unit ranges (ITC: cosines of unit features; ITM: a
# probability), where tp sums every projection's heads in another order:
# one bf16 rounding (2^-8) of that unit
SHARD_SCORE_ATOL = 2 ** -8


def heads_by_stage(model):
    """The heads each attention runs on this rank: the vision tower's
    first of each stage, the audio tower's first and BERT's first."""
    def first(mod):
        return next(m.heads for m in mod.modules()
                    if hasattr(m, "tp_linears") and hasattr(m, "heads"))

    vt = model.vision_tower
    stages = vt.layers if hasattr(vt, "layers") else [vt]
    return {"vision": [first(s) for s in stages],
            "audio": [first(model.audio_encoder)],
            "bert": [first(model.multimodal_encoder)]}


def planned_bytes(state):
    """This rank's parameter and moment bytes as the plan gives them,
    and the bytes of the whole (replicated) tensors."""
    sh, opt = state.sharding, state.opt
    local = whole = moments = whole_moments = 0
    for name, p in state.model.named_parameters():
        plan = sh.plans[name]
        n_local, n_whole = math.prod(plan.local_shape()), math.prod(plan.shape)
        local += n_local * p.element_size()
        whole += n_whole * p.element_size()
        for key in ("mu", "nu"):
            t = getattr(opt, key).get(name)
            if t is not None:
                moments += n_local * t.element_size()
                whole_moments += n_whole * t.element_size()
    return {"param_bytes": local, "moment_bytes": moments,
            "whole_param_bytes": whole, "whole_moment_bytes": whole_moments}


def shard_step_run(torch, np, rank, world, dev, ref_path):
    """One ret%tvas train step of ``ddp_model`` sharded by
    ``shard_state(fsdp=True, tp=True)`` on ``create_mesh(**SHARD_MESH)``,
    this rank's data rows of ``ddp_batch``; its bytes against the plan;
    rank 0 holds the losses, every gradient and every parameter after the
    step, gathered whole, against ddp_step's reference."""
    from vast_tpu_torch import parallel
    from vast_tpu_torch.ops import flash_attention as fa
    from vast_tpu_torch.parallel import collectives
    from vast_tpu_torch.training import optimizer as optim_mod
    from vast_tpu_torch.training.pipeline import shard_bytes
    from vast_tpu_torch.training.step import (create_train_state,
                                              make_train_step, shard_state)

    model, opt = ddp_model(torch, dev)
    mesh = parallel.create_mesh(**SHARD_MESH)
    state = shard_state(mesh, create_train_state(model, opt), fsdp=True,
                        tp=True)
    sh = state.sharding
    group = parallel.data_group(mesh)
    drank, dsize = parallel.group_rank(group), parallel.group_size(group)
    step = make_train_step(model, state.opt, "ret%tvas", sharding=sh)
    batch = ddp_rows(torch, np, drank, dsize, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches(fa)
    zero_launches(optim_mod)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, metrics = step(state, batch, torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    out = {"rank": rank, "world": world, "device": str(dev),
           "data_rank": [drank, dsize], "step_s": seconds,
           "launches": {k: v for k, v in fa.LAUNCHES.items() if v},
           "adam": adam_counts(state.opt),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "metrics": {k: v.item() for k, v in metrics.items()},
           "heads": heads_by_stage(model), "bytes": shard_bytes(state),
           "planned": planned_bytes(state)}
    # every rank must hold the same parameters that stay whole (the
    # ranks of a tp group step them alike): a fingerprint each
    finger = torch.stack([p.detach().double().abs().sum() for n, p in
                          model.named_parameters() if sh.plans[n].whole])
    prints = collectives.all_gather_detached(finger[None])
    out["ranks_agree"] = bool((prints == prints[0]).all())
    # every rank joins the gathers; rank 0 keeps the whole tensors
    whole = {}
    for n, p in model.named_parameters():
        g = None if p.grad is None else sh.full(n, p.grad)
        w = sh.full(n, p.detach())
        if rank == 0:
            w = w.clone()
            # a gradient the loss did not reach is zeros here (the data
            # group's all-reduce), absent in the reference
            w.grad = g if g is not None and bool(g.any()) else None
            whole[n] = w
    if rank == 0:
        out |= ddp_errors(torch, whole, out["metrics"], torch.load(
            ref_path, map_location=dev, weights_only=True))
    return out


def phase_shard_step(torch, np, tmp):
    """ddp_step's train step sharded over fsdp 2 x tp 2 (four ranks on
    the card over gloo; four over NCCL where the machine shows four
    cards), against ddp_step's one-rank reference in ``tmp``: the losses,
    every gradient and every parameter after the step within ddp_step's
    tolerances (``ddp_errors``); each rank's parameter and moment bytes
    exactly as the plan gives them, its towers on their tp heads, and
    rows 1-4 launched as one rank launches them (each on its heads)."""
    ref = os.path.join(tmp, "reference.pt")
    check(os.path.exists(ref), "shard_step needs ddp_step's reference")
    runs = {"gloo_4_ranks_1_card": spawn_ranks(
        SHARD_WORLD, "gloo", tmp, "shard_gloo", "shard_step_run", ref)}
    if torch.cuda.device_count() >= SHARD_WORLD:
        runs["nccl_4_ranks_4_cards"] = spawn_ranks(
            SHARD_WORLD, "nccl", tmp, "shard_nccl", "shard_step_run", ref)
    want = ddp_step_launches()
    for name, ranks in runs.items():
        losses = {json.dumps(r["metrics"], sort_keys=True) for r in ranks}
        check(len(losses) == 1, f"shard_step {name}: the ranks' losses")
        for r in ranks:
            check(r["launches"] == want, f"shard_step {name} rank "
                  f"{r['rank']}: launches {r['launches']} != {want}")
            check(r["heads"] == SHARD_HEADS, f"shard_step {name} rank "
                  f"{r['rank']}: heads {r['heads']}")
            check(r["adam"]["kernel_launches"] == 1 and r["adam"]["tensors"]
                  == r["adam"]["trainable"], f"shard_step {name} rank "
                  f"{r['rank']}: the optimizer's kernel {r['adam']}")
            check(r["ranks_agree"], f"shard_step {name}: the ranks' whole "
                  f"parameters")
            for key in ("param_bytes", "moment_bytes"):
                check(r["bytes"][key] == r["planned"][key],
                      f"shard_step {name} rank {r['rank']}: {key} "
                      f"{r['bytes'][key]} != planned {r['planned'][key]}")
        check("loss_rel" in ranks[0], f"shard_step {name}: rank 0's errors")
    gloo = runs["gloo_4_ranks_1_card"]
    emit({"phase": "shard_step", "task": "ret%tvas", "global_batch": BATCH,
          "mesh": SHARD_MESH, "dtype": "float32", "remat_policy": "attn",
          "depth": DDP_DEPTH, "route": "own gathers and all-reduces "
          "(parallel/fsdp.py), one path on every backend",
          "tolerances": {"loss_rel": DDP_LOSS_RTOL,
                         "grad_rel_to_tensor_max": DDP_GRAD_RTOL,
                         "param_in_lr_where_grad_firm": DDP_PARAM_LR_TOL,
                         "param_bound_in_lr": 2.0},
          "launches_per_rank": want, "heads_per_rank": SHARD_HEADS,
          "share_of_whole": {
              k: gloo[0]["bytes"][k] / gloo[0]["planned"][f"whole_{k}"]
              for k in ("param_bytes", "moment_bytes")},
          "runs": runs, "cards": torch.cuda.device_count(),
          "cross_card_nccl": "nccl_4_ranks_4_cards" in runs})
    return gloo[0]["launches"]


# phase shard_towers: the towers whose tp split came last, each with
# BERT-base, sharded as shard_step shards EVA01-g + BEATs: CLIP-L/14-336
# + AST (DDP_DEPTH layers), VideoSwin and Swin-B + BEATs (two blocks a
# stage, all four stages, so that every head count runs); four ranks on
# SHARD_MESH against a world of one on the same seeded weights and
# batch, fp32, 'attn', ddp_step's tolerances; CLIP + AST's evaluate_ret
# on the mesh against the world of one
SHARD_TOWERS = {
    "clip_ast": dict(vision_encoder_type="clip_vit_large_14_336px",
                     vision_resolution=336, audio_encoder_type="ast"),
    "videoswin_beats": dict(vision_encoder_type="videoswin"),
    "swin_beats": dict(vision_encoder_type="swin_base_22k_224"),
}
SHARD_STAGES = (2, 2, 2, 2)
# a tp rank's heads (tp 2): the vision tower's by stage, the audio
# tower's and BERT's
SHARD_TOWER_HEADS = {
    "clip_ast": {"vision": [8], "audio": [6], "bert": [6]},
    "videoswin_beats": {"vision": [2, 4, 8, 16], "audio": [6], "bert": [6]},
    "swin_beats": {"vision": [2, 4, 8, 16], "audio": [6], "bert": [6]},
}
# CLIP + AST's evaluation: 16 clips at 336 px in batches of SHARD_CLIPS
# on each data rank, every text reranking every clip (16 texts a
# candidate's segment: Lq 640 over CA_COND_TOKENS)
SHARD_EVAL_CLIPS = 16


def shard_towers_config(torch, name):
    """``SHARD_TOWERS[name]`` at full width, fp32 parameters and compute,
    'attn' checkpointing, no dropout: CLIP at ``DDP_DEPTH`` layers,
    Swin-B and VideoSwin at ``SHARD_STAGES`` blocks, AST and BEATs at
    ``DDP_DEPTH``'s audio layers, BERT-base at its layers."""
    import dataclasses

    from vast_tpu_torch.models.ast import AstConfig
    from vast_tpu_torch.models.beats import BeatsConfig
    from vast_tpu_torch.models.bert import BertConfig
    from vast_tpu_torch.models.clip_vit import CLIP_PRESETS
    from vast_tpu_torch.models.swin import SWIN_PRESETS
    from vast_tpu_torch.models.vast import VASTConfig
    from vast_tpu_torch.models.videoswin import VideoSwinConfig

    f32 = torch.float32
    sub = dict(dtype=f32, param_dtype=f32, remat=True, remat_policy="attn")
    kw = SHARD_TOWERS[name]
    vtype = kw["vision_encoder_type"]
    if vtype in CLIP_PRESETS:
        vision = dataclasses.replace(CLIP_PRESETS[vtype],
                                     layers=DDP_DEPTH["vision"], **sub)
    elif vtype in SWIN_PRESETS:
        vision = dataclasses.replace(SWIN_PRESETS[vtype],
                                     depths=SHARD_STAGES, **sub)
    else:
        vision = VideoSwinConfig(depths=SHARD_STAGES, **sub)
    audio = (AstConfig(num_hidden_layers=DDP_DEPTH["audio"], **sub)
             if kw.get("audio_encoder_type") == "ast"
             else BeatsConfig(encoder_layers=DDP_DEPTH["audio"], **sub))
    return VASTConfig(
        dtype=f32, param_dtype=f32, checkpointing=True, remat_policy="attn",
        max_subtitle_len=CLI_SUBTITLE_LEN, vision_cfg=vision,
        audio_cfg=audio,
        bert_cfg=BertConfig(num_hidden_layers=DDP_DEPTH["bert"],
                            hidden_dropout_prob=0.0, **sub), **kw)


def shard_towers_launches(name, data_ranks):
    """What one rank launches (fp32: the mma.sync / CUDA-core entries):
    the step's (one a layer or block for a forward with its lse and for
    its backward; Swin's 49-token windows take the plain route) and, for
    CLIP + AST, the evaluation's over its data rank's clips, by stage."""
    v, a, bert = DDP_DEPTH["vision"], DDP_DEPTH["audio"], DDP_DEPTH["bert"]
    beats = {"tmajor_attention_fwd_bias": a, "tmajor_attention_bwd_bias": a,
             "tmajor_attention_bwd_lse": a}
    blocks = sum(SHARD_STAGES)
    step = {"clip_ast": {"flash_attention_fwd_lse": v + a,
                         "flash_attention_bwd": v + a},
            "videoswin_beats": beats | {"flash_attention_fwd_lse": blocks,
                                        "flash_attention_bwd_dbias": blocks},
            "swin_beats": beats}[name]
    if name != "clip_ast":
        return step, None
    clips = SHARD_EVAL_CLIPS // data_ranks
    batches, calls = clips // SHARD_CLIPS, clips // RERANK_CANDS
    return step, {"vision": {"flash_attention_fwd": v * batches},
                  "audio": {"flash_attention_fwd": a * batches},
                  "rerank": {"flash_attention_fwd": bert * calls}}


def shard_eval_batches(np, drank, dsize):
    """This data rank's contiguous share of 16 synthetic clips at 336 px
    (``synthetic_batches``), in batches of ``SHARD_CLIPS``."""
    clips = synthetic_batches(np, 336)
    whole = {k: (sum((b[k] for b in clips), []) if isinstance(b0, list)
                 else np.concatenate([b[k] for b in clips]))
             for k, b0 in clips[0].items()}
    n = SHARD_EVAL_CLIPS // dsize
    return [{k: v[i:i + SHARD_CLIPS] for k, v in whole.items()}
            for i in range(drank * n, (drank + 1) * n, SHARD_CLIPS)]


def shard_towers_eval(torch, np, model, dev, mesh, drank, dsize):
    """``evaluate_ret`` (ret%tva, every text reranking every clip) over
    this data rank's share of the 16 clips: its seconds, launches by
    stage and the ITC and ITM score matrices."""
    from vast_tpu_torch.evaluation.evaluation_mm import evaluate_ret
    from vast_tpu_torch.ops import flash_attention as fa

    batches = shard_eval_batches(np, drank, dsize)
    calls = []
    model.eval()
    with TowerLaunches(fa, model) as by_stage, recorded_scores(calls):
        zero_launches(fa)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        log = evaluate_ret(model, ["tva"], batches,
                           {"itm_rerank_num": SHARD_EVAL_CLIPS},
                           vision_transforms="none", device=dev, mesh=mesh)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    model.train()
    rest = {k: v - by_stage["vision"].get(k, 0)
            - by_stage["audio"].get(k, 0) for k, v in launches.items()}
    by_stage["rerank"] = {k: v for k, v in rest.items() if v}
    return {"eval_s": seconds, "eval_launches": launches,
            "eval_by_stage": by_stage, "eval_log": log}, calls


def wait_for_reference(path):
    """Wait for the reference run's file ``path`` (the reference runs
    beside the ranks); fail where the reference failed or outlasts
    ``DDP_TIMEOUT``."""
    failed = os.path.join(os.path.dirname(path), "reference_failed")
    deadline = time.monotonic() + DDP_TIMEOUT
    while not os.path.exists(path):
        check(not os.path.exists(failed), "shard_towers: the reference "
              "run failed")
        check(time.monotonic() < deadline, f"shard_towers: no {path}")
        time.sleep(0.5)


def shard_towers_run(torch, np, rank, world, dev, ref_dir):
    """Each model of ``SHARD_TOWERS`` in turn, from ``ddp_model``'s seeded
    init, on this rank's data rows of ``ddp_batch`` (336 px for CLIP):
    CLIP + AST's evaluation, then one ret%tva train step. A world of one
    is the reference: unsharded, it saves its losses, gradients,
    parameters after the step and score matrices under ``ref_dir``. On
    ``SHARD_MESH`` the state is sharded (``shard_state(fsdp=True,
    tp=True)``); each rank reports its heads, launches and bytes against
    the plan, and rank 0 its errors against the reference."""
    import gc

    from vast_tpu_torch import parallel
    from vast_tpu_torch.ops import flash_attention as fa
    from vast_tpu_torch.parallel import collectives
    from vast_tpu_torch.training.pipeline import shard_bytes
    from vast_tpu_torch.training.step import (create_train_state,
                                              make_train_step, shard_state)

    save = world == 1
    mesh = None if save else parallel.create_mesh(**SHARD_MESH)
    group = parallel.data_group(mesh)
    drank, dsize = parallel.group_rank(group), parallel.group_size(group)
    out = {"rank": rank, "world": world, "device": str(dev),
           "data_rank": [drank, dsize]}
    for name, kw in SHARD_TOWERS.items():
        t0 = time.perf_counter()
        model, opt = ddp_model(torch, dev, shard_towers_config(torch, name))
        state = create_train_state(model, opt)
        if not save:
            state = shard_state(mesh, state, fsdp=True, tp=True)
        sh = state.sharding
        res = {"heads": heads_by_stage(model),
               "build_s": time.perf_counter() - t0}
        ref_path = os.path.join(ref_dir, f"shard_towers_{name}.pt")
        calls = None
        if name == "clip_ast":
            got, calls = shard_towers_eval(torch, np, model, dev, mesh,
                                           drank, dsize)
            res |= got
        step = make_train_step(model, state.opt, "ret%tva", sharding=sh)
        batch = ddp_rows(torch, np, drank, dsize, dev,
                         kw.get("vision_resolution", 224))
        bwd_by_lq, bwd = {}, fa.flash_attention_bwd

        def tallied_bwd(q, *args, **kwargs):
            bwd_by_lq[q.shape[2]] = bwd_by_lq.get(q.shape[2], 0) + 1
            return bwd(q, *args, **kwargs)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        with TowerLaunches(fa, model) as by_tower:
            fa.flash_attention_bwd = tallied_bwd
            try:
                zero_launches(fa)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                state, metrics = step(state, batch,
                                      torch.Generator().manual_seed(SEED))
                torch.cuda.synchronize(dev)
                res["step_s"] = time.perf_counter() - t0
                res["launches"] = {k: v for k, v in fa.LAUNCHES.items()
                                   if v}
            finally:
                fa.flash_attention_bwd = bwd
        res |= {"lse_by_tower": {t: c.get("flash_attention_fwd_lse", 0)
                                 for t, c in by_tower.items()},
                "bwd_by_lq": {str(k): v for k, v in bwd_by_lq.items()},
                "max_memory_allocated":
                    torch.cuda.max_memory_allocated(dev),
                "metrics": {k: v.item() for k, v in metrics.items()}}
        named = dict(model.named_parameters())
        t0 = time.perf_counter()         # the save, or the comparison
        if save:
            # written whole, then renamed: the ranks wait for the name
            torch.save({"metrics": res["metrics"],
                        "grads": {n: None if p.grad is None
                                  else p.grad.cpu()
                                  for n, p in named.items()},
                        "params": {n: p.detach().cpu()
                                   for n, p in named.items()},
                        "scores": calls}, ref_path + ".tmp")
            os.replace(ref_path + ".tmp", ref_path)
        else:
            res |= {"bytes": shard_bytes(state),
                    "planned": planned_bytes(state)}
            finger = torch.stack([p.detach().double().abs().sum()
                                  for n, p in named.items()
                                  if sh.plans[n].whole])
            prints = collectives.all_gather_detached(finger[None])
            res["ranks_agree"] = bool((prints == prints[0]).all())
            whole = {}
            for n, p in named.items():
                g = None if p.grad is None else sh.full(n, p.grad)
                w = sh.full(n, p.detach())
                if rank == 0:
                    w = w.clone()
                    w.grad = g if g is not None and bool(g.any()) else None
                    whole[n] = w
            if rank == 0:
                wait_for_reference(ref_path)
                ref = torch.load(ref_path, map_location=dev,
                                 weights_only=False)
                res |= ddp_errors(torch, whole, res["metrics"], ref)
                if calls is not None:
                    res["score_agreement"] = [
                        score_agreement(a, b)
                        | {"reference_largest": float(np.abs(b[0]).max())}
                        for a, b in zip(calls, ref["scores"], strict=True)]
                del ref
            del whole
        res["compare_s"] = time.perf_counter() - t0
        out[name] = res
        del model, opt, state, step, batch, named
        gc.collect()
        torch.cuda.empty_cache()
        parallel.barrier()
    return out


def phase_shard_towers(torch, np, tmp):
    """CLIP-L/14-336 + AST, VideoSwin + BEATs and Swin-B + BEATs (each
    with BERT-base; ``shard_towers_config``) sharded over fsdp 2 x tp 2:
    a world of one under NCCL (the reference), then four ranks sharing
    the card over gloo (and four over NCCL where the machine shows four
    cards), on the same seeded weights and global batch of ``BATCH``
    clips (4 a data rank). For each model the losses, every gradient and
    every parameter after the step within ddp_step's tolerances
    (``ddp_errors``); every rank's losses equal, its parameter and moment
    bytes exactly as the plan gives them, its towers on their tp heads
    (``SHARD_TOWER_HEADS``) and its launches as one rank's at those heads
    (``shard_towers_launches``, the reference's own too); for CLIP + AST
    the evaluation's ITC and ITM scores within ``SHARD_SCORE_ATOL`` of
    the reference's largest entry, R@k moving only across a near-tie.
    The reference runs beside the gloo ranks, which wait for its files:
    the times of each include the other's load on the host and the card.
    Returns rank 0 of the gloo run's results."""
    import threading

    reference = {}

    def run_reference():
        try:
            reference["ranks"] = spawn_ranks(
                1, "nccl", tmp, "towers_reference", "shard_towers_run", tmp)
        except Exception as exc:          # reported after the join
            reference["error"] = exc
            open(os.path.join(tmp, "reference_failed"), "w").close()

    beside = threading.Thread(target=run_reference)
    beside.start()
    try:
        runs = {"gloo_4_ranks_1_card": spawn_ranks(
            SHARD_WORLD, "gloo", tmp, "towers_gloo", "shard_towers_run",
            tmp)}
    finally:
        beside.join()
    if "error" in reference:
        raise reference["error"]
    (one,) = reference["ranks"]
    if torch.cuda.device_count() >= SHARD_WORLD:
        runs["nccl_4_ranks_4_cards"] = spawn_ranks(
            SHARD_WORLD, "nccl", tmp, "towers_nccl", "shard_towers_run", tmp)
    for name in SHARD_TOWERS:
        step, evaluation = shard_towers_launches(name, 1)
        r = one[name]
        check(r["launches"] == step, f"shard_towers {name} reference: "
              f"launches {r['launches']} != {step}")
        if evaluation is not None:
            check(r["eval_by_stage"] == evaluation, f"shard_towers {name} "
                  f"reference: evaluation launches {r['eval_by_stage']}")
        for run, ranks in runs.items():
            step, evaluation = shard_towers_launches(name, 2)
            losses = {json.dumps(r[name]["metrics"], sort_keys=True)
                      for r in ranks}
            check(len(losses) == 1, f"shard_towers {name} {run}: the "
                  f"ranks' losses")
            for r in ranks:
                got, tag = r[name], f"shard_towers {name} {run} rank " \
                                    f"{r['rank']}"
                check(got["launches"] == step,
                      f"{tag}: launches {got['launches']} != {step}")
                check(got["heads"] == SHARD_TOWER_HEADS[name],
                      f"{tag}: heads {got['heads']}")
                check(got["ranks_agree"], f"{tag}: the ranks' whole "
                      f"parameters")
                for key in ("param_bytes", "moment_bytes"):
                    check(got["bytes"][key] == got["planned"][key],
                          f"{tag}: {key} {got['bytes'][key]} != planned "
                          f"{got['planned'][key]}")
                if evaluation is not None:
                    check(got["eval_by_stage"] == evaluation,
                          f"{tag}: evaluation launches "
                          f"{got['eval_by_stage']} != {evaluation}")
                    check(got["eval_log"] == ranks[0][name]["eval_log"],
                          f"{tag}: the ranks' R@k")
            r0 = ranks[0][name]
            check("loss_rel" in r0, f"shard_towers {name} {run}: rank 0's "
                  f"errors")
            for sc in r0.get("score_agreement", []):
                lim = SHARD_SCORE_ATOL * sc["reference_largest"]
                check(sc["max_abs_diff"] < lim, f"shard_towers {name} "
                      f"{run}: scores differ by {sc['max_abs_diff']}, not "
                      f"under {lim}")
                check(all(m["gap"] <= 2 * sc["max_abs_diff"]
                          for m in sc["moved"]),
                      f"shard_towers {name} {run}: a rank moved beyond a "
                      f"near-tie {sc['moved']}")
            if evaluation is not None:
                check(len(r0["score_agreement"]) == 2,
                      f"shard_towers {name} {run}: ITC and ITM matrices")
    gloo = runs["gloo_4_ranks_1_card"]
    reduced = {
        "clip_ast": {"vision layers": [24, DDP_DEPTH["vision"]],
                     "audio layers": [12, DDP_DEPTH["audio"]],
                     "bert layers": [12, DDP_DEPTH["bert"]]},
        "videoswin_beats": {"vision blocks by stage": [[2, 2, 18, 2],
                                                       list(SHARD_STAGES)],
                            "audio layers": [12, DDP_DEPTH["audio"]],
                            "bert layers": [12, DDP_DEPTH["bert"]]},
        "swin_beats": {"vision blocks by stage": [[2, 2, 18, 2],
                                                  list(SHARD_STAGES)],
                       "audio layers": [12, DDP_DEPTH["audio"]],
                       "bert layers": [12, DDP_DEPTH["bert"]]}}
    emit({"phase": "shard_towers", "task": "ret%tva", "global_batch": BATCH,
          "mesh": SHARD_MESH, "dtype": "float32", "remat_policy": "attn",
          "models": {n: kw | {"reduced": reduced[n],
                              "heads_per_rank": SHARD_TOWER_HEADS[n],
                              "launches_per_rank": dict(zip(
                                  ("step", "evaluation"),
                                  shard_towers_launches(n, 2)))}
                     for n, kw in SHARD_TOWERS.items()},
          "evaluation": {"model": "clip_ast", "clips": SHARD_EVAL_CLIPS,
                         "itm_rerank_num": SHARD_EVAL_CLIPS,
                         "score_atol_of_largest": SHARD_SCORE_ATOL},
          "tolerances": {"loss_rel": DDP_LOSS_RTOL,
                         "grad_rel_to_tensor_max": DDP_GRAD_RTOL,
                         "param_in_lr_where_grad_firm": DDP_PARAM_LR_TOL,
                         "param_bound_in_lr": 2.0},
          "reference": one,
          "share_of_whole": {
              n: {k: gloo[0][n]["bytes"][k]
                  / gloo[0][n]["planned"][f"whole_{k}"]
                  for k in ("param_bytes", "moment_bytes")}
              for n in SHARD_TOWERS},
          "runs": runs, "cards": torch.cuda.device_count(),
          "cross_card_nccl": "nccl_4_ranks_4_cards" in runs})
    return gloo[0]


def shard_cli_config(root):
    """``ddp_cli_config``'s copy with ``run_cfg.fsdp`` and ``tp`` set."""
    with open(ddp_cli_config(root)) as f:
        cfg = json.load(f)
    cfg["run_cfg"] |= {"fsdp": True, "tp": True}
    path = os.path.join(root, "retrieval-msrvtt-shard.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def shard_train_run(torch, np, rank, world, dev, cfg_path, reduced,
                    out_dir):
    """``pipeline.train`` on ``create_mesh(**SHARD_MESH)`` (``run_cfg.fsdp``
    and ``tp`` set) from the seeded init made ``well_conditioned``:
    ``SHARD_STEPS`` steps, one evaluation and one save at the end; the whole state gathered (rank 0 holds the saved file
    against it and loads it into an unsharded model); then
    ``pipeline.test`` of the saved file in an unsharded model on every
    rank, over the same mesh."""
    from vast_tpu_torch import parallel, run
    from vast_tpu_torch.ops import flash_attention as fa
    from vast_tpu_torch.training import optimizer as optim_mod
    from vast_tpu_torch.training import pipeline
    from vast_tpu_torch.training.optimizer import build_optimizer
    from vast_tpu_torch.training.step import create_train_state

    mesh = parallel.create_mesh(**SHARD_MESH)
    opts = run.get_args(["--config", cfg_path] + reduced)
    pipeline.initialize(opts)
    tok = pipeline.build_tokenizer(opts)
    model = pipeline.build_model(opts, dev, tok)
    # the seeded init, well conditioned: bf16 scores of a sharded and an
    # unsharded model then differ by a few roundings (the init alone left
    # ITC scores 6% of the largest apart on the H100)
    pipeline.init_params(model, opts)
    well_conditioned(torch, model)
    opt, _ = build_optimizer(model, opts.run_cfg, opts.model_cfg,
                             SHARD_STEPS)
    train_loader = pipeline.create_train_dataloaders(opts, tok, mesh)
    val = pipeline.create_val_dataloaders(opts, tok, mesh)
    # one evaluation and one save, after the last step
    opts.run_cfg.valid_steps = SHARD_STEPS + 2
    zero_launches(fa)
    zero_launches(optim_mod)
    torch.cuda.reset_peak_memory_stats(dev)
    timings, sharded_scores, tested_scores = {}, [], []
    t0 = time.perf_counter()
    with recorded_scores(sharded_scores):
        state, logged = pipeline.train(
            model, opts, tok, train_loader, val,
            state=create_train_state(model, opt), timings=timings,
            mesh=mesh)
    torch.cuda.synchronize(dev)
    out = {"rank": rank, "train_s": time.perf_counter() - t0,
           "timings": timings, "heads": heads_by_stage(model),
           "sharded": state.sharding is not None,
           "launches": {k: v for k, v in fa.LAUNCHES.items() if v},
           "adam": adam_counts(state.opt),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "bytes": pipeline.shard_bytes(state),
           "logged": {k: dict(v) for k, v in logged.items()}}
    ckpt = os.path.join(out_dir, "ckpt", f"model_step_{SHARD_STEPS}.pt")
    whole = state.sharding.full_state_dict(keep=rank == 0)
    if rank == 0:
        saved = torch.load(ckpt, map_location=dev, weights_only=True)
        out["files"] = sorted(os.listdir(os.path.dirname(ckpt)))
        out["saved_keys_equal"] = list(saved) == list(whole)
        out["saved_differs"] = [k for k in saved if k not in whole
                                or not torch.equal(saved[k], whole[k])]
        del saved
    del whole, state, model
    torch.cuda.empty_cache()
    parallel.barrier()
    plain = pipeline.build_model(opts, dev, tok)
    reload = plain.load_state_dict(torch.load(
        ckpt, map_location=dev, weights_only=True), strict=False)
    out["reload"] = {"missing": reload.missing_keys,
                     "unexpected": reload.unexpected_keys}
    zero_launches(fa)
    with recorded_scores(tested_scores):
        out["tested"] = pipeline.test(plain, opts, tok, val, mesh=mesh)
    out["test_launches"] = {k: v for k, v in fa.LAUNCHES.items() if v}
    out["scores"] = [score_agreement(a, b) for a, b in
                     zip(sharded_scores, tested_scores, strict=True)]
    return out


class recorded_scores:
    """Each ``compute_metric_ret`` call's (score matrix, ids, ids_txt,
    direction) while the context lasts, appended to ``calls``."""

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        import numpy as np

        from vast_tpu_torch.evaluation import evaluation_mm

        self.module, self.real = evaluation_mm, evaluation_mm.compute_metric_ret

        def recorded(score, ids, ids_txt, direction="forward"):
            self.calls.append((np.array(score), list(ids), list(ids_txt),
                               direction))
            return self.real(score, ids, ids_txt, direction)

        evaluation_mm.compute_metric_ret = recorded
        return self.calls

    def __exit__(self, *exc):
        self.module.compute_metric_ret = self.real


def score_agreement(a, b):
    """Two evaluations' score matrices of the same rows in the same order
    (ITC or ITM; bf16 arithmetic that sums in another order): their
    largest difference over the larger's largest entry, and the texts
    whose ground truth ranks differently between them, each with the gap
    from its ground truth's score to the nearest other score of its row
    (a near-tie where it is within twice the difference)."""
    import numpy as np

    (s1, ids1, txt1, d1), (s2, ids2, txt2, d2) = a, b
    check((ids1, txt1, d1) == (ids2, txt2, d2) and d1 == "forward",
          "the evaluations' rows and their order")
    diff = float(np.abs(s1 - s2).max())
    scale = float(max(np.abs(s1).max(), np.abs(s2).max(), 1e-30))
    first = {v: j for j, v in reversed(list(enumerate(ids1)))}
    moved = []
    for i, t in enumerate(txt1):
        g = first[t]
        ranks = [int((s[i] > s[i, g]).sum() + (s[i, :g] == s[i, g]).sum())
                 for s in (s1, s2)]
        if ranks[0] != ranks[1]:
            others = np.delete(s1[i], g)
            moved.append({"text": i, "ranks": ranks,
                          "gap": float(np.abs(others - s1[i, g]).min())})
    return {"max_abs_diff": diff, "largest": scale, "moved": moved}


def phase_shard_train(torch, np, root):
    """``pipeline.train`` with ``mesh=create_mesh(dp=1, fsdp=2, tp=2)``
    in four spawned ranks sharing the card over gloo, on the released
    retrieval-msrvtt.json (``shard_cli_config``: full width,
    ``DDP_DEPTH`` layers, bf16: the Hopper bodies) over write_msrvtt's
    clips: ``SHARD_STEPS`` steps of the global batch 8 (4 a data rank,
    the same 4 for both ranks of a tp group), one evaluation and one
    save. The saved ``model_step_3.pt`` must hold the ranks' whole
    tensors under every reference name and load into an unsharded model
    with no key missing or unexpected; ``pipeline.test`` of it, unsharded
    on the same mesh (the rows in the same ranks' order), must give the
    sharded evaluation's ITC and ITM scores within ``SHARD_SCORE_ATOL``
    and its R@k but where a near-tie's order flips; every rank must run
    its tp heads and launch rows 1-4 and 6 as counted."""
    import shutil

    cfg_path = shard_cli_config(root)
    out_dir = os.path.join(root, "output_shard")
    reduced = ["--train_batch_size", "8", "--test_batch_size", "8",
               "--checkpointing", "true", "--first_eval", "false",
               "--num_train_steps", str(SHARD_STEPS),
               "--output_dir", out_dir]
    tmp = os.path.join(root, "shard_ranks")
    os.makedirs(tmp, exist_ok=True)
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(SHARD_WORLD, "gloo", tmp, "shard_train",
                            "shard_train_run", cfg_path, reduced, out_dir)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.rmtree(out_dir + "_test", ignore_errors=True)
    r0 = ranks[0]
    v, a, bert = DDP_DEPTH["vision"], DDP_DEPTH["audio"], DDP_DEPTH["bert"]
    step = {"tmajor_attention_fwd": v, "tmajor_attention_fwd_bias": a,
            "tmajor_attention_fwd_sm90": v + a,
            "tmajor_attention_bwd": v, "tmajor_attention_bwd_bias": a,
            "tmajor_attention_bwd_sm90": v + a,
            "tmajor_attention_bwd_lse": v + a}
    # per data rank: its 8 test clips in 2 batches of 4, the rerank's 16
    # segments split 8 a data rank: 2 calls of 4
    evaluation = {"tmajor_attention_fwd": 2 * v,
                  "tmajor_attention_fwd_bias": 2 * a,
                  "tmajor_attention_fwd_sm90": 2 * (v + a),
                  "flash_attention_fwd": 2 * bert,
                  "flash_attention_fwd_sm90": 2 * bert}
    want = {k: SHARD_STEPS * step.get(k, 0) + evaluation.get(k, 0)
            for k in set(step) | set(evaluation)}
    key = None
    for r in ranks:
        check(r["sharded"], f"shard_train rank {r['rank']}: not sharded")
        check(r["heads"] == SHARD_HEADS, f"shard_train rank {r['rank']}: "
              f"heads {r['heads']}")
        check(r["launches"] == want, f"shard_train rank {r['rank']}: "
              f"launches {r['launches']} != {want}")
        check(r["adam"]["kernel_launches"] == SHARD_STEPS
              and r["adam"]["tensors"] == r["adam"]["trainable"],
              f"shard_train rank {r['rank']}: the optimizer's kernel "
              f"{r['adam']} over {SHARD_STEPS} steps")
        check(r["test_launches"] == evaluation, f"shard_train rank "
              f"{r['rank']}: testing launches {r['test_launches']}")
        check(r["logged"] == r0["logged"], "the ranks' evaluations")
        check(not r["reload"]["missing"] and not r["reload"]["unexpected"],
              f"shard_train rank {r['rank']}: reload {r['reload']}")
        key = next(iter(r["tested"]))
        # the unsharded re-test scores the same rows in the same order;
        # tp sums every projection's heads in another order, so bf16
        # scores may differ: within SHARD_SCORE_ATOL, and a text's ground
        # truth may change rank
        # only across a near-tie (another score of its row within twice
        # the matrices' largest difference: each may move by it)
        check(len(r["scores"]) == 2, f"shard_train: {len(r['scores'])} "
              f"score matrices an evaluation, not ITC and ITM")
        emit({"phase": "shard_train_scores", "rank": r["rank"],
              "score_agreement": dict(zip(("itc", "itm"), r["scores"]))})
        for sc in r["scores"]:
            check(sc["max_abs_diff"] <= SHARD_SCORE_ATOL, f"shard_train rank "
                  f"{r['rank']}: scores differ by {sc['max_abs_diff']}")
            check(all(m["gap"] <= 2 * sc["max_abs_diff"]
                      for m in sc["moved"]),
                  f"shard_train rank {r['rank']}: a rank moved beyond a "
                  f"near-tie {sc['moved']}")
        check(r["tested"][key] == r0["tested"][key], "the ranks' re-tests")
    check(r0["files"] == [f"model_step_{SHARD_STEPS}.pt",
                          f"optimizer_step_{SHARD_STEPS}.pt"],
          f"shard_train files {r0['files']}")
    check(r0["saved_keys_equal"] and not r0["saved_differs"],
          f"shard_train: the saved file differs from the ranks' tensors at "
          f"{r0['saved_differs'][:5]}")
    emit({"phase": "shard_train", "config": "vast_tpu/configs/finetune_cfg/"
          "retrieval-msrvtt.json", "mesh": SHARD_MESH,
          "launch": "pipeline.train(..., mesh=create_mesh(dp=1, fsdp=2, "
          "tp=2)) in 4 spawned ranks, gloo on one card",
          "reduced": {"vision layers": [40, v], "audio layers": [12, a],
                      "bert layers": [12, bert],
                      "train_batch_size": [64, 8],
                      "test_batch_size": [64, 8],
                      "checkpointing": [False, True],
                      "num_train_steps": ["3.6 epochs", SHARD_STEPS],
                      "evaluations": ["every 10% of the run", 1],
                      "first_eval": [True, False],
                      "vision_format": ["video_rawvideo", "video_frame"]},
          "wall_s": wall,
          "ranks": {r["rank"]: {k: r[k] for k in (
              "train_s", "timings", "max_memory_allocated", "bytes",
              "launches", "adam")} for r in ranks},
          "launches_per_rank": {"train": want, "testing": evaluation},
          "r_at_k": {"sharded": {name[len(key) + 1:]: hist[str(SHARD_STEPS)]
                                 for name, hist in r0["logged"].items()},
                     "unsharded_retest": r0["tested"][key]},
          "score_agreement": dict(zip(("itc", "itm"), r0["scores"])),
          "score_atol": SHARD_SCORE_ATOL, "checkpoint": r0["files"]})
    return r0["launches"]


def phase_remat_offload(torch, np):
    """One ret%tvas train step (forward and backward) of ``ddp_model``
    on ``ddp_batch`` in one process under 'attn', 'attn_offload', 'dots'
    and 'dots_offload': each offload policy's losses and gradients equal
    to its policy's within ddp_step's tolerances, the bytes its cache
    moved to pinned host memory, and its peak device memory lower."""
    import dataclasses

    from vast_tpu_torch.models import remat

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    model, _ = ddp_model(torch, dev)
    towers = (model.vision_tower, model.audio_encoder.encoder,
              model.multimodal_encoder.bert)
    batch = ddp_rows(torch, np, 0, 1, dev)
    moved = []
    real = remat._to_host

    def counted(storage):
        moved.append(sum(e.val.numel() * e.val.element_size()
                         for e in remat._cached(storage)
                         if e.val.device.type == "cuda"))
        real(storage)

    runs, ref = {}, {}
    remat._to_host = counted
    try:
        for policy in ("attn", "attn_offload", "dots", "dots_offload"):
            for t in towers:
                t.cfg = dataclasses.replace(t.cfg, remat_policy=policy)
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            moved.clear()
            t0 = time.perf_counter()
            out = model(batch, "ret%tvas", compute_loss=True,
                        generator=torch.Generator().manual_seed(SEED))
            sum(out.values()).backward()
            torch.cuda.synchronize()
            runs[policy] = {
                "step_s": time.perf_counter() - t0,
                "peak_bytes": torch.cuda.max_memory_allocated() - base,
                "moved_to_host_bytes": sum(moved),
                "losses": {k: v.item() for k, v in out.items()}}
            grads = {n: p.grad.detach().clone() for n, p in
                     model.named_parameters() if p.grad is not None}
            del out
            base_policy = policy.removesuffix("_offload")
            if policy == base_policy:
                ref[policy] = grads
                continue
            want = ref.pop(base_policy)
            check(set(grads) == set(want), f"{policy}: gradient presence")
            errs = [((grads[n] - g).abs().max() / g.abs().max().clamp(
                min=1e-30)).item() for n, g in want.items()]
            loss_rel = max(abs(runs[policy]["losses"][k] - w) / abs(w)
                           for k, w in runs[base_policy]["losses"].items())
            runs[policy] |= {"grad_max_rel_err": max(errs),
                             "loss_rel": loss_rel,
                             "peak_lower_by_bytes":
                                 runs[base_policy]["peak_bytes"]
                                 - runs[policy]["peak_bytes"]}
            del want, grads
            check(loss_rel <= DDP_LOSS_RTOL, f"{policy}: losses {loss_rel}")
            check(max(errs) <= DDP_GRAD_RTOL, f"{policy}: gradients "
                  f"{max(errs)}")
            check(runs[policy]["moved_to_host_bytes"] > 0,
                  f"{policy}: nothing left the device")
            check(runs[policy]["peak_lower_by_bytes"] > 0,
                  f"{policy}: peak {runs[policy]['peak_bytes']} not below "
                  f"{base_policy}'s {runs[base_policy]['peak_bytes']}")
    finally:
        remat._to_host = real
        del model
        torch.cuda.empty_cache()
    emit({"phase": "remat_offload", "task": "ret%tvas", "batch": BATCH,
          "dtype": "float32", "depth": DDP_DEPTH,
          "tolerances": {"loss_rel": DDP_LOSS_RTOL,
                         "grad_rel_to_tensor_max": DDP_GRAD_RTOL},
          "runs": runs})


def body_of(spec):
    body = BODIES[spec["layout"]]
    return body[spec["name"]] if isinstance(body, dict) else body


def window_stage(torch, grid, heads, gen):
    """q, k, v (packed views), the table (N(0, 0.02)), the shifted
    windows' region labels, the cotangent and the plain version's
    table-plus-mask sum of one stage's window blocks."""
    from vast_tpu_torch.models import videoswin
    from vast_tpu_torch.ops import window_attention as wa

    win = tuple(min(a, b) for a, b in zip((8, 7, 7), grid))
    shift = tuple(0 if w >= g else w // 2 for w, g in zip(win, grid))
    n_win = math.prod(g // w for g, w in zip(grid, win))
    n, d, w = math.prod(win), 32, WINDOW_CLIPS * n_win
    q, k, v = (t.transpose(1, 2) for t in torch.randn(
        w, n, 3, heads, d, device="cuda", generator=gen).to(
            torch.bfloat16).unbind(2))
    table = 0.02 * torch.randn(heads, n, n, device="cuda", generator=gen)
    labels = wa.region_labels(torch.from_numpy(videoswin.shift_mask_3d(
        *grid, win, shift))).to("cuda")
    do = torch.randn(w, n, heads, d, device="cuda", generator=gen).to(
        torch.bfloat16).transpose(1, 2)
    return q, k, v, table, labels, do, wa._window_bias_plain(table, labels, w)


def window_errors(torch, fa, kind, got, want, case, label):
    """Each output of the window kernels against the plain version, held
    to the bf16 rules of the kernel rows (``check``: raises past one):
    the forward's output to one ulp of max |out| plus 2^-8 x max |v| and
    an rms of 2^-6, its lse to fp32 rounding (1e-5 x max |lse|); dq, dk
    and dv to 1.1 x 2^-8 of their sums of |terms| (``grad_errors``); the
    table's gradient, the windows' fp32 ds summed in another order than
    the plain sum's (chunks of windows, then the chunks), to 2^-16 of its
    sum of |terms|. Returns {output: its error, tolerance and why}."""
    q, k, v, full, o, lse, do, scale = case
    if kind == "fwd":
        (out, lse_k), (ref, ref_lse) = got, want
        ref = ref.float()
        diff = out.float() - ref
        err = diff.abs().max().item()
        tol = ref.abs().max().item() * 2 ** -7 + \
            v.float().abs().max().item() * 2 ** -8
        rms_rel = (diff.square().mean().sqrt()
                   / ref.square().mean().sqrt()).item()
        lse_err = (lse_k - ref_lse).abs().max().item()
        lse_tol = 1e-5 * max(ref_lse.abs().max().item(), 1.0)
        check(math.isfinite(err) and err <= tol,
              f"{label}: max abs err {err} > {tol}")
        check(math.isfinite(rms_rel) and rms_rel <= 2 ** -6,
              f"{label}: rms error / rms(ref) {rms_rel} > {2 ** -6}")
        check(math.isfinite(lse_err) and lse_err <= lse_tol,
              f"{label}: lse max abs err {lse_err} > {lse_tol}")
        return {"o": {"max_abs_err": err, "tolerance": tol,
                      "tolerance_reason": "one bf16 ulp of max |out| "
                                          "(2^-7) plus bf16 rounding of p "
                                          "(2^-8 x max |v|)",
                      "rms_rel_err": rms_rel, "rms_tolerance": 2 ** -6},
                "lse": {"max_abs_err": lse_err, "tolerance": lse_tol,
                        "tolerance_reason": "fp32 rounding of the scores: "
                                            "1e-5 x max |lse|"}}
    names = ("dq", "dk", "dv")
    terms = fa._flash_attention_bwd_abs_terms(q, k, v, full, o, lse, do,
                                              scale=scale)
    dtable_terms = terms.pop("dbias").sum(dim=0)
    errors = grad_errors(torch, {n: g.float() for n, g in zip(names, got)},
                         {n: w.float() for n, w in zip(names, want)},
                         terms, torch.bfloat16, label)
    del terms
    err = (got[3] - want[3]).abs().max().item()
    tol = 2 ** -16 * (want[3].abs() + dtable_terms).max().item()
    check(math.isfinite(err) and err <= tol,
          f"{label} dtable: max abs err {err} > {tol}")
    errors["dtable"] = {"max_abs_err": err, "tolerance": tol,
                        "tolerance_reason": "fp32 sums of the windows' ds in "
                                            "another order: 2^-16 of the sum "
                                            "of |terms|"}
    return errors


def phase_window_kernels(torch, device_name):
    """The window attention's forward (with its lse) and backward at each
    of WINDOW_STAGES, shifted, bf16 (phase 14b), each output checked
    against the plain version (``window_errors``): returns its
    ``kernels`` entries, without the launches (``window_line``)."""
    import torch.nn.functional as F

    from benchmark.counts.window_attention import window_work
    from vast_tpu_torch.ops import flash_attention as fa
    from vast_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    line = []
    for si, (grid, h, _) in enumerate(WINDOW_STAGES):
        q, k, v, table, labels, do, full = window_stage(torch, grid, h, gen)
        w, _, n, d = q.shape
        scale = d ** -0.5
        o, lse = fa._flash_attention_plain(q, k, v, full, scale=scale,
                                           return_lse=True)
        mask16 = full.to(torch.bfloat16)     # SDPA's mask in q's type
        calls = {
            "fwd": (lambda: wa.WINDOW_OP(q, k, v, table, labels, scale,
                                         True),
                    lambda: fa._flash_attention_plain(
                        q, k, v, full, scale=scale, return_lse=True),
                    lambda: fa.flash_attention(q, k, v, full, scale=scale,
                                               return_lse=True)),
            "bwd": (lambda: wa.window_attention_bwd(
                        q, k, v, table, labels, o, lse, do, scale=scale),
                    lambda: fa._flash_attention_bwd_plain(
                        q, k, v, full, o, lse, do, scale=scale,
                        return_dbias=True),
                    lambda: fa.flash_attention_bwd(
                        q, k, v, full, o, lse, do, scale=scale,
                        return_dbias=True)[3].sum(dim=0))}
        for kind, (run, plain, general) in calls.items():
            label = f"window_attention_{kind} videoswin_stage{si}"
            got, want = run(), plain()
            torch.cuda.synchronize()
            if kind == "bwd":
                want = (*want[:3], want[3].sum(dim=0))
            errors = window_errors(torch, fa, kind, got, want,
                                   (q, k, v, full, o, lse, do, scale), label)
            del got, want
            nbytes_, flops = window_work(f"window_{kind}", w, h, n, d,
                                         labels.shape[0], True)
            bound_ms, bound_by = bound(torch, device_name, nbytes_, flops,
                                       torch.bfloat16)
            kernels = profiled_kernels(torch, run, calls=5)
            by_kernel = {}
            for e in kernels:        # the kernel's name, namespace and
                name = e.key.split("namespace)::", 1)[-1]  # template cut
                name = name.split("<")[0].split("(")[0]
                by_kernel[name] = by_kernel.get(name, 0.0) + \
                    e.self_device_time_total / 5 / 1e3
            if kind == "fwd":
                library_ms = time_ms(torch, lambda: (
                    F.scaled_dot_product_attention(q, k, v, attn_mask=mask16,
                                                   scale=scale)))
            else:
                library_ms, _ = sdpa_backward_ms(torch, q, k, v, full, do,
                                                 scale)
            row = {"phase": "window_kernels",
                   "name": f"window_attention_{kind}",
                   "at": f"videoswin_stage{si}", "route": "cuda",
                   "source": SOURCE, "replaces": None, "replaces_also": [],
                   "shape": {"windows": w, "heads": h, "n": n, "d": d,
                             "masks": labels.shape[0]},
                   "errors": errors,
                   "max_abs_err": max(e["max_abs_err"]
                                      for e in errors.values()),
                   "ms": time_ms(torch, run),
                   "device_ms": sum(by_kernel.values()) if by_kernel
                   else None,
                   "device_ms_by_kernel": by_kernel or None,
                   "plain_ms": time_ms(torch, plain, **LIGHT_TIMING),
                   "general_ms": time_ms(torch, general, **LIGHT_TIMING),
                   "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "body": f"window_attention_{kind}_sm90"}
            emit(row)
            line.append(row)
        del q, k, v, table, labels, do, full, mask16, o, lse
        torch.cuda.empty_cache()
    return line


def window_line(rows, train_windows, slice_windows):
    """The ``kernels`` entries of the window rows (phase_window_kernels,
    at the cell's shapes) with their launches as the main path counted
    them by stage (head count; WindowLaunches): the forward's and the
    backward's over train_towers' counted block (five steps on 8 clips of
    ``FRAMES`` frames: each stage's heads, fewer windows than the cell's
    16 frames give), and the forward's in slice_towers' counted
    evaluation."""
    line = []
    for r in rows:
        kind = r["name"].rsplit("_", 1)[1]
        heads = r["shape"]["heads"]
        line.append(r | {
            "path": "train_towers",
            "launches": train_windows[kind].get(heads, 0),
            "launches_by_path": {"slice_towers": slice_windows[kind].get(
                heads, 0)} if kind == "fwd" else {}})
    return line


def kernels_line(bf16_rows, launches_at, by_path=None):
    """The ``kernels`` entries: each row of KERNELS with its bf16
    measurements (``bf16_rows``, in KERNELS' order), its launches on its
    path (``launches_at`` by (name, at); 0 for a shape no path reaches)
    and the kernel's launches on other paths at their own shapes
    (``by_path``, by (name, at): {phase: launches})."""
    by_path = by_path or {}
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
            "device_ms_by_kernel": r.get("device_ms_by_kernel"),
            "launches_by_path": by_path.get(key, {})})
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
    seconds = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - t0
        emit({"phase_done": phase, "seconds": seconds[phase]})
        return out

    device_name = timed("device", phase_device, torch)
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, torch, device_name)
    timed("hmajor_turns", phase_hmajor_turns, torch)
    timed("tmajor_turns", phase_tmajor_turns, torch, device_name)
    timed("bwd_turns", phase_bwd_turns, torch)
    window_rows = timed("window_kernels", phase_window_kernels, torch,
                        device_name)
    probe_rows, probe_launches = timed("tmajor_variants",
                                       phase_tmajor_variants, torch,
                                       device_name)
    rows |= probe_rows
    torch.cuda.empty_cache()
    timed("tiny", phase_tiny, torch, np)
    timed("tiny_cap_qa", phase_tiny_cap_qa, torch, np)
    launches, model, batches, run_cfg = timed("slice", phase_slice, torch,
                                              np)
    timed("profile", phase_profile, torch, model, batches, run_cfg)
    del model, batches
    torch.cuda.empty_cache()
    train_launches = timed("train", phase_train, torch, np)
    torch.cuda.empty_cache()
    timed("tiny_clip_ast", phase_tiny_clip_ast, torch, np)
    _, ca_by_stage = timed("slice_clip_ast", phase_slice_clip_ast, torch, np)
    torch.cuda.empty_cache()
    ca_lse_by_tower, ca_bwd_by_lq, ca_adam = timed(
        "train_clip_ast", phase_train_clip_ast, torch, np)
    torch.cuda.empty_cache()
    adam = timed("adam", phase_adam, torch, device_name)
    towers, slice_windows = timed("slice_towers", phase_slice_towers,
                                  torch, np)
    train_towers, train_windows = timed("train_towers", phase_train_towers,
                                        torch, np)
    torch.cuda.empty_cache()
    ddp_tmp = tempfile.mkdtemp(prefix="vast_ddp_step_")
    try:
        ddp_step = timed("ddp_step", phase_ddp_step, torch, np, ddp_tmp)
        shard_step = timed("shard_step", phase_shard_step, torch, np,
                           ddp_tmp)
        torch.cuda.empty_cache()
        shard_towers = timed("shard_towers", phase_shard_towers, torch, np,
                             ddp_tmp)
    finally:
        shutil.rmtree(ddp_tmp, ignore_errors=True)
    timed("remat_offload", phase_remat_offload, torch, np)
    with msrvtt_data(np) as (root, data_s):
        cli_launches = timed("cli_ret_tvas", phase_cli_ret_tvas, torch, np,
                             root, data_s)
        for kind in CLI_GEN:
            timed(f"cli_{kind}_tvas", phase_cli_generation, torch, np, root,
                  kind)
        pretrain = timed("cli_pretrain", phase_cli_pretrain, torch, np, root)
        torch.cuda.empty_cache()
        cli_ddp = timed("cli_ddp_ret_tvas", phase_cli_ddp_ret_tvas, torch,
                        np, root)
        torch.cuda.empty_cache()
        shard_train = timed("shard_train", phase_shard_train, torch, np,
                            root)
    emit({"phase_seconds": seconds})
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
        ("flash_attention_fwd", "tvas_rerank"): cli_launches["tvas_rerank"],
        ("attention_dma", "probe"): probe_launches["attention_dma"],
        ("attention_sect", "probe"): probe_launches["attention_sect"],
        ("tmajor_attention_fwd", "bige"):
            towers["evaclip02_bige"]["vision"]["tmajor_attention_fwd"],
        ("flash_attention_fwd", "eva02_l"):
            towers["evaclip02_large"]["vision"]["flash_attention_fwd"],
        ("flash_attention_fwd", "eva02_b"):
            towers["evaclip02_base"]["vision"]["flash_attention_fwd"],
        ("flash_attention_fwd_lse", "eva02_l"):
            train_towers["evaclip02_large"]["flash_attention_fwd_lse"],
        ("flash_attention_bwd", "eva02_l"):
            train_towers["evaclip02_large"]["flash_attention_bwd"],
        ("flash_attention_fwd", "pretrain_rerank"):
            pretrain["rerank"],
        # rank 0 of 4's run of shard_train (each rank on its tp heads)
        ("tmajor_attention_fwd", "eva01g_tp2"):
            shard_train["tmajor_attention_fwd"],
        ("tmajor_attention_fwd_bias", "beats_tp2"):
            shard_train["tmajor_attention_fwd_bias"],
        ("tmajor_attention_bwd", "eva01g_tp2"):
            shard_train["tmajor_attention_bwd"],
        ("tmajor_attention_bwd_bias", "beats_tp2"):
            shard_train["tmajor_attention_bwd_bias"],
        ("flash_attention_fwd", "tvas_rerank_tp2"):
            shard_train["flash_attention_fwd"],
        # rank 0 of 4's run of shard_towers (fp32; each rank on its tp
        # heads): CLIP + AST's evaluation by stage and step by tower and
        # query length, VideoSwin's step over its four stages
        ("flash_attention_fwd", "clip_l14_336_tp2"):
            shard_towers["clip_ast"]["eval_by_stage"]["vision"][
                "flash_attention_fwd"],
        ("flash_attention_fwd", "ast_tp2"):
            shard_towers["clip_ast"]["eval_by_stage"]["audio"][
                "flash_attention_fwd"],
        ("flash_attention_fwd", "clip_ast_rerank_tp2"):
            shard_towers["clip_ast"]["eval_by_stage"]["rerank"][
                "flash_attention_fwd"],
        ("flash_attention_fwd_lse", "clip_l14_336_tp2"):
            shard_towers["clip_ast"]["lse_by_tower"]["vision"],
        ("flash_attention_fwd_lse", "ast_tp2"):
            shard_towers["clip_ast"]["lse_by_tower"]["audio"],
        ("flash_attention_bwd", "clip_l14_336_tp2"):
            shard_towers["clip_ast"]["bwd_by_lq"]["577"],
        ("flash_attention_bwd", "ast_tp2"):
            shard_towers["clip_ast"]["bwd_by_lq"]["257"],
        ("flash_attention_fwd_lse", "videoswin_tp2"):
            shard_towers["videoswin_beats"]["lse_by_tower"]["vision"],
        ("flash_attention_bwd_dbias", "videoswin_tp2"):
            shard_towers["videoswin_beats"]["launches"][
                "flash_attention_bwd_dbias"],
    }
    # the same kernels on the other new paths, at those paths' shapes:
    # BEATs' forward in every tower's slice and train run, EVA01-g's and
    # BEATs' in the pretraining run (one frame a clip in its steps)
    by_path = {
        ("tmajor_attention_fwd_bias", "beats"): {
            "slice_towers": sum(t["audio"]["tmajor_attention_fwd_bias"]
                                for t in towers.values()),
            "train_towers": sum(t["tmajor_attention_fwd_bias"]
                                for t in train_towers.values()),
            "cli_pretrain": pretrain["launches"]["tmajor_attention_fwd_bias"]},
        ("tmajor_attention_bwd_bias", "beats"): {
            "train_towers": sum(t["tmajor_attention_bwd_bias"]
                                for t in train_towers.values()),
            "cli_pretrain": pretrain["launches"]["tmajor_attention_bwd_bias"]},
        ("tmajor_attention_fwd", "eva01g"): {
            "cli_pretrain": pretrain["launches"]["tmajor_attention_fwd"]},
        ("tmajor_attention_bwd", "eva01g"): {
            "cli_pretrain": pretrain["launches"]["tmajor_attention_bwd"]},
        ("flash_attention_fwd", "flagship_rerank"): {
            "slice_towers": sum(t["rerank"].get("flash_attention_fwd", 0)
                                for t in towers.values())},
        ("flash_attention_fwd", "tvas_rerank"): {
            "cli_ddp_ret_tvas (rank 0 of 2)": cli_ddp["flash_attention_fwd"]},
    }
    # the data-parallel phases' launches counted by rank 0 (ddp_step's in
    # fp32: the CUDA-core bodies), at their depth-cut towers' shapes
    for row, key in ((("tmajor_attention_fwd", "eva01g"),
                      "tmajor_attention_fwd"),
                     (("tmajor_attention_fwd_bias", "beats"),
                      "tmajor_attention_fwd_bias"),
                     (("tmajor_attention_bwd", "eva01g"),
                      "tmajor_attention_bwd"),
                     (("tmajor_attention_bwd_bias", "beats"),
                      "tmajor_attention_bwd_bias")):
        by_path.setdefault(row, {}).update({
            "ddp_step (rank 0 of 2, fp32)": ddp_step[key],
            "cli_ddp_ret_tvas (rank 0 of 2)": cli_ddp[key],
            "shard_step (rank 0 of 4, fp32, tp heads)": shard_step[key]})
    # BEATs at its tp heads in shard_towers (rank 0 of 4, fp32): the
    # VideoSwin and Swin-B models' steps, at shard_train's shapes
    for row in (("tmajor_attention_fwd_bias", "beats_tp2"),
                ("tmajor_attention_bwd_bias", "beats_tp2")):
        by_path.setdefault(row, {})[
            "shard_towers (rank 0 of 4, fp32)"] = sum(
                shard_towers[m]["launches"][row[0]]
                for m in ("videoswin_beats", "swin_beats"))
    # the optimizer's kernel: a launch a step of each train phase's counted
    # block (its own configuration's parameter set)
    emit({"kernels": kernels_line(
        [rows[(i, torch.bfloat16)] for i in range(len(KERNELS))],
        launches_at, by_path) + window_line(
            window_rows, train_windows, slice_windows) + adam_rows(adam, {
            "vast_evaclip01g_beats": (
                "train", train_launches["multi_tensor_adam"]),
            "vast_clipl336_ast": ("train_clip_ast", ca_adam)})})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
