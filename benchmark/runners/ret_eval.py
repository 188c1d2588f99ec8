"""Retrieval-evaluation cells: whole ``evaluate_ret`` runs back to back.

Set-up builds the program's model (bf16, its serving type) from the
seed, draws the mix's test set (numpy batches, as a loader hands them
to ``evaluate_ret``) and runs one whole evaluation, which warms up every
shape. The window runs whole evaluations until the first that ends
after ``--seconds``; the rate is their clips over all that time.

The benchmark's wrappers around the model's entry points keep, from
each evaluation, the sampled clips' condition outputs, the ITC matrix
and the ITM rerank's refined matrix, of which a fixed number of
reranked pairs is compared (``reference/ret_ref.py``), and the
shapes of the grouped ITM calls with the attention launches each made
(the FLOP and roofline counts). With ``--trace 1`` two more evaluations
run after the window: one with the program's stage clock, one under the
profiler.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import generator, harness, weights
from benchmark.counts import attention as attn_counts
from benchmark.counts import flops
from benchmark.reference import ret_ref
from benchmark.trace import traced

FWD_KEYS = attn_counts.LAUNCH_KEYS[:4]


def make_set(ctx, device) -> list:
    """The test set: numpy batches with ``ids`` and ``ids_txt``, one
    caption a clip."""
    tr, cfg = ctx.traffic, ctx.cfg
    g = generator.generator(ctx.seed, 0, device)
    vocab = cfg["bert"]["vocab_size"]
    out = []
    for s in range(0, tr["clips"], tr["batch_size"]):
        n = min(tr["batch_size"], tr["clips"] - s)
        b = generator.clip_batch(n, tr, cfg, vocab, g, device)
        host = {k: v.cpu().numpy() for k, v in b.items()}
        ids = [f"clip{i:05d}" for i in range(s, s + n)]
        out.append(host | {"ids": ids, "ids_txt": list(ids)})
    return out


def sampled_clips(ctx) -> list:
    g = generator.generator(ctx.seed, 77, "cpu")
    perm = torch.randperm(ctx.traffic["clips"], generator=g)
    return sorted(perm[:ctx.traffic["checked_clips"]].tolist())


class Recorder:
    """Wraps the model's entry points and ``rerank_scores`` to keep what
    one evaluation produced (``begin`` starts a new one)."""

    def __init__(self, model, sample, batch_size):
        from vast_tpu_torch.evaluation import evaluation_mm as em
        from vast_tpu_torch.ops import flash_attention as fa

        self.em, self.fa, self.model = em, fa, model
        self.sample, self.bs = sample, batch_size
        self.orig_rerank = em.rerank_scores
        cond_fn = model.condition_features
        grouped = model.compute_slice_scores_grouped

        def condition_features(batch, subtasks):
            out = cond_fn(batch, subtasks)
            st = subtasks[0]
            lo = self.batches * self.bs
            rows = [i - lo for i in self.sample if lo <= i < lo + self.bs]
            if rows:
                idx = torch.as_tensor(rows, device=out[f"feat_cond_{st}"]
                                      .device)
                self.cur["cond"].append(
                    out[f"condition_feats_{st}"][idx].clone())
                self.cur["feat_cond"].append(out[f"feat_cond_{st}"][idx]
                                             .clone())
            self.batches += 1
            return out

        def compute_slice_scores_grouped(cond, ids, mask):
            before = sum(fa.LAUNCHES[k] for k in FWD_KEYS)
            out = grouped(cond, ids, mask)
            launched = sum(fa.LAUNCHES[k] for k in FWD_KEYS) - before
            self.cur["calls"].append((tuple(cond.shape), tuple(ids.shape),
                                      launched))
            return out

        def rerank_scores(model, cseq, input_ids, mask, itc, *a, **kw):
            with record_function("bench.itm_rerank"):
                out = self.orig_rerank(model, cseq, input_ids, mask, itc,
                                       *a, **kw)
            self.cur["itc"], self.cur["refined"] = itc, out
            return out

        model.condition_features = condition_features
        model.compute_slice_scores_grouped = compute_slice_scores_grouped
        em.rerank_scores = rerank_scores
        self.begin()

    def begin(self):
        self.cur = {"cond": [], "feat_cond": [], "calls": []}
        self.batches = 0

    def close(self):
        self.em.rerank_scores = self.orig_rerank
        del self.model.condition_features
        del self.model.compute_slice_scores_grouped


def build(ctx, device):
    model = harness.build_program(ctx.cfg, device, torch.bfloat16)
    weights.init_weights(model, ctx.seed, device)
    model.eval()
    return model


def prepare(ctx):
    """The program's model from the seed, the test set, the sampled
    clips, the recorder around the model, and one whole evaluation as a
    function (``timings``: the program's stage clock)."""
    from vast_tpu_torch.evaluation.evaluation_mm import evaluate_ret

    device, tr = ctx.device, ctx.traffic
    model = build(ctx, device)
    data = make_set(ctx, device)
    sample = sampled_clips(ctx)
    rec = Recorder(model, sample, tr["batch_size"])
    run_cfg = {"itm_rerank_num": tr["itm_rerank_num"]}
    subtasks = [tr["task"].split("%", 1)[1]]

    def evaluation(timings=None):
        rec.begin()
        with record_function("bench.evaluate_ret"):
            log = evaluate_ret(model, subtasks, data, run_cfg,
                               vision_transforms=tr["vision_transforms"],
                               device=device, timings=timings)
        harness.sync(device)
        return log

    return model, data, sample, rec, evaluation


def run(ctx) -> dict:
    from vast_tpu_torch.ops import flash_attention as fa

    device, tr, cfg = ctx.device, ctx.traffic, ctx.cfg
    model, data, sample, rec, evaluation = prepare(ctx)
    evaluation()                                     # warm-up
    harness.free(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - ctx.t_start

    evals, t0 = 0, time.perf_counter()
    while True:
        log = evaluation()
        evals += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    got = rec.cur
    dev = harness.device_info(device)
    clips = tr["clips"] * evals
    harness.log(f"window: {evals} evaluations, {window_s:.3f} s, "
                f"{clips / window_s:.4f} clips/s; recalls {log}")
    # (candidates, condition length, text rows, text length) a call
    shapes = [(c[0], c[1], t[0], t[1]) for c, t, _ in got["calls"]]
    obs = {"kind": "eval", "evals": evals, "window_s": window_s,
           "unit_s": window_s / evals,
           "flops_per_eval": flops.eval_pass(cfg, tr, shapes),
           "device_name": dev["kind"]}
    if ctx.trace:
        timings = {}
        t1 = time.perf_counter()
        evaluation(timings)
        obs["stage_s"] = timings
        obs["staged_eval_s"] = time.perf_counter() - t1
        before = dict(fa.LAUNCHES)
        with traced(device) as tw:
            evaluation()
        counted = sum(fa.LAUNCHES[k] - before[k] for k in FWD_KEYS)
        obs["trace"], obs["profiled"] = tw["summary"], 1
        obs["attention_launches"] = eval_launches(cfg, tr, rec.cur["calls"])
        obs["attention_launches_counted"] = counted
        harness.log(f"traced: one evaluation {tw['summary']['wall_s']:.3f} "
                    f"s under the profiler, {obs['staged_eval_s']:.3f} s "
                    f"with the stage clock {timings}; attention launches "
                    f"{counted} counted, {len(obs['attention_launches'])} "
                    f"from shapes")
    rec.close()
    del model, rec, evaluation
    harness.free(device)
    t_ref = time.perf_counter()
    checks = check(ctx, data, sample, got, device)
    harness.log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    return {"attempted": evals, "failed": 0, "device": dev,
            "e2e": {"eval_clips_per_s": clips / window_s,
                    "setup_s": setup_s},
            "obs": obs, "checks": checks}


def eval_launches(cfg, tr, calls) -> list:
    """The hand-kernel attention launches of one evaluation: each batch's
    towers, and the grouped ITM calls that launched the kernel (one a
    BERT layer, the texts of a candidate folded into its query)."""
    batches = -(-tr["clips"] // tr["batch_size"])
    out = attn_counts.tower_launches(cfg, tr["batch_size"], tr["frames"],
                                     False) * batches
    b = cfg["bert"]
    h = b["num_attention_heads"]
    d = b["hidden_size"] // h
    for (g, lc, _), (rows, length), launched in calls:
        if launched:
            out += [("fwd", g, h, rows // g * length, lc, d, False,
                     False)] * launched
    return out


def check(ctx, data, sample, got, device) -> dict:
    mine = program_sample(ctx, got, sample)
    ref = reference_sample(ctx, data, sample, mine["itm_clips"],
                           mine["cols"], device)
    return {k: {"value": v, "limit": ctx.limits[k]}
            for k, v in ret_ref.compare(mine, ref).items()}


def _gather(data, key, rows, bs):
    return np.stack([data[i // bs][key][i % bs] for i in rows])


def itm_pairs(ctx, itc) -> tuple:
    """The reranked (caption, clip) pairs whose ITM probabilities are
    compared, the same number on every seed: ``itm_checked_clips`` clips
    drawn from the seed among those the rerank scored for at least
    ``itm_checked_texts`` captions (where fewer qualify, the clips it
    scored most), and ``itm_checked_texts`` of each one's reranked
    captions drawn from the seed. The reranked pairs are each caption's
    ITC top ``itm_rerank_num``, as the rerank picks them; a few clips
    take most of them, so clips drawn alike would often hold none.
    Returns (clips, caption rows of each)."""
    tr = ctx.traffic
    k = min(tr["itm_rerank_num"], itc.shape[1])
    top = np.zeros(itc.shape, bool)
    np.put_along_axis(top, np.argpartition(-itc, k - 1, axis=1)[:, :k],
                      True, axis=1)
    n_texts = tr["itm_checked_texts"]
    counts = np.minimum(top.sum(0), n_texts)
    g = generator.generator(ctx.seed, 78, "cpu")
    order = torch.randperm(itc.shape[1], generator=g).tolist()
    order.sort(key=lambda c: -counts[c])          # stable: the seed's order
    clips = sorted(order[:tr["itm_checked_clips"]])
    cols = []
    for c in clips:
        rows = np.nonzero(top[:, c])[0]
        pick = torch.randperm(len(rows), generator=g)[:n_texts].numpy()
        cols.append(np.sort(rows[pick]))
    return clips, cols


def program_sample(ctx, got, sample) -> dict:
    """The program's outputs for the sampled clips, and its ITM
    probabilities of the pairs :func:`itm_pairs` draws."""
    refined, itc = got["refined"], got["itc"]
    clips, cols = itm_pairs(ctx, itc)
    return {"cond": torch.cat(got["cond"]),
            "feat_cond": torch.cat(got["feat_cond"]),
            "itc": itc[:, sample],
            "itm": [refined[r, c] for r, c in zip(cols, clips)],
            "itm_clips": clips, "cols": cols}


def reference_sample(ctx, data, sample, itm_clips, cols, device,
                     fp8=False) -> dict:
    from benchmark.reference.vast_ref import VastRef

    harness.reference_backends(device)
    bs = ctx.traffic["batch_size"]
    ref = VastRef(ctx.cfg, fp8).to(device)
    weights.init_weights(ref, ctx.seed, device)
    ref.eval()
    keys = ("vision_frames", "audio_waveforms", "caption_tokens",
            "caption_attention_mask", "subtitle_tokens",
            "subtitle_attention_mask")

    def clips(rows):
        return {k: torch.from_numpy(_gather(data, k, rows, bs)).to(device)
                for k in keys}

    ids = torch.from_numpy(np.concatenate([b["caption_tokens"]
                                           for b in data])).to(device)
    mask = torch.from_numpy(np.concatenate([b["caption_attention_mask"]
                                            for b in data])).to(device)
    out = ret_ref.reference_outputs(ref, clips(sample), (ids, mask),
                                    clips(itm_clips), cols)
    del ref
    harness.free(device)
    return out


def calibrate(ctx, controls: bool):
    """The readings that the limits are set from (``run.py
    --calibrate``): the program's numbers on this seed after one whole
    evaluation, with no window, and with ``controls`` also the
    control's (the reference in fp8 products in the program's place)."""
    model, data, sample, rec, evaluation = prepare(ctx)
    evaluation()
    got = rec.cur
    rec.close()
    del model, rec, evaluation
    harness.free(ctx.device)
    mine = program_sample(ctx, got, sample)
    pairs = (mine["itm_clips"], mine["cols"])
    ref = reference_sample(ctx, data, sample, *pairs, ctx.device)
    yield {"kind": "program", **ret_ref.compare(mine, ref)}
    if controls:
        control = reference_sample(ctx, data, sample, *pairs, ctx.device,
                                   fp8=True)
        yield {"kind": "control_fp8", **ret_ref.compare(control, ref)}
