"""Retrieval evaluation (``ret%...``): features, ITC ranking, ITM rerank.

Counterpart of the retrieval part of ``vast_tpu.evaluation.evaluation_mm``
for one process on one device. ``evaluate_ret`` takes an iterable of
numpy batches (the data loader and tokenizer are a later slice): each
holds the model's input arrays plus ``ids`` (one per sample) and
``ids_txt`` (one per caption). Condition sequences stay on the device;
only the pooled features and the score matrices come to the host.

The ITM rerank scores the ITC top-k (text, candidate) pairs grouped by
candidate, so each candidate's cross-attention K/V is projected once per
call (``compute_slice_scores_grouped``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vast_tpu_torch.device import resolve_device


class _StageClock:
    """Seconds per stage, accumulated into ``timings`` (device work is
    synchronized at each stage boundary so its time lands in its stage)."""

    def __init__(self, timings, device):
        self.timings = timings
        self.cuda = device.type == "cuda"

    def __call__(self, stage, fn, *args, **kwargs):
        if self.timings is None:
            return fn(*args, **kwargs)
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.cuda:
            torch.cuda.synchronize()
        self.timings[stage] = (self.timings.get(stage, 0.0)
                               + time.perf_counter() - t0)
        return out


def _to_device(batch, device):
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


@torch.inference_mode()
def evaluate_ret(model, subtasks, batches, run_cfg, *,
                 vision_transforms: str = "none", device=None,
                 timings: dict | None = None):
    """R@1/5/10 of ITC and of the ITM rerank per subtask.

    ``device`` (None: the GPU) must be the model's device. ``timings``,
    when given, receives seconds per stage: ``condition_features``,
    ``text_features``, ``itc``, ``itm_rerank``.
    """
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, evaluation asked "
                         f"for {device}")
    clock = _StageClock(timings, device)
    ids, ids_txt, feats_t, toks, masks = [], [], [], [], []
    cond_feats = {st: [] for st in subtasks}
    cond_seqs = {st: [] for st in subtasks}
    for batch in batches:
        db = _to_device(batch, device)
        db["vision_transforms"] = vision_transforms
        ids += list(batch["ids"])
        ids_txt += list(batch["ids_txt"])
        out = clock("condition_features", model.condition_features, db,
                    tuple(subtasks))
        ft = clock("text_features", model.text_features,
                   db["caption_tokens"], db["caption_attention_mask"])
        for st in subtasks:
            cond_feats[st].append(out[f"feat_cond_{st}"].float().cpu())
            cond_seqs[st].append(out[f"condition_feats_{st}"])
        feats_t.append(ft.float().cpu())
        toks.append(np.asarray(batch["caption_tokens"]))
        masks.append(np.asarray(batch["caption_attention_mask"]))

    feat_t = torch.cat(feats_t).numpy()
    input_ids, attention_mask = np.concatenate(toks), np.concatenate(masks)
    top_k = int(run_cfg.get("itm_rerank_num", 50))
    both = bool(run_cfg.get("ret_bidirection_evaluation"))
    val_log = {}
    for st in subtasks:
        fc = torch.cat(cond_feats[st]).numpy()
        score = clock("itc", np.matmul, feat_t, fc.T)
        log = _metric_log(score, ids, ids_txt, "forward")
        if both:
            log.update(_metric_log(score, ids, ids_txt, "backward"))
        val_log[f"ret_itc_{st}"] = log
        cseq = torch.cat(cond_seqs[st])
        refined = clock("itm_rerank", rerank_scores, model, cseq, input_ids,
                        attention_mask, score, top_k, "forward")
        log = _metric_log(refined, ids, ids_txt, "forward")
        if both:
            refined_b = clock("itm_rerank", rerank_scores, model, cseq,
                              input_ids, attention_mask, score, top_k,
                              "backward")
            log.update(_metric_log(refined_b, ids, ids_txt, "backward"))
        val_log[f"ret_itm_{st}"] = log
    return val_log


_DIRECTION_NAMES = {"forward": "video", "backward": "txt"}


def _metric_log(score, ids, ids_txt, direction):
    return {k.replace(direction, _DIRECTION_NAMES[direction]): v
            for k, v in compute_metric_ret(score, ids, ids_txt,
                                           direction).items()}


@torch.inference_mode()
def rerank_scores(model, cond_seqs, input_ids, attention_mask, itc_scores,
                  top_k, direction: str = "forward", texts_per_seg: int = 32,
                  conds_per_call: int = 4):
    """ITM probabilities at the ITC top-k cells, 0 elsewhere.

    ``direction='forward'`` reranks each text's top-k candidates,
    ``'backward'`` each candidate's top-k texts (refine_score_matrix,
    reference evaluation_mm.py:253-319). ``cond_seqs`` (n_cond, Lc, D)
    stays on the model's device; ``input_ids``/``attention_mask`` are
    numpy (n_text, L). Pairs are grouped by candidate in segments of up to
    ``texts_per_seg`` texts; ``conds_per_call`` segments share one call,
    padded to the longest segment of the call.
    """
    n_text, n_cond = itc_scores.shape
    if direction == "forward":
        k = min(top_k, n_cond)
        top = np.argpartition(-itc_scores, k - 1, axis=1)[:, :k]
        pair_t = np.repeat(np.arange(n_text), k)
        pair_c = top.reshape(-1)
    else:
        k = min(top_k, n_text)
        top = np.argpartition(-itc_scores, k - 1, axis=0)[:k]
        pair_c = np.tile(np.arange(n_cond), k)
        pair_t = top.reshape(-1)

    by_cand: dict = {}
    for t, c in zip(pair_t.tolist(), pair_c.tolist()):
        by_cand.setdefault(c, []).append(t)
    segs = [(c, ts[s:s + texts_per_seg]) for c, ts in by_cand.items()
            for s in range(0, len(ts), texts_per_seg)]

    device = cond_seqs.device
    out = np.zeros_like(itc_scores)
    for s0 in range(0, len(segs), conds_per_call):
        call = segs[s0:s0 + conds_per_call]
        t_max = max(len(ts) for _, ts in call)
        tmat = np.zeros((len(call), t_max), np.int64)
        for gi, (_, ts) in enumerate(call):
            tmat[gi, : len(ts)] = ts                 # pad rows score text 0
        cands = torch.tensor([c for c, _ in call], device=device)
        flat = tmat.reshape(-1)
        scores = model.compute_slice_scores_grouped(
            cond_seqs[cands],
            torch.from_numpy(input_ids[flat]).to(device),
            torch.from_numpy(attention_mask[flat]).to(device))
        scores = scores.float().cpu().numpy().reshape(len(call), t_max)
        for gi, (c, ts) in enumerate(call):
            out[ts, c] = scores[gi, : len(ts)]
    return out


def compute_metric_ret(score_matrix, ids, ids_txt, direction="forward"):
    """R@1/5/10 (+ recall string + avg), reference evaluation_mm.py:326-380.

    Only the ground-truth cell's rank is needed: per text (forward, text
    -> vision), or per vision item the best rank over its texts
    (backward). rank = #(strictly greater) + #(equal at a lower index),
    the cell's position under a stable descending sort; blocks of about
    64 MB bound the memory.
    """
    score_matrix = np.asarray(score_matrix)
    if score_matrix.shape != (len(ids_txt), len(ids)):
        raise ValueError(f"score matrix {score_matrix.shape} does not match "
                         f"{len(ids_txt)} texts x {len(ids)} items")
    n_text, n_cond = score_matrix.shape
    first = {}
    for j, v in enumerate(ids):
        first.setdefault(v, j)
    gt = np.asarray([first[t] for t in ids_txt])
    if direction == "forward":
        ranks = np.empty(n_text, np.int64)
        chunk = max(1, (1 << 24) // max(n_cond, 1))
        for s in range(0, n_text, chunk):
            block = score_matrix[s:s + chunk]
            rows = np.arange(block.shape[0])
            g = gt[s:s + chunk]
            v = block[rows, g][:, None]
            eq_before = (block == v).cumsum(1, dtype=np.int32)[rows, g] - 1
            ranks[s:s + chunk] = (block > v).sum(1) + eq_before
    else:
        own_rank = np.empty(n_text, np.int64)
        chunk = max(1, (1 << 24) // max(n_text, 1))
        for s in range(0, n_text, chunk):
            c = gt[s:s + chunk]
            block = score_matrix[:, c]
            m = block.shape[1]
            v = score_matrix[np.arange(s, s + m), c][None, :]
            eq_before = (block == v).cumsum(0, dtype=np.int32)[
                np.arange(s, s + m), np.arange(m)] - 1
            own_rank[s:s + chunk] = (block > v).sum(0) + eq_before
        ranks = np.full(n_cond, n_text, np.int64)
        np.minimum.at(ranks, gt, own_rank)
    r1, r5, r10 = [(ranks < k).mean() for k in (1, 5, 10)]
    return {
        f"{direction}_r1": round(r1 * 100, 1),
        f"{direction}_recall":
            f"{round(r1*100,1)}/{round(r5*100,1)}/{round(r10*100,1)}",
        f"{direction}_ravg": round((r1 + r5 + r10) / 3 * 100, 1),
    }
