"""Multi-modal evaluation: retrieval (``ret%...``), captioning
(``cap%...``) and QA (``qa%...``).

Counterpart of ``vast_tpu.evaluation.evaluation_mm`` for one process on
one device. ``evaluate_mm`` runs each ``{task--name: loader}`` and each
head of its task; ``evaluate_ret`` takes a loader (``BatchLoader``) or
any iterable of numpy batches, each holding the model's input arrays
plus ``ids`` (one per sample) and ``ids_txt`` (one per caption).
``evaluate_cap`` and ``evaluate_qa`` generate over each batch's
condition sequences (``models/generation.py``) and score the text.
Condition sequences stay on the device; only the pooled features and
the score matrices come to the host.

Batches go through ``_full_batches``' row accounting (evaluation_mm.py:
86-149 of ``vast_tpu``): a ragged batch is repeat-padded to the loader's
batch size and only its first ``nv`` sample rows and ``nvt`` text rows
are kept (they differ when a sample has several captions), and the
loader's ``padded_tail`` rows, duplicates that align hosts, are dropped
at the end.

The ITM rerank scores the ITC top-k (text, candidate) pairs grouped by
candidate, so each candidate's cross-attention K/V is projected once per
call (``compute_slice_scores_grouped``).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from vast_tpu_torch.config import parse_task_string
from vast_tpu_torch.device import resolve_device
from vast_tpu_torch.evaluation.metrics.coco_eval import \
    compute_caption_metrics
from vast_tpu_torch.evaluation.vqa_metrics import exact_match_accuracy
from vast_tpu_torch.logger import LOGGER
from vast_tpu_torch.models import layers
from vast_tpu_torch.models.generation import GenerationConfig, generate


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


def evaluate_mm(model, tokenizer, val_loaders: dict, run_cfg,
                global_step: int = 0, *, device=None,
                timings: dict | None = None):
    """``{f"{task}--{name}": loader}`` -> ``{key: {metric: ...}}``, as
    ``vast_tpu``'s ``evaluate_mm`` (evaluation_mm.py:45-72)."""
    eval_log = {}
    for key, loader in val_loaders.items():
        task, dset_name = key.split("--")[:2]
        LOGGER.info("evaluate on %s", key)
        val_log = {}
        for head, subtasks in parse_task_string(task):
            if head.startswith("ret"):
                val_log.update(evaluate_ret(model, subtasks, loader, run_cfg,
                                            device=device, timings=timings))
            elif head.startswith("cap"):
                val_log.update(evaluate_cap(
                    model, tokenizer, subtasks, loader, run_cfg, global_step,
                    dset_name, device=device, timings=timings))
            elif head.startswith("qa"):
                val_log.update(evaluate_qa(
                    model, tokenizer, subtasks, loader, run_cfg, global_step,
                    dset_name, device=device, timings=timings))
            else:
                raise NotImplementedError(f"evaluation of the {head!r} head")
        eval_log[key] = val_log
    return eval_log


_TXT_KEYS = ("caption_tokens", "caption_attention_mask")


def _full_batches(loader):
    """Yield ``(batch, nv, nvt)``: each batch repeat-padded to the
    loader's ``batch_size`` (text arrays to the next multiple of it), with
    ``nv`` its real sample rows and ``nvt`` its real text rows. An
    iterable without ``batch_size`` passes through unpadded."""
    bs = getattr(loader, "batch_size", None)
    for batch in loader:
        n = next((v.shape[0] for k, v in batch.items()
                  if k not in _TXT_KEYS and isinstance(v, np.ndarray)), None)
        nt = next((v.shape[0] for k in _TXT_KEYS
                   if isinstance(v := batch.get(k), np.ndarray)), None)
        if n is None and nt is not None:
            n = len(batch["ids"]) if "ids" in batch else nt  # text-only
        if n is None or bs is None:
            yield batch, (n if n is not None else bs), (nt or n or bs)
            continue
        bst = None if nt is None else -(-nt // bs) * bs
        if n == bs and (nt is None or nt == bst):
            yield batch, n, (nt if nt is not None else n)
            continue
        padded = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                target = bst if k in _TXT_KEYS else bs
                padded[k] = v if v.shape[0] == target else np.concatenate(
                    [v, np.repeat(v[-1:], target - v.shape[0], axis=0)])
            elif isinstance(v, (list, tuple)) and len(v) == n:
                padded[k] = list(v) + [v[-1]] * (bs - n)
            else:
                padded[k] = v
        yield padded, n, (nt if nt is not None else n)


def _loader_transforms(loader):
    d_cfg = getattr(getattr(loader, "dataset", None), "d_cfg", None)
    return (d_cfg or {}).get("vision_transforms", "none")


@torch.inference_mode()
def evaluate_ret(model, subtasks, loader, run_cfg, *,
                 vision_transforms: str | None = None, device=None,
                 timings: dict | None = None):
    """R@1/5/10 of ITC and of the ITM rerank per subtask.

    ``loader``: a ``BatchLoader`` or an iterable of numpy batches.
    ``vision_transforms`` (None: the loader's dataset config, else
    'none') must match the batches' frames. ``device`` (None: the GPU)
    must be the model's device. ``timings``, when given, receives seconds
    per stage: ``condition_features``, ``text_features``, ``itc``,
    ``itm_rerank``.
    """
    device = _check_device(model, device)
    if vision_transforms is None:
        vision_transforms = _loader_transforms(loader)
    clock = _StageClock(timings, device)
    ids, ids_txt, feats_t, toks, masks = [], [], [], [], []
    cond_feats = {st: [] for st in subtasks}
    cond_seqs = {st: [] for st in subtasks}
    for batch, nv, nvt in _full_batches(loader):
        db = _to_device(batch, device)
        db["vision_transforms"] = vision_transforms
        ids += list(batch["ids"])[:nv]
        ids_txt += list(batch["ids_txt"])[:nvt]
        out = clock("condition_features", model.condition_features, db,
                    tuple(subtasks))
        ft = clock("text_features", model.text_features,
                   db["caption_tokens"], db["caption_attention_mask"])
        for st in subtasks:
            cond_feats[st].append(out[f"feat_cond_{st}"][:nv].float().cpu())
            cond_seqs[st].append(out[f"condition_feats_{st}"][:nv])
        feats_t.append(ft[:nvt].float().cpu())
        toks.append(np.asarray(batch["caption_tokens"])[:nvt])
        masks.append(np.asarray(batch["caption_attention_mask"])[:nvt])

    # drop the loader's cross-host alignment duplicates at the epoch's end
    pt = getattr(loader, "padded_tail", 0)

    def local(parts, cat):
        x = cat(parts)
        return x[: x.shape[0] - pt]

    ids, ids_txt = ids[: len(ids) - pt], ids_txt[: len(ids_txt) - pt]
    feat_t = local(feats_t, torch.cat).numpy()
    input_ids = local(toks, np.concatenate)
    attention_mask = local(masks, np.concatenate)
    top_k = int(run_cfg.get("itm_rerank_num", 50))
    both = bool(run_cfg.get("ret_bidirection_evaluation"))
    val_log = {}
    for st in subtasks:
        fc = local(cond_feats[st], torch.cat).numpy()
        score = clock("itc", np.matmul, feat_t, fc.T)
        log = _metric_log(score, ids, ids_txt, "forward")
        if both:
            log.update(_metric_log(score, ids, ids_txt, "backward"))
        val_log[f"ret_itc_{st}"] = log
        cseq = local(cond_seqs[st], torch.cat)
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


def _check_device(model, device):
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, evaluation asked "
                         f"for {device}")
    return device


def _gen_config(tokenizer, **kw):
    return GenerationConfig(
        bos_id=tokenizer.bos_token_id, eos_id=tokenizer.eos_token_id,
        pad_id=tokenizer.pad_token_id, mask_id=tokenizer.mask_token_id,
        **kw)


def _condition_batches(model, subtasks, loader, device, clock):
    """``(batch, nv, {st: condition sequence})`` for each padded batch."""
    vt = _loader_transforms(loader)
    for batch, nv, _ in _full_batches(loader):
        db = _to_device(batch, device)
        db["vision_transforms"] = vt
        out = clock("condition_features", model.condition_features, db,
                    tuple(subtasks))
        yield batch, nv, {st: out[f"condition_feats_{st}"]
                          for st in subtasks}


@torch.inference_mode()
def evaluate_cap(model, tokenizer, subtasks, loader, run_cfg, global_step,
                 dset_name, *, device=None, timings: dict | None = None):
    """Captions for every clip (evaluation_mm.py:480-573 of ``vast_tpu``):
    beam search (``beam_size`` beams, length penalty 0.6) of at most
    ``max_caption_len`` tokens, written to
    ``results_test_{dset}/step_{N}_{st}.json`` under ``output_dir``, and
    Bleu_1-4, METEOR, ROUGE_L and CIDEr against the dataset's ``annfile``
    where it has one. In ``captioner_mode``: ``generate_nums`` top-10
    samples a clip, flushed to ``gencap_rank0_idx{i}_{st}.json`` every
    20,000 clips, and no metrics. ``timings``: seconds per stage
    (``condition_features``, ``decode``)."""
    device = _check_device(model, device)
    cfg = model.cfg
    sample = bool(cfg.captioner_mode)
    gen_cfg = _gen_config(tokenizer, max_new_tokens=cfg.max_caption_len,
                          num_beams=1 if sample else cfg.beam_size,
                          do_sample=sample, top_k=10, length_penalty=0.6)
    clock = _StageClock(timings, device)
    out_dir = os.path.join(run_cfg.get("output_dir", "."),
                           f"results_test_{dset_name}")
    os.makedirs(out_dir, exist_ok=True)
    # captioner_mode: {video_id: [captions]} files as the reference's
    # (evaluation_mm.py:111-154); else [{'video_id', 'caption'}]
    results = {st: ({} if sample else []) for st in subtasks}
    gen_idx = 0

    def flush_gencap(st):
        nonlocal gen_idx
        path = os.path.join(out_dir, f"gencap_rank0_idx{gen_idx}_{st}.json")
        with open(path, "w") as f:
            json.dump(results[st], f)
        gen_idx += 1
        results[st] = {}

    gn = cfg.generate_nums if sample else 1
    gen = layers.seeded(int(run_cfg.get("seed", 50)), device)
    for batch, nv, conds in _condition_batches(model, subtasks, loader,
                                               device, clock):
        vids = list(batch["ids"])[:nv]
        for st in subtasks:
            cond = conds[st]
            if gn > 1:
                cond = cond.repeat_interleave(gn, dim=0)
            toks = clock("decode", generate, model, cond, gen_cfg,
                         generator=gen)
            caps = tokenizer.batch_decode(toks.cpu().numpy())
            if sample:
                for i, vid in enumerate(vids):
                    results[st][vid] = caps[i * gn:(i + 1) * gn]
                if len(results[st]) > 20000:
                    flush_gencap(st)
            else:
                results[st] += [{"video_id": vid, "caption": cap}
                                for vid, cap in zip(vids, caps)]
    if sample:
        for st in subtasks:
            if results[st]:
                flush_gencap(st)
        return {}

    pt = getattr(loader, "padded_tail", 0)
    annfile = getattr(getattr(loader, "dataset", None), "annfile", None)
    val_log = {}
    for st in subtasks:
        rows = results[st][:len(results[st]) - pt]
        with open(os.path.join(out_dir, f"step_{global_step}_{st}.json"),
                  "w") as f:
            json.dump(rows, f)
        if annfile:
            val_log[f"cap_{st}"] = compute_caption_metrics(rows, annfile)
    return val_log


@torch.inference_mode()
def evaluate_qa(model, tokenizer, subtasks, loader, run_cfg, global_step=0,
                dset_name="", *, device=None, timings: dict | None = None):
    """Answers by beam search (``beam_size`` beams, length penalty 1.0,
    at most 10 tokens) after the prompt question + BOS
    (evaluation_mm.py:576-641 of ``vast_tpu``), written to
    ``predict_answers/step{N}_pred_{dset}_{st}.json`` under
    ``output_dir``; the accuracy is the exact match against
    ``raw_answers`` (any element of a list). ``timings``: seconds per
    stage (``condition_features``, ``decode``)."""
    device = _check_device(model, device)
    gen_cfg = _gen_config(tokenizer, max_new_tokens=10,
                          num_beams=model.cfg.beam_size, length_penalty=1.0)
    clock = _StageClock(timings, device)
    gt_rows, preds = [], {st: [] for st in subtasks}
    for batch, nv, conds in _condition_batches(model, subtasks, loader,
                                               device, clock):
        gt_rows += list(batch["raw_answers"])[:nv]
        q_ids = torch.from_numpy(np.asarray(batch["question_tokens"]))
        q_mask = torch.from_numpy(np.asarray(
            batch["question_attention_mask"]))
        b = q_ids.shape[0]
        prompt = torch.cat([q_ids, torch.full(
            (b, 1), tokenizer.bos_token_id, dtype=q_ids.dtype)], dim=1)
        pmask = torch.cat([q_mask, torch.ones((b, 1), dtype=q_mask.dtype)],
                          dim=1)
        prompt, pmask = prompt.to(device), pmask.to(device)
        for st in subtasks:
            toks = clock("decode", generate, model, conds[st], gen_cfg,
                         prompt_ids=prompt, prompt_mask=pmask)
            preds[st] += tokenizer.batch_decode(toks.cpu().numpy())[:nv]

    pt = getattr(loader, "padded_tail", 0)
    gt_rows = gt_rows[:len(gt_rows) - pt]
    out_dir = os.path.join(run_cfg.get("output_dir", "."), "predict_answers")
    os.makedirs(out_dir, exist_ok=True)
    val_log = {}
    for st in subtasks:
        rows = preds[st][:len(preds[st]) - pt]
        with open(os.path.join(
                out_dir, f"step{global_step}_pred_{dset_name}_{st}.json"),
                "w") as f:
            json.dump(rows, f)
        acc = exact_match_accuracy(rows, gt_rows)
        val_log[f"vqa_{st}"] = {"accuracy": round(acc * 100, 2)}
    return val_log
