"""Masked-AR generation over a KV cache: greedy, top-k sampling, beam.

Counterpart of ``vast_tpu.models.generation``. The reference decodes by
appending a [MASK] token each step and predicting it through HF
``generate`` (bert.py:1027-1044, model/vast.py:529-547), re-running the
whole prefix each step. Here the prompt is written into a KV cache once
(the prefill) and each step feeds the 2-token window [previous token,
MASK] at positions ``p - 1 + i`` and ``p + i``: the previous token
replaces last step's [MASK] at its slot (its cached K/V are rewritten,
the "fixup") and the new [MASK] predicts the next token. Each step is
O(L), with the reference's arithmetic.

The loop is a Python ``while`` that stops once every row has finished
(HF's stopping rule, ``vast_tpu``'s ``lax.while_loop`` condition): its
test reads one boolean from the device a step, which waits for that
step's work (a host sync per step).

Beam search follows HF's ``BeamSearchScorer`` (early_stopping=False) as
``vast_tpu`` does: the top 2k of the k x vocab candidates a step; EOS
candidates ranked below k join a pool of finished hypotheses scored
``sum_logprobs / (p + i) ** length_penalty`` and hold no live slot; the
pool keeps its best k; a batch row is done when its pool is full and its
worst pooled score beats the best score still possible, and its state
freezes; at the end the rows never done add their live beams at full
length and the best pooled hypothesis wins. The cross K/V of the
condition is not tiled over the beams: the beams fold onto one copy
(``models/bert.py``), and the self-attention cache is reordered by a
gather each step.

Ties: ``jax.lax.top_k`` and ``argmax`` take the lower index first;
``torch.topk`` promises no order among equal values, so the top k here is
a stable descending sort. Sampling draws from an explicit generator on
the condition's device.

QA prompts (question + BOS) reproduce the reference's
``update_attention_mask`` (bert.py:1011-1018): question rows attend over
the valid question tokens, BOS only to itself; BOS and the generated
tokens see the valid question, BOS and what was generated so far.
"""

from __future__ import annotations

import dataclasses

import torch

from vast_tpu_torch.models.bert import init_cache

NEG_INF = -1.0e7


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 40
    num_beams: int = 1
    do_sample: bool = False
    top_k: int = 10
    length_penalty: float = 0.6
    bos_id: int = 101
    eos_id: int = 102
    pad_id: int = 0
    mask_id: int = 103


def _top_k(x, k: int):
    """The k largest of the last dim, descending, equal values in index
    order (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _prefill_mask(prompt_mask):
    """(B, P) valid mask -> (B, P, P): bidirectional over the valid prompt
    positions; the last slot (BOS) visible only to itself."""
    b, p = prompt_mask.shape
    m = prompt_mask[:, None, :].expand(b, p, p).clone()
    m[:, :p - 1, p - 1] = 0
    m[:, p - 1, p - 1] = 1
    return m


def _len_penalty(length: int, penalty: float):
    """``length ** penalty`` in fp32, as ``vast_tpu`` computes it."""
    return torch.tensor(float(length), dtype=torch.float32) ** penalty


@torch.inference_mode()
def generate(model, cond_feats, cfg: GenerationConfig, prompt_ids=None,
             prompt_mask=None, generator=None):
    """Generated ids (B, max_new_tokens), pad after EOS.

    ``model``: a ``VASTModel``; ``cond_feats`` (B, Lc, D): the fusion
    condition sequences, on the model's device. ``prompt_ids`` /
    ``prompt_mask`` (B, P): the prompt, ending in BOS (default: BOS
    alone). ``generator``: the draws of top-k sampling, on the
    condition's device.
    """
    bert = model.multimodal_encoder
    b, dev = cond_feats.shape[0], cond_feats.device
    if prompt_ids is None:
        prompt_ids = torch.full((b, 1), cfg.bos_id, dtype=torch.long,
                                device=dev)
        prompt_mask = torch.ones((b, 1), dtype=torch.long, device=dev)
    prompt_ids, prompt_mask = prompt_ids.long(), prompt_mask.long()
    p = prompt_ids.shape[1]
    total = p + cfg.max_new_tokens + 1
    cross_kv = bert.precompute_cross_kv(cond_feats)

    # the prefill writes the prompt's K/V under the bidirectional mask
    cache = init_cache(bert.cfg, b, total, device=dev,
                       heads=bert.bert.encoder.layer[0].attention.heads)
    m3 = torch.nn.functional.pad(_prefill_mask(prompt_mask),
                                 (0, total - p))
    _, cache = bert.bert(prompt_ids, cache=cache, cache_index=0,
                         cross_kv=cross_kv, decode_self_mask=m3)

    # the decode's cache mask: the valid prompt (BOS forced visible) and
    # every generated slot (causality comes from each token's position)
    dec_mask = torch.cat([prompt_mask, torch.ones(
        (b, total - p), dtype=torch.long, device=dev)], dim=1)
    dec_mask[:, p - 1] = 1
    last_tok = prompt_ids[:, -1]
    if cfg.num_beams > 1:
        return _beam_search(bert, cache, cross_kv, dec_mask, last_tok, p,
                            cfg, b)
    return _greedy_or_sample(bert, cache, cross_kv, dec_mask, last_tok, p,
                             cfg, generator, b)


def _bert_step(bert, tokens2, index, cache, cache_mask, cross_kv):
    """One decode step: the MLM logits of the window's last token."""
    hidden, cache = bert.bert(tokens2, cache=cache, cache_index=index,
                              cache_mask=cache_mask, cross_kv=cross_kv)
    return bert.logits_from_hidden(hidden[:, -1]), cache


def _window(prev_tok, mask_id: int):
    return torch.stack([prev_tok, torch.full_like(prev_tok, mask_id)],
                       dim=1)


def _greedy_or_sample(bert, cache, cross_kv, cache_mask, last_tok, p, cfg,
                      generator, b):
    t_max = cfg.max_new_tokens
    dev = last_tok.device
    toks = torch.full((b, t_max), cfg.pad_id, dtype=torch.long, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    prev, i = last_tok, 0
    while i < t_max and not bool(finished.all()):
        logits, cache = _bert_step(bert, _window(prev, cfg.mask_id),
                                   p - 1 + i, cache, cache_mask, cross_kv)
        if cfg.do_sample:
            topv, topi = _top_k(logits.float(), cfg.top_k)
            choice = torch.multinomial(torch.softmax(topv, dim=-1), 1,
                                       generator=generator)
            nxt = topi.gather(1, choice)[:, 0]
        else:
            nxt = logits.argmax(dim=-1)
        nxt = torch.where(finished, cfg.pad_id, nxt)
        finished = finished | (nxt == cfg.eos_id)
        toks[:, i] = nxt
        prev, i = nxt, i + 1
    return toks


def _beam_search(bert, cache, cross_kv, cache_mask, last_tok, p, cfg, b):
    k, t_max, lp = cfg.num_beams, cfg.max_new_tokens, cfg.length_penalty
    dev = last_tok.device
    cache = [{n: x.repeat_interleave(k, dim=0) for n, x in c.items()}
             for c in cache]
    cache_mask = cache_mask.repeat_interleave(k, dim=0)
    f32 = dict(dtype=torch.float32, device=dev)
    scores = torch.full((b, k), NEG_INF, **f32)
    scores[:, 0] = 0.0
    tokens = torch.full((b, k, t_max), cfg.pad_id, dtype=torch.long,
                        device=dev)
    prev = last_tok[:, None].repeat(1, k)
    pool_scores = torch.full((b, k), NEG_INF, **f32)
    pool_tokens = tokens.clone()
    pool_count = torch.zeros(b, dtype=torch.long, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    beams = torch.arange(k, device=dev)
    first_k = torch.arange(2 * k, device=dev)[None] < k
    rows = torch.arange(b, device=dev)[:, None] * k

    def take(x, idx):
        """x (b, n, T) rows at idx (b, m) -> (b, m, T)."""
        return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[2]))

    i = 0
    while i < t_max and not bool(done.all()):
        logits, cache = _bert_step(bert, _window(prev.reshape(-1),
                                                 cfg.mask_id),
                                   p - 1 + i, cache, cache_mask, cross_kv)
        logp = torch.log_softmax(logits.float(), dim=-1)
        vocab = logp.shape[-1]
        cand = (scores[:, :, None] + logp.view(b, k, vocab)).view(b, -1)
        s2k, idx2k = _top_k(cand, 2 * k)
        beam2k, tok2k = idx2k // vocab, idx2k % vocab
        is_eos = tok2k == cfg.eos_id

        # the pool: EOS candidates ranked below k, length-penalised at
        # p + i (BeamHypotheses.add; the hypothesis leaves the EOS out)
        pen = _len_penalty(p + i, lp)
        eligible = is_eos & first_k & ~done[:, None]
        add_score = torch.where(eligible, s2k / pen, NEG_INF)
        pool_scores, pool_idx = _top_k(
            torch.cat([pool_scores, add_score], dim=1), k)
        pool_tokens = take(torch.cat([pool_tokens, take(tokens, beam2k)],
                                     dim=1), pool_idx)
        pool_count = (pool_count + eligible.sum(dim=1)).clamp(max=k)

        # the live beams: the k best candidates that are not EOS
        new_scores, sel = _top_k(torch.where(is_eos, NEG_INF, s2k), k)
        beam_idx, tok_idx = beam2k.gather(1, sel), tok2k.gather(1, sel)
        new_tokens = take(tokens, beam_idx)
        new_tokens[:, :, i] = tok_idx

        # done rows keep their state (HF pads them and skips the pool)
        frozen = done[:, None]
        scores = torch.where(frozen, scores, new_scores)
        tokens = torch.where(frozen[:, :, None], tokens, new_tokens)
        prev = torch.where(frozen, prev, tok_idx)
        flat = (rows + torch.where(frozen, beams[None], beam_idx)).view(-1)
        cache = [{n: x[flat] for n, x in c.items()} for c in cache]

        # BeamHypotheses.is_done with early_stopping=False
        done = done | ((pool_count >= k)
                       & (pool_scores[:, -1] >= s2k[:, 0] / pen))
        i += 1

    # BeamSearchScorer.finalize: rows never done add their live beams at
    # full length; the best pooled hypothesis wins
    live = torch.where(done[:, None], NEG_INF,
                       scores / _len_penalty(p + t_max, lp))
    best = torch.cat([pool_scores, live], dim=1).argmax(dim=1)
    every = torch.cat([pool_tokens, tokens], dim=1)
    return every[torch.arange(b, device=dev), best]
