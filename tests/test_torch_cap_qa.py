"""Captioning and QA: the port against vast_tpu on the CPU.

``mask_tokens``' rules in both packages; ``mlm_loss``; the ``cap`` and
``qa`` losses with injected masks (and vast27m's caption streams) and
the gradient of every parameter; the prefill and decode logits of the
MLM head over a KV cache; and the tokens of ``generate`` — greedy, beam
3 at length penalties 0.6 and 1.0, padded QA prompts, a row that
finishes early, top-k 1 sampling — equal to
``vast_tpu.models.generation.generate``'s. Same weights on both sides: a
tiny vast_tpu model initialised in JAX from a seed (every head), every
parameter nudged, carried across with ``from_jax``. fp32; JAX matmuls at
"highest" precision (tests/conftest.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_vast_config
from tests.test_torch_models import _init_every_param, port_config, raw_batch
from tests.test_torch_ret_tvas import _losses_and_grads
from vast_tpu.models import generation as jgen
from vast_tpu.models.bert import init_cache as j_init_cache
from vast_tpu.models.bert import mlm_loss as j_mlm_loss
from vast_tpu.models.vast import VASTModel as JaxVAST
from vast_tpu.ops.masking import mask_tokens as j_mask_tokens
from vast_tpu_torch.convert.from_jax import from_jax, load_numpy_state_dict
from vast_tpu_torch.models import generation as pgen
from vast_tpu_torch.models.bert import init_cache, mlm_loss
from vast_tpu_torch.models.vast import VASTModel
from vast_tpu_torch.ops.masking import IGNORE_LABEL, mask_tokens

STREAMS = ("vision_caption", "audio_caption", "omni_caption")
VOCAB = 170      # tests/helpers.py TINY_BERT


def _tokens(rs, b=3, length=12, pad_from=None, row=1):
    ids = rs.randint(106, VOCAB, (b, length)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((b, length), np.int32)
    if pad_from is not None:
        mask[row, pad_from:] = 0
        ids[row, pad_from:] = 0
    return ids, mask


def _inject(rs, ids, mask, prob=0.5):
    """Masked tokens and labels as mask_tokens would make them, drawn by
    numpy: candidates are the valid positions from 1 on."""
    sel = (rs.rand(*ids.shape) < prob) & (mask > 0)
    sel[:, 0] = False
    sel[np.arange(len(ids)), mask.sum(1) - 1] = True
    kind = rs.rand(*ids.shape)
    masked = np.where(sel & (kind < 0.8), 103, ids)
    masked = np.where(sel & (kind >= 0.9),
                      rs.randint(106, VOCAB, ids.shape), masked)
    return masked.astype(np.int32), np.where(sel, ids, -100).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    """(jax model, params, port model, numpy batch with a subtitle, the
    vast27m streams, a question and an answer, and injected masks)."""
    rs = np.random.RandomState(21)
    batch = raw_batch(rs)
    batch["caption_tokens"][:, 0] = 101
    batch["subtitle_tokens"], batch["subtitle_attention_mask"] = \
        _tokens(rs, pad_from=7)
    for i, stream in enumerate(STREAMS):
        batch[f"{stream}_tokens"], batch[f"{stream}_attention_mask"] = \
            _tokens(rs, pad_from=5 + i)
    batch["question_tokens"], batch["question_attention_mask"] = \
        _tokens(rs, pad_from=6)
    batch["answer_tokens"], batch["answer_attention_mask"] = \
        _tokens(rs, length=6, pad_from=3, row=2)
    for key in ("caption", "answer") + STREAMS:
        batch[f"{key}_masked_tokens"], batch[f"{key}_masked_labels"] = \
            _inject(rs, batch[f"{key}_tokens"],
                    batch[f"{key}_attention_mask"])
    jm = JaxVAST(tiny_vast_config())
    init = jax.jit(functools.partial(jm.init, method=_init_every_param))
    params = init(jax.random.PRNGKey(21),
                  {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.02) * np.asarray(
            rs.randn(*np.shape(p)), np.float32), params)
    pm = VASTModel(port_config(jm.cfg), device="cpu")
    load_numpy_state_dict(pm, from_jax(params))
    return jm, params, pm, batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------- masking

def _check_mask_rules(tokens, corrupted, labels, vocab):
    """Returns the selection, after asserting every rule."""
    sel = labels != IGNORE_LABEL
    cand = tokens != 0
    cand[:, 0] = False
    assert not (sel & ~cand).any(), "position 0 or a pad was masked"
    assert (sel.any(1) == cand.any(1)).all(), "a row without a mask"
    np.testing.assert_array_equal(labels[sel], tokens[sel])
    np.testing.assert_array_equal(corrupted[~sel], tokens[~sel])
    changed = sel & (corrupted != 103)
    randoms = corrupted[changed & (corrupted != tokens)]
    assert ((randoms >= 106) & (randoms < vocab)).all()
    return sel


@pytest.mark.parametrize("impl", ["port", "vast_tpu"])
def test_mask_tokens_rules_and_frequencies(impl):
    rs = np.random.RandomState(0)
    b, l, vocab = 512, 40, 30522
    tokens = rs.randint(106, vocab, (b, l)).astype(np.int32)
    tokens[:, 0] = 101
    lengths = rs.randint(1, l + 1, b)
    lengths[:8] = 1                       # rows with no candidate
    lengths[8:16] = 2                     # one candidate each
    tokens[np.arange(l)[None] >= lengths[:, None]] = 0
    if impl == "port":
        out = mask_tokens(torch.Generator().manual_seed(0),
                          torch.from_numpy(tokens), 0.6, mask_token=103,
                          range_end=vocab)
    else:
        out = j_mask_tokens(jax.random.PRNGKey(0), jnp.asarray(tokens), 0.6,
                            mask_token=103, range_end=vocab)
    corrupted, labels = (np.asarray(x) for x in out)
    assert corrupted.dtype == labels.dtype == np.int32
    sel = _check_mask_rules(tokens, corrupted, labels, vocab)
    assert not sel[:8].any() and sel[8:16, 1].all()
    # rows with many candidates: p = 0.6 per candidate; then 80% [MASK],
    # 10% a random id, 10% kept (limits at about 5 standard deviations)
    n_cand = (lengths[16:] - 1).sum()
    assert abs(sel[16:].sum() / n_cand - 0.6) < 5 * (0.24 / n_cand) ** 0.5
    n = sel.sum()
    masked = (corrupted == 103) & sel
    kept = (corrupted == tokens) & sel
    for share, want in ((masked.sum() / n, 0.8), (kept.sum() / n, 0.1),
                        ((sel & ~masked & ~kept).sum() / n, 0.1)):
        assert abs(share - want) < 5 * (want * (1 - want) / n) ** 0.5


def test_mask_tokens_draws_from_its_generator():
    tokens = torch.randint(106, 200, (4, 20), dtype=torch.int32)
    a = mask_tokens(torch.Generator().manual_seed(3), tokens, 0.6,
                    mask_token=103, range_end=200)
    b = mask_tokens(torch.Generator().manual_seed(3), tokens, 0.6,
                    mask_token=103, range_end=200)
    c = mask_tokens(torch.Generator().manual_seed(4), tokens, 0.6,
                    mask_token=103, range_end=200)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])


def test_mlm_loss_matches():
    rs = np.random.RandomState(1)
    logits = (rs.randn(3, 7, 50) * 3).astype(np.float32)
    labels = rs.randint(0, 50, (3, 7)).astype(np.int32)
    labels[rs.rand(3, 7) < 0.5] = -100
    got = mlm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want = j_mlm_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-6)
    none = torch.full((3, 7), -100)
    assert mlm_loss(torch.from_numpy(logits), none).item() == 0.0


# --------------------------------------------------------- losses, grads

# parameters only the MLM losses reach
MLM_HEAD = ("multimodal_encoder.cls.predictions.bias",
            "multimodal_encoder.cls.predictions.transform.dense.weight",
            "multimodal_encoder.cls.predictions.transform.LayerNorm.weight",
            "multimodal_encoder.bert.embeddings.word_embeddings.weight")


@pytest.mark.parametrize("task", ["cap%tv", "cap%tvas", "qa%tva",
                                  "qa%tvas"])
def test_losses_and_every_gradient_match(pair, task):
    drop = STREAMS if task.startswith("cap") else ()
    reached = _losses_and_grads(pair, task, drop=tuple(
        f"{s}_{k}" for s in drop for k in ("tokens", "attention_mask")))
    assert set(MLM_HEAD) <= reached
    assert "contra_head_t.linear.weight" not in reached
    assert ("hidden_trans_subtitle_multimodal.0.weight" in reached) \
        == task.endswith("s")


def test_vast27m_caption_streams_losses_and_gradients(pair):
    """cap on a vast27m batch: each subtask against its own caption
    stream, the losses averaged; no caption_tokens in the batch."""
    reached = _losses_and_grads(
        pair, "cap%tvas%tv%ta",
        drop=("caption_tokens", "caption_attention_mask",
              "caption_masked_tokens", "caption_masked_labels"))
    assert set(MLM_HEAD) <= reached


def test_drawn_masks_need_a_generator(pair):
    _, _, pm, batch = pair
    b = {k: torch.from_numpy(v) for k, v in batch.items()
         if "masked" not in k}
    with pytest.raises(ValueError, match="generator"):
        pm(b, "cap%tv", compute_loss=True)
    with torch.no_grad():
        out = pm(b, "qa%tv", compute_loss=True,
                 generator=torch.Generator().manual_seed(0))
    assert out.keys() == {"loss_qa"} and torch.isfinite(out["loss_qa"])


# ---------------------------------------------------------------- decode

@pytest.fixture(scope="module")
def cond(pair):
    jm, params, _, batch = pair
    out = jax.jit(lambda p: jm.apply({"params": p}, _j(batch), "cap%tvas",
                                     compute_loss=False))(params)
    return np.array(out["condition_feats_tvas"])


def test_condition_features_match(pair, cond):
    _, _, pm, batch = pair
    with torch.no_grad():
        got = pm({k: torch.from_numpy(v) for k, v in batch.items()},
                 "cap%tvas%tv")
    assert set(got) == {"condition_feats_tvas", "condition_feats_tv"}
    np.testing.assert_allclose(got["condition_feats_tvas"].numpy(), cond,
                               atol=3e-5, rtol=3e-5)


def test_prefill_and_decode_logits_match(pair, cond):
    """A padded 4-token prompt written under the prefill mask, then four
    2-token windows over the cache: logits and cache equal vast_tpu's
    BertForMaskedLM with a cache."""
    jm, params, pm, _ = pair
    rs = np.random.RandomState(5)
    b, p, total = 3, 4, 10
    prompt = rs.randint(106, VOCAB, (b, p)).astype(np.int32)
    pmask = np.ones((b, p), np.int32)
    pmask[1, 2] = 0
    m3 = np.pad(np.asarray(jgen._prefill_mask(jnp.asarray(pmask))),
                [(0, 0), (0, 0), (0, total - p)])
    np.testing.assert_array_equal(
        pgen._prefill_mask(torch.from_numpy(pmask)).numpy(), m3[:, :, :p])
    dec_mask = np.concatenate([pmask, np.ones((b, total - p), np.int32)], 1)
    windows = [rs.randint(106, VOCAB, (b, 2)).astype(np.int32)
               for _ in range(4)]
    bcfg = jm.cfg.resolved_bert_cfg()

    def jrun(params):
        def f(m):
            enc = m.multimodal_encoder
            kv = enc.precompute_cross_kv(jnp.asarray(cond))
            logits, cache = enc(jnp.asarray(prompt),
                                cache=j_init_cache(bcfg, b, total),
                                cache_index=0, cross_kv=kv,
                                decode_self_mask=jnp.asarray(m3))
            outs = [logits]
            for i, w in enumerate(windows):
                logits, cache = enc(jnp.asarray(w), cache=cache,
                                    cache_index=p - 1 + i,
                                    cache_mask=jnp.asarray(dec_mask),
                                    cross_kv=kv)
                outs.append(logits)
            return outs, cache
        return jm.apply({"params": params}, method=f)

    want, want_cache = jax.jit(jrun)(params)
    enc = pm.multimodal_encoder
    with torch.no_grad():
        kv = enc.precompute_cross_kv(torch.from_numpy(cond))
        logits, cache = enc(torch.from_numpy(prompt),
                            cache=init_cache(enc.cfg, b, total),
                            cache_index=0, cross_kv=kv,
                            decode_self_mask=torch.from_numpy(m3))
        got = [logits]
        for i, w in enumerate(windows):
            logits, cache = enc(torch.from_numpy(w), cache=cache,
                                cache_index=p - 1 + i,
                                cache_mask=torch.from_numpy(dec_mask),
                                cross_kv=kv)
            got.append(logits)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5,
                                   rtol=3e-5, err_msg=f"step {i}")
    for g, w in zip(cache, want_cache):
        for n in ("k", "v"):
            np.testing.assert_allclose(g[n].numpy(), np.asarray(w[n]),
                                       atol=3e-5, rtol=3e-5)


def _qa_prompt(rs, b=3, q=6):
    ids, mask = _tokens(rs, b=b, length=q, pad_from=3)
    ids[2, 5:] = 0
    mask[2, 5:] = 0
    return (np.concatenate([ids, np.full((b, 1), 101, np.int32)], 1),
            np.concatenate([mask, np.ones((b, 1), np.int32)], 1))


def _generate(pair, cond, gcfg, prompt=None, generator=None):
    """(port tokens, vast_tpu tokens) as numpy."""
    jm, params, pm, _ = pair
    jkw, pkw = {}, {}
    if prompt is not None:
        jkw = dict(prompt_ids=jnp.asarray(prompt[0]),
                   prompt_mask=jnp.asarray(prompt[1]))
        pkw = dict(prompt_ids=torch.from_numpy(prompt[0]),
                   prompt_mask=torch.from_numpy(prompt[1]))
    want = np.asarray(jgen.generate(jm, params, jnp.asarray(cond),
                                    jgen.GenerationConfig(**gcfg), **jkw))
    got = pgen.generate(pm, torch.from_numpy(cond),
                        pgen.GenerationConfig(**gcfg), generator=generator,
                        **pkw).numpy()
    return got, want


CASES = {
    "greedy": (dict(max_new_tokens=8), False),
    "beam3_lp0.6": (dict(max_new_tokens=8, num_beams=3,
                         length_penalty=0.6), False),
    "beam3_lp1.0": (dict(max_new_tokens=8, num_beams=3,
                         length_penalty=1.0), False),
    "qa_beam3": (dict(max_new_tokens=5, num_beams=3, length_penalty=1.0),
                 True),
    "qa_greedy": (dict(max_new_tokens=5), True),
}


@pytest.mark.parametrize("case", CASES)
def test_generate_equal(pair, cond, case):
    gcfg, qa = CASES[case]
    prompt = _qa_prompt(np.random.RandomState(6)) if qa else None
    got, want = _generate(pair, cond, gcfg, prompt)
    assert got.shape == want.shape == (3, gcfg["max_new_tokens"])
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got}) > 1     # the rows differ


@pytest.fixture(scope="module")
def greedy(pair, cond):
    got, _ = _generate(pair, cond, dict(max_new_tokens=8))
    return got


@pytest.mark.parametrize("beams", [1, 3])
def test_one_row_finishes_early(pair, cond, greedy, beams):
    """EOS set to a token that row 0 writes at step 2 and no other row
    writes in its first three: row 0 pads after it (a beam's finished
    hypothesis leaves its EOS out), and the tokens stay equal."""
    eos = next(int(t) for t in greedy[0, 2:]
               if not (greedy[1:, :3] == t).any())
    gcfg = dict(max_new_tokens=8, num_beams=beams, eos_id=eos,
                length_penalty=0.6)
    got, want = _generate(pair, cond, gcfg)
    np.testing.assert_array_equal(got, want)
    if beams > 1:
        assert got[0, -1] == 0 and not (got == eos).any()
        return
    end = int(np.argmax(greedy[0] == eos))
    assert got[0, end] == eos and (got[0, end + 1:] == 0).all()
    assert not (got[1:] == 0).all(axis=1).any()


def test_all_rows_finished_exit_early(pair, cond, greedy, monkeypatch):
    """Once every row has its EOS the loop stops: no decode step after."""
    eos = int(greedy[0, 0])
    steps = []
    real = pgen._bert_step
    monkeypatch.setattr(pgen, "_bert_step",
                        lambda *a: steps.append(1) or real(*a))
    gcfg = dict(max_new_tokens=8, eos_id=eos)
    got, want = _generate(pair, cond, gcfg)
    np.testing.assert_array_equal(got, want)
    finish = max(int(np.argmax(r == eos)) if (r == eos).any() else 8
                 for r in greedy)
    assert len(steps) == min(finish + 1, 8)


def test_top_k_1_sampling_equals_greedy(pair, cond, greedy):
    _, _, pm, _ = pair
    got = pgen.generate(
        pm, torch.from_numpy(cond),
        pgen.GenerationConfig(max_new_tokens=8, do_sample=True, top_k=1),
        generator=torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(got, greedy)


def test_top_k_sampling_follows_its_generator(pair, cond):
    _, _, pm, _ = pair
    cfg = pgen.GenerationConfig(max_new_tokens=8, do_sample=True, top_k=10)
    c = torch.from_numpy(cond)
    runs = [pgen.generate(pm, c, cfg,
                          generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_top_k_keeps_the_lower_index_among_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    v, i = pgen._top_k(x, 4)
    assert i.tolist() == [[1, 2, 4, 3]] and v.tolist() == [[3, 3, 3, 2]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert np.asarray(ji).tolist() == i.tolist()
