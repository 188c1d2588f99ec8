"""The port's EVA01, BEATs and BERT against vast_tpu's, on the same weights.

One tiny vast_tpu ``VASTModel`` (tests/helpers.py ``tiny_vast_config``)
is initialised in JAX from a seed, every parameter nudged with seeded
noise so that zero-initialised biases are exercised too, and carried
across to the port with ``from_jax``. Each encoder is then run on the
same numpy inputs in both packages, in fp32 on the CPU (JAX matmuls at
"highest" precision, tests/conftest.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_BEATS, TINY_BERT, TINY_EVA, tiny_vast_config
from vast_tpu.models.vast import VASTModel as JaxVAST
from vast_tpu_torch.convert.from_jax import from_jax, load_numpy_state_dict
from vast_tpu_torch.models.beats import BeatsConfig
from vast_tpu_torch.models.bert import BertConfig
from vast_tpu_torch.models.eva_vit import EvaVitConfig
from vast_tpu_torch.models.vast import VASTConfig, VASTModel

# all values below are O(1); two tiny fp32 layers deep the two packages
# differ by summation order only (~1e-6 relative measured)
ATOL = RTOL = 2e-5


def _port_cfg(cls, jcfg):
    names = {f.name for f in dataclasses.fields(cls)} - {"dtype"}
    return cls(**{n: getattr(jcfg, n) for n in names if hasattr(jcfg, n)})


def port_config(jcfg) -> VASTConfig:
    """The port's VASTConfig with the fields of a vast_tpu VASTConfig."""
    cfg = _port_cfg(VASTConfig, jcfg)
    return dataclasses.replace(
        cfg, vision_cfg=_port_cfg(EvaVitConfig, jcfg.vision_cfg),
        audio_cfg=_port_cfg(BeatsConfig, jcfg.audio_cfg),
        bert_cfg=_port_cfg(BertConfig, jcfg.bert_cfg))


def raw_batch(rs, b=3, n_frames=2, hw=(40, 48), text_len=12):
    """uint8 frames, int16-scale waveforms (64 fbank frames) and captions
    with some padding."""
    mask = np.ones((b, text_len), np.int32)
    mask[0, text_len - 3:] = 0
    return {
        "vision_frames": rs.randint(0, 256, (b, n_frames) + hw + (3,)
                                    ).astype(np.uint8),
        "audio_waveforms": (rs.randn(b, 63 * 160 + 400) * 3000
                            ).astype(np.float32),
        "caption_tokens": rs.randint(106, 170, (b, text_len)
                                     ).astype(np.int32),
        "caption_attention_mask": mask,
    }


def _init_every_param(m, b):
    """Touch every head so init creates the full tree that a released
    checkpoint converts to (convert_vast_checkpoint's keys)."""
    out = m(b, "ret%tva", compute_loss=False)
    m.multimodal_encoder(b["caption_tokens"], b["caption_attention_mask"],
                         encoder_hidden_states=out["condition_feats_tva"])
    md = m.multimodal_dim
    m.contra_head_s(jnp.zeros((1, md)))
    m.contra_head_v(jnp.zeros((1, m.vision_dim)))
    m.contra_head_a(jnp.zeros((1, m.audio_dim)))
    m.contra_head_vs(jnp.zeros((1, m.vision_dim + md)))
    m.contra_head_vas(jnp.zeros((1, m.vision_dim + m.audio_dim + md)))
    m.hidden_trans_subtitle_multimodal(jnp.zeros((1, md)))
    m.itm_head(jnp.zeros((1, md)))
    return out


def build_pair(seed=0):
    """(jax model, jax params, port model on the CPU, numpy batch)."""
    jcfg = tiny_vast_config()
    rs = np.random.RandomState(seed)
    batch = raw_batch(rs)
    jm = JaxVAST(jcfg)
    params = jm.init(jax.random.PRNGKey(seed),
                     {k: jnp.asarray(v) for k, v in batch.items()},
                     method=_init_every_param)["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.02) * np.asarray(
            rs.randn(*np.shape(p)), np.float32), params)
    pm = VASTModel(port_config(jcfg), device="cpu")
    load_numpy_state_dict(pm, from_jax(params))
    return jm, params, pm, batch


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_eva01_matches(pair):
    jm, params, pm, _ = pair
    px = np.random.RandomState(4).randn(2, 2, 32, 32, 3).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(px),
                    method=JaxVAST.forward_vision_encoder)
    with torch.no_grad():
        got = pm.forward_vision_encoder(torch.from_numpy(px))
    assert tuple(got.shape) == (2, 2, 17, 32)
    _close(got, want)


def test_beats_matches(pair):
    jm, params, pm, _ = pair
    sp = np.random.RandomState(5).randn(2, 1, 64, 16).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(sp),
                    method=JaxVAST.forward_audio_encoder)
    with torch.no_grad():
        got = pm.forward_audio_encoder(torch.from_numpy(sp))
    assert tuple(got.shape) == (2, 1, 16, 32)
    _close(got, want)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_bert_matches(pair, cross):
    jm, params, pm, batch = pair
    ids, mask = batch["caption_tokens"], batch["caption_attention_mask"]
    cond = np.random.RandomState(6).randn(3, 20, 32).astype(np.float32) \
        if cross else None
    want = jm.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask),
        None if cond is None else jnp.asarray(cond),
        method=lambda m, i, a, c: m.multimodal_encoder.encode(
            i, a, encoder_hidden_states=c))
    with torch.no_grad():
        got = pm.multimodal_encoder.encode(
            torch.from_numpy(ids), torch.from_numpy(mask),
            encoder_hidden_states=None if cond is None
            else torch.from_numpy(cond))
    _close(got, want)


def test_grouped_cross_kv_scores_match(pair):
    """T texts folded onto each candidate's cross K/V (kv_groups), against
    vast_tpu's grouped scores and the port's own pair-by-pair scores."""
    jm, params, pm, _ = pair
    rs = np.random.RandomState(7)
    g, t = 2, 3
    cond = rs.randn(g, 20, 32).astype(np.float32)
    ids = rs.randint(106, 170, (g * t, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 8:] = 0
    want = jm.apply({"params": params}, jnp.asarray(cond), jnp.asarray(ids),
                    jnp.asarray(mask),
                    method=JaxVAST.compute_slice_scores_grouped)
    with torch.no_grad():
        got = pm.compute_slice_scores_grouped(
            torch.from_numpy(cond), torch.from_numpy(ids),
            torch.from_numpy(mask))
        pairwise = pm.compute_slice_scores(
            torch.from_numpy(np.repeat(cond, t, axis=0)),
            torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got, want)
    _close(pairwise, got.numpy())


def test_grouped_cross_kv_kernel_route_matches(pair, monkeypatch):
    """Eight texts of 12 tokens folded onto each candidate's 200 condition
    tokens: the folded query (96 rows) takes the head-major kernel's route
    (on the CPU its plain version), as the flagship rerank does from eight
    texts per candidate on. Held against vast_tpu (plain on the CPU) and
    the port's own pair-by-pair scores (plain route)."""
    from vast_tpu_torch.ops import attention
    from vast_tpu_torch.ops import flash_attention as fa

    calls = []

    def spy(q, *args, **kwargs):
        calls.append(tuple(q.shape))
        return fa.flash_attention(q, *args, **kwargs)

    monkeypatch.setattr(attention, "flash_attention", spy)
    jm, params, pm, _ = pair
    rs = np.random.RandomState(8)
    g, t, lc = 2, 8, 200
    cond = rs.randn(g, lc, 32).astype(np.float32)
    ids = rs.randint(106, 170, (g * t, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[3, 7:] = 0
    want = jm.apply({"params": params}, jnp.asarray(cond), jnp.asarray(ids),
                    jnp.asarray(mask),
                    method=JaxVAST.compute_slice_scores_grouped)
    with torch.no_grad():
        got = pm.compute_slice_scores_grouped(
            torch.from_numpy(cond), torch.from_numpy(ids),
            torch.from_numpy(mask))
        n_layers = len(calls)
        pairwise = pm.compute_slice_scores(
            torch.from_numpy(np.repeat(cond, t, axis=0)),
            torch.from_numpy(ids), torch.from_numpy(mask))
    heads = TINY_BERT.num_attention_heads
    assert calls == [(g, heads, t * 12, 32 // heads)] * n_layers
    assert n_layers == TINY_BERT.num_hidden_layers
    _close(got, want)
    _close(pairwise, got.numpy())
