"""Retrieval beyond ``tva``: the port against vast_tpu on the CPU.

The subtasks ``tv``, ``ta``, ``tva``, ``tvs`` and ``tvas`` (the subtitle
stream: ``subtitle_output``, ``condition_feats_s/_vs/_vas``,
``feat_s/_v/_a/_vs/_vas``) and the vast27m per-modality caption streams
(``text_output@…``, ``feat_t@…``): features, ITC and ITM losses with the
ITM negatives injected, and the gradient of every parameter; the frame
embedding both ways; ``VASTConfig.from_model_cfg`` on every released
``ret%…`` finetune config. Same weights on both sides: a tiny vast_tpu
model initialised in JAX from a seed (every head), every parameter
nudged, carried across with ``from_jax``. fp32; JAX matmuls at
"highest" precision (tests/conftest.py).
"""

import dataclasses
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_vast_config
from tests.test_torch_models import _init_every_param, port_config, raw_batch
from vast_tpu.config import get_args as j_get_args
from vast_tpu.models.vast import VASTConfig as JaxVASTConfig
from vast_tpu.models.vast import VASTModel as JaxVAST
from vast_tpu_torch.config import get_args
from vast_tpu_torch.convert.from_jax import from_jax, load_numpy_state_dict
from vast_tpu_torch.models.vast import VASTConfig, VASTModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBTASKS = ("tv", "ta", "tva", "tvs", "tvas")
# O(1) features through preprocessing, two encoders, BERT and the heads,
# fp32: the packages differ by summation order only (~1e-6 relative
# measured), as tests/test_torch_vast.py
ATOL = RTOL = 3e-5
STREAMS = ("vision_caption", "audio_caption", "omni_caption")
NEG = {"itm_neg_cond_idx": np.array([[2, 0, 1]], np.int32),
       "itm_neg_text_idx": np.array([[1, 2, 0]], np.int32)}


def _tokens(rs, b=3, length=12, pad_from=None):
    ids = rs.randint(106, 170, (b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    if pad_from is not None:
        mask[1, pad_from:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def pair():
    """(jax model, params, port model, numpy batch with a subtitle and the
    three vast27m caption streams)."""
    rs = np.random.RandomState(11)
    batch = raw_batch(rs)
    batch["subtitle_tokens"], batch["subtitle_attention_mask"] = \
        _tokens(rs, pad_from=7)
    for i, stream in enumerate(STREAMS):
        batch[f"{stream}_tokens"], batch[f"{stream}_attention_mask"] = \
            _tokens(rs, pad_from=5 + i)
    jcfg = tiny_vast_config()
    jm = JaxVAST(jcfg)
    init = jax.jit(functools.partial(jm.init, method=_init_every_param))
    params = init(jax.random.PRNGKey(11),
                  {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.02) * np.asarray(
            rs.randn(*np.shape(p)), np.float32), params)
    pm = VASTModel(port_config(jcfg), device="cpu")
    load_numpy_state_dict(pm, from_jax(params))
    return jm, params, pm, batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def features(pair):
    """Every subtask's features in one vast_tpu call and one port call."""
    jm, params, pm, batch = pair
    task = "ret%" + "%".join(SUBTASKS)
    want = jax.jit(lambda p: jm.apply({"params": p}, _j(batch), task,
                                      compute_loss=False))(params)
    with torch.no_grad():
        got = pm(_t(batch), task, compute_loss=False)
    return got, want


@pytest.mark.parametrize("st", SUBTASKS)
def test_features_match(features, st):
    got, want = features
    for key in ("feat_t", f"feat_cond_{st}", f"condition_feats_{st}"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)


def test_subtitle_condition_order(features):
    """condition_feats_tvas is the vision, audio and subtitle sequences in
    that order, and tvs the vision and subtitle ones (vast.py:487-492)."""
    got, _ = features
    tv, ta = got["condition_feats_tv"], got["condition_feats_ta"]
    tvas, tvs = got["condition_feats_tvas"], got["condition_feats_tvs"]
    v, a = tv.shape[1], ta.shape[1]
    assert tvas.shape[1] == v + a + 12 and tvs.shape[1] == v + 12
    for part, want in ((tvas[:, :v], tv), (tvas[:, v:v + a], ta),
                       (tvs[:, :v], tv), (tvs[:, v:], tvas[:, v + a:])):
        torch.testing.assert_close(part, want, rtol=0, atol=0)


# the key projections' biases (BEATs, BERT)
KEY_BIASES = ("k_proj.bias", "self.key.bias")


def _losses_and_grads(pair, task, extra=None, drop=()):
    jm, params, pm, batch = pair
    batch = {k: v for k, v in batch.items() if k not in drop} | NEG
    if extra:
        batch |= extra

    def loss_fn(p):
        out = jm.apply({"params": p}, _j(batch), task, compute_loss=True,
                       deterministic=True)
        return sum(out.values()), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn,
                                                   has_aux=True))(params)
    want = from_jax(jax.tree.map(np.asarray, jgrads))
    pm.zero_grad(set_to_none=True)
    out = pm(_t(batch), task, compute_loss=True)
    sum(out.values()).backward()
    assert out.keys() == jout.keys()
    for k in out:
        # O(1) losses through 2+2+2 fp32 layers: ~1e-6 relative
        # (tests/test_torch_train_step.py)
        np.testing.assert_allclose(out[k].item(), float(jout[k]),
                                   rtol=2e-5, err_msg=k)
    reached = set()
    for n, p in pm.named_parameters():
        w = want[n]
        if p.grad is None:
            assert not w.any(), n
            continue
        reached.add(n)
        if n.endswith(KEY_BIASES):
            # softmax ignores a bias added to every key alike: this
            # gradient is rounding noise on both sides (~1e-8 here), so
            # only its smallness holds
            assert np.abs(p.grad.numpy()).max() < 1e-6 > np.abs(w).max(), n
            continue
        scale = max(float(np.abs(w).max()), 1e-3)
        # fp32 backward through the same layers in another order, relative
        # to each tensor's largest entry (tests/test_torch_train_step.py)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=2e-5 * scale,
                                   rtol=1e-4, err_msg=n)
    return reached


# each subtask's own heads: its losses must reach them
HEADS = {"tv": ("contra_head_v.linear.weight",
                "hidden_trans_vision_multimodal.0.weight"),
         "ta": ("contra_head_a.linear.weight",
                "hidden_trans_audio_multimodal.0.weight"),
         "tvs": ("contra_head_vs.weight", "subtitle_type_embeddings",
                 "hidden_trans_subtitle_multimodal.0.weight"),
         "tvas": ("contra_head_vas.weight", "contra_head_vas.bias",
                  "subtitle_type_embeddings", "audio_frame_embedding",
                  "hidden_trans_subtitle_multimodal.1.weight")}


@pytest.mark.parametrize("st", ("tv", "ta", "tvs", "tvas"))
def test_losses_and_every_gradient_match(pair, st):
    reached = _losses_and_grads(pair, f"ret%{st}")
    assert set(HEADS[st]) <= reached, set(HEADS[st]) - reached
    assert ("vision_frame_embedding" in reached) == ("v" in st)


def test_vast27m_streams_losses_and_gradients(pair):
    """Each subtask against its own caption stream (tv: vision_caption,
    ta: audio_caption, tvas: omni_caption), the losses averaged; no
    caption_tokens in the batch."""
    reached = _losses_and_grads(
        pair, "ret%tvas%tv%ta",
        drop=("caption_tokens", "caption_attention_mask"))
    assert set(HEADS["tvas"]) | set(HEADS["tv"]) | set(HEADS["ta"]) \
        <= reached


def test_vast27m_text_feature_streams(pair):
    jm, params, pm, batch = pair
    keys = [f"feat_t@{s}" for s in STREAMS]

    def feats(m, b):
        cache = {}
        return [m.get_feature(b, k, cache) for k in keys]

    want = jax.jit(lambda p: jm.apply({"params": p}, _j(batch),
                                      method=feats))(params)
    with torch.no_grad():
        got = feats(pm, _t(batch))
    for k, g, w in zip(keys, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    assert not np.allclose(got[0].numpy(), got[2].numpy())


def test_frame_embedding_type_none(pair):
    """frame_embedding_type other than 'adaptive': no vision frame
    embedding (vast.py:350); the audio one stays."""
    jm, params, pm, batch = pair
    jm_none = JaxVAST(dataclasses.replace(jm.cfg,
                                          frame_embedding_type="none"))
    pm_none = VASTModel(dataclasses.replace(pm.cfg,
                                            frame_embedding_type="none"),
                        device="cpu")
    pm_none.load_state_dict(pm.state_dict())
    want = jax.jit(lambda p: jm_none.apply({"params": p}, _j(batch),
                                           "ret%tvas", compute_loss=False)
                   )(params)
    with torch.no_grad():
        got = pm_none(_t(batch), "ret%tvas", compute_loss=False)
        adaptive = pm(_t(batch), "ret%tvas", compute_loss=False)
    key = "condition_feats_tvas"
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               atol=ATOL, rtol=RTOL)
    n_v = batch["vision_frames"].shape[1] * 17
    assert not torch.allclose(got[key][:, :n_v], adaptive[key][:, :n_v])
    torch.testing.assert_close(got[key][:, n_v:], adaptive[key][:, n_v:],
                               rtol=0, atol=0)


RET_CONFIGS = sorted(glob.glob(os.path.join(
    ROOT, "vast_tpu", "configs", "finetune_cfg", "retrieval-*.json")))


def _fields(cfg, names):
    return {n: getattr(cfg, n) for n in names}


@pytest.mark.parametrize("path", RET_CONFIGS, ids=os.path.basename)
@pytest.mark.parametrize("checkpointing", [False, True])
def test_from_model_cfg_matches(path, checkpointing):
    """Every field the two VASTConfigs share, and every field of the
    resolved towers they share, equal after from_model_cfg on a released
    config (with --checkpointing, the remat policy reaching the towers)."""
    argv = ["--config", path, "--checkpointing", str(checkpointing).lower()]
    jcfg = JaxVASTConfig.from_model_cfg(j_get_args(argv).model_cfg)
    cfg = VASTConfig.from_model_cfg(get_args(argv).model_cfg)
    skip = {"dtype", "param_dtype", "vision_cfg", "audio_cfg", "bert_cfg"}
    common = ({f.name for f in dataclasses.fields(VASTConfig)}
              & {f.name for f in dataclasses.fields(JaxVASTConfig)}) - skip
    assert len(common) >= 17
    assert _fields(cfg, common) == _fields(jcfg, common)
    assert cfg.checkpointing is checkpointing
    for tower in ("vision", "audio", "bert"):
        p = getattr(cfg, f"resolved_{tower}_cfg")()
        j = getattr(jcfg, f"resolved_{tower}_cfg")()
        names = ({f.name for f in dataclasses.fields(p)}
                 & {f.name for f in dataclasses.fields(j)}) - skip
        assert _fields(p, names) == _fields(j, names), tower
        assert p.remat is checkpointing


def test_from_model_cfg_tiny_dicts():
    """The tiny model_cfg of tests/helpers.py: dict sub-configs become the
    towers' configs, as vast_tpu's (``gelu_approx`` too, now ported); an
    unported key raises."""
    from tests.helpers import TINY_MODEL_CFG_JSON

    jcfg = JaxVASTConfig.from_model_cfg(TINY_MODEL_CFG_JSON)
    cfg = VASTConfig.from_model_cfg(TINY_MODEL_CFG_JSON)
    assert cfg == port_config(jcfg)
    forced = dict(TINY_MODEL_CFG_JSON,
                  vision_cfg=dict(TINY_MODEL_CFG_JSON["vision_cfg"],
                                  gelu_approx=True))
    assert VASTConfig.from_model_cfg(forced).vision_cfg.gelu_approx is True
    assert JaxVASTConfig.from_model_cfg(forced).vision_cfg.gelu_approx
    # BEATs' pre-LN variant: vast_tpu has it, the released config and the
    # port do not
    bad = dict(TINY_MODEL_CFG_JSON,
               audio_cfg=dict(TINY_MODEL_CFG_JSON["audio_cfg"],
                              layer_norm_first=True))
    with pytest.raises(NotImplementedError, match="layer_norm_first"):
        VASTConfig.from_model_cfg(bad)


def test_ret_tvas_needs_subtitles(pair):
    _, _, pm, batch = pair
    b = {k: v for k, v in batch.items() if not k.startswith("subtitle")}
    with pytest.raises(KeyError, match="subtitle_tokens"):
        with torch.no_grad():
            pm(_t(b), "ret%tvas", compute_loss=False)
