"""The remaining vision towers: the port against vast_tpu, on the same
weights.

EVA02 (``subln``: separate q/k/v without a k bias, rope on the patch
tokens with ``intp_freq`` over a 12 x 12 grid that is not the
pretraining grid of 16, SwiGLU with its inner LayerNorm; 145 tokens, so
the port sends its attention through the head-major op), a post-norm
EVA tower with layer scale (bigE's block, through the token-major op),
Swin (49-token windows, every second block shifted and masked) and
VideoSwin (T' = T; 128-token windows, so the head-major op with the
relative bias and the shift mask, and its ds in the backward). Each tower
forward and its gradient against vast_tpu's; ``rope_2d_freqs`` exactly;
the whole model's ``ret%tva`` losses and every gradient with EVA02,
Swin and VideoSwin; ``from_jax`` then ``convert_vast_checkpoint`` giving
the params back exactly; the optimizer's labels; the full-size presets.
Weights are initialised in JAX from a seed, every parameter nudged with
seeded noise, and carried across with ``from_jax``; fp32 on the CPU, JAX
matmuls at "highest" precision (tests/conftest.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_vast_config
from tests.test_torch_models import _init_every_param, _port_cfg, raw_batch
from vast_tpu.convert.vast_ckpt import convert_vast_checkpoint
from vast_tpu.models import eva_vit as j_eva
from vast_tpu.models import swin as j_swin
from vast_tpu.models import videoswin as j_videoswin
from vast_tpu.models.vast import VASTConfig as JaxVASTConfig
from vast_tpu.models.vast import VASTModel as JaxVAST
from vast_tpu.training.optimizer import param_labels as j_param_labels
from vast_tpu_torch.convert import from_jax as convert
from vast_tpu_torch.convert.from_jax import from_jax, load_numpy_state_dict
from vast_tpu_torch.models import eva_vit, swin, videoswin
from vast_tpu_torch.models.beats import BeatsConfig
from vast_tpu_torch.models.bert import BertConfig
from vast_tpu_torch.models.vast import VASTConfig, VASTModel
from vast_tpu_torch.ops import attention
from vast_tpu_torch.ops import flash_attention as fa
from vast_tpu_torch.training.optimizer import param_labels

TINY_EVA02 = j_eva.EvaVitConfig(
    image_size=48, patch_size=4, width=32, layers=2, head_width=8,
    mlp_ratio=2.6667, subln=True, swiglu=True, rope=True, intp_freq=True,
    pt_hw_seq_len=16)
TINY_POSTNORM = j_eva.EvaVitConfig(
    image_size=32, patch_size=8, width=32, layers=2, head_width=8,
    mlp_ratio=2.0, postnorm=True, ls_init_value=0.1)
TINY_SWIN = j_swin.SwinConfig(image_size=56, patch_size=4, embed_dim=16,
                              depths=(2, 2), num_heads=(2, 4), window_size=7)
TINY_VIDEOSWIN = j_videoswin.VideoSwinConfig(
    embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=(2, 8, 8))

# tower: (vast_tpu module class, its config, the port's module class,
# the port's config class, input shape, from_jax's key mapping,
# vision_encoder_type, vision_resolution of the whole model)
TOWERS = {
    "eva02": (j_eva.EvaVisionTransformer, TINY_EVA02,
              eva_vit.EvaVisionTransformer, eva_vit.EvaVitConfig,
              (2, 48, 48, 3), convert._eva, "evaclip02_base", 48),
    "postnorm_layer_scale": (j_eva.EvaVisionTransformer, TINY_POSTNORM,
                             eva_vit.EvaVisionTransformer,
                             eva_vit.EvaVitConfig, (2, 32, 32, 3),
                             convert._eva, "evaclip02_bige", 32),
    "swin": (j_swin.SwinTransformer, TINY_SWIN, swin.SwinTransformer,
             swin.SwinConfig, (2, 56, 56, 3), convert._swin,
             "swin_base_22k_224", 56),
    "videoswin": (j_videoswin.VideoSwinTransformer, TINY_VIDEOSWIN,
                  videoswin.VideoSwinTransformer, videoswin.VideoSwinConfig,
                  (2, 2, 64, 64, 3), convert._swin, "videoswin", 64),
}
WHOLE_MODEL = ("eva02", "swin", "videoswin")
NEG = {"itm_neg_cond_idx": np.array([[2, 0, 1]], np.int32),
       "itm_neg_text_idx": np.array([[1, 2, 0]], np.int32)}
# O(1) values two tiny fp32 layers deep: the packages differ by summation
# order only (~1e-6 relative measured); the stated limit of a forward is
# 1e-5 of its largest value, of a gradient 1e-4 of its tensor's largest
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _jit(name, fn):
    """jax.jit, except for VideoSwin: vast_tpu's ``shift_mask_3d`` builds
    its masks with numpy from jnp values, which a trace cannot give."""
    return fn if name == "videoswin" else jax.jit(fn)


def _nudged(params, rs):
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.02) * np.asarray(
            rs.randn(*np.shape(p)), np.float32), params)


def _port_tower(name):
    _, jc, port_cls, cfg_cls, shape, _, _, _ = TOWERS[name]
    if port_cls is videoswin.VideoSwinTransformer:
        return port_cls(_port_cfg(cfg_cls, jc), "cpu", frames=shape[1],
                        image_size=shape[2])
    return port_cls(_port_cfg(cfg_cls, jc), "cpu")


def _assert_fwd(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FWD_TOL * np.abs(want).max())


def _assert_grads(named, want):
    """Each parameter's gradient within GRAD_TOL of its tensor's largest
    (what the loss does not reach has a zero gradient in JAX)."""
    reached = 0
    for n, p in named:
        w = want[n]
        if p.grad is None:
            assert not w.any(), n
            continue
        reached += 1
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=n)
    return reached


@pytest.fixture(scope="module", params=list(TOWERS))
def tower(request):
    return _build_tower(request.param)


def _build_tower(name):
    """(name, jax module, nudged params, port tower on the CPU, input)."""
    jcls, jc, _, _, shape, mapping, _, _ = TOWERS[name]
    rs = np.random.RandomState(11)
    px = rs.randn(*shape).astype(np.float32)
    jm = jcls(jc)
    params = _nudged(_jit(name, jm.init)(jax.random.PRNGKey(3),
                                         jnp.asarray(px))["params"], rs)
    pm = _port_tower(name)
    sd = {}
    mapping(sd, "", params)
    load_numpy_state_dict(pm, sd)
    return name, jm, params, pm, px


def test_rope_2d_freqs_exactly_equal():
    for jc in (TINY_EVA02, j_eva.EVA_PRESETS["evaclip02_base"],
               j_eva.EVA_PRESETS["evaclip02_large"],
               dataclasses.replace(j_eva.EVA_PRESETS["evaclip02_large"],
                                   image_size=336)):
        got = eva_vit.rope_2d_freqs(_port_cfg(eva_vit.EvaVitConfig, jc))
        want = j_eva.rope_2d_freqs(jc)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_apply_rope_matches():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 144, 4, 8).astype(np.float32)
    ang = j_eva.rope_2d_freqs(TINY_EVA02)
    got = eva_vit.apply_rope(torch.from_numpy(x), torch.from_numpy(ang))
    _assert_fwd(got, j_eva.apply_rope(jnp.asarray(x), jnp.asarray(ang)))


def test_tower_forward_and_gradient_match(tower, monkeypatch):
    """The tower's output and the gradient of sum(out * r) with respect to
    every parameter and to the pixels, against jax.grad."""
    name, jm, params, pm, px = tower
    routes = []
    for fn in ("flash_attention", "self_attention_tmajor"):
        real = getattr(fa, fn)

        def spy(*a, _real=real, _fn=fn, **k):
            routes.append(_fn)
            return _real(*a, **k)
        target = attention if fn == "flash_attention" else eva_vit
        monkeypatch.setattr(target, fn, spy)
    with torch.no_grad():
        shape = pm(torch.from_numpy(px)).shape
    r = np.random.RandomState(12).randn(*shape).astype(np.float32)

    def loss(p, x):
        out = jm.apply({"params": p}, x)
        return jnp.sum(out * r), out

    (_, want), (g_p, g_x) = _jit(name, jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(px))
    x = torch.from_numpy(px).requires_grad_()
    got = pm(x)
    _assert_fwd(got, want)
    (got * torch.from_numpy(r)).sum().backward()
    wgrads = {}
    TOWERS[name][5](wgrads, "", jax.tree.map(np.asarray, g_p))
    assert _assert_grads(pm.named_parameters(), wgrads) == len(wgrads)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_x), rtol=0,
                               atol=GRAD_TOL * np.abs(np.asarray(g_x)).max())
    # the route each tower's attention takes in the port
    want_route = {"eva02": "flash_attention",
                  "postnorm_layer_scale": "self_attention_tmajor",
                  "videoswin": "flash_attention"}.get(name)
    if want_route is None:                              # Swin: plain
        assert routes == []
    else:
        assert routes and set(routes) == {want_route}, routes


def test_swin_shift_mask_blocks_cross_region_pairs():
    """The shifted block's mask equals vast_tpu's and keeps tokens of
    different regions of the rolled image apart; the relative position
    indices agree in 2-D and 3-D."""
    got = swin.shift_attn_mask(14, 14, 7, 3)
    np.testing.assert_array_equal(got, j_swin.shift_attn_mask(14, 14, 7, 3))
    assert got.shape == (4, 49, 49) and got[0].all() and not got[3].all()
    # in the last window, token 0 (rows 7-9) and token 48 (rows 11-13) lie
    # in different regions
    assert not got[3, 0, 48]
    np.testing.assert_array_equal(swin.relative_position_index(7),
                                  j_swin.relative_position_index(7))
    np.testing.assert_array_equal(videoswin.rel_index_3d(8, 7, 7),
                                  j_videoswin.rel_index_3d(8, 7, 7))
    m3 = videoswin.shift_mask_3d(2, 16, 16, (2, 8, 8), (0, 4, 4))
    np.testing.assert_array_equal(
        m3, j_videoswin.shift_mask_3d(2, 16, 16, (2, 8, 8), (0, 4, 4)))
    assert not m3.all()


def test_videoswin_keeps_the_frame_count():
    """T' = T: the temporal patch of 2 at time stride 1 after one trailing
    zero frame; a grid that clamps a window otherwise raises."""
    pm = _port_tower("videoswin")
    with torch.no_grad():
        out = pm(torch.zeros(1, 2, 64, 64, 3))
    assert tuple(out.shape) == (1, 2, 8 * 8, TINY_VIDEOSWIN.num_features)
    with pytest.raises(ValueError, match="clamps the window"):
        with torch.no_grad():
            pm(torch.zeros(1, 1, 64, 64, 3))


def _jax_vast_config(name):
    jc, vtype, res = TOWERS[name][1], TOWERS[name][6], TOWERS[name][7]
    return tiny_vast_config(vision_encoder_type=vtype, vision_cfg=jc,
                            vision_resolution=res)


def _port_vast_config(jcfg, name):
    cfg_cls = TOWERS[name][3]
    return dataclasses.replace(
        _port_cfg(VASTConfig, jcfg),
        vision_cfg=_port_cfg(cfg_cls, jcfg.vision_cfg),
        audio_cfg=_port_cfg(BeatsConfig, jcfg.audio_cfg),
        bert_cfg=_port_cfg(BertConfig, jcfg.bert_cfg))


@pytest.fixture(scope="module", params=WHOLE_MODEL)
def model_pair(request):
    """(name, jax model, params, port model on the CPU, numpy batch with
    the ITM negatives)."""
    name = request.param
    jcfg = _jax_vast_config(name)
    rs = np.random.RandomState(5)
    batch = raw_batch(rs)
    jm = JaxVAST(jcfg)
    init = _jit(name, functools.partial(jm.init, method=_init_every_param))
    params = _nudged(init(jax.random.PRNGKey(5),
                          {k: jnp.asarray(v) for k, v in batch.items()}
                          )["params"], rs)
    pm = VASTModel(_port_vast_config(jcfg, name), device="cpu")
    load_numpy_state_dict(pm, from_jax(params))
    return name, jm, params, pm, dict(batch, **NEG)


def test_whole_model_features_match(model_pair):
    """ret%tva features from uint8 frames: ImageNet statistics and mean
    pooling for Swin and VideoSwin, CLIP's and the CLS token for EVA02."""
    name, jm, params, pm, batch = model_pair
    want = _jit(name, functools.partial(jm.apply, task="ret%tva",
                                        compute_loss=False))(
        {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = pm({k: torch.from_numpy(v) for k, v in batch.items()},
                 "ret%tva", compute_loss=False)
    for key in ("feat_t", "feat_cond_tva", "condition_feats_tva"):
        assert got[key].shape == want[key].shape, key
        _assert_fwd(got[key], want[key])


def test_whole_model_losses_and_every_gradient_match(model_pair):
    """forward_ret(compute_loss=True): ITC and ITM and the gradient of
    their sum with respect to every parameter, against
    jax.value_and_grad."""
    name, jm, params, pm, batch = model_pair

    def loss_fn(p):
        out = jm.apply({"params": p},
                       {k: jnp.asarray(v) for k, v in batch.items()},
                       "ret%tva", compute_loss=True, deterministic=True)
        return sum(out.values()), out

    (_, jout), jgrads = _jit(name, jax.value_and_grad(loss_fn,
                                                      has_aux=True))(params)
    want = from_jax(jax.tree.map(np.asarray, jgrads))
    pm.zero_grad(set_to_none=True)
    out = pm({k: torch.from_numpy(v) for k, v in batch.items()}, "ret%tva",
             compute_loss=True)
    sum(out.values()).backward()
    for k in ("loss_itc", "loss_itm"):
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-5,
                                   err_msg=k)
    assert _assert_grads(pm.named_parameters(), want) > 60
    vision = [p for n, p in pm.named_parameters()
              if n.startswith("vision_encoder.")]
    assert all(p.grad is not None and p.grad.abs().max() > 0
               for p in vision)


def test_checkpoint_round_trip_is_exact(model_pair):
    """convert_vast_checkpoint(from_jax(params)) == params for each tower:
    EVA02's q/k/v, inner LayerNorms and SwiGLU; Swin's and VideoSwin's
    top-level vision_encoder.* with the 2-D and 3-D patch kernels."""
    name, jm, params, pm, _ = model_pair
    sd = from_jax(params)
    assert set(sd) == set(pm.state_dict())
    if name == "videoswin":
        # vast_tpu's convert_vast_checkpoint divides vision_resolution by
        # VideoSwin's 3-tuple patch (vast_ckpt.py:445) and raises, a fault
        # of vast_tpu; its convert_videoswin (:313) reads the tower
        from vast_tpu.convert.vast_ckpt import convert_videoswin

        with pytest.raises(TypeError):
            convert_vast_checkpoint(sd, jm.cfg)
        back = {"vision_encoder": convert_videoswin(
            sd, "vision_encoder.", TINY_VIDEOSWIN.depths)}
        params = {"vision_encoder": params["vision_encoder"]}
    else:
        back = convert_vast_checkpoint(sd, jm.cfg)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_postnorm_layer_scale_round_trip_is_exact():
    """bigE's block: gamma_1 / gamma_2 and the post-norm tower's keys map
    both ways (convert_eva_vit reads the port's state dict)."""
    from vast_tpu.convert.vast_ckpt import convert_eva_vit

    _, _, params, pm, _ = _build_tower("postnorm_layer_scale")
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    assert {"blocks.0.gamma_1", "blocks.1.gamma_2"} <= set(sd)
    back = convert_eva_vit(sd, "", TINY_POSTNORM.layers)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, np.asarray(leaf))


def test_param_labels_match_vast_tpu(model_pair):
    """Decay and LR groups against vast_tpu's param_labels: EVA02's q/v
    biases decayed, Conv3d's bias not, the tower in the clip group only
    for EVA (a 'clip' type)."""
    name, _, params, pm, _ = model_pair
    vtype = TOWERS[name][6]
    clip = "clip" in vtype
    jl = j_param_labels(params, (), vision_is_clip=clip)
    names = sorted(set(jax.tree_util.tree_leaves(jl)))
    codes = jax.tree.map(
        lambda lab, p: np.full(np.shape(p), names.index(lab), np.int32), jl,
        params)
    want = {k: names[int(v.flat[0])] for k, v in from_jax(codes).items()}
    assert param_labels(pm, (), vision_is_clip=clip) == want


@pytest.mark.parametrize("vtype", [
    "evaclip02_base", "evaclip02_large", "evaclip02_bige",
    "swin_base_22k_224", "swin_large_22k_224", "videoswin"])
def test_full_size_configs_match_vast_tpu(vtype):
    """Each preset as VASTConfig resolves it against vast_tpu's, and the
    tower's width into the fusion projections (EVA_VISION_DIMS,
    SWIN_VISION_DIMS, VideoSwin's 1024)."""
    port, jcfg = (VASTConfig(vision_encoder_type=vtype),
                  JaxVASTConfig(vision_encoder_type=vtype))
    got, want = port.resolved_vision_cfg(), jcfg.resolved_vision_cfg()
    # gelu_approx None (every preset): GELU by dtype, the port's only rule
    assert getattr(want, "gelu_approx", None) is None
    names = {f.name for f in dataclasses.fields(want)} - {"dtype",
                                                           "gelu_approx"}
    assert {n: getattr(got, n) for n in names} == \
        {n: getattr(want, n) for n in names}
    width = (j_eva.EVA_VISION_DIMS.get(vtype)
             or j_swin.SWIN_VISION_DIMS.get(vtype) or 1024)
    vc = port.resolved_vision_cfg()
    assert (vc.width if hasattr(vc, "width") else vc.num_features) == width
    assert (eva_vit.EVA_VISION_DIMS.get(vtype)
            or swin.SWIN_VISION_DIMS.get(vtype)
            or videoswin.VideoSwinConfig().num_features) == width
