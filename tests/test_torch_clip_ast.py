"""The CLIP + AST configuration of ret%tva: the port against vast_tpu.

Two tiny sizes of the towers. ``TINY_CLIP`` / ``TINY_AST`` (17 tokens)
keep every attention on the plain route, in both packages. ``KERNEL``
(patch 2: 257 tokens per frame and per clip) sends every CLIP and AST
attention through the port's head-major op, as the full-width towers
(577 and 257 tokens) do, while vast_tpu on the CPU takes its plain route:
the two routes must agree. Same weights on both sides (initialised in
JAX from a seed, every parameter nudged, carried across with
``from_jax``), the same numpy inputs, injected ITM negatives; fp32 on the
CPU, JAX matmuls at "highest" precision (tests/conftest.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_AST, TINY_CLIP, tiny_vast_config
from tests.test_torch_models import _init_every_param, _port_cfg, raw_batch
from vast_tpu.convert.vast_ckpt import convert_vast_checkpoint
from vast_tpu.models.ast import AstModel as JaxAst
from vast_tpu.models.clip_vit import ClipVisionTransformer as JaxClip
from vast_tpu.models.vast import VASTConfig as JaxVASTConfig
from vast_tpu.models.vast import VASTModel as JaxVAST
from vast_tpu.ops import attention as j_attention
from vast_tpu.ops.fbank import ast_fbank as j_ast_fbank
from vast_tpu.training.optimizer import build_optimizer as j_build_optimizer
from vast_tpu.training.optimizer import param_labels as j_param_labels
from vast_tpu.training.step import create_train_state as j_create_state
from vast_tpu.training.step import make_train_step as j_make_train_step
from vast_tpu_torch.convert import from_jax as convert
from vast_tpu_torch.convert.from_jax import from_jax, load_numpy_state_dict
from vast_tpu_torch.models.ast import AstConfig, AstModel
from vast_tpu_torch.models.bert import BertConfig
from vast_tpu_torch.models.clip_vit import ClipVisionTransformer, ClipVitConfig
from vast_tpu_torch.models.vast import VASTConfig, VASTModel
from vast_tpu_torch.ops import attention
from vast_tpu_torch.ops import flash_attention as fa
from vast_tpu_torch.ops.fbank import ast_fbank
from vast_tpu_torch.training.optimizer import build_optimizer, param_labels
from vast_tpu_torch.training.step import create_train_state, make_train_step

SIZES = {
    "plain_route": (TINY_CLIP, TINY_AST),
    "kernel_route": (dataclasses.replace(TINY_CLIP, patch_size=2),
                     dataclasses.replace(TINY_AST, patch_size=2)),
}
NEG = {"itm_neg_cond_idx": np.array([[2, 0, 1]], np.int32),
       "itm_neg_text_idx": np.array([[1, 2, 0]], np.int32)}
MODEL_CFG = {"vision_encoder_type": "clip_vit_base_16"}
KEY_BIASES = ("attention.linears.1.bias", "self.key.bias")
# O(1) values two tiny fp32 layers deep: the packages differ by summation
# order only (~1e-6 relative measured)
ATOL = RTOL = 2e-5


def jax_config(size):
    clip, ast = SIZES[size]
    return tiny_vast_config(vision_encoder_type="clip_vit_base_16",
                            audio_encoder_type="ast", vision_cfg=clip,
                            audio_cfg=ast)


def port_config(jcfg, remat_policy="none"):
    """The port's VASTConfig with the fields of a vast_tpu one, every
    tower under ``remat_policy``."""
    on = dict(remat=remat_policy != "none", remat_policy=remat_policy)
    return dataclasses.replace(
        _port_cfg(VASTConfig, jcfg),
        vision_cfg=dataclasses.replace(
            _port_cfg(ClipVitConfig, jcfg.vision_cfg), **on),
        audio_cfg=dataclasses.replace(_port_cfg(AstConfig, jcfg.audio_cfg),
                                      **on),
        bert_cfg=dataclasses.replace(_port_cfg(BertConfig, jcfg.bert_cfg),
                                     **on))


def build_pair(size, seed=0):
    """(jax model, jax params, port model on the CPU, numpy batch with
    the ITM negatives)."""
    jcfg = jax_config(size)
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
    return jm, params, pm, dict(batch, **NEG)


@pytest.fixture(scope="module", params=list(SIZES))
def pair(request):
    return build_pair(request.param)


@pytest.fixture(scope="module")
def kernel_pair():
    return build_pair("kernel_route", seed=1)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **({"atol": ATOL, "rtol": RTOL} | kw))


@pytest.mark.parametrize("size", list(SIZES))
def test_clip_vision_transformer_matches(size):
    jc = SIZES[size][0]
    rs = np.random.RandomState(1)
    px = rs.randn(3, 32, 32, 3).astype(np.float32)
    jm = JaxClip(jc)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(px))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.02) * np.asarray(
            rs.randn(*np.shape(p)), np.float32), params)
    want = jm.apply({"params": params}, jnp.asarray(px))
    model = ClipVisionTransformer(_port_cfg(ClipVitConfig, jc), "cpu")
    sd = {}
    convert._clip(sd, "", params)
    load_numpy_state_dict(model, sd)
    with torch.no_grad():
        got = model(torch.from_numpy(px))
    assert tuple(got.shape) == (3, jc.grid_size ** 2 + 1, jc.width)
    _close(got, want)


@pytest.mark.parametrize("size", list(SIZES))
def test_ast_model_matches(size):
    ja = SIZES[size][1]
    rs = np.random.RandomState(2)
    fb = rs.randn(2, ja.audio_target_length, ja.audio_melbins
                  ).astype(np.float32)
    jm = JaxAst(ja)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(fb))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.02) * np.asarray(
            rs.randn(*np.shape(p)), np.float32), params)
    want = jm.apply({"params": params}, jnp.asarray(fb))
    model = AstModel(_port_cfg(AstConfig, ja), "cpu")
    sd = {}
    convert._ast(sd, params)
    load_numpy_state_dict(model, sd)
    with torch.no_grad():
        got = model(torch.from_numpy(fb))
    assert tuple(got.shape) == (2, ja.tokens_per_clip + 1, ja.hidden_size)
    _close(got, want)


def test_ast_fbank_matches():
    rs = np.random.RandomState(3)
    wav = (rs.randn(2, 99 * 160 + 400) * 0.1).astype(np.float32)
    got = ast_fbank(torch.from_numpy(wav), num_mel_bins=16)
    want = j_ast_fbank(jnp.asarray(wav), 16000, num_mel_bins=16)
    # log-mel of fp32 FFTs in two libraries: ~1e-6 relative of O(10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


def test_ret_tva_features_match(pair):
    """Features from uint8 frames and int16-scale waveforms (the AST
    fbank and its stats, CLIP's pixels, AST's CLS pooling)."""
    jm, params, pm, batch = pair
    want = jm.apply({"params": params},
                    {k: jnp.asarray(v) for k, v in batch.items()},
                    "ret%tva", compute_loss=False)
    with torch.no_grad():
        got = pm({k: torch.from_numpy(v) for k, v in batch.items()},
                 "ret%tva", compute_loss=False)
    for key in ("feat_t", "feat_cond_tva", "condition_feats_tva"):
        assert got[key].shape == want[key].shape, key
        _close(got[key], want[key], atol=3e-5, rtol=3e-5, err_msg=key)


def test_losses_and_every_gradient_match_jax(pair):
    """forward_ret(compute_loss=True) losses and the gradient of their sum
    w.r.t. every parameter, against jax.value_and_grad. At the kernel
    route's size every CLIP and AST attention goes through the head-major
    op and its backward (their plain versions on the CPU)."""
    jm, params, pm, batch = pair

    def loss_fn(p):
        out = jm.apply({"params": p},
                       {k: jnp.asarray(v) for k, v in batch.items()},
                       "ret%tva", compute_loss=True, deterministic=True)
        return sum(out.values()), out

    (_, jout), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    want = from_jax(jax.tree.map(np.asarray, jgrads))
    pm.zero_grad(set_to_none=True)
    out = pm({k: torch.from_numpy(v) for k, v in batch.items()}, "ret%tva",
             compute_loss=True)
    sum(out.values()).backward()
    for k in ("loss_itc", "loss_itm"):
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=2e-5,
                                   err_msg=k)
    reached = 0
    for n, p in pm.named_parameters():
        w = want[n]
        if p.grad is None:
            # what the losses do not reach has a zero gradient in JAX
            assert not w.any(), n
            continue
        reached += 1
        if n.endswith(KEY_BIASES):
            # softmax ignores a bias added to every key alike, so the
            # exact gradient is 0 and each side reads rounding noise
            # (<= 2.6e-8 measured)
            assert np.abs(w).max() <= 1e-7, n
            assert p.grad.abs().max().item() <= 1e-7, n
            continue
        scale = max(float(np.abs(w).max()), 1e-3)
        # relative to each tensor's largest entry, ~1e-6 measured
        np.testing.assert_allclose(p.grad.numpy(), w, atol=2e-5 * scale,
                                   rtol=1e-4, err_msg=n)
    for n in ("vision_encoder.visual.transformer.resblocks.0.attn."
              "in_proj_weight",
              "vision_encoder.visual.transformer.resblocks.1.attn."
              "in_proj_bias", "vision_encoder.visual.class_embedding",
              "audio_embeddings.first_conv.weight",
              "audio_embeddings.position_embeddings.weight",
              "audio_encoder.layer.1.attention.linears.0.weight"):
        g = dict(pm.named_parameters())[n].grad
        assert g is not None and g.abs().max().item() > 0, n
    assert reached > 100


def test_three_train_steps_match_jax(kernel_pair):
    """make_train_step x 3 on one batch at the kernel route's size: losses
    per step and every parameter after the third, against vast_tpu's
    jitted step with build_optimizer (CLIP's tower in the clip_lr group)."""
    jm, params, pm, batch = kernel_pair
    run_cfg = {"learning_rate": 1e-3, "clip_lr": 2e-4, "betas": [0.9, 0.98],
               "weight_decay": 0.01, "scheduler": "warmup_linear",
               "warmup_ratio": 0.1}
    jp = jax.tree.map(jnp.asarray, params)
    tx, _ = j_build_optimizer(jp, run_cfg, MODEL_CFG, 20)
    state = j_create_state(jp, tx)
    jstep = j_make_train_step(jm, tx, "ret%tva")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(3):
        state, m = jstep(state, jbatch, jax.random.PRNGKey(0))
        want.append({k: float(v) for k, v in m.items()})
    want_params = from_jax(jax.tree.map(np.asarray, state.params))

    model = VASTModel(pm.cfg, device="cpu")
    model.load_state_dict(pm.state_dict())
    opt, _ = build_optimizer(model, run_cfg, MODEL_CFG, 20)
    pstate = create_train_state(model, opt)
    step = make_train_step(model, opt, "ret%tva")
    gen = torch.Generator().manual_seed(0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = []
    for _ in range(3):
        pstate, m = step(pstate, tb, gen)
        got.append({k: v.item() for k, v in m.items()})
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-5, err_msg=k)
    assert got[2]["total_loss"] != got[0]["total_loss"]
    for n, p in model.named_parameters():
        # three Adam updates of <= lr = 1e-3 (tests/test_torch_train_step.py
        # test_three_train_steps_match_jax gives the reasons): 1e-5; a key
        # bias's gradient is rounding noise on both sides, so only the
        # update's bound holds there
        got_p, want_p = p.detach().numpy(), want_params[n]
        atol = np.full(got_p.shape, 1e-5)
        if n.endswith(KEY_BIASES):
            atol[:] = 3 * run_cfg["learning_rate"]
        elif n.endswith("in_proj_bias"):                # its key third
            w = got_p.shape[0] // 3
            atol[w:2 * w] = 3 * run_cfg["learning_rate"]
        assert (np.abs(got_p - want_p) <= atol + 1e-5 * np.abs(want_p)
                ).all(), (n, np.abs(got_p - want_p).max())


def test_frozen_audio_gets_no_gradient(kernel_pair):
    _, _, pm, batch = kernel_pair
    model = VASTModel(dataclasses.replace(pm.cfg, frozen_audio=True),
                      device="cpu")
    model.load_state_dict(pm.state_dict())
    out = model({k: torch.from_numpy(v) for k, v in batch.items()},
                "ret%tva", compute_loss=True)
    sum(out.values()).backward()
    for n, p in model.named_parameters():
        if n.startswith(("audio_embeddings.", "audio_encoder.")):
            assert p.grad is None, n
    assert model.vision_encoder["visual"].conv1.weight.grad is not None


def test_checkpoint_round_trip_is_exact(pair):
    """convert_vast_checkpoint(from_jax(params)) == params: CLIP's packed
    in_proj and AST's two top-level modules map both ways."""
    jm, params, _, _ = pair
    back = convert_vast_checkpoint(from_jax(params), jm.cfg)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_param_labels_match_vast_tpu(kernel_pair):
    """Decay / no-decay and LR groups against vast_tpu's param_labels:
    CLIP's tower in the clip group, its in_proj bias not decayed."""
    _, params, pm, _ = kernel_pair
    jl = j_param_labels(params, (), vision_is_clip=True)
    names = sorted(set(jax.tree_util.tree_leaves(jl)))
    codes = jax.tree.map(
        lambda lab, p: np.full(np.shape(p), names.index(lab), np.int32), jl,
        params)
    want = {k: names[int(v.flat[0])] for k, v in from_jax(codes).items()}
    got = param_labels(pm, (), vision_is_clip=True)
    assert got == want
    stem = "vision_encoder.visual.transformer.resblocks.0.attn."
    assert got[stem + "in_proj_bias"] == "clip_nd"
    assert got[stem + "in_proj_weight"] == "clip"
    assert got["audio_embeddings.position_embeddings.weight"] == "basic"


def test_full_size_configs_match_vast_tpu():
    """CLIP-L/14-336 + AST as VASTConfig resolves them, against
    vast_tpu's presets (clip_vit.py:41-46, ast.py:24-36)."""
    kw = dict(vision_encoder_type="clip_vit_large_14_336px",
              vision_resolution=336, audio_encoder_type="ast")
    port, jcfg = VASTConfig(**kw), JaxVASTConfig(**kw)
    for got, want in ((port.resolved_vision_cfg(), jcfg.resolved_vision_cfg()),
                      (port.resolved_audio_cfg(), jcfg.resolved_audio_cfg())):
        names = {f.name for f in dataclasses.fields(want)} - {"dtype"}
        assert {n: getattr(got, n) for n in names} == \
            {n: getattr(want, n) for n in names}
    vc, ac = port.resolved_vision_cfg(), port.resolved_audio_cfg()
    assert (vc.grid_size ** 2 + 1, vc.width // vc.heads) == (577, 64)
    assert (ac.tokens_per_clip + 1,
            ac.hidden_size // ac.num_attention_heads) == (257, 64)


@pytest.mark.parametrize("lq,lk,plain", [
    (577, 577, False), (257, 257, False), (16 * 40, 4873, False),
    (8 * 40, 4873, True), (40, 4873, True)],
    ids=["clip_336", "ast", "rerank_16_texts", "rerank_8_texts",
         "caption_cross"])
def test_routing_rule_at_clip_ast_shapes(monkeypatch, lq, lk, plain):
    """D 64 everywhere; the condition sequence is 8 x 577 + 257 = 4873.
    vast_tpu's rule (attention.py:231-251, its backend set to "tpu" here)
    agrees with the port's: CLIP's and AST's self-attention and the
    rerank's folded query of 16 texts take the kernel."""
    monkeypatch.setattr(j_attention.jax, "default_backend", lambda: "tpu")
    assert attention._plain_route(lq, lk, 64) is plain
    assert j_attention._use_pallas_shapes(8, lq, lk, 12, 64,
                                          has_bias=False) is not plain


@pytest.mark.parametrize("policy,runs", [("none", 1), ("full", 2),
                                         ("attn", 1), ("dots", 1)])
def test_attn_policy_does_not_rerun_hmajor_attention(kernel_pair,
                                                     monkeypatch, policy,
                                                     runs):
    """Under 'attn' and 'dots' the head-major op's outputs (o and lse)
    are saved, so the backward does not run its forward again ('full'
    does); the gradients equal those without checkpointing."""
    jm, _, pm, batch = kernel_pair
    calls = []
    plain = fa._flash_attention_plain

    def spy(*args, **kwargs):
        calls.append(kwargs.get("return_lse", False))
        return plain(*args, **kwargs)

    monkeypatch.setattr(fa, "_flash_attention_plain", spy)
    grads = []
    for pol in ("none", policy):
        model = VASTModel(port_config(jm.cfg, pol), device="cpu")
        model.load_state_dict(pm.state_dict())
        calls.clear()
        out = model({k: torch.from_numpy(v) for k, v in batch.items()},
                    "ret%tva", compute_loss=True)
        n_fwd = len(calls)
        assert n_fwd == (pm.cfg.vision_cfg.layers
                         + pm.cfg.audio_cfg.num_hidden_layers)
        assert all(calls)                    # the forward with the lse
        sum(out.values()).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None})
    assert len(calls) == runs * n_fwd
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], atol=1e-7,
                                   rtol=1e-6, msg=n)


def test_tiny_clip_ast_step_conditioning(monkeypatch):
    """The card's tiny CLIP + AST train step (chip_smoke.py
    ``phase_tiny_clip_ast``, whose limit is 1e-4 of each tensor's largest
    gradient) in fp32 against fp64, on the CPU alone, from the weights it
    uses (temperature 0.07, LayerNorm gains + 1). On clips of equal
    statistics the condition features are equal (a CLS token over 257
    tokens averages 256 patches of noise) and the ITC gradient cancels:
    fp32 errs by 1.9e-4 there. On the clips of distinct brightness and
    loudness that the card runs it errs by 3.2e-5, so two fp32 devices,
    each under 5e-5 from fp64, differ by less than the limit. (The lse's
    fp32 dtype check of the head-major backward is bypassed for the fp64
    copy.)"""
    import chip_smoke as cs
    from tests.test_torch_train_step import _tiny_step_fp64, _worst

    monkeypatch.setattr(fa, "flash_attention_bwd",
                        fa._flash_attention_bwd_plain)
    worst = {}
    for distinct in (False, True):
        cpu, batch = cs.tiny_train_inputs(
            torch, np, config=cs.tiny_clip_ast_config, distinct=distinct)
        ref = _tiny_step_fp64(monkeypatch, cs, cpu, batch)
        cs.tiny_step(torch, cpu, batch)
        worst[distinct] = _worst(cpu, ref, "grad")
        print(f"\ndistinct clips {distinct}: grad fp32 vs fp64 "
              f"{worst[distinct][0]:.3g} at {worst[distinct][1]}; param "
              f"{_worst(cpu, ref, 'data')[0]:.3g}")
    assert worst[False][0] > 1e-4
    assert worst[True][0] < 5e-5
