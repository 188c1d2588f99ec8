"""The port's training pieces against vast_tpu's, on the CPU, in fp32.

The backward of the token-major attention (its plain version, which the
CUDA kernel is held to on the card) against vast_tpu's Pallas backward
in interpret mode and against ``jax.grad``; activation checkpointing
policies against each other; the random resized crop against
``jax.image.scale_and_translate``; the optimizer against optax; the LR
schedule. JAX matmuls run at "highest" precision (tests/conftest.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_models import build_pair
from vast_tpu.ops.attention import flash_self_attention_tmajor as j_attn
from vast_tpu.ops.attention import \
    flash_self_attention_tmajor_biased as j_attn_biased
from vast_tpu.ops.flash_attention import self_attention_tmajor_bwd as j_bwd
from vast_tpu.training.optimizer import build_optimizer as j_build_optimizer
from vast_tpu.training.optimizer import param_labels as j_param_labels
from vast_tpu.training.sched import get_lr_ratio as j_lr_ratio
from vast_tpu_torch.convert.from_jax import from_jax, load_numpy_state_dict
from vast_tpu_torch.models.vast import AUDIO_STATS, VASTModel
from vast_tpu_torch.ops import flash_attention as fa
from vast_tpu_torch.ops import image
from vast_tpu_torch.ops.fbank import kaldi_fbank
from vast_tpu_torch.training.optimizer import build_optimizer, param_labels
from vast_tpu_torch.training.sched import get_lr_ratio

# the head layouts of tests/test_ops.py:344-503, which vast_tpu's head
# packing (_hc_for) accepts: 2 heads of 128, 4 of 64 with lk_true, and 4
# of 64 with a per-sample bias over 128 keys
BWD_CASES = {
    "d128_lk_true": dict(b=2, l=32, h=2, d=128, lk_true=27, scale=0.7,
                         bias=False),
    "d64_lk_true": dict(b=2, l=32, h=4, d=64, lk_true=27, scale=0.7,
                        bias=False),
    "d64_bias": dict(b=2, l=128, h=4, d=64, lk_true=0, scale=64 ** -0.5,
                     bias=True),
}


def _bwd_inputs(c, seed):
    rs = np.random.RandomState(seed)
    b, l, h, d = c["b"], c["l"], c["h"], c["d"]
    qkv = rs.randn(b, l, h * 3 * d).astype(np.float32)
    bias = rs.randn(b, h, l, l).astype(np.float32) if c["bias"] else None
    do = rs.randn(b, l, h * d).astype(np.float32)
    if c["lk_true"]:
        # a padded tail, as EVA's padded L: garbage rows, zero cotangent
        qkv[:, c["lk_true"]:] = 50.0 * rs.randn(b, l - c["lk_true"],
                                                h * 3 * d)
        do[:, c["lk_true"]:] = 0.0
    return qkv, bias, do


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_tmajor_bwd_matches_pallas(case):
    c = BWD_CASES[case]
    qkv, bias, do = _bwd_inputs(c, 0)
    h, lk = c["h"], c["lk_true"]
    tb = None if bias is None else torch.from_numpy(bias)
    o = fa.self_attention_tmajor(torch.from_numpy(qkv), tb, heads=h,
                                 lk_true=lk, scale=c["scale"])
    before = dict(fa.LAUNCHES)
    got = fa.self_attention_tmajor_bwd(torch.from_numpy(qkv), o,
                                       torch.from_numpy(do), tb, heads=h,
                                       lk_true=lk, scale=c["scale"])
    assert fa.LAUNCHES == before          # the CPU path launches no kernel
    want = j_bwd(jnp.asarray(qkv), jnp.asarray(o.numpy()), jnp.asarray(do),
                 None if bias is None else jnp.asarray(bias), heads=h,
                 lk_true=lk, scale=c["scale"], interpret=True)
    if bias is None:
        got, want = (got,), (want,)
    # fp32 softmax over <= 128 keys and D-term products: ~1e-6 relative
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5,
                                   rtol=3e-5)
    if lk:
        # the padded tail's gradients are exactly 0, in the port and JAX
        assert not got[0][:, lk:].any()
        assert not np.asarray(want[0])[:, lk:].any()


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_tmajor_autograd_matches_jax_grad(case):
    """torch.autograd through the differentiable op against jax.grad of
    vast_tpu's custom-VJP entry (Pallas in interpret mode)."""
    c = BWD_CASES[case]
    qkv, bias, do = _bwd_inputs(c, 1)
    h, lk, scale = c["h"], c["lk_true"], c["scale"]
    x = torch.from_numpy(qkv).requires_grad_(True)
    inputs = [x]
    tb = None
    if bias is not None:
        tb = torch.from_numpy(bias).requires_grad_(True)
        inputs.append(tb)
    out = fa.self_attention_tmajor(x, tb, heads=h, lk_true=lk, scale=scale)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(do))

    def loss(*args):
        if bias is None:
            y = j_attn(args[0], h, lk, scale, interpret=True)
        else:
            y = j_attn_biased(args[0], args[1], h, lk, scale,
                              interpret=True)
        return jnp.sum(y * jnp.asarray(do))

    jargs = [jnp.asarray(qkv)] + ([] if bias is None else [jnp.asarray(bias)])
    want = jax.grad(loss, argnums=tuple(range(len(jargs))))(*jargs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5,
                                   rtol=3e-5)


def test_tmajor_shared_bias_grad_sums_over_the_batch():
    """A (1, H, L, L) bias shared by the batch gets the batch's summed ds
    (vast_tpu broadcasts it first, so its gradient is the same sum)."""
    rs = np.random.RandomState(2)
    b, l, h, d = 3, 40, 2, 16
    qkv = torch.from_numpy(rs.randn(b, l, h * 3 * d).astype(np.float32))
    bias = torch.from_numpy(rs.randn(1, h, l, l).astype(np.float32))
    do = torch.from_numpy(rs.randn(b, l, h * d).astype(np.float32))
    shared = bias.clone().requires_grad_(True)
    wide = bias.expand(b, h, l, l).clone().requires_grad_(True)
    g_shared = torch.autograd.grad(
        fa.self_attention_tmajor(qkv, shared, heads=h, scale=0.5), shared,
        do)[0]
    g_wide = torch.autograd.grad(
        fa.self_attention_tmajor(qkv, wide, heads=h, scale=0.5), wide,
        do)[0]
    assert g_shared.shape == (1, h, l, l)
    torch.testing.assert_close(g_shared, g_wide.sum(0, keepdim=True),
                               atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=2)


def _loss_batch(batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["itm_neg_cond_idx"] = torch.tensor([[1, 2, 0]])
    tb["itm_neg_text_idx"] = torch.tensor([[2, 0, 1]])
    return tb


def _grads(pm, cfg_changes, batch, generator_seed=None):
    model = VASTModel(dataclasses.replace(pm.cfg, **cfg_changes),
                      device="cpu")
    model.load_state_dict(pm.state_dict())
    gen = None
    if generator_seed is not None:
        gen = torch.Generator().manual_seed(generator_seed)
    out = model(batch, "ret%tva", compute_loss=True, generator=gen)
    sum(out.values()).backward()
    return {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}


def _with_remat(cfg, policy, **sub):
    """``cfg`` with every encoder checkpointed under ``policy`` (the tiny
    sub-configs are explicit, so they carry their own switches)."""
    on = dict(remat=policy != "none", remat_policy=policy)
    return dict(
        vision_cfg=dataclasses.replace(cfg.vision_cfg, **on,
                                       **sub.get("vision", {})),
        audio_cfg=dataclasses.replace(cfg.audio_cfg, **on),
        bert_cfg=dataclasses.replace(cfg.bert_cfg, **on,
                                     **sub.get("bert", {})))


@pytest.mark.parametrize("policy", ["full", "attn", "dots"])
def test_remat_policy_grads_match_no_remat(pair, policy):
    """Checkpointing trades memory for compute only: the gradients under
    every policy equal those without it (vast_tpu's
    test_remat_policy_grads_match_no_remat), with drop-path and dropout
    on, so the recompute must draw the forward's masks again."""
    _, _, pm, batch = pair
    tb = _loss_batch(batch)
    sub = {"vision": {"drop_path_rate": 0.3},
           "bert": {"hidden_dropout_prob": 0.2}}
    g0 = _grads(pm, _with_remat(pm.cfg, "none", **sub), tb, 5)
    g1 = _grads(pm, _with_remat(pm.cfg, policy, **sub), tb, 5)
    assert g0.keys() == g1.keys()
    for n in g0:
        # the same operations on the same values: equal up to a reordered
        # fp32 sum of the recomputed branches
        torch.testing.assert_close(g1[n], g0[n], atol=1e-7, rtol=1e-6,
                                   msg=n)


@pytest.mark.parametrize("policy,runs", [("none", 1), ("full", 2),
                                         ("attn", 1), ("dots", 1)])
def test_attn_policy_does_not_rerun_attention(pair, monkeypatch, policy,
                                              runs):
    """Under 'attn' and 'dots' the attention op's output is saved, so the
    backward does not run the attention forward again ('full' does)."""
    _, _, pm, batch = pair
    calls = []
    plain = fa._self_attention_tmajor_plain

    def spy(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(fa, "_self_attention_tmajor_plain", spy)
    model = VASTModel(dataclasses.replace(pm.cfg, **_with_remat(pm.cfg,
                                                                policy)),
                      device="cpu")
    model.load_state_dict(pm.state_dict())
    out = model(_loss_batch(batch), "ret%tva", compute_loss=True)
    n_fwd = len(calls)
    assert n_fwd == pm.cfg.vision_cfg.layers + pm.cfg.audio_cfg.encoder_layers
    sum(out.values()).backward()
    assert len(calls) == runs * n_fwd


def test_random_resized_crop_matches_scale_and_translate():
    """The crop itself, for given draws, against the JAX function that
    vast_tpu's random_resized_crop_flip calls per clip."""
    rs = np.random.RandomState(3)
    b, n, h, w, r = 3, 2, 40, 48, 32
    x = rs.rand(b, n, h, w, 3).astype(np.float32)
    top = np.array([0, 3, 5])
    left = np.array([7, 0, 2])
    side = np.array([35.5, 38.0, 36.2], np.float32)
    flip = np.array([False, True, True])
    got = image.resized_crop_flip(torch.from_numpy(x), torch.from_numpy(top),
                                  torch.from_numpy(left),
                                  torch.from_numpy(side),
                                  torch.from_numpy(flip), r)
    for i in range(b):
        s = np.float32(r) / side[i]
        want = jax.image.scale_and_translate(
            jnp.asarray(x[i]), (n, r, r, 3), (1, 2), jnp.stack([s, s]),
            -jnp.asarray([top[i], left[i]], jnp.float32) * s,
            method="bilinear")
        want = np.asarray(want)[:, :, ::-1] if flip[i] else np.asarray(want)
        np.testing.assert_allclose(got[i].numpy(), want, atol=2e-6,
                                   rtol=1e-5)


def test_random_crop_draws_stay_inside_the_frame():
    g = torch.Generator().manual_seed(0)
    top, left, side, flip = image.crop_params(500, 40, 48, g, "cpu")
    assert bool(((side >= np.sqrt(0.8 * 40 * 48) - 1e-3)
                 & (side <= 40.0)).all())
    assert bool(((top >= 0) & (top + side <= 40 + 1e-3)).all())
    assert bool(((left >= 0) & (left + side <= 48 + 1e-3)).all())
    assert 0.4 < flip.float().mean().item() < 0.6
    frames = torch.randint(0, 256, (4, 2, 40, 48, 3), dtype=torch.uint8)
    out = image.preprocess_frames(frames, 32, transforms="crop_flip",
                                  generator=g)
    assert out.shape == (4, 2, 32, 32, 3) and bool(torch.isfinite(out).all())


def test_training_audio_clip_is_one_of_its_segment(pair):
    """With a generator, each of n segments gives one of its own clips
    (vast_tpu vast.py:420-427), not always the centre one."""
    _, _, pm, _ = pair
    model = VASTModel(dataclasses.replace(pm.cfg, max_audio_sample_num=2),
                      device="cpu")
    rs = np.random.RandomState(4)
    # 6 clips of 64 fbank frames: two segments of 3
    wav = torch.from_numpy((rs.randn(2, (6 * 64 - 1) * 160 + 400) * 3000
                            ).astype(np.float32))
    batch = {"audio_waveforms": wav}
    eval_clips = model._preprocess_audio(batch)
    g = torch.Generator().manual_seed(1)
    mean, std = AUDIO_STATS["beats"]
    fb = (kaldi_fbank(wav, num_mel_bins=16) - mean) / (2.0 * std)
    all_clips = fb.view(2, 6, 64, 16)
    # eval: the centre clip of each segment (1 and 4)
    torch.testing.assert_close(eval_clips, all_clips[:, [1, 4]])
    seen = set()
    for _ in range(8):
        clips = model._preprocess_audio(batch, g)
        for bi in range(2):
            for si in range(2):
                hits = [c for c in range(3 * si, 3 * si + 3)
                        if torch.equal(clips[bi, si], all_clips[bi, c])]
                assert len(hits) == 1
                seen.add(hits[0])
    assert len(seen) > 2


def test_param_labels_match_vast_tpu(pair):
    """The port's decay / no-decay and LR groups, mapped through the
    checkpoint names, equal vast_tpu's param_labels on the JAX tree."""
    _, params, pm, _ = pair
    jl = j_param_labels(params, (), vision_is_clip=True)
    names = sorted({lab for lab in jax.tree_util.tree_leaves(jl)})
    codes = jax.tree.map(
        lambda lab, p: np.full(np.shape(p), names.index(lab), np.int32), jl,
        params)
    want = {k: names[int(v.flat[0])] for k, v in from_jax(codes).items()}
    got = param_labels(pm, (), vision_is_clip=True)
    assert got == want
    # the trap of the rule: these are decayed in vast_tpu
    for name in ("vision_encoder.visual.blocks.0.attn.q_bias",
                 "audio_encoder.encoder.pos_conv.0.bias",
                 "multimodal_encoder.cls.predictions.bias", "contra_temp"):
        assert not got[name].endswith("_nd"), name


OPT_CASES = {
    "fp32_moments": {},
    "bf16_mu": {"adam_mu_dtype": "bfloat16"},
    "bf16_moments": {"adam_mu_dtype": "bfloat16",
                     "adam_nu_dtype": "bfloat16"},
    "clip_grads": {"clip_grads": True, "grad_norm": 0.5},
    "accumulate_2": {"gradient_accumulation_steps": 2},
}
RUN_CFG = {"learning_rate": 1e-3, "clip_lr": 2e-4, "new_lr": 0.0,
           "new_params_name": [], "betas": [0.9, 0.98],
           "weight_decay": 0.01, "optim": "adamw",
           "scheduler": "warmup_linear", "warmup_ratio": 0.1}
MODEL_CFG = {"vision_encoder_type": "evaclip01_giant"}
UNREACHED = "contra_head_s"      # no gradient: optax sees zeros


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_steps_match_optax(pair, case):
    """Updates from the same params and gradients, against vast_tpu's
    build_optimizer (optax), over as many calls as make two updates."""
    _, params, pm, _ = pair
    run_cfg = dict(RUN_CFG, **OPT_CASES[case])
    rs = np.random.RandomState(5)
    calls = 2 * run_cfg.get("gradient_accumulation_steps", 1)
    grads = []
    for _ in range(calls):
        g = jax.tree.map(
            lambda p: np.asarray(rs.randn(*np.shape(p)) * 0.1, np.float32),
            params)
        g[UNREACHED] = jax.tree.map(np.zeros_like, g[UNREACHED])
        grads.append(g)

    tx, _ = j_build_optimizer(params, run_cfg, MODEL_CFG, 40)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
    want = from_jax(jax.tree.map(np.asarray, jp))

    model = VASTModel(pm.cfg, device="cpu")
    load_numpy_state_dict(model, from_jax(params))
    opt, _ = build_optimizer(model, run_cfg, MODEL_CFG, 40)
    applied = []
    for g in grads:
        flat = from_jax(g)
        for n, p in model.named_parameters():
            p.grad = (None if n.startswith(UNREACHED)
                      else torch.from_numpy(flat[n]))
        applied.append(opt.step())
    assert applied == [False, True] * (calls // 2) if calls > 2 \
        else applied == [True, True]
    moved = 0
    for n, p in model.named_parameters():
        moved += not np.array_equal(p.detach().numpy(), from_jax(params)[n])
        # fp32 on both sides: bias corrections and the LR ratio in double
        # here, fp32 there (~1e-7 relative of an update <= lr); with bf16
        # moments a one-ulp fp32 difference can flip a bf16 rounding of a
        # moment, 2^-8 of an update of <= 2e-4 at these steps
        tol = 1e-6 if "mu" in case or "moments" in case else 1e-7
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=tol,
                                   rtol=1e-6, err_msg=n)
    assert moved == len(list(model.parameters()))


@pytest.mark.parametrize("scheduler", ["warmup_linear", "warmup_cosine",
                                       "warmup_constant"])
def test_lr_schedule_matches(scheduler):
    for step in (0, 1, 7, 10, 11, 55, 99, 100, 130):
        assert get_lr_ratio(step, 100, scheduler, 0.1) == \
            j_lr_ratio(step, 100, scheduler, 0.1)
