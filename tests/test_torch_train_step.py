"""The ret%tva train step as a whole: the port against vast_tpu, on the CPU.

Same weights on both sides (tests/test_torch_models.py ``build_pair``:
a tiny vast_tpu model, every parameter nudged, carried across with
``from_jax``), the same numpy batch of uint8 frames, int16-scale
waveforms and captions, and the ITM negatives injected
(``itm_neg_cond_idx`` / ``itm_neg_text_idx``), so no draw is random. In
fp32; JAX matmuls at "highest" precision (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import build_pair
from vast_tpu.training.optimizer import build_optimizer as j_build_optimizer
from vast_tpu.training.step import create_train_state as j_create_state
from vast_tpu.training.step import make_train_step as j_make_train_step
from vast_tpu_torch.convert.from_jax import from_jax
from vast_tpu_torch.models.vast import label_smoothed_ce
from vast_tpu_torch.training.optimizer import build_optimizer
from vast_tpu_torch.training.step import create_train_state, make_train_step

NEG = {"itm_neg_cond_idx": np.array([[2, 0, 1]], np.int32),
       "itm_neg_text_idx": np.array([[1, 2, 0]], np.int32)}


@pytest.fixture(scope="module")
def pair():
    jm, params, pm, batch = build_pair(seed=3)
    return jm, params, pm, dict(batch, **NEG)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_label_smoothed_ce_matches():
    from vast_tpu.models.vast import label_smoothed_ce as j_ce

    rs = np.random.RandomState(0)
    logits = rs.randn(5, 7).astype(np.float32) * 3
    targets = rs.randint(0, 7, 5)
    for smoothing in (0.0, 0.1):
        got = label_smoothed_ce(torch.from_numpy(logits),
                                torch.from_numpy(targets), smoothing)
        want = j_ce(jnp.asarray(logits), jnp.asarray(targets), smoothing)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_losses_and_every_gradient_match_jax(pair):
    """forward_ret(compute_loss=True) losses and the gradient of their sum
    w.r.t. every parameter, against jax.value_and_grad. EVA's qkv weight,
    q/v biases and BEATs' q/k/v projections are read through the fused
    per-head layout, so their gradients show that it is built
    differentiably while autograd records."""
    jm, params, pm, batch = pair

    def loss_fn(p):
        out = jm.apply({"params": p},
                       {k: jnp.asarray(v) for k, v in batch.items()},
                       "ret%tva", compute_loss=True, deterministic=True)
        return sum(out.values()), out

    (_, jout), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    want = from_jax(jax.tree.map(np.asarray, jgrads))

    pm.zero_grad(set_to_none=True)
    out = pm(_torch_batch(batch), "ret%tva", compute_loss=True)
    sum(out.values()).backward()
    for k in ("loss_itc", "loss_itm"):
        # O(1) losses through 2+2+2 fp32 layers: ~1e-6 relative
        np.testing.assert_allclose(out[k].item(), float(jout[k]),
                                   rtol=2e-5, err_msg=k)
    reached = 0
    for n, p in pm.named_parameters():
        w = want[n]
        if p.grad is None:
            # what the losses do not reach (the subtitle, MLM and other
            # contrastive heads) has a zero gradient in JAX
            assert not w.any(), n
            continue
        reached += 1
        scale = max(float(np.abs(w).max()), 1e-3)
        # fp32 backward through the same 2+2+2 layers in another order:
        # relative to each tensor's largest entry, ~1e-6 measured
        np.testing.assert_allclose(p.grad.numpy(), w, atol=2e-5 * scale,
                                   rtol=1e-4, err_msg=n)
    for n in ("vision_encoder.visual.blocks.0.attn.qkv.weight",
              "vision_encoder.visual.blocks.1.attn.q_bias",
              "vision_encoder.visual.blocks.1.attn.v_bias",
              "audio_encoder.encoder.layers.0.self_attn.k_proj.weight",
              "audio_encoder.encoder.layers.1.self_attn.q_proj.bias",
              "audio_encoder.encoder.layers.0.self_attn."
              "relative_attention_bias.weight"):
        g = dict(pm.named_parameters())[n].grad
        assert g is not None and g.abs().max().item() > 0, n
    assert reached > 100


def test_frozen_encoders_get_no_gradient(pair):
    import dataclasses

    from vast_tpu_torch.models.vast import VASTModel

    _, _, pm, batch = pair
    cfg = dataclasses.replace(pm.cfg, frozen_vision=True, frozen_audio=True)
    model = VASTModel(cfg, device="cpu")
    model.load_state_dict(pm.state_dict())
    out = model(_torch_batch(batch), "ret%tva", compute_loss=True)
    sum(out.values()).backward()
    for n, p in model.named_parameters():
        if n.startswith(("vision_encoder.", "audio_encoder.")):
            assert p.grad is None, n
    assert model.hidden_trans_vision_multimodal[0].weight.grad is not None


def test_three_train_steps_match_jax(pair):
    """make_train_step x 3 on one batch: losses per step and the
    parameters after the third, against vast_tpu's jitted step with
    build_optimizer. Frames are resized ('none'), the waveform holds one
    clip, and the negatives are injected, so no draw is random."""
    jm, params, pm, batch = pair
    run_cfg = {"learning_rate": 1e-3, "clip_lr": 2e-4, "betas": [0.9, 0.98],
               "weight_decay": 0.01, "scheduler": "warmup_linear",
               "warmup_ratio": 0.1}
    model_cfg = {"vision_encoder_type": "evaclip01_giant"}

    jp = jax.tree.map(jnp.asarray, params)
    tx, _ = j_build_optimizer(jp, run_cfg, model_cfg, 20)
    state = j_create_state(jp, tx)
    jstep = j_make_train_step(jm, tx, "ret%tva")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(3):
        state, m = jstep(state, jbatch, jax.random.PRNGKey(0))
        want.append({k: float(v) for k, v in m.items()})
    want_params = from_jax(jax.tree.map(np.asarray, state.params))

    opt, _ = build_optimizer(pm, run_cfg, model_cfg, 20)
    pstate = create_train_state(pm, opt)
    step = make_train_step(pm, opt, "ret%tva")
    gen = torch.Generator().manual_seed(0)
    tb = _torch_batch(batch)
    got = []
    for _ in range(3):
        pstate, m = step(pstate, tb, gen)
        got.append({k: v.item() for k, v in m.items()})
    assert pstate.step == 3 and opt.count == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-5, err_msg=k)
    assert got[2]["total_loss"] != got[0]["total_loss"]
    for n, p in pm.named_parameters():
        # three Adam updates of <= lr = 1e-3 each, from gradients that
        # agree to ~1e-8 absolute: Adam divides by |g| + eps, so where a
        # gradient is near eps = 1e-6 that difference is scaled up to ~1%
        # of lr (the update rule itself is held at 1e-7 against optax in
        # tests/test_torch_train.py)
        atol = 1e-5
        if n.endswith(("k_proj.bias", "self.key.bias")):
            # softmax ignores a bias on every key alike, so this gradient
            # is rounding noise (~1e-9) on both sides, which Adam scales
            # up to as much as lr per update: only the bound holds
            atol = 3 * run_cfg["learning_rate"]
        np.testing.assert_allclose(p.detach().numpy(), want_params[n],
                                   atol=atol, rtol=1e-5, err_msg=n)


def _tiny_step_fp64(monkeypatch, cs, cpu, batch):
    """The card's tiny train step of ``cpu``'s weights, on a copy in fp64
    arithmetic: the fp32 casts of the port's plain versions, losses and
    optimizer (``Tensor.float``) keep fp64 as it is."""
    import dataclasses

    from vast_tpu_torch.models.vast import VASTModel
    from vast_tpu_torch.ops import flash_attention as fa

    f64 = torch.float64
    cfg = cpu.cfg
    cfg = dataclasses.replace(
        cfg, dtype=f64,
        vision_cfg=dataclasses.replace(cfg.vision_cfg, dtype=f64),
        audio_cfg=dataclasses.replace(cfg.audio_cfg, dtype=f64),
        bert_cfg=dataclasses.replace(cfg.bert_cfg, dtype=f64))
    model = VASTModel(cfg, device="cpu")
    model.load_state_dict(cpu.state_dict())
    to_fp32 = torch.Tensor.float
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", lambda t, *a, **k:
                  t if t.dtype == f64 else to_fp32(t, *a, **k))
        m.setitem(fa._DTYPE_CODES, f64, -1)
        cs.tiny_step(torch, model, batch)
    return model


def _worst(model, ref, attr):
    """The largest error of ``model``'s gradients (``attr`` "grad",
    relative to each tensor's largest, floored at 1e-3, as on the card) or
    parameters ("data", absolute) against ``ref``'s, and where."""
    want = dict(ref.named_parameters())
    worst, where = 0.0, None
    for n, p in model.named_parameters():
        g, w = getattr(p, attr), getattr(want[n], attr)
        assert (g is None) == (w is None), n
        if g is None:
            continue
        err = (g.double() - w.double()).abs().max().item()
        if attr == "grad":
            err /= max(w.abs().max().item(), 1e-3)
        if err > worst:
            worst, where = err, n
    return worst, where


@pytest.mark.parametrize("temperature,gain_offset,low,high", [
    (None, 0.0, 1e-3, None),          # every weight as drawn: 1.1e-2
    (0.07, 0.0, 1e-4, None),          # the temperature alone: 2.8e-4
    (None, 1.0, None, 2e-5),          # the LayerNorm gains alone: 8.1e-6
    (0.07, 1.0, None, 2e-5),          # both, as chip_smoke.py runs: 7.2e-6
], ids=["drawn", "temperature", "gains", "both"])
def test_tiny_step_conditioning(monkeypatch, temperature, gain_offset, low,
                                high):
    """Why the card's GPU-against-CPU train step (chip_smoke.py
    ``tiny_train_inputs``) sets the temperature and LayerNorm gains: the
    same step in fp32 against fp64, on the CPU alone. The reading is the
    gradient error relative to each tensor's largest gradient (floored at
    1e-3), as on the card, where the limit is 1e-4. With a temperature of
    0.013 and gains near 0, as N(0, 0.02) draws them, fp32 itself is off
    by far more than that limit, so two fp32 devices cannot agree to it;
    with the gains near 1 it reads under a tenth of it. Printed beside it
    (``pytest -s``): the parameters after the step against fp64, and the
    same fp32 step from weights moved by one fp32 ulp (x (1 +- 2^-23))
    against the unmoved one, the spread that rounding alone gives two
    fp32 runs."""
    import chip_smoke as cs
    from vast_tpu_torch.models.vast import VASTModel

    cpu, batch = cs.tiny_train_inputs(torch, np, temperature, gain_offset)
    moved = VASTModel(cpu.cfg, device="cpu")
    moved.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in moved.parameters():
            p.mul_(1 + 2.0 ** -23 * torch.randn(p.shape, generator=gen).sign())
    ref = _tiny_step_fp64(monkeypatch, cs, cpu, batch)
    cs.tiny_step(torch, cpu, batch)
    cs.tiny_step(torch, moved, batch)
    worst, where = _worst(cpu, ref, "grad")
    readings = {"grad fp64": (worst, where),
                "param fp64": _worst(cpu, ref, "data"),
                "grad ulp-moved": _worst(moved, cpu, "grad"),
                "param ulp-moved": _worst(moved, cpu, "data")}
    print(f"\ntemperature {temperature}, gain offset {gain_offset}: "
          + "; ".join(f"{k} {v:.3g} at {n}" for k, (v, n) in readings.items()))
    assert low is None or worst > low
    assert high is None or worst < high
