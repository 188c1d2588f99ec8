"""Parameter sharding over fsdp: 2 gloo ranks on the CPU, on the port's
``create_mesh(dp=1, fsdp=2)``, against ``vast_tpu``'s ``shard_state`` and
train step on the same mesh over conftest's CPU devices, and against one
process of the port.

The weights, batches and tolerances are ``tests/test_torch_ddp.py``'s (a
tiny vast_tpu model initialised in JAX, every parameter nudged, carried
across with ``from_jax``; 6 clips with a subtitle and injected ITM
negatives and masks; losses rtol 2e-5, gradients atol 2e-5 x each
tensor's largest entry and rtol 1e-4); ``min_size=0`` on both sides, so
every parameter with a divisible dim is split. The ranks run in one spawn
(``tests/torch_dist_workers.py``'s ``several``):

* ``ret%tvas`` and ``cap%tvas``: the losses, every gradient (gathered
  whole) and the parameters after one AdamW step against vast_tpu's;
* the moments split with their parameters;
* a resume into a sharded state: the moments and the step exact, and the
  saved ``.pt`` files equal to an unsharded save of the same state;
* ``evaluate_ret`` and ``evaluate_cap`` equal to one process;
* ``FusedCache`` under fsdp: evaluate, step, evaluate: each equal to an
  unsharded model at that point;
* clipping by the whole gradient's norm.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_dist_workers as w
from tests.helpers import tiny_vast_config
from tests.test_torch_ddp import RUN_CFG, _global_batch, _masked, _tokens
from tests.test_torch_models import _init_every_param, port_config, raw_batch
from vast_tpu.models.vast import VASTModel as JaxVAST
from vast_tpu.parallel.mesh import create_mesh, shard_batch
from vast_tpu.training.optimizer import build_optimizer as j_build_optimizer
from vast_tpu.training.step import create_train_state, shard_state
from vast_tpu_torch.convert.from_jax import from_jax, load_numpy_state_dict
from vast_tpu_torch.models.vast import VASTModel
from vast_tpu_torch.training.optimizer import global_norm
from vast_tpu_torch.training.saver import ModelSaver

DIMS = {"dp": 1, "fsdp": 2, "tp": 1}
FLAGS = {"fsdp": True}
CLIP_CFG = dict(RUN_CFG, clip_grads=True, grad_norm=0.05)


def build_setup():
    """(jax model, params, port config, port state dict, ret batch, cap
    batch): tests/test_torch_ddp.py's."""
    rs = np.random.RandomState(31)
    ret = _global_batch(rs)
    cap = dict(ret)
    cap["caption_masked_tokens"], cap["caption_masked_labels"] = _masked(
        rs, cap["caption_tokens"], cap["caption_attention_mask"])
    jm = JaxVAST(tiny_vast_config())
    params = jax.jit(lambda b: jm.init(jax.random.PRNGKey(31), b,
                                       method=_init_every_param))(
        {k: jnp.asarray(v) for k, v in ret.items()})["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.02) * np.asarray(
            rs.randn(*np.shape(p)), np.float32), params)
    cfg = port_config(jm.cfg)
    pm = VASTModel(cfg, device="cpu")
    load_numpy_state_dict(pm, from_jax(params))
    return jm, params, cfg, pm.state_dict(), ret, cap


def eval_clips():
    """10 clips: frames, a waveform, a caption and a subtitle each."""
    rs = np.random.RandomState(50)
    arrays = raw_batch(rs, b=10)
    arrays["caption_tokens"][:, 0] = 101
    arrays["subtitle_tokens"], arrays["subtitle_attention_mask"] = \
        _tokens(rs, 10, pad_from=7)
    return arrays


def jax_sharded_step(jm, params, batch, task, dims, fsdp=False, tp=False,
                     eval_constants=False):
    """vast_tpu's losses, gradient and AdamW update of one step on the
    global batch, its state placed by ``shard_state`` (min_size 0) on
    ``create_mesh(**dims)`` over conftest's CPU devices;
    ``eval_constants`` computes what depends on no input while tracing
    (vast_tpu's VideoSwin builds its shift masks with numpy from jnp
    values)."""
    n = dims["dp"] * dims["fsdp"] * dims["tp"]
    mesh = create_mesh(devices=jax.devices()[:n], **dims)
    tx, _ = j_build_optimizer(params, RUN_CFG, {}, 20)
    with jax.set_mesh(mesh):
        state = shard_state(mesh, create_train_state(
            jax.tree.map(jnp.asarray, params), tx), fsdp=fsdp, tp=tp,
            tx=tx, min_size=0)

        def step(state, b):
            with (jax.ensure_compile_time_eval() if eval_constants
                  else contextlib.nullcontext()):
                return _step(state, b)

        def _step(state, b):
            def loss_fn(p):
                out = jm.apply({"params": p}, b, task, compute_loss=True,
                               deterministic=True)
                return sum(out.values()), out
            (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params)
            updates, _ = tx.update(grads, state.opt_state, state.params)
            return out, grads, optax.apply_updates(state.params, updates)

        b = shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
        out, grads, new = jax.jit(step)(state, b)
    as_np = lambda t: from_jax(jax.tree.map(np.asarray, t))  # noqa: E731
    return ({k: float(v) for k, v in out.items()}, as_np(grads),
            as_np(new))


def check_step(got, want):
    """The rank's first step against vast_tpu's (losses, every whole
    gradient, the whole parameters after the update)."""
    losses, grads, params = want
    for k, v in losses.items():
        np.testing.assert_allclose(got["metrics"][0][k], v, rtol=2e-5,
                                   err_msg=k)
    reached = 0
    for n, want_g in grads.items():
        g = got["grads"][n]
        if g is None or not want_g.any():
            assert g is None or not np.asarray(g).any(), n
            continue
        reached += 1
        scale = max(float(np.abs(want_g).max()), 1e-3)
        np.testing.assert_allclose(g, want_g, atol=2e-5 * scale, rtol=1e-4,
                                   err_msg=n)
    for n, p in params.items():
        # Adam's first update is lr * g / (|g| + eps) per element: where
        # the gradient is resolved far above the tolerance above (1% of
        # the tensor's largest entry), the update is determined and the
        # parameters agree; elsewhere it may take either sign
        g = np.abs(grads[n])
        sure = g >= 1e-2 * max(float(g.max()), 1e-3) if g.ndim else True
        np.testing.assert_allclose(np.asarray(got["params"][n])[sure],
                                   np.asarray(p)[sure], atol=1e-5,
                                   rtol=1e-5, err_msg=n)
    return reached


@pytest.fixture(scope="module")
def setup():
    return build_setup()


@pytest.fixture(scope="module")
def one_process(setup, tmp_path_factory):
    """The port in one process: a ret%tvas step saved (nonzero moments),
    the features before a step, a step with and without clipping, and
    the evaluations."""
    _, _, cfg, state, ret, _ = setup
    root = str(tmp_path_factory.mktemp("one"))
    model = w._model(cfg, state)
    from vast_tpu_torch.training.optimizer import build_optimizer
    from vast_tpu_torch.training.step import (create_train_state,
                                              make_train_step)
    opt, _ = build_optimizer(model, RUN_CFG, {}, 20)
    st = create_train_state(model, opt)
    st, _ = make_train_step(model, opt, "ret%tvas")(
        st, w._shard(ret, 0, 1), torch.Generator().manual_seed(0))
    ModelSaver(os.path.join(root, "ckpt_src")).save(st, 1)
    rows = w._shard(ret, 0, 1)

    def feats(m):
        with torch.inference_mode():
            out = m.condition_features(rows, ("tvas",))
        return {k: v.numpy().copy() for k, v in out.items()}

    fresh = w._model(cfg, state)
    clipped = w.train_steps(w._model(cfg, state), [ret], "ret%tvas",
                            CLIP_CFG)
    plain = w.train_steps(w._model(cfg, state), [ret], "ret%tvas", RUN_CFG)
    (ev,) = [w.eval_case(0, 1, cfg, state, eval_clips(), 4,
                         os.path.join(root, "eval"))]
    return {"root": root, "before": feats(fresh), "clipped": clipped,
            "plain": plain, "eval": ev}


def sharded_cases(setup, one, root, dims, flags, steps=("ret", "cap"),
                  extra=("resume", "fused", "norm", "eval")):
    """The cases of one spawn on ``create_mesh(**dims)``."""
    _, _, cfg, state, ret, cap = setup
    runs = {"ret": ("ret%tvas", [ret], RUN_CFG),
            "cap": ("cap%tvas", [cap], RUN_CFG)}
    cases = {"step": ("shard_step_case", (cfg, state, dims, flags,
                                          {k: runs[k] for k in steps}))}
    if "resume" in extra:
        cases["resume"] = ("resume_save_case", (
            cfg, os.path.join(one["root"], "ckpt_src"),
            os.path.join(root, "ckpt_out"), dims, flags, RUN_CFG))
    if "fused" in extra:
        cases["fused"] = ("fused_eval_case", (cfg, state, ret, dims, flags,
                                              "ret%tvas", RUN_CFG))
    if "norm" in extra:
        cases["norm"] = ("norm_case", (cfg, state, ret, dims, flags,
                                       "ret%tvas", CLIP_CFG))
    if "eval" in extra:
        cases["eval"] = ("shard_eval_case", (
            cfg, state, eval_clips(), 4, os.path.join(root, "eval"), dims,
            flags))
    world = dims["dp"] * dims["fsdp"] * dims["tp"]
    return root, w.spawn(world, w.several, root, cases)


@pytest.fixture(scope="module")
def ranks(setup, one_process, tmp_path_factory):
    """(the spawn's directory, each rank's cases)."""
    return sharded_cases(setup, one_process,
                         str(tmp_path_factory.mktemp("fsdp")), DIMS, FLAGS)


@pytest.fixture(scope="module")
def reference(setup):
    jm, params, _, _, ret, cap = setup
    return {k: jax_sharded_step(jm, params, b, t, DIMS, fsdp=True)
            for k, (t, b) in {"ret": ("ret%tvas", ret),
                              "cap": ("cap%tvas", cap)}.items()}


# ------------------------------------------------- checks shared with tp

def check_moments_split(outs, split_any=True):
    """Each moment has its parameter's local shape; some are split."""
    split = 0
    for out in outs:
        for n, (local, mu, nu) in out["step"]["ret"]["shapes"].items():
            assert local == mu == nu, n
            plan = out["step"]["ret"]["plan"][n]
            assert local == plan.local_shape(), n
            split += local != plan.shape
    assert (split > 0) == split_any


def check_resume_and_save(outs, one, out_root):
    """The moments and step restored exactly into the sharded state; the
    files saved from it equal the unsharded save they came from."""
    src = ModelSaver(os.path.join(one["root"], "ckpt_src"))
    saved = torch.load(src.path("optimizer", 1), weights_only=True)
    for out in outs:
        r = out["resume"]
        assert (r["start"], r["step"], r["count"]) == (1, 1, 1)
        mu, nu = saved["optimizer"]["mu"], saved["optimizer"]["nu"]
        assert set(r["mu"]) == set(mu)
        assert any(t.abs().max() > 0 for t in mu.values())
        for n in mu:
            np.testing.assert_array_equal(r["mu"][n], mu[n].numpy(), n)
            np.testing.assert_array_equal(r["nu"][n], nu[n].numpy(), n)
    dst = ModelSaver(out_root)
    assert sorted(os.listdir(dst.ckpt_dir)) == ["model_step_1.pt",
                                                "optimizer_step_1.pt"]
    for kind in ("model", "optimizer"):
        a = torch.load(src.path(kind, 1), weights_only=True)
        b = torch.load(dst.path(kind, 1), weights_only=True)
        if kind == "optimizer":
            assert a["step"] == b["step"]
            assert a["optimizer"]["count"] == b["optimizer"]["count"]
            a, b = (dict(**x["optimizer"]["mu"], **{
                f"nu.{k}": v for k, v in x["optimizer"]["nu"].items()})
                for x in (a, b))
        assert list(a) == list(b)
        for k in a:
            assert a[k].shape == b[k].shape, k
            assert torch.equal(a[k], b[k]), k


def check_fused(outs, one, setup):
    """Evaluate, step, evaluate: the first as an unsharded model, the
    second as an unsharded model holding the parameters the ranks hold
    after their step (a stale fused qkv would keep the first), on the
    rank's rows."""
    _, _, cfg, state, ret, _ = setup
    for out in outs:
        f = out["fused"]
        r, n = f["rows"]
        after = w._model(cfg, state)
        with torch.no_grad():
            for name, p in after.named_parameters():
                p.copy_(torch.from_numpy(f["params_after"][name]))
        rows = w._shard(ret, r, n)
        with torch.inference_mode():
            want_after = after.condition_features(rows, ("tvas",))
        for k, want in one["before"].items():
            part = slice(r * len(want) // n, (r + 1) * len(want) // n)
            np.testing.assert_allclose(f["before"][k], want[part],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(f["before_again"][k],
                                          f["before"][k])
            np.testing.assert_allclose(f["after"][k],
                                       want_after[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            assert np.abs(f["after"][k] - f["before"][k]).max() > 1e-4, k


def check_norm(outs, one):
    """The whole gradient's norm, as one process's unclipped gradient
    has it, and the clipped update."""
    norm = float(global_norm(torch.from_numpy(np.asarray(g)) for g in
                             one["plain"]["grads"].values()
                             if g is not None))
    assert norm > CLIP_CFG["grad_norm"]          # the clip is active
    for out in outs:
        assert len(out["norm"]["norm"]) == 1
        np.testing.assert_allclose(out["norm"]["norm"][0], norm, rtol=1e-5)
        for n, p in one["clipped"]["params"].items():
            np.testing.assert_allclose(out["norm"]["params"][n], p,
                                       atol=1e-5, rtol=1e-5, err_msg=n)


def _cells(score, ids, ids_txt):
    return {(t, c): score[i, j] for i, t in enumerate(ids_txt)
            for j, c in enumerate(ids)}


def check_eval(outs, one):
    """Every R@k and every ITC and rerank score cell of one process (the
    rows in the ranks' order); the captions of one process."""
    ev = one["eval"]
    for out in outs:
        e = out["eval"]
        assert e["ret"] == ev["ret"]
        assert len(e["scores"]) == len(ev["scores"]) == 4
        for (s, ids, txt, d), (s1, ids1, txt1, d1) in zip(e["scores"],
                                                          ev["scores"]):
            assert d == d1 and sorted(ids) == sorted(ids1)
            got, want = _cells(s, ids, txt), _cells(s1, ids1, txt1)
            assert got.keys() == want.keys()
            np.testing.assert_allclose([got[k] for k in want],
                                       list(want.values()), rtol=1e-5,
                                       atol=1e-6)
        assert e["cap"] == ev["cap"]


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("task", ["ret", "cap"])
def test_step_matches_vast_tpu_shard_state(task, ranks, reference):
    """The losses (the ranks' means), every gradient and every parameter
    after the step, gathered whole, equal vast_tpu's on the fsdp mesh,
    on both ranks."""
    outs = [o["step"][task] for o in ranks[1]]
    for out in outs:
        assert check_step(out, reference[task]) > 100


def test_moments_split_with_their_parameters(ranks):
    check_moments_split(ranks[1])


def test_resume_into_sharded_state_and_save_equal_unsharded(ranks,
                                                            one_process):
    root, outs = ranks
    check_resume_and_save(outs, one_process, os.path.join(root, "ckpt_out"))


def test_evaluations_equal_one_process(ranks, one_process):
    check_eval(ranks[1], one_process)


def test_fused_qkv_cache_rebuilt_after_step(ranks, one_process, setup):
    check_fused(ranks[1], one_process, setup)


def test_clipping_by_the_whole_gradient_norm(ranks, one_process):
    check_norm(ranks[1], one_process)
