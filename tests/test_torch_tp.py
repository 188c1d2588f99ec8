"""Tensor parallelism (and tp with fsdp): gloo ranks on the CPU on the
port's ``create_mesh(dp=1, tp=2)``, ``(dp=2, tp=2)`` and ``(dp=1, fsdp=2,
tp=2)``, against ``vast_tpu``'s ``shard_state`` and train step on the
same meshes over conftest's CPU devices, and against one process of the
port. Weights, batches and tolerances as ``tests/test_torch_fsdp.py``
(``min_size=0`` on both sides).

* the plan: which parameter is split over tp (and on which dim, in
  torch's layout) and which over fsdp, parameter by parameter, against
  ``vast_tpu``'s ``combined_param_sharding`` (the CLIP, AST, Swin and
  VideoSwin towers: tests/test_torch_tp_towers.py);
* ``ret%tvas`` and ``cap%tvas`` on each mesh: losses, every gradient and
  the parameters after the step, against vast_tpu's;
* EVA02 with rope, SwiGLU and its sub-LayerNorms split over tp: the
  tower's output and every gradient against vast_tpu's tower;
* evaluations, ``FusedCache``, the moments, the resume and the saved
  files, and clipping by the whole norm, as in the fsdp tests.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_workers as w
from tests.helpers import make_synth_dataset, make_task_config
from tests.test_torch_fsdp import (build_setup, check_eval, check_fused,
                                   check_moments_split, check_norm,
                                   check_resume_and_save, check_step,
                                   jax_sharded_step, one_process,  # noqa
                                   setup, sharded_cases)  # noqa: F401
from tests.test_torch_models import _port_cfg
from vast_tpu.models import eva_vit as j_eva
from vast_tpu.parallel.mesh import combined_param_sharding, create_mesh
from vast_tpu_torch.convert import from_jax as convert
from vast_tpu_torch.convert.from_jax import from_jax
from vast_tpu_torch.models import eva_vit
from vast_tpu_torch.parallel import mesh as pmesh

TP = {"dp": 1, "fsdp": 1, "tp": 2}
DP_TP = {"dp": 2, "fsdp": 1, "tp": 2}
FSDP_TP = {"dp": 1, "fsdp": 2, "tp": 2}

# EVA02 with an MLP hidden size that divides (32 x 2.0): its SwiGLU and
# its ffn_ln split too
TINY_EVA02_TP = j_eva.EvaVitConfig(
    image_size=32, patch_size=8, width=32, layers=2, head_width=8,
    mlp_ratio=2.0, subln=True, swiglu=True, rope=True, intp_freq=True,
    pt_hw_seq_len=16)


# ----------------------------------------------------------------- plan

def _markers(params, sharding, axis):
    """A tree like ``params`` whose leaves vary along the dim that
    ``sharding`` puts on ``axis`` (1, 2, ...) and are 0 elsewhere."""
    def mark(p, sh):
        p = np.asarray(p)
        spec = tuple(sh.spec) + (None,) * (p.ndim - len(sh.spec))
        out = np.zeros(p.shape, np.float32)
        for d, s in enumerate(spec):
            if s == axis or (isinstance(s, tuple) and axis in s):
                shape = [1] * p.ndim
                shape[d] = p.shape[d]
                out = out + np.arange(1, p.shape[d] + 1).reshape(shape)
        return out
    return jax.tree.map(mark, params, sharding)


def _varying_dim(a):
    """The dim along which ``a`` varies, None where it does not."""
    a = np.asarray(a)
    if not a.any():
        return None
    dims = [d for d in range(a.ndim) if np.ptp(a, axis=d).any()]
    assert len(dims) == 1, dims
    return dims[0]


@pytest.fixture(scope="module")
def tiny():
    """(vast_tpu params, the port's model) of the tiny config."""
    jm, params, cfg, state, _, _ = build_setup()
    return params, w._model(cfg, state)


@pytest.mark.parametrize("min_size", [0, None], ids=["min0", "default"])
@pytest.mark.parametrize("dims", [TP, DP_TP, FSDP_TP,
                                  {"dp": 2, "fsdp": 2, "tp": 1}],
                         ids=["tp2", "dp2tp2", "fsdp2tp2", "dp2fsdp2"])
def test_plan_matches_combined_param_sharding(dims, min_size, tiny):
    """Parameter by parameter: split over tp on the transposed dim of
    vast_tpu's, split over fsdp where vast_tpu splits, whole where it
    keeps it whole."""
    params, model = tiny
    n = dims["dp"] * dims["fsdp"] * dims["tp"]
    mesh = create_mesh(devices=jax.devices()[:n], **dims)
    want = combined_param_sharding(mesh, params, min_size=min_size)
    tp_dims = from_jax(_markers(params, want, "tp"))
    fsdp_dims = from_jax(_markers(params, want, "fsdp"))
    plan = pmesh.combined_param_sharding(dims, model, min_size=min_size)
    assert set(plan) == set(tp_dims)
    for name, p in plan.items():
        assert p.tp_dim == _varying_dim(tp_dims[name]), name
        assert (p.fsdp_dim is None) == (
            _varying_dim(fsdp_dims[name]) is None), name
        assert p.local_shape() == p.split(torch.zeros(p.shape), 0,
                                          0).shape, name
    split_tp = sum(p.tp_dim is not None for p in plan.values())
    split_fsdp = sum(p.fsdp_dim is not None for p in plan.values())
    if min_size == 0:
        assert split_tp == (40 if dims["tp"] > 1 else 0)
        assert (split_fsdp > 100) == (dims["fsdp"] > 1)
    else:
        assert split_tp == split_fsdp == 0     # every tiny tensor < 16384


def test_eva01_qkv_rows_take_each_rank_heads_from_each_third():
    """The fused qkv's rank-t rows: its heads' rows of q, of k, of v."""
    plan = pmesh.ParamPlan(shape=(3 * 4 * 8, 32), tp_dim=0, tp=2,
                           tp_groups=3)
    rows = [plan.tp_index(t) for t in range(2)]
    assert rows[0].tolist() == (list(range(0, 16)) + list(range(32, 48))
                                + list(range(64, 80)))
    assert sorted(np.concatenate(rows).tolist()) == list(range(96))


# ------------------------------------------------------------------ steps

@pytest.fixture(scope="module")
def tp_ranks(setup, one_process, tmp_path_factory):
    """dp=1 x tp=2: the steps, the evaluations, FusedCache, EVA02."""
    return sharded_cases(setup, one_process,
                         str(tmp_path_factory.mktemp("tp")), TP,
                         {"tp": True}, extra=("fused", "eval"))


@pytest.fixture(scope="module")
def dp_tp_ranks(setup, one_process, tmp_path_factory):
    """dp=2 x tp=2: the steps, the resume and the saved files."""
    return sharded_cases(setup, one_process,
                         str(tmp_path_factory.mktemp("dptp")), DP_TP,
                         {"tp": True}, extra=("resume",))


@pytest.fixture(scope="module")
def fsdp_tp_ranks(setup, one_process, tmp_path_factory):
    """fsdp=2 x tp=2: the ret step, the resume and saved files, the
    clipping."""
    return sharded_cases(setup, one_process,
                         str(tmp_path_factory.mktemp("fsdptp")), FSDP_TP,
                         {"tp": True, "fsdp": True}, steps=("ret",),
                         extra=("resume", "norm"))


# vast_tpu's fault on a mesh of 4 of conftest's CPU devices (the batch
# over 2, tp 2): the gradient of BEATs' weight-normed positional conv
# comes out twice its value on one device, replicated or split alike
# (ROADMAP.md section 3); those two are held against vast_tpu's step on
# the 2-device tp mesh, which agrees with one device
POS_CONV = ("audio_encoder.encoder.pos_conv.0.weight_v",
            "audio_encoder.encoder.pos_conv.0.weight_g")


@pytest.fixture(scope="module")
def reference(setup):
    """vast_tpu's step per (mesh, task), computed once."""
    jm, params, _, _, ret, cap = setup
    batches = {"ret": ("ret%tvas", ret), "cap": ("cap%tvas", cap)}
    cache = {}

    def get(name, dims, task, fsdp=False):
        if (name, task) not in cache:
            t, b = batches[task]
            cache[name, task] = jax_sharded_step(jm, params, b, t, dims,
                                                 fsdp=fsdp, tp=True)
        return cache[name, task]
    return get


def _four_devices(reference, name, dims, task, fsdp=False):
    """vast_tpu's step on a 4-device mesh, its positional-conv gradient
    and update replaced by the 2-device tp mesh's, after checking that
    they are twice those."""
    losses, grads, params = reference(name, dims, task, fsdp)
    _, grads2, params2 = reference("tp2", TP, task)
    grads, params = dict(grads), dict(params)
    for n in POS_CONV:
        scale = float(np.abs(grads2[n]).max())
        np.testing.assert_allclose(grads[n], 2 * grads2[n], rtol=1e-4,
                                   atol=2e-5 * scale, err_msg=n)
        grads[n], params[n] = grads2[n], params2[n]
    return losses, grads, params


@pytest.mark.parametrize("task", ["ret", "cap"])
def test_tp_step_matches_vast_tpu(task, reference, tp_ranks):
    want = reference("tp2", TP, task)
    for out in tp_ranks[1]:
        assert check_step(out["step"][task], want) > 100


@pytest.mark.parametrize("task", ["ret", "cap"])
def test_dp_tp_step_matches_vast_tpu(task, reference, dp_tp_ranks):
    want = _four_devices(reference, "dp2tp2", DP_TP, task)
    for out in dp_tp_ranks[1]:
        assert check_step(out["step"][task], want) > 100


def test_fsdp_tp_step_matches_vast_tpu(reference, fsdp_tp_ranks):
    want = _four_devices(reference, "fsdp2tp2", FSDP_TP, "ret", fsdp=True)
    for out in fsdp_tp_ranks[1]:
        assert check_step(out["step"]["ret"], want) > 100


@pytest.mark.parametrize("mesh", ["tp2", "dp2tp2", "fsdp2tp2"])
def test_moments_split_with_their_parameters(mesh, tp_ranks, dp_tp_ranks,
                                             fsdp_tp_ranks):
    outs = {"tp2": tp_ranks, "dp2tp2": dp_tp_ranks,
            "fsdp2tp2": fsdp_tp_ranks}[mesh][1]
    check_moments_split(outs)


@pytest.mark.parametrize("mesh", ["dp2tp2", "fsdp2tp2"])
def test_resume_into_sharded_state_and_save_equal_unsharded(
        mesh, dp_tp_ranks, fsdp_tp_ranks, one_process):
    """EVA01's fused qkv written back in reference row order."""
    root, outs = {"dp2tp2": dp_tp_ranks, "fsdp2tp2": fsdp_tp_ranks}[mesh]
    check_resume_and_save(outs, one_process, os.path.join(root, "ckpt_out"))


def test_evaluations_equal_one_process(tp_ranks, one_process):
    check_eval(tp_ranks[1], one_process)


def test_fused_qkv_cache_of_local_heads(tp_ranks, one_process, setup):
    check_fused(tp_ranks[1], one_process, setup)


def test_clipping_by_the_whole_gradient_norm(fsdp_tp_ranks, one_process):
    check_norm(fsdp_tp_ranks[1], one_process)


# ---------------------------------------------------------------- EVA02

@pytest.fixture(scope="module")
def eva02():
    """(vast_tpu's output and gradients of sum(out * weights), the port's
    tower config, state dict, pixels and weights)."""
    rs = np.random.RandomState(11)
    px = rs.randn(2, 32, 32, 3).astype(np.float32)
    jm = j_eva.EvaVisionTransformer(TINY_EVA02_TP)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3),
                              jnp.asarray(px))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.02) * np.asarray(
            rs.randn(*np.shape(p)), np.float32), params)
    x = jnp.asarray(px)
    out = np.asarray(jm.apply({"params": params}, x))
    wts = rs.randn(*out.shape).astype(np.float32)
    grads = jax.jit(jax.grad(
        lambda p: (jm.apply({"params": p}, x) * wts).sum()))(params)
    sd, gd = {}, {}
    convert._eva(sd, "", params)
    convert._eva(gd, "", jax.tree.map(np.asarray, grads))
    cfg = _port_cfg(eva_vit.EvaVitConfig, TINY_EVA02_TP)
    return (out, gd, cfg,
            {k: torch.from_numpy(v) for k, v in sd.items()}, px, wts)


def test_eva02_sub_layernorms_under_tp(eva02, tmp_path):
    """rope, q/k/v split by heads, inner_attn_ln and the SwiGLU's ffn_ln
    over split channels: output and every gradient as vast_tpu's."""
    want_out, want_grads, cfg, state, px, wts = eva02
    outs = w.spawn(2, w.towers_tp_case, tmp_path, {"eva02": (
        eva_vit.__name__, "EvaVisionTransformer", cfg, {}, state, px, wts)},
        TP)
    for out in (rank["eva02"] for rank in outs):
        np.testing.assert_allclose(out["out"], want_out, rtol=0,
                                   atol=1e-5 * np.abs(want_out).max())
        assert "blocks.0.mlp.w1.weight" in out["split"]
        assert "blocks.0.attn.q_proj.weight" in out["split"]
        assert "blocks.0.mlp.ffn_ln.weight" in out["partial"]
        assert "blocks.0.attn.inner_attn_ln.bias" in out["partial"]
        for n, g in want_grads.items():
            scale = max(float(np.abs(g).max()), 1e-3)
            np.testing.assert_allclose(out["grads"][n], g, rtol=0,
                                       atol=1e-4 * scale, err_msg=n)


# ------------------------------------------------------------ the pipeline

@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    """16 synthetic clips with subtitles, the ret%tvas task config with
    ``run_cfg.fsdp`` and ``tp`` set; ``pipeline.train(mesh=...)`` on fsdp 2
    x tp 2, 2 steps."""
    root = str(tmp_path_factory.mktemp("pipeline"))
    anno, annfile = make_synth_dataset(root, n=16)
    with open(anno) as f:
        annos = json.load(f)
    for i, a in enumerate(annos):
        a["subtitle"] = f"a man talks {i} times in the red car"
    with open(anno, "w") as f:
        json.dump(annos, f)
    cfg = make_task_config(root, anno, annfile, task="ret%tvas", steps=2)
    with open(cfg) as f:
        task = json.load(f)
    task["run_cfg"] |= {"fsdp": True, "tp": True}
    with open(cfg, "w") as f:
        json.dump(task, f)
    out = os.path.join(root, "out")
    return w.spawn(4, w.pipeline_mesh_case, root, cfg, out, FSDP_TP)


def test_pipeline_train_on_a_mesh_saves_what_one_process_loads(
        pipeline_run):
    """``train(mesh=create_mesh(dp=1, fsdp=2, tp=2))``: the state split
    by run_cfg's flags, one evaluation and one save; the saved file holds
    the ranks' whole tensors under every reference name and loads into an
    unsharded model with no key missing or unexpected; ``test`` of it
    unsharded on the same mesh gives the sharded evaluation's R@k."""
    r0 = pipeline_run[0]
    steps = r0["steps"]
    assert r0["files"] == [f"model_step_{steps}.pt",
                           f"optimizer_step_{steps}.pt"]
    assert r0["keys_equal"] and r0["differs"] == []
    for r in pipeline_run:
        assert r["sharded"] and r["split"] > 100
        assert r["reload"] == ([], [])
        assert r["logged"] == r0["logged"]
        key = next(iter(r["tested"]))
        at_step = {name[len(key) + 1:]: hist[str(steps)]
                   for name, hist in r["logged"].items()}
        assert set(at_step) == {"ret_itc_tvas", "ret_itm_tvas"}
        assert r["tested"][key] == at_step
