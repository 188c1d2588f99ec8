"""Tensor parallelism of the CLIP, AST, Swin and VideoSwin towers: gloo
ranks on the CPU on the port's ``create_mesh``, against ``vast_tpu``'s
``combined_param_sharding``, towers and ``shard_state`` step over
conftest's CPU devices, and against one process of the port.

* the plan, parameter by parameter, for each tower (tiny, on tp 2, dp 2
  x tp 2, fsdp 2 x tp 2 and fsdp 2; and at full size on tp 2): split
  over tp on the transposed dim of vast_tpu's, over fsdp where vast_tpu
  splits; AST's q, k and v stay whole under tp. Where the port's module
  rule keeps a module whole that vast_tpu's rule, parameter by parameter,
  splits (heads that do not divide; weights on both sides of
  ``min_size``), the test names each such parameter;
* the packed q/k/v rows and biases of CLIP's ``in_proj`` and Swin's
  ``qkv``: each rank takes its heads from each third;
* each tower's output and every gradient under tp 2 (2 gloo ranks)
  against vast_tpu's tower;
* a whole-model ``ret%tva`` step with CLIP + AST and with VideoSwin +
  BEATs on fsdp 2 x tp 2 (4 ranks): losses, every gradient and the
  parameters after the step against vast_tpu's ``shard_state`` step
  (``min_size=0``), the moments split with their parameters, the saved
  ``.pt`` equal to an unsharded save and a resume into the sharded
  state; ``evaluate_ret`` and ``evaluate_cap`` with CLIP + AST equal to
  one process.

Weights are initialised in JAX from a seed, every parameter nudged with
seeded noise, and carried across with ``from_jax``; fp32 on the CPU, JAX
matmuls at "highest" precision (tests/conftest.py). A tower's forward
is held to 1e-5 of its largest value and a gradient to 1e-4 of its
tensor's largest (tests/test_torch_towers.py); the whole-model steps to
``check_step``'s limits (tests/test_torch_fsdp.py).
"""

import contextlib
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_clip_ast as clip_ast
from tests import test_torch_towers as towers_mod
from tests import torch_dist_workers as w
from tests.helpers import TINY_AST, TINY_CLIP
from tests.test_torch_ddp import RUN_CFG, _global_batch
from tests.test_torch_fsdp import (check_eval, check_moments_split,
                                   check_resume_and_save, check_step,
                                   eval_clips, jax_sharded_step)
from tests.test_torch_models import _init_every_param, _port_cfg
from tests.test_torch_tp import DP_TP, FSDP_TP, POS_CONV, TP
from vast_tpu.models import videoswin as j_videoswin
from vast_tpu.models.ast import AstModel as JaxAst
from vast_tpu.models.clip_vit import ClipVisionTransformer as JaxClip
from vast_tpu.models.swin import SwinTransformer as JaxSwin
from vast_tpu.models.vast import VASTConfig as JaxVASTConfig
from vast_tpu.models.vast import VASTModel as JaxVAST
from vast_tpu.models.videoswin import VideoSwinTransformer as JaxVideoSwin
from vast_tpu.parallel.mesh import combined_param_sharding, create_mesh
from vast_tpu_torch.convert import from_jax as convert
from vast_tpu_torch.convert.from_jax import from_jax, load_numpy_state_dict
from vast_tpu_torch.models import videoswin
from vast_tpu_torch.models.ast import AstConfig, AstModel
from vast_tpu_torch.models.clip_vit import ClipVisionTransformer, ClipVitConfig
from vast_tpu_torch.models.swin import SwinConfig, SwinTransformer
from vast_tpu_torch.models.vast import VASTConfig, VASTModel
from vast_tpu_torch.parallel import mesh as pmesh
from vast_tpu_torch.parallel.tp import TpInfo
from vast_tpu_torch.training.optimizer import build_optimizer
from vast_tpu_torch.training.saver import ModelSaver
from vast_tpu_torch.training.step import create_train_state, make_train_step

FSDP = {"dp": 1, "fsdp": 2, "tp": 1}
MESHES = {"tp2": TP, "dp2tp2": DP_TP, "fsdp2tp2": FSDP_TP, "fsdp2": FSDP}
FLAGS = {"tp": True, "fsdp": True}
FWD_TOL, GRAD_TOL = towers_mod.FWD_TOL, towers_mod.GRAD_TOL


def _clip_map(sd, p):
    convert._clip(sd, "", p)


def _ast_map(sd, p):
    convert._ast(sd, p)


def _swin_map(sd, p):
    convert._swin(sd, "", p)


# tower: (vast_tpu module, its config, the port's module and config
# class, constructor keywords, input shape, from_jax's key mapping)
TOWERS = {
    "clip": (JaxClip, TINY_CLIP, ClipVisionTransformer, ClipVitConfig, {},
             (2, 32, 32, 3), _clip_map),
    "ast": (JaxAst, TINY_AST, AstModel, AstConfig, {},
            (2, TINY_AST.audio_target_length, TINY_AST.audio_melbins),
            _ast_map),
    "swin": (JaxSwin, towers_mod.TINY_SWIN, SwinTransformer, SwinConfig, {},
             (2, 56, 56, 3), _swin_map),
    "videoswin": (JaxVideoSwin, towers_mod.TINY_VIDEOSWIN,
                  videoswin.VideoSwinTransformer, videoswin.VideoSwinConfig,
                  {"frames": 2, "image_size": 64}, (2, 2, 64, 64, 3),
                  _swin_map),
}
# a tp rank's heads of each attention module of a tiny tower at tp 2
TP2_HEADS = {"clip": [2, 2], "ast": [2, 2], "swin": [1, 1, 2, 2],
             "videoswin": [1, 1, 2, 2]}


@pytest.fixture(scope="module")
def towers():
    """{tower: (vast_tpu params, output, gradients of sum(output *
    weights) by the port's names, the port's tower, input, weights)}."""
    out = {}
    for name, (jcls, jc, cls, ccls, kw, shape, mapping) in TOWERS.items():
        rs = np.random.RandomState(11)
        x = rs.randn(*shape).astype(np.float32)
        jm = jcls(jc)
        jit = functools.partial(towers_mod._jit, name)
        params = towers_mod._nudged(jit(jm.init)(
            jax.random.PRNGKey(3), jnp.asarray(x))["params"], rs)
        y = np.asarray(jit(jm.apply)({"params": params}, jnp.asarray(x)))
        wts = rs.randn(*y.shape).astype(np.float32)
        grads = jit(jax.grad(lambda p: (jm.apply(
            {"params": p}, jnp.asarray(x)) * wts).sum()))(params)
        gd, sd = {}, {}
        mapping(gd, jax.tree.map(np.asarray, grads))
        mapping(sd, params)
        pm = cls(_port_cfg(ccls, jc), "cpu", **kw)
        load_numpy_state_dict(pm, sd)
        out[name] = (params, y, gd, pm, x, wts)
    return out


# ----------------------------------------------------------------- plan

def _axis_dims(shapes, sharding, mapping, axis):
    """{port name: the dim that ``sharding`` puts on ``axis``, in torch's
    layout, or None}: each leaf marked by a (1 or 2, ...) array, 2 on the
    axis's dim, carried through ``mapping`` (which only transposes)."""
    def mark(p, sh):
        spec = tuple(sh.spec) + (None,) * (len(p.shape) - len(sh.spec))
        return np.zeros([2 if s == axis or (isinstance(s, tuple)
                                            and axis in s) else 1
                         for s in spec], np.int8)
    out = {}
    mapping(out, jax.tree.map(mark, shapes, sharding))
    return {n: next((d for d, k in enumerate(m.shape) if k == 2), None)
            for n, m in out.items()}


def plan_disagreements(shapes, mapping, model, dims, min_size):
    """(the port's plan, {parameter: ((tp dim, fsdp split), vast_tpu's)}
    wherever they differ) on ``dims``; every local shape is its split's."""
    n = dims["dp"] * dims["fsdp"] * dims["tp"]
    mesh = create_mesh(devices=jax.devices()[:n], **dims)
    want = combined_param_sharding(mesh, shapes, min_size=min_size)
    tp_dims = _axis_dims(shapes, want, mapping, "tp")
    fsdp_dims = _axis_dims(shapes, want, mapping, "fsdp")
    plan = pmesh.combined_param_sharding(dims, model, min_size=min_size)
    assert set(plan) == set(tp_dims)
    differ = {}
    for name, p in plan.items():
        got = (p.tp_dim, p.fsdp_dim is not None)
        exp = (tp_dims[name], fsdp_dims[name] is not None)
        if got != exp:
            differ[name] = (got, exp)
        full = torch.zeros(p.shape, device="meta")
        assert p.local_shape() == p.split(full, 0, 0).shape, name
    return plan, differ


AST_QKV = tuple(f"audio_encoder.layer.{i}.attention.linears.{j}.{p}"
                for i in range(2) for j in range(3) for p in ("weight",
                                                              "bias"))


@pytest.mark.parametrize("min_size", [0, None], ids=["min0", "default"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(TOWERS))
def test_plan_matches_combined_param_sharding(name, mesh, min_size, towers):
    """Parameter by parameter: split over tp on the transposed dim of
    vast_tpu's, split over fsdp where vast_tpu splits, whole where it
    keeps it whole; on fsdp alone every tower splits (at min_size 0)."""
    params, _, _, model, _, _ = towers[name]
    dims = MESHES[mesh]
    plan, differ = plan_disagreements(params, TOWERS[name][6], model, dims,
                                      min_size)
    assert differ == {}
    split_tp = sum(p.tp_dim is not None for p in plan.values())
    split_fsdp = sum(p.fsdp_dim is not None for p in plan.values())
    if min_size is None:                  # every tiny tensor < 16384
        assert split_tp == split_fsdp == 0
        return
    assert (split_tp > 0) == (dims["tp"] > 1)
    assert (split_fsdp > 0) == (dims["fsdp"] > 1)
    if name == "ast":
        for n in AST_QKV:
            assert plan[n].tp_dim is None, n
            assert plan[n].tp_partial == (dims["tp"] > 1), n
        if dims["fsdp"] > 1:                  # whole over tp, fsdp-split
            assert plan[AST_QKV[0]].fsdp_dim is not None


def _full_size(vtype, audio=False):
    """(vast_tpu's parameter shapes, the port's tower on the meta device,
    from_jax's mapping) of a preset at full size."""
    kw = {"vision_resolution": 336} if vtype.startswith("clip") else {}
    jcfg, cfg = (JaxVASTConfig(vision_encoder_type=vtype,
                               audio_encoder_type="ast", **kw),
                 VASTConfig(vision_encoder_type=vtype,
                            audio_encoder_type="ast", **kw))
    if audio:
        jc, pc = jcfg.resolved_audio_cfg(), cfg.resolved_audio_cfg()
        x = jnp.zeros((1, jc.audio_target_length, jc.audio_melbins))
        return (jax.eval_shape(JaxAst(jc).init, jax.random.PRNGKey(0),
                               x)["params"], AstModel(pc, "meta"), _ast_map)
    jc, pc = jcfg.resolved_vision_cfg(), cfg.resolved_vision_cfg()
    if vtype.startswith("clip"):
        jm, pm, mapping = JaxClip(jc), ClipVisionTransformer(pc, "meta"), \
            _clip_map
        x = jnp.zeros((1, 336, 336, 3))
    elif vtype == "videoswin":
        jm, mapping = JaxVideoSwin(jc), _swin_map
        pm = videoswin.VideoSwinTransformer(pc, "meta", frames=8,
                                            image_size=224)
        x = jnp.zeros((1, 8, 224, 224, 3))
    else:
        jm, pm, mapping = JaxSwin(jc), SwinTransformer(pc, "meta"), _swin_map
        x = jnp.zeros((1, 224, 224, 3))
    return (jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"],
            pm, mapping)


@pytest.fixture
def traceable_videoswin(monkeypatch):
    """vast_tpu's VideoSwin builds its shift masks with numpy from jnp
    values, which ``eval_shape`` cannot trace; the masks do not shape a
    parameter, so the port's numpy masks stand in for the trace."""
    monkeypatch.setattr(j_videoswin, "shift_mask_3d",
                        videoswin.shift_mask_3d)


@pytest.mark.parametrize("tower", ["clip_vit_large_14_336px", "ast",
                                   "swin_base_22k_224", "swin_large_22k_224",
                                   "videoswin"])
def test_full_size_plan_on_tp2_matches(tower, traceable_videoswin):
    """The released sizes at the default ``min_size`` on tp 2: the plan
    equals vast_tpu's parameter by parameter; every attention and MLP
    splits (AST's q, k and v stay whole, used in part)."""
    shapes, model, mapping = (_full_size("clip_vit_base_16", audio=True)
                              if tower == "ast" else _full_size(tower))
    plan, differ = plan_disagreements(shapes, mapping, model, TP, None)
    assert differ == {}
    tp_mods = [m for m in model.modules() if hasattr(m, "tp_linears")]
    assert tp_mods and len(pmesh.tp_modules(
        model, 2, pmesh.MIN_SHARD_SIZE)) == len(tp_mods)
    if tower == "ast":
        qkv = [n for n in plan if ".attention.linears.0." in n]
        assert qkv and all(plan[n].tp_partial and plan[n].tp_dim is None
                           for n in qkv)


# (case: tower config, vast_tpu module, mesh, min_size, the parameters
# whose plan differs, as (port's, vast_tpu's) (tp dim, fsdp split))
def _stage0_attn(blocks, what):
    return {f"layers.0.blocks.{b}.attn.{n}.weight": what[n]
            for b in range(blocks) for n in what}


DIFFER = {
    # 2 heads at tp 4: the port keeps the attention whole, vast_tpu
    # splits its kernels (48 and 16 columns divide by 4)
    "swin_tp4": ("swin", {"dp": 1, "fsdp": 1, "tp": 4}, 0, _stage0_attn(
        2, {"qkv": ((None, False), (0, False)),
            "proj": ((None, False), (1, False))})),
    "videoswin_tp4": ("videoswin", {"dp": 1, "fsdp": 1, "tp": 4}, 0,
                      _stage0_attn(2, {"qkv": ((None, False), (0, False)),
                                       "proj": ((None, False), (1, False))})),
    # min_size 512 between stage 0's proj (256) and qkv (768): vast_tpu
    # splits qkv alone, the port keeps the module whole
    "swin_straddle": ("swin", TP, 512, _stage0_attn(
        2, {"qkv": ((None, False), (0, False))})),
}


@pytest.mark.parametrize("case", list(DIFFER))
def test_plan_differs_where_a_module_stays_whole(case, towers):
    """The port splits a module whole or not at all: where its heads do
    not divide by tp, or its weights lie on both sides of ``min_size``,
    it stays whole on every tp rank. vast_tpu's rule, parameter by
    parameter, splits those weights that divide and are large enough:
    these are the only parameters on which the plans differ."""
    name, dims, min_size, want = DIFFER[case]
    params, _, _, model, _, _ = towers[name]
    _, differ = plan_disagreements(params, TOWERS[name][6], model, dims,
                                   min_size)
    assert differ == want


def test_swin_large_first_stage_stays_whole_at_tp4(traceable_videoswin):
    """Swin-L's first stage has 6 heads: at tp 4 its attention stays
    whole in the port, where vast_tpu splits its qkv (576 columns) and
    proj (192 rows); every other module splits in both."""
    shapes, model, mapping = _full_size("swin_large_22k_224")
    _, differ = plan_disagreements(shapes, mapping, model,
                                   {"dp": 1, "fsdp": 1, "tp": 4}, None)
    assert differ == _stage0_attn(2, {"qkv": ((None, False), (0, False)),
                                      "proj": ((None, False), (1, False))})


@pytest.mark.parametrize("name,weight,bias", [
    ("clip", "transformer.resblocks.0.attn.in_proj_weight",
     "transformer.resblocks.0.attn.in_proj_bias"),
    ("swin", "layers.1.blocks.0.attn.qkv.weight",
     "layers.1.blocks.0.attn.qkv.bias"),
    ("videoswin", "layers.1.blocks.1.attn.qkv.weight",
     "layers.1.blocks.1.attn.qkv.bias")])
def test_packed_qkv_takes_each_rank_heads_from_each_third(name, weight,
                                                          bias, towers):
    """Rank t's rows of the packed weight and of its bias: its heads'
    rows of q, of k and of v (a contiguous block of the bias would give
    rank 0 all of q's and half of k's)."""
    model = towers[name][3]
    plan = pmesh.combined_param_sharding(TP, model, min_size=0)
    p, pb = plan[weight], plan[bias]
    assert (p.tp_dim, p.tp_groups) == (0, 3)
    assert pb.whole and pb.tp_partial
    full = model.get_parameter(weight).detach()
    b = model.get_parameter(bias).detach()
    c = full.shape[0] // 3
    for t in range(2):
        rows = torch.cat([torch.arange(g * c + t * c // 2,
                                       g * c + (t + 1) * c // 2)
                          for g in range(3)])
        assert torch.equal(p.split(full, t, 0), full[rows])
        tp = TpInfo(None, t, 2)
        assert torch.equal(tp.part(b, 3), b[rows])
        assert not torch.equal(tp.part(b), b[rows])


# ---------------------------------------------------------------- towers

@pytest.fixture(scope="module")
def tower_ranks(towers, tmp_path_factory):
    args = {}
    for name, (_, jc, cls, ccls, kw, _, _) in TOWERS.items():
        _, _, _, pm, x, wts = towers[name]
        args[name] = (cls.__module__, cls.__name__, _port_cfg(ccls, jc), kw,
                      pm.state_dict(), x, wts)
    return w.spawn(2, w.towers_tp_case, tmp_path_factory.mktemp("towers"),
                   args, TP)


@pytest.mark.parametrize("name", list(TOWERS))
def test_tower_under_tp_matches_vast_tpu(name, towers, tower_ranks):
    """Each rank's output (the row-parallel sums) and every whole
    gradient, the tp-partial ones summed over the ranks, as vast_tpu's
    tower; each attention on its tp heads."""
    _, want_out, want_grads, _, _, _ = towers[name]
    for rank in tower_ranks:
        out = rank[name]
        np.testing.assert_allclose(out["out"], want_out, rtol=0,
                                   atol=FWD_TOL * np.abs(want_out).max())
        assert out["heads"] == TP2_HEADS[name]
        reached = 0
        for n, g in want_grads.items():
            got = out["grads"][n]
            if got is None:
                assert not g.any(), n
                continue
            reached += 1
            if n.endswith(clip_ast.KEY_BIASES):
                # softmax ignores a bias added to every key alike: the
                # exact gradient is 0 and each side reads rounding noise,
                # held under 1e-5 of the layer's query bias gradient
                q = want_grads[n.replace("linears.1", "linears.0")]
                noise = 1e-5 * float(np.abs(q).max())
                assert np.abs(g).max() <= noise, n
                assert np.abs(got).max() <= noise, n
                continue
            scale = max(float(np.abs(g).max()), 1e-3)
            np.testing.assert_allclose(got, g, rtol=0,
                                       atol=GRAD_TOL * scale, err_msg=n)
        assert reached == len(want_grads)
        assert out["split"] and out["partial"]
        if name == "ast":
            assert not set(out["split"]) & set(AST_QKV)
            assert set(out["partial"]) >= set(AST_QKV)


# --------------------------------------------------------- whole models

# model: (vast_tpu's config, the port's config of it, whether vast_tpu's
# trace must compute its constants (VideoSwin's numpy shift masks))
MODELS = {
    "clip_ast": (lambda: clip_ast.jax_config("plain_route"),
                 clip_ast.port_config, False),
    "videoswin_beats": (lambda: towers_mod._jax_vast_config("videoswin"),
                        lambda j: towers_mod._port_vast_config(
                            j, "videoswin"), True),
}


def _model_setup(name):
    """(jax model, params, port config, port state dict, ret batch of 6
    clips with injected negatives)."""
    jcfg_fn, port_fn, const = MODELS[name]
    jcfg = jcfg_fn()
    rs = np.random.RandomState(31)
    ret = _global_batch(rs)
    jm = JaxVAST(jcfg)

    def init(key, b):
        with (jax.ensure_compile_time_eval() if const
              else contextlib.nullcontext()):
            return jm.init(key, b, method=_init_every_param)
    params = jax.jit(init)(
        jax.random.PRNGKey(31), {k: jnp.asarray(v) for k, v in ret.items()}
    )["params"]
    params = towers_mod._nudged(params, rs)
    cfg = port_fn(jcfg)
    pm = VASTModel(cfg, device="cpu")
    load_numpy_state_dict(pm, from_jax(params))
    return jm, params, cfg, pm.state_dict(), ret


@pytest.fixture(scope="module")
def models():
    return {name: _model_setup(name) for name in MODELS}


def _one_process(cfg, state, ret, root, evaluate):
    """A ret%tva step saved (nonzero moments) and, with ``evaluate``, the
    evaluations of one process."""
    model = w._model(cfg, state)
    opt, _ = build_optimizer(model, RUN_CFG, {}, 20)
    st, _ = make_train_step(model, opt, "ret%tva")(
        create_train_state(model, opt), w._shard(ret, 0, 1),
        torch.Generator().manual_seed(0))
    ModelSaver(os.path.join(root, "ckpt_src")).save(st, 1)
    one = {"root": root}
    if evaluate:
        one["eval"] = w.eval_case(0, 1, cfg, state, eval_clips(), 4,
                                  os.path.join(root, "eval"))
    return one


@pytest.fixture(scope="module")
def model_ranks(models, tmp_path_factory):
    """({model: one process}, each of 4 ranks' cases on fsdp 2 x tp 2)."""
    root = str(tmp_path_factory.mktemp("models"))
    ones, cases = {}, {}
    for name, (_, _, cfg, state, ret) in models.items():
        sub = os.path.join(root, name)
        ones[name] = _one_process(cfg, state, ret, sub, name == "clip_ast")
        cases[f"{name}.step"] = ("shard_step_case", (
            cfg, state, FSDP_TP, FLAGS, {"ret": ("ret%tva", [ret],
                                                 RUN_CFG)}))
        cases[f"{name}.resume"] = ("resume_save_case", (
            cfg, os.path.join(sub, "ckpt_src"),
            os.path.join(sub, "ckpt_out"), FSDP_TP, FLAGS, RUN_CFG))
    _, _, cfg, state, _ = models["clip_ast"]
    cases["clip_ast.eval"] = ("shard_eval_case", (
        cfg, state, eval_clips(), 4, os.path.join(root, "eval"), FSDP_TP,
        FLAGS))
    return ones, w.spawn(4, w.several, root, cases)


def _rank_cases(outs, name):
    return [{k.split(".", 1)[1]: v for k, v in o.items()
             if k.startswith(f"{name}.")} for o in outs]


def _reference(models, name):
    """vast_tpu's step on fsdp 2 x tp 2 (4 of conftest's devices). With
    BEATs, its positional-conv gradient and update come out twice their
    value there (ROADMAP.md section 3): those two are checked to be twice
    the 2-device tp step's and replaced by it."""
    jm, params, _, _, ret = models[name]
    const = MODELS[name][2]
    losses, grads, new = jax_sharded_step(jm, params, ret, "ret%tva",
                                          FSDP_TP, fsdp=True, tp=True,
                                          eval_constants=const)
    if name == "videoswin_beats":
        _, grads2, new2 = jax_sharded_step(jm, params, ret, "ret%tva", TP,
                                           tp=True, eval_constants=const)
        grads, new = dict(grads), dict(new)
        for n in POS_CONV:
            scale = float(np.abs(grads2[n]).max())
            np.testing.assert_allclose(grads[n], 2 * grads2[n], rtol=1e-4,
                                       atol=2e-5 * scale, err_msg=n)
            grads[n], new[n] = grads2[n], new2[n]
    return losses, grads, new


@pytest.mark.parametrize("name", list(MODELS))
def test_fsdp_tp_step_matches_vast_tpu(name, models, model_ranks):
    """Losses (the ranks' means), every gradient and every parameter
    after the step, gathered whole, on every rank."""
    want = _reference(models, name)
    n_params = len(want[1])
    for out in _rank_cases(model_ranks[1], name):
        assert check_step(out["step"]["ret"], want) > n_params // 2


@pytest.mark.parametrize("name", list(MODELS))
def test_moments_split_with_their_parameters(name, model_ranks):
    """Each rank's parameters and moments have the plan's local shapes,
    so their bytes are the plan's."""
    outs = _rank_cases(model_ranks[1], name)
    check_moments_split(outs)
    plan = outs[0]["step"]["ret"]["plan"]
    heads = {n for n, p in plan.items() if p.tp_dim is not None}
    if name == "clip_ast":
        assert "vision_encoder.visual.transformer.resblocks.0.attn." \
               "in_proj_weight" in heads
        assert plan["vision_encoder.visual.transformer.resblocks.0.attn."
                    "in_proj_weight"].tp_groups == 3
    else:
        assert "vision_encoder.layers.0.blocks.0.attn.qkv.weight" in heads
    # the local shapes' elements, summed over the ranks, count every
    # split tensor once a replica (dp 1): tp x fsdp parts of the whole
    for n, p in plan.items():
        parts = ((p.tp if p.tp_dim is not None else 1)
                 * (p.fsdp if p.fsdp_dim is not None else 1))
        assert math.prod(p.local_shape()) * parts == math.prod(p.shape), n


@pytest.mark.parametrize("name", list(MODELS))
def test_resume_into_sharded_state_and_save_equal_unsharded(name,
                                                            model_ranks):
    """The packed q/k/v weights written back in reference row order."""
    ones, outs = model_ranks
    check_resume_and_save(_rank_cases(outs, name), ones[name],
                          os.path.join(ones[name]["root"], "ckpt_out"))


def test_clip_ast_evaluations_equal_one_process(model_ranks):
    ones, outs = model_ranks
    check_eval(_rank_cases(outs, "clip_ast"), ones["clip_ast"])

