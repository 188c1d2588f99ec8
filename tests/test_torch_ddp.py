"""Data-parallel training and evaluation of the port: 2 and 3 gloo ranks
on the CPU against ``vast_tpu`` on the global batch, and against one
process of the port.

Same weights on every side (a tiny vast_tpu model initialised in JAX
from a seed, every parameter nudged, carried across with ``from_jax``),
the same numpy global batch of 6 clips with a subtitle, each rank given
its rows (``tests/torch_dist_workers.py``: spawned ranks, a ``file://``
rendezvous under the test's tmp dir). No draw is random: the ITM
negatives are injected as the global (1, 6) indices, each rank its
columns; the caption's masks are injected with unequal masked counts on
every rank. In fp32; the tolerances of ``tests/test_torch_train_step.py``
(losses rtol 2e-5; gradients atol 2e-5 x each tensor's largest entry,
rtol 1e-4).

* ``ret%tvas``: the ranks' mean losses and DDP's averaged gradients
  against ``jax.value_and_grad`` of vast_tpu's model on the global batch
  sharded over ``create_mesh(dp=2)`` (two of conftest's CPU devices);
* ``cap%tvas`` likewise, each rank with its own count of masked tokens;
* three steps at ``gradient_accumulation_steps: 2`` against one process;
* ``evaluate_ret`` over 10 clips (ragged shards, a ``padded_tail``) and
  ``evaluate_cap``, against one process;
* ``MetaLoader``'s task draw, equal on every rank;
* the CLI under 2 ranks: rank 0 alone writes the checkpoint, ``--mode
  testing`` gives one process's R@k;
* no fallback: NCCL with two ranks on one card raises, a process told
  ``WORLD_SIZE=2`` with no group raises;
* the CLI's ``fsdp`` / ``tp`` flags under its dp-only mesh split nothing
  (as in vast_tpu: parameter sharding is ``pipeline.train(...,
  mesh=create_mesh(dp, fsdp, tp))``, tests/test_torch_fsdp.py and
  tests/test_torch_tp.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_workers as w
from tests.helpers import make_synth_dataset, make_task_config, \
    tiny_vast_config
from tests.test_torch_models import _init_every_param, port_config, raw_batch
from vast_tpu.models.vast import VASTModel as JaxVAST
from vast_tpu.parallel.mesh import create_mesh, replicated, shard_batch
from vast_tpu_torch import parallel, run
from vast_tpu_torch.convert.from_jax import from_jax, load_numpy_state_dict
from vast_tpu_torch.models.vast import VASTModel
from vast_tpu_torch.parallel.mesh import BACKEND_ENV, choose_backend

B = 6
RUN_CFG = {"learning_rate": 1e-3, "clip_lr": 2e-4, "betas": [0.9, 0.98],
           "weight_decay": 0.01, "scheduler": "warmup_linear",
           "warmup_ratio": 0.1}
WORLDS = [2, 3]


def _tokens(rs, b, length=12, pad_from=None):
    ids = rs.randint(106, 170, (b, length)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((b, length), np.int32)
    if pad_from is not None:
        mask[1::2, pad_from:] = 0
    return ids, mask


def _global_batch(rs):
    """6 clips with a subtitle; the ITM negatives as global indices."""
    batch = raw_batch(rs, b=B)
    batch["caption_tokens"][:, 0] = 101
    batch["subtitle_tokens"], batch["subtitle_attention_mask"] = \
        _tokens(rs, B, pad_from=7)
    batch["itm_neg_cond_idx"] = rs.permutation(B)[None].astype(np.int32)
    batch["itm_neg_text_idx"] = np.roll(np.arange(B), 2)[None].astype(
        np.int32)
    return batch


def _masked(rs, ids, mask):
    """Masked captions with a masking share rising over the rows, so that
    every split of the batch gives its ranks unequal counts."""
    prob = np.linspace(0.1, 0.9, len(ids))[:, None]
    sel = (rs.rand(*ids.shape) < prob) & (mask > 0)
    sel[:, 0] = False
    sel[np.arange(len(ids)), mask.sum(1) - 1] = True
    masked = np.where(sel, 103, ids).astype(np.int32)
    return masked, np.where(sel, ids, -100).astype(np.int32)


@pytest.fixture(scope="module")
def setup():
    """(jax model, params, port config, port state dict, ret batch, cap
    batch, three accumulation batches)."""
    rs = np.random.RandomState(31)
    ret = _global_batch(rs)
    cap = dict(ret)
    cap["caption_masked_tokens"], cap["caption_masked_labels"] = _masked(
        rs, cap["caption_tokens"], cap["caption_attention_mask"])
    accum = [_global_batch(np.random.RandomState(40 + i)) for i in range(3)]
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
    return jm, params, cfg, pm.state_dict(), ret, cap, accum


def _jax_losses_and_grads(jm, params, batch, task):
    """vast_tpu's losses and the gradient of their sum on the global
    batch, sharded over a dp=2 mesh."""
    mesh = create_mesh(dp=2, devices=jax.devices()[:2])

    def loss_fn(p, b):
        out = jm.apply({"params": p}, b, task, compute_loss=True,
                       deterministic=True)
        return sum(out.values()), out

    with jax.set_mesh(mesh):
        p = jax.device_put(jax.tree.map(jnp.asarray, params),
                           replicated(mesh))
        b = shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(p, b)
    return ({k: float(v) for k, v in out.items()},
            from_jax(jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module")
def reference(setup):
    jm, params, _, _, ret, cap, _ = setup
    return {"ret": _jax_losses_and_grads(jm, params, ret, "ret%tvas"),
            "cap": _jax_losses_and_grads(jm, params, cap, "cap%tvas")}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def ranks(request, setup, tmp_path_factory):
    """Each rank's runs: one ret%tvas step, one cap%tvas step, three
    ret%tvas steps at accumulation 2."""
    world = request.param
    _, _, cfg, state, ret, cap, accum = setup
    runs = {"ret": ("ret%tvas", [ret], RUN_CFG),
            "cap": ("cap%tvas", [cap], RUN_CFG),
            "accum": ("ret%tvas", accum,
                      dict(RUN_CFG, gradient_accumulation_steps=2))}
    return world, w.spawn(world, w.ddp_case,
                          tmp_path_factory.mktemp(f"ddp{world}"), cfg,
                          state, runs)


def _check_run(outs, want_losses, want_grads):
    got = outs[0]
    for k, v in want_losses.items():
        # O(1) losses through 2+2+2 fp32 layers: ~1e-6 relative
        np.testing.assert_allclose(got["metrics"][0][k], v, rtol=2e-5,
                                   err_msg=k)
    reached = 0
    for n, g in got["grads"].items():
        want = want_grads[n]
        for other in outs[1:]:
            # DDP's all-reduce hands every rank the same sum
            o = other["grads"][n]
            assert (g is None) == (o is None), n
            if g is not None:
                np.testing.assert_array_equal(o, g, err_msg=n)
        if g is None:
            assert not want.any(), n
            continue
        reached += 1
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(g, want, atol=2e-5 * scale, rtol=1e-4,
                                   err_msg=n)
    return reached


def test_ret_losses_and_every_gradient_match_vast_tpu(ranks, reference):
    """ITC against the gathered, detached other side with this rank's
    global targets; ITM's condition sequences gathered with their
    gradient: the ranks' mean loss and DDP's mean gradient are vast_tpu's
    on the global batch."""
    _, outs = ranks
    losses, grads = reference["ret"]
    reached = _check_run([o["ret"] for o in outs], losses, grads)
    assert reached > 100
    for n in ("vision_encoder.visual.blocks.0.attn.qkv.weight",
              "audio_encoder.encoder.layers.0.self_attn.k_proj.weight",
              "hidden_trans_subtitle_multimodal.0.weight",
              "itm_head.linear2.weight", "contra_temp"):
        assert outs[0]["ret"]["grads"][n] is not None, n


def test_cap_with_unequal_masked_counts_matches_vast_tpu(ranks, setup,
                                                         reference):
    """Each rank's sum over its masked tokens over the global count
    (times the world): unequal counts still give the global loss."""
    world, outs = ranks
    labels = setup[5]["caption_masked_labels"]
    counts = [(part != -100).sum() for part in np.split(labels, world)]
    assert len(set(counts)) == world, counts
    losses, grads = reference["cap"]
    _check_run([o["cap"] for o in outs], losses, grads)


def test_three_steps_with_accumulation_equal_one_process(ranks, setup):
    """Steps 1-2 one window (the first under no_sync, the second's
    synchronised backward averaging the window's sum), step 3 the next
    window's first: the metrics of every step, the parameters after the
    update, and the ranks' running means averaging to one process's."""
    world, outs = ranks
    _, _, cfg, state, _, _, accum = setup
    want = w.train_steps(w._model(cfg, state), accum, "ret%tvas",
                         dict(RUN_CFG, gradient_accumulation_steps=2))
    got = [o["accum"] for o in outs]
    assert [g["count"] for g in got] == [1] * world
    assert [g["mini_step"] for g in got] == [1] * world
    for m, wm in zip(got[0]["metrics"], want["metrics"]):
        for k in wm:
            np.testing.assert_allclose(m[k], wm[k], rtol=2e-5, err_msg=k)
    for n, p in want["params"].items():
        for g in got:
            # one Adam update of <= lr from gradients that agree to ~1e-8
            # (tests/test_torch_train_step.py's three steps)
            np.testing.assert_allclose(g["params"][n], p, atol=1e-5,
                                       rtol=1e-5, err_msg=n)
        acc = np.mean([g["acc"][n] for g in got], axis=0)
        scale = max(float(np.abs(want["acc"][n]).max()), 1e-3)
        np.testing.assert_allclose(acc, want["acc"][n], atol=2e-5 * scale,
                                   rtol=1e-4, err_msg=n)


# ------------------------------------------------------------ evaluation

@pytest.fixture(scope="module")
def clips():
    """10 clips: frames, a waveform, a caption and a subtitle each."""
    rs = np.random.RandomState(50)
    arrays = raw_batch(rs, b=10)
    arrays["caption_tokens"][:, 0] = 101
    arrays["subtitle_tokens"], arrays["subtitle_attention_mask"] = \
        _tokens(rs, 10, pad_from=7)
    return arrays


def _eval(world, setup, clips, tmp):
    _, _, cfg, state, _, _, _ = setup
    out_dir = os.path.join(str(tmp), "out")
    if world == 1:
        return [w.eval_case(0, 1, cfg, state, clips, 4, out_dir)], out_dir
    return w.spawn(world, w.eval_case, tmp, cfg, state, clips, 4,
                   out_dir), out_dir


@pytest.fixture(scope="module")
def one_process_eval(setup, clips, tmp_path_factory):
    return _eval(1, setup, clips, tmp_path_factory.mktemp("eval1"))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def rank_eval(request, setup, clips, tmp_path_factory):
    world = request.param
    return world, _eval(world, setup, clips,
                        tmp_path_factory.mktemp(f"eval{world}"))


def _cells(score, ids, ids_txt):
    return {(t, c): score[i, j] for i, t in enumerate(ids_txt)
            for j, c in enumerate(ids)}


def test_evaluate_ret_equals_one_process(rank_eval, one_process_eval):
    """Ragged shards (10 clips over 2 or 3 ranks, a padded_tail on the
    short ones), gathered in rank order: every ITC and rerank score cell
    and every R@k equal to one process's, on every rank."""
    world, (outs, _) = rank_eval
    (one,), _ = one_process_eval
    if world == 3:
        assert [o["padded_tail"] for o in outs] == [0, 1, 1]
    for out in outs:
        assert out["ret"] == one["ret"]
        assert len(out["scores"]) == len(one["scores"]) == 4
        for (s, ids, txt, d), (s1, ids1, txt1, d1) in zip(out["scores"],
                                                          one["scores"]):
            assert d == d1 and sorted(ids) == sorted(ids1) == \
                [f"clip{i}" for i in range(10)]
            got, want = _cells(s, ids, txt), _cells(s1, ids1, txt1)
            assert got.keys() == want.keys()
            # features of the same rows in other batch compositions
            np.testing.assert_allclose([got[k] for k in want],
                                       list(want.values()), rtol=1e-5,
                                       atol=1e-6)


def test_evaluate_cap_gathers_every_clip_once(rank_eval, one_process_eval):
    """Each rank decodes its shard; rank 0 writes every clip's caption
    once, the captions one process decodes."""
    world, (outs, out_dir) = rank_eval
    _, one_dir = one_process_eval
    path = os.path.join("results_test_synth", "step_0_tvas.json")
    with open(os.path.join(out_dir, path)) as f:
        rows = json.load(f)
    with open(os.path.join(one_dir, path)) as f:
        want = json.load(f)
    assert sorted(r["video_id"] for r in rows) == \
        [f"clip{i}" for i in range(10)]
    assert sorted(rows, key=lambda r: r["video_id"]) == \
        sorted(want, key=lambda r: r["video_id"])
    assert all(o["cap"] == {} for o in outs)


def test_meta_loader_draws_the_same_task_on_every_rank(rank_eval):
    """Seeded by ``seed`` alone: every rank steps the same task."""
    world, (outs, _) = rank_eval
    draws = outs[0]["draws"]
    assert len(draws) == world and all(d == draws[0] for d in draws)
    assert set(draws[0]) == {"a", "b", "c"}
    # an accumulation window of 2 holds its task
    assert all(draws[0][i] == draws[0][i + 1] for i in range(0, 24, 2))


# -------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """16 synthetic clips with subtitles, the ret%tvas task config; the
    CLI under 2 ranks."""
    root = str(tmp_path_factory.mktemp("cli"))
    anno, annfile = make_synth_dataset(root, n=16)
    with open(anno) as f:
        annos = json.load(f)
    for i, a in enumerate(annos):
        a["subtitle"] = f"a man talks {i} times in the red car"
    with open(anno, "w") as f:
        json.dump(annos, f)
    cfg = make_task_config(root, anno, annfile, task="ret%tvas", steps=2)
    out = os.path.join(root, "out")
    return cfg, out, w.spawn(2, w.cli_case, root, cfg, out)


def test_cli_two_ranks_one_checkpoint_by_rank_zero(cli):
    """2 steps, an evaluation and a save after each: rank 0 wrote every
    file, rank 1 none, and one pair is left; both ranks logged the same
    evaluations and took the same steps."""
    _, out, (r0, r1) = cli
    assert r0["writes"] == ["model_step_1.pt", "optimizer_step_1.pt",
                            "model_step_2.pt", "optimizer_step_2.pt"]
    assert r1["writes"] == []
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == \
        ["model_step_2.pt", "optimizer_step_2.pt"]
    assert r0["step"] == r1["step"] == 2
    assert r0["logged"] == r1["logged"] and r0["logged"]
    with open(os.path.join(out, "log", "log.txt")) as f:
        log = f.read()
    assert "summary train rank 0 of 2" in log
    assert "rank 1 of 2" not in log          # rank 0 alone writes the log
    summary = json.loads(log.split("summary train rank 0 of 2: ")[1]
                         .splitlines()[0])
    # DDP's own all-reduce timing: step 1's, read at step 2's forward
    assert summary["grad_allreduce_steps"] == 1
    assert summary["grad_allreduce_s"] > 0


def test_cli_two_ranks_test_equal_one_process(cli):
    cfg, out, (r0, r1) = cli
    assert r0["tested"] == r1["tested"]
    one = run.main(["--config", cfg, "--output_dir", out + "_one",
                    "--mode", "testing", "--checkpoint",
                    os.path.join(out, "ckpt", "model_step_2.pt"),
                    "--device", "cpu"])
    assert r0["tested"] == one
    key = next(iter(one))
    assert set(one[key]) == {"ret_itc_tvas", "ret_itm_tvas"}
    # the run's own evaluation at step 2 is the test's
    at_step = {name[len(key) + 1:]: hist["2"]
               for name, hist in r0["logged"].items()}
    assert at_step == one[key]


# ------------------------------------------------------------ no fallback

def test_nccl_refuses_two_ranks_on_one_card():
    with pytest.raises(RuntimeError, match=BACKEND_ENV):
        choose_backend("cuda", 2, 1)
    assert choose_backend("cuda", 2, 1, "gloo") == "gloo"
    assert choose_backend("cuda", 2, 2) == "nccl"
    assert choose_backend("cpu", 3, 0) == "gloo"
    with pytest.raises(ValueError, match="CUDA"):
        choose_backend("cpu", 2, 0, "nccl")
    with pytest.raises(ValueError, match=BACKEND_ENV):
        choose_backend("cuda", 1, 1, "mpi")


def test_a_rank_without_its_group_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group"):
        parallel.world()
    from vast_tpu_torch.parallel import collectives
    with pytest.raises(RuntimeError, match="no process group"):
        collectives.gather_list(["x"])


@pytest.fixture(scope="module")
def cli_flags(cli, tmp_path_factory):
    """The CLI under 2 ranks with ``run_cfg.fsdp`` and with ``run_cfg.tp``
    set in the task config, as the ``cli`` run otherwise."""
    cfg, _, _ = cli
    root = str(tmp_path_factory.mktemp("cli_flags"))
    with open(cfg) as f:
        task = json.load(f)
    paths = {}
    for key in ("fsdp", "tp"):
        t = json.loads(json.dumps(task))
        t["run_cfg"][key] = True
        paths[key] = os.path.join(root, f"{key}.json")
        with open(paths[key], "w") as f:
            json.dump(t, f)
    return root, w.spawn(2, w.cli_flags_case, root, paths, root)


@pytest.mark.parametrize("key", ["fsdp", "tp"])
def test_cli_sharding_flags_follow_the_mesh(key, cli, cli_flags):
    """The CLI passes ``train`` no mesh, so it builds the dp-only
    ``create_mesh()``: ``fsdp`` / ``tp`` split nothing there, as in
    vast_tpu, and the run is the ``cli`` run, evaluations and
    checkpoint alike."""
    _, out, (r0, _) = cli
    root, ranks = cli_flags
    for rk in ranks:
        got = rk[key]
        assert not got["sharded"] and got["step"] == 2
        assert got["logged"] == r0["logged"]
    a = torch.load(os.path.join(out, "ckpt", "model_step_2.pt"),
                   weights_only=True)
    b = torch.load(os.path.join(root, key, "ckpt", "model_step_2.pt"),
                   weights_only=True)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
