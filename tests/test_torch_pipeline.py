"""The port's CLI, train loop and saver on the CPU, at tiny size.

``--mode testing`` through ``vast_tpu_torch.run.main`` and through the
repo's ``run.main`` from one ``--checkpoint x.pt`` (the port's state
dict of a seeded vast_tpu init, carried across with ``from_jax``) on
``ret%tvas`` synthetic data: every R@k equal. A run resumed after 2 of 4
steps continues the unbroken run exactly; the loss falls; vast_tpu's
``ingest_torch_checkpoint`` reads the port's ``model_step_N.pt`` into
the port's weights; the frame- and pos-embed surgery equals
``vast_ckpt``'s; three non-finite loss checks in a row abort the run.
"""

import functools
import itertools
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from tests.helpers import make_synth_dataset, make_task_config
from vast_tpu import config as jconfig
from vast_tpu.convert import vast_ckpt as jckpt
from vast_tpu.data.tokenizer import tiny_tokenizer as j_tiny_tokenizer
from vast_tpu.models.vast import VASTConfig as JaxVASTConfig
from vast_tpu.models.vast import VASTModel as JaxVAST
from vast_tpu.training import pipeline as jpipeline
from vast_tpu_torch import run as prun
from vast_tpu_torch.config import get_args
from vast_tpu_torch.convert import vast_ckpt
from vast_tpu_torch.convert.from_jax import from_jax
from vast_tpu_torch.training import pipeline
from vast_tpu_torch.training.step import make_train_step

SUBTITLES = ["a man talks about the red car", "two girls sing with music",
             "the crowd walks in the rain near the house",
             "a dog eats food under the table"]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """16 synthetic clips with subtitles; the ret%tvas task config."""
    root = str(tmp_path_factory.mktemp("cli"))
    anno, annfile = make_synth_dataset(root, n=16)
    with open(anno) as f:
        annos = json.load(f)
    for i, a in enumerate(annos):
        a["subtitle"] = SUBTITLES[i % 4] + " " + SUBTITLES[(i // 4) % 4]
    with open(anno, "w") as f:
        json.dump(annos, f)
    return root, make_task_config(root, anno, annfile, task="ret%tvas",
                                  steps=4)


@pytest.fixture(scope="module")
def checkpoint(synth):
    """The port's state dict of a seeded vast_tpu init (every head), as a
    .pt file, and vast_tpu's model config."""
    root, cfg = synth
    jopts = jconfig.get_args(["--config", cfg])
    jcfg = JaxVASTConfig.from_model_cfg(jopts.model_cfg)
    init = jax.jit(functools.partial(jpipeline.init_params, JaxVAST(jcfg),
                                     jopts, j_tiny_tokenizer()))
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3)))
    path = os.path.join(root, "seeded.pt")
    torch.save({k: torch.tensor(v) for k, v in from_jax(params).items()},
               path)
    return path, jcfg


def test_testing_mode_equal_through_both_clis(synth, checkpoint,
                                              monkeypatch):
    import run as jrun

    root, cfg = synth
    path, _ = checkpoint
    argv = ["--config", cfg, "--mode", "testing", "--checkpoint", path,
            "--output_dir", os.path.join(root, "test_out")]
    got = prun.main(argv + ["--device", "cpu"])
    logs = []
    real_test = jpipeline.test
    monkeypatch.setattr(jpipeline, "test", lambda *a, **k: logs.append(
        real_test(*a, **k)))
    monkeypatch.setattr(sys, "argv", ["run.py"] + argv)
    jrun.main()
    want = logs[0]
    assert got == want
    assert set(got["ret%tvas--synth"]) == {"ret_itc_tvas", "ret_itm_tvas"}
    # the ranks are not a tie order: the ITC scores of a batch's texts
    # over its clips lie apart by far more than the packages' ~1e-6
    opts = get_args(argv)
    model = pipeline.build_model(opts, "cpu")
    # every key of vast_tpu's init_params tree (contra_head_s materialised
    # there) is a parameter of the port, and the reverse
    loaded = vast_ckpt.load_checkpoint(model, path)
    assert not loaded.missing_keys and not loaded.unexpected_keys, loaded
    loader = pipeline.create_val_dataloaders(opts,
                                             pipeline.build_tokenizer(opts))
    batch = next(iter(loader["ret%tvas--synth"]))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()
          if isinstance(v, np.ndarray)}
    with torch.no_grad():
        out = model(tb, "ret%tvas")
    score = (out["feat_t"] @ out["feat_cond_tvas"].T).numpy()
    assert np.diff(np.sort(score, axis=1), axis=1).min() > 1e-4


def _run(cfg, out, extra=(), limit=None, losses=None, monkeypatch=None,
         reads=None):
    """The CLI's training flow, its loader cut after ``limit`` batches
    (a run that stopped there); each step's losses into ``losses``, the
    index of each training sample read into ``reads``."""
    opts = get_args(["--config", cfg, "--output_dir", out] + list(extra))
    pipeline.initialize(opts)
    tok = pipeline.build_tokenizer(opts)
    model = pipeline.build_model(opts, "cpu")
    val = pipeline.create_val_dataloaders(opts, tok)
    loader = pipeline.create_train_dataloaders(opts, tok)
    if reads is not None:
        for ld in loader.name2loader.values():
            def read(i, get=ld.dataset.__getitem__):
                reads.append(i)
                return get(i)
            ld.dataset.__getitem__ = read
    if limit is not None:
        loader = itertools.islice(loader, limit)
    if losses is not None:
        def recording(*a, **k):
            step = make_train_step(*a, **k)

            def run(state, batch, gen):
                state, m = step(state, batch, gen)
                losses.append({n: v.item() for n, v in m.items()})
                return state, m
            return run
        monkeypatch.setattr(pipeline, "make_train_step", recording)
    return pipeline.train(model, opts, tok, loader, val)


def test_resume_continues_exactly(synth, monkeypatch):
    """4 steps unbroken against 2 steps, a save, and a resumed run to 4:
    parameters, moments, update and step counts, and the losses of steps
    3 and 4 all equal, bit for bit (same CPU, same order of operations).
    The resumed run reads no sample of the 2 steps it skips: its first
    training reads are the batch of step 3."""
    root, cfg = synth
    flags = ["--valid_freq", "1"]      # evaluate and save after steps 2, 4
    whole, cut, whole_reads, resumed_reads = [], [], [], []
    a, _ = _run(cfg, os.path.join(root, "whole"), flags, losses=whole,
                monkeypatch=monkeypatch, reads=whole_reads)
    _run(cfg, os.path.join(root, "cut"), flags, limit=2, losses=cut,
         monkeypatch=monkeypatch)
    assert os.listdir(os.path.join(root, "cut", "ckpt")) and \
        sorted(os.listdir(os.path.join(root, "cut", "ckpt"))) == \
        ["model_step_2.pt", "optimizer_step_2.pt"]
    b, _ = _run(cfg, os.path.join(root, "cut"), flags + ["--resume"],
                losses=cut, monkeypatch=monkeypatch, reads=resumed_reads)
    assert len(whole) == len(cut) == 4 and whole == cut
    # the loader's producer reads one batch of 8 after another
    batch = [sorted(whole_reads[i:i + 8]) for i in range(0, 32, 8)]
    assert batch[0] != batch[2]
    assert sorted(resumed_reads[:8]) == batch[2]
    assert a.step == b.step == 4 and a.opt.count == b.opt.count == 4
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    for key in ("mu", "nu"):
        for n, t in getattr(a.opt, key).items():
            assert torch.equal(t, getattr(b.opt, key)[n]), (key, n)


def test_loss_falls(synth, monkeypatch):
    root, cfg = synth
    losses = []
    _run(cfg, os.path.join(root, "falls"),
         ["--num_train_steps", "8", "--valid_freq", "1"], losses=losses,
         monkeypatch=monkeypatch)
    total = [m["total_loss"] for m in losses]
    assert len(total) == 8 and all(np.isfinite(total))
    assert np.mean(total[-2:]) < total[0]


def test_saved_model_reads_into_vast_tpu(synth, checkpoint):
    """vast_tpu's ingest_torch_checkpoint reads the port's saved
    model_step_N.pt into a tree equal to the port's weights."""
    root, cfg = synth
    _, jcfg = checkpoint
    out = os.path.join(root, "ingest")
    state, _ = _run(cfg, out, ["--num_train_steps", "2"])
    params = jckpt.ingest_torch_checkpoint(os.path.join(out, "ckpt",
                                                        "model_step_2.pt"),
                                           jcfg)
    want = from_jax(jax.tree.map(np.asarray, params))
    got = state.model.state_dict()
    assert want.keys() == got.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # and the port reads it back, no key missing or unexpected
    model = pipeline.build_model(get_args(["--config", cfg]), "cpu")
    loaded = vast_ckpt.load_checkpoint(model, out)
    assert not loaded.missing_keys and not loaded.unexpected_keys, loaded
    for k, v in model.state_dict().items():
        assert torch.equal(v, got[k]), k


def test_frame_and_pos_embed_surgery_matches(checkpoint):
    """A checkpoint with 4 frame embeddings and a 6 x 6 patch grid onto
    the tiny model's 1 (max_vision_sample_num) and 4 x 4: the port's
    fit_to_model against vast_ckpt's interpolations; the renames."""
    path, jcfg = checkpoint
    sd = vast_ckpt.load_torch_state_dict(path)
    rs = np.random.RandomState(0)
    d = sd["vision_frame_embedding"].shape[-1]
    w = sd["vision_encoder.visual.pos_embed"].shape[-1]
    sd["vision_frame_embedding"] = torch.from_numpy(
        rs.randn(1, 4, d).astype(np.float32))
    sd["vision_encoder.visual.pos_embed"] = torch.from_numpy(
        rs.randn(1, 37, w).astype(np.float32))
    sd["videoswin_unused.video_key"] = torch.zeros(1)
    model = pipeline.build_model(
        get_args(["--config", os.path.join(os.path.dirname(path),
                                           "task.json")]), "cpu")
    got = vast_ckpt.fit_to_model(sd, model)
    assert "visionswin_unused.vision_key" in got          # renamed, kept
    want_frames = jckpt.interp_frame_embedding(
        sd["vision_frame_embedding"].numpy(), jcfg.max_vision_sample_num)
    np.testing.assert_array_equal(got["vision_frame_embedding"].numpy(),
                                  want_frames)
    want_pos = jckpt.interp_pos_embed(
        sd["vision_encoder.visual.pos_embed"].numpy()[0], 4)
    np.testing.assert_allclose(
        got["vision_encoder.visual.pos_embed"].numpy()[0], want_pos,
        atol=1e-6, rtol=1e-6)    # fp32 bilinear, other summation order
    assert got["vision_encoder.visual.pos_embed"].shape == (1, 17, w)
    bad = dict(sd, contra_temp=torch.zeros(2))
    with pytest.raises(ValueError, match="contra_temp"):
        vast_ckpt.fit_to_model(bad, model)


def test_nan_strikes_abort_after_three(synth, monkeypatch):
    root, cfg = synth
    calls = []

    def nan_step(model, opt, task, vision_transforms="none"):
        def step(state, batch, gen):
            state.step += 1
            calls.append(state.step)
            return state, {"loss_itc": torch.tensor(float("nan"))}
        return step

    monkeypatch.setattr(pipeline, "make_train_step", nan_step)
    opts = get_args(["--config", cfg, "--output_dir",
                     os.path.join(root, "nan"), "--num_train_steps", "10",
                     "--valid_freq", "1"])
    tok = pipeline.build_tokenizer(opts)
    model = pipeline.build_model(opts, "cpu")
    loader = pipeline.create_train_dataloaders(opts, tok)
    opts.run_cfg.metrics_every = 1       # a check after every step
    opts.run_cfg.valid_steps = 100       # and no evaluation before the end
    with pytest.raises(FloatingPointError, match="3 consecutive"):
        pipeline.train(model, opts, tok, loader, {})
    assert calls == [1, 2, 3]


def test_profile_steps_write_a_trace(synth):
    """--profile_steps 1: the third step (after two of warm-up) under
    torch.profiler, its Chrome trace under <output_dir>/log/profile, and
    beside it the summary of the spans recorded in that window: one
    train step with its forward, backward and optimizer."""
    root, cfg = synth
    out = os.path.join(root, "profiled")
    _run(cfg, out, ["--num_train_steps", "3", "--profile_steps", "1"])
    files = sorted(os.listdir(os.path.join(out, "log", "profile")))
    assert len(files) == 2
    trace, spans = files
    assert spans == trace[:-len(".json")] + "_spans.json"
    with open(os.path.join(out, "log", "profile", trace)) as f:
        assert json.load(f)["traceEvents"]
    with open(os.path.join(out, "log", "profile", spans)) as f:
        summary = json.load(f)
    for name in ("vast.train.step", "vast.train.forward",
                 "vast.train.backward", "vast.train.optimizer"):
        assert summary[name]["count"] == 1, name
        assert summary[name]["host_s"] > 0
