"""Pretraining (``pretrain_cfg/pretrain_vast.json``): the port against
vast_tpu on the CPU.

* ``create_train_dataloaders`` on a copy of the released config over
  synthetic data under ``VAST_DATA`` (vast27m and valor1m as annotation
  sets of JPEG images, laion400m as a directory of tar shards with a
  corrupt member): the steps 60000 : 25000 : 15000, the step budget, the
  stream's loader, and the same sequence of task draws and batch ids as
  vast_tpu's ``MetaLoader``.
* One loss of each of the three released task strings, and every
  gradient, against vast_tpu's, with the ITM negatives and the [MASK]
  positions injected, on a batch shaped as the loader makes it.
* A short CLI run (``--device cpu``) of a pretrain-shaped config with the
  tiny model: a run cut after 3 of 6 steps and resumed reads, after the
  resume, the batches of the unbroken run (the stream by reading and
  dropping what it skips), and ends with the same parameters.
* ``optim: adam`` and ``adamax`` against optax over three updates with the
  three LR groups; ``adamax`` with ``adam_nu_dtype`` raises.
"""

import io
import json
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.helpers import TINY_MODEL_CFG_JSON, make_synth_dataset
from tests.test_src_dataset import make_shard
from tests.test_torch_cap_qa import pair as cap_qa_pair  # noqa: F401
from tests.test_torch_models import build_pair
from tests.test_torch_ret_tvas import _losses_and_grads
from vast_tpu import config as jconfig
from vast_tpu.data.tokenizer import tiny_tokenizer as j_tiny_tokenizer
from vast_tpu.training import pipeline as jpipeline
from vast_tpu.training.optimizer import build_optimizer as j_build_optimizer
from vast_tpu_torch.config import get_args
from vast_tpu_torch.convert.from_jax import from_jax, load_numpy_state_dict
from vast_tpu_torch.data.loader import STREAM_LENGTH, StreamBatchLoader
from vast_tpu_torch.data.tokenizer import tiny_tokenizer
from vast_tpu_torch.models.vast import VASTModel
from vast_tpu_torch.training import pipeline
from vast_tpu_torch.training.optimizer import build_optimizer

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASED = os.path.join(HERE, "vast_tpu", "configs", "pretrain_cfg",
                        "pretrain_vast.json")
TASKS = {"vast27m": "ret%tvas%tvs%tv%ta_cap%tvas%tvs%tv%ta",
         "valor1m": "ret%tva%tv%ta_cap%tva%tv%ta",
         "laion400m": "ret%tv_cap%tv"}


def write_pretrain_data(root):
    """Under ``root``: vast27m (subtitles, and the per-modality captions
    its annotations carry) and valor1m as 16-clip annotation sets over one
    directory of JPEG images and wavs, three laion400m tar shards of 6
    images with .txt or .json captions (one member corrupt), and an
    MSR-VTT-shaped test set with subtitles."""
    anno, _ = make_synth_dataset(root, n=16)
    with open(anno) as f:
        annos = json.load(f)
    rows = {"vast27m": [], "valor1m": [], "msrvtt": []}
    for a in annos:
        cap = a["caption"]
        rows["vast27m"].append({"video_id": a["video_id"], "desc": cap,
                                "subtitle": f"subtitle {cap}",
                                "vision_cap": cap.split(" ", 2)[-1],
                                "audio_cap": "a sound"})
        rows["valor1m"].append({"video_id": a["video_id"], "desc": cap})
        rows["msrvtt"].append({"video_id": a["video_id"], "desc": cap,
                               "subtitle": f"subtitle {cap}"})
    for name, r in rows.items():
        os.makedirs(os.path.join(root, name, "annotations"), exist_ok=True)
        split = "ret_test" if name == "msrvtt" else "train"
        with open(os.path.join(root, name, "annotations", split + ".json"),
                  "w") as f:
            json.dump(r, f)
    shards = os.path.join(root, "laion400m", "shards")
    os.makedirs(shards, exist_ok=True)
    for s in range(3):
        make_shard(os.path.join(shards, f"{s:05d}.tar"), 6, 6 * s,
                   corrupt_one=s == 1)
    with tarfile.open(os.path.join(shards, "00003.tar"), "w") as tf:
        from tests.test_src_dataset import _image_member

        rs = np.random.RandomState(9)
        for i in range(4):
            for ext, data in (("jpg", _image_member(rs)), ("json", json.dumps(
                    {"caption": f"a json caption {i}"}).encode())):
                info = tarfile.TarInfo(f"js{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def released_copy(root):
    """pretrain_vast.json with its video sets as the JPEG images of
    ``write_pretrain_data`` (image_rawimage; vision under images/)."""
    with open(RELEASED) as f:
        cfg = json.load(f)
    for d in cfg["data_cfg"]["train"] + cfg["data_cfg"]["val"]:
        if d["type"] == "annoindexed":
            d["vision"] = os.path.join(root, "images")
            d["audio"] = os.path.join(root, "audios")
            d["vision_format"] = "image_rawimage"
            d["n_workers"] = 2
    path = os.path.join(root, "pretrain_vast.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pretrain"))
    write_pretrain_data(root)
    return root


def test_create_train_dataloaders_matches_vast_tpu(data, monkeypatch):
    monkeypatch.setenv("VAST_DATA", data)
    argv = ["--config", released_copy(data), "--train_batch_size", "4"]
    p_opts, j_opts = get_args(argv), jconfig.get_args(argv)
    pl = pipeline.create_train_dataloaders(p_opts, tiny_tokenizer())
    jl = jpipeline.create_train_dataloaders(j_opts, j_tiny_tokenizer())
    names = [f"{TASKS[n]}--{n}" for n in TASKS]
    assert list(pl.name2loader) == list(jl.name2loader) == names
    assert pl.sampling_pools == jl.sampling_pools
    assert [pl.sampling_pools.count(n) for n in names] == \
        [60000, 25000, 15000]
    assert p_opts.run_cfg.num_train_steps == \
        j_opts.run_cfg.num_train_steps == 100000
    assert p_opts.run_cfg.valid_steps == j_opts.run_cfg.valid_steps
    stream = pl.name2loader[names[2]]
    assert isinstance(stream, StreamBatchLoader) and stream.batch_size == 4
    assert not hasattr(stream.dataset, "__len__") and STREAM_LENGTH == 10 ** 9
    # the released yuv420: the annotation sets fall back to rgb (not
    # video_rawvideo); the stream keeps yuv420 where the runtime decodes
    # it, as vast_tpu's does
    jstream = jl.name2loader[names[2]]
    assert stream.dataset.pixel_format == jstream.dataset.pixel_format
    got, want = [], []
    for (pn, pb), (jn, jb) in zip(pl, jl):
        got.append((pn, pb["ids"]))
        want.append((jn, jb["ids"]))
        if len(got) == 40:
            break
    assert got == want
    # the first 40 draws of 60000 : 25000 : 15000 reach every set
    assert {n for n, _ in got} == set(names)


def test_a_stream_needs_its_steps(data, monkeypatch):
    monkeypatch.setenv("VAST_DATA", data)
    path = released_copy(data)
    with open(path) as f:
        cfg = json.load(f)
    del cfg["data_cfg"]["train"][2]["steps"]
    path = os.path.join(data, "no_steps.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="laion400m.*steps"):
        pipeline.create_train_dataloaders(get_args(["--config", path]),
                                          tiny_tokenizer())


# the keys of a batch as each set's loader collates it: vast27m with its
# subtitle (its per-modality captions are read by neither package's
# loader), valor1m without, laion400m one image and its caption
LOADER_KEYS = {
    "vast27m": ("vision_frames", "caption", "subtitle", "audio_waveforms"),
    "valor1m": ("vision_frames", "caption", "audio_waveforms"),
    "laion400m": ("vision_frames", "caption"),
}


@pytest.mark.parametrize("name", list(TASKS))
def test_released_task_losses_and_every_gradient_match(cap_qa_pair, name):
    """The task string of each released set on a batch as its loader
    makes it: ITC and ITM over every ret subtask and the MLM loss over
    every cap subtask, and every gradient, against vast_tpu's."""
    jm, params, pm, batch = cap_qa_pair
    keep = LOADER_KEYS[name]
    drop = tuple(k for k in batch if not k.startswith(
        tuple(f"{key}_" if key in ("caption", "subtitle") else key
              for key in keep)))
    task = TASKS[name]
    n_ret = len(task.split("_")[0].split("%")) - 1
    rs = np.random.RandomState(3)
    extra = {"itm_neg_cond_idx": np.stack([rs.permutation(3)
                                           for _ in range(n_ret)]),
             "itm_neg_text_idx": np.stack([rs.permutation(3)
                                           for _ in range(n_ret)])}
    if name == "laion400m":                      # one image a sample
        extra["vision_frames"] = batch["vision_frames"][:, :1]
    reached = _losses_and_grads((jm, params, pm, batch), task, extra=extra,
                                drop=drop)
    assert "multimodal_encoder.cls.predictions.bias" in reached
    assert ("hidden_trans_subtitle_multimodal.0.weight" in reached) == \
        (name == "vast27m")
    assert ("audio_encoder.layer_norm.weight" in reached) == \
        (name != "laion400m")


def pretrain_task_config(root, steps=6):
    """The released sets' tasks and step ratio (3 : 2 : 1 for 60000 :
    25000 : 15000 at this size) over ``write_pretrain_data``, the tiny
    model, batches of 4, a ret%tvas validation."""
    def anno(name, task, n):
        return {"type": "annoindexed", "training": True, "name": name,
                "txt": os.path.join(root, name, "annotations", "train.json"),
                "vision": os.path.join(root, "images"),
                "audio": os.path.join(root, "audios"),
                "vision_format": "image_rawimage", "vision_sample_num": 1,
                "audio_sample_num": 1, "task": task, "steps": n,
                "n_workers": 2, "batch_size": 4}

    train = [anno("vast27m", TASKS["vast27m"], 3),
             anno("valor1m", TASKS["valor1m"], 2),
             {"type": "srcindexed", "training": True, "name": "laion400m",
              "txt": os.path.join(root, "laion400m", "shards"),
              "vision_format": "image_rawimage", "pixel_format": "yuv420",
              "vision_sample_num": 1, "task": TASKS["laion400m"],
              "steps": 1, "batch_size": 4, "shuffle_buffer": 8}]
    val = dict(anno("msrvtt", "ret%tvas", 0), training=False,
               txt=os.path.join(root, "msrvtt", "annotations",
                                "ret_test.json"))
    del val["steps"]
    # seed 5 draws the sets a v l | v l l: the stream on both sides of
    # the cut after step 3
    cfg = {"run_cfg": {"learning_rate": 1e-3, "bf16": False, "seed": 5,
                       "valid_freq": 2, "first_eval": False,
                       "num_train_steps": steps},
           "model_cfg": dict(TINY_MODEL_CFG_JSON),
           "data_cfg": {"train": train, "val": [val]}}
    path = os.path.join(root, "pretrain_tiny.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _run(cfg, out, extra=(), limit=None, seen=None, monkeypatch=None):
    """The CLI's training flow on the CPU; each step's (set, batch ids)
    into ``seen`` (the loader runs one batch ahead of the steps)."""
    import itertools

    opts = get_args(["--config", cfg, "--output_dir", out] + list(extra))
    pipeline.initialize(opts)
    tok = pipeline.build_tokenizer(opts)
    model = pipeline.build_model(opts, "cpu", tok)
    val = pipeline.create_val_dataloaders(opts, tok)
    loader = pipeline.create_train_dataloaders(opts, tok)
    if limit is not None:
        loader = itertools.islice(loader, limit)
    real = pipeline._device_batches

    def tap(batches, *a, **k):
        def each():
            for name, batch in batches:
                seen.append((name.split("--")[1], list(batch["ids"])))
                yield name, batch
        return real(each(), *a, **k)
    monkeypatch.setattr(pipeline, "_device_batches", tap)
    return pipeline.train(model, opts, tok, loader, val)


def test_cli_run_resumes_across_the_stream(data, monkeypatch):
    """6 steps unbroken against 3 steps, a save, and a run resumed to 6:
    after the resume each step reads the unbroken run's batch (the
    stream's by reading and dropping the batches it skips), and the two
    runs end on equal parameters; the stream is drawn on both sides of
    the cut."""
    from vast_tpu_torch import run as prun

    cfg = pretrain_task_config(data)
    whole, cut, resumed = [], [], []
    a, _ = _run(cfg, os.path.join(data, "whole"), seen=whole,
                monkeypatch=monkeypatch)
    _run(cfg, os.path.join(data, "cut"), limit=3, seen=cut,
         monkeypatch=monkeypatch)
    assert sorted(os.listdir(os.path.join(data, "cut", "ckpt"))) == \
        ["model_step_3.pt", "optimizer_step_3.pt"]
    b, _ = _run(cfg, os.path.join(data, "cut"), ["--resume"], seen=resumed,
                monkeypatch=monkeypatch)
    steps = 6
    assert cut[:3] == whole[:3]
    assert resumed[:steps - 3] == whole[3:steps]
    drawn = [n for n, _ in whole[:steps]]
    assert drawn == ["valor1m", "vast27m", "laion400m", "vast27m",
                     "laion400m", "laion400m"]
    assert a.step == b.step == steps
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    # and the port's own entry point runs the config end to end
    state, logged = prun.main(["--config", cfg, "--device", "cpu",
                               "--output_dir", os.path.join(data, "cli"),
                               "--num_train_steps", "2"])
    assert state.step == 2 and logged


PRETRAIN_RUN_CFG = {"learning_rate": 1e-3, "clip_lr": 2e-4, "new_lr": 5e-4,
                    "new_params_name": ["contra_head"], "betas": [0.9, 0.98],
                    "weight_decay": 0.01, "scheduler": "warmup_linear",
                    "warmup_ratio": 0.1}
OPT_CASES = {"adam": {"optim": "adam"},
             "adam_bf16_mu": {"optim": "adam", "adam_mu_dtype": "bfloat16"},
             "adam_bf16_moments": {"optim": "adam",
                                   "adam_mu_dtype": "bfloat16",
                                   "adam_nu_dtype": "bfloat16"},
             "adam_clip_grads": {"optim": "adam", "clip_grads": True,
                                 "grad_norm": 0.5},
             "adamax": {"optim": "adamax"},
             "adamax_mu_dtype_ignored": {"optim": "adamax",
                                         "adam_mu_dtype": "bfloat16"}}


@pytest.fixture(scope="module")
def tiny_pair():
    return build_pair()


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_adam_and_adamax_match_optax(tiny_pair, case):
    """Three updates from the same params and gradients against vast_tpu's
    build_optimizer: the new (contra heads), clip (EVA) and basic LR
    groups, each with and without decay; a parameter with no gradient
    left where it was, as optax leaves it (no weight decay)."""
    _, params, pm, _ = tiny_pair
    run_cfg = dict(PRETRAIN_RUN_CFG, **OPT_CASES[case])
    model_cfg = {"vision_encoder_type": "evaclip01_giant"}
    rs = np.random.RandomState(8)
    grads = []
    for _ in range(3):
        g = jax.tree.map(
            lambda p: np.asarray(rs.randn(*np.shape(p)) * 0.1, np.float32),
            params)
        g["contra_head_s"] = jax.tree.map(np.zeros_like, g["contra_head_s"])
        grads.append(g)
    tx, _ = j_build_optimizer(params, run_cfg, model_cfg, 30)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
    want = from_jax(jax.tree.map(np.asarray, jp))

    model = VASTModel(pm.cfg, device="cpu")
    load_numpy_state_dict(model, from_jax(params))
    opt, labels = build_optimizer(model, run_cfg, model_cfg, 30)
    assert {lab.removesuffix("_nd") for lab in labels.values()} == \
        {"basic", "new", "clip"}
    if case.startswith("adamax"):
        assert all(m.dtype == torch.float32 for m in opt.mu.values())
    for g in grads:
        flat = from_jax(g)
        for n, p in model.named_parameters():
            p.grad = (None if n.startswith("contra_head_s")
                      else torch.from_numpy(flat[n]))
        assert opt.step()
    start = from_jax(params)
    for n, p in model.named_parameters():
        got = p.detach().numpy()
        # no decay and no gradient: contra_head_s stays where it was
        assert np.array_equal(got, start[n]) == n.startswith(
            "contra_head_s"), n
        # fp32 on both sides (tests/test_torch_train.py
        # test_optimizer_steps_match_optax): 1e-7 of updates <= lr; a bf16
        # moment may round one ulp apart: 2^-8 of an update
        tol = 1e-6 if "bf16" in case else 1e-7
        np.testing.assert_allclose(got, want[n], atol=tol, rtol=1e-6,
                                   err_msg=n)


def test_adamax_refuses_nu_dtype(tiny_pair):
    _, _, pm, _ = tiny_pair
    run_cfg = dict(PRETRAIN_RUN_CFG, optim="adamax",
                   adam_nu_dtype="bfloat16")
    with pytest.raises(ValueError, match="adam_nu_dtype.*adamax"):
        build_optimizer(pm, run_cfg, {}, 10)
    with pytest.raises(ValueError, match="optim 'sgd'"):
        build_optimizer(pm, dict(PRETRAIN_RUN_CFG, optim="sgd"), {}, 10)
