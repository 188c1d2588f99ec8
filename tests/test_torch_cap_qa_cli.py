"""Captioning and QA through the CLIs, on the CPU at tiny size.

``--mode testing`` of ``cap%tvas`` and ``qa%tvas`` through
``vast_tpu_torch.run.main`` and the repo's ``run.main`` from one
``--checkpoint x.pt`` (the port's state dict of a seeded vast_tpu init):
equal metrics and equal caption and answer files. The port's CLI trains
each task for two steps (losses, evaluations, saves), and its ``--mode
testing`` from the saved ``.pt`` reproduces the captions, the answers
and the metrics of the run's last evaluation. ``captioner_mode`` writes
the gencap files of ``vast_tpu``'s form. ``build_model`` takes the
tokenizer's [MASK] id, as ``vast_tpu``'s does.
"""

import functools
import json
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

from tests.helpers import make_synth_dataset, make_task_config
from vast_tpu import config as jconfig
from vast_tpu.data.tokenizer import tiny_tokenizer as j_tiny_tokenizer
from vast_tpu.models.vast import VASTConfig as JaxVASTConfig
from vast_tpu.models.vast import VASTModel as JaxVAST
from vast_tpu.training import pipeline as jpipeline
from vast_tpu_torch import run as prun
from vast_tpu_torch.config import get_args
from vast_tpu_torch.convert.from_jax import from_jax
from vast_tpu_torch.training import pipeline
from vast_tpu_torch.training.step import make_train_step

SUBTITLES = ["a man talks about the red car", "two girls sing with music",
             "the crowd walks in the rain near the house",
             "a dog eats food under the table"]
TASKS = ("cap%tvas", "qa%tvas")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """16 synthetic clips with subtitles, questions and answers; a COCO
    annfile with two references a clip; a task config per task."""
    root = str(tmp_path_factory.mktemp("capqa"))
    anno, annfile = make_synth_dataset(root, n=16)
    with open(anno) as f:
        annos = json.load(f)
    for i, a in enumerate(annos):
        a["subtitle"] = SUBTITLES[i % 4] + " " + SUBTITLES[(i // 4) % 4]
    with open(anno, "w") as f:
        json.dump(annos, f)
    with open(annfile) as f:
        coco = json.load(f)
    n = len(coco["annotations"])
    coco["annotations"] += [
        {"image_id": a["image_id"], "id": n + i,
         "caption": coco["annotations"][(i + 3) % n]["caption"]}
        for i, a in enumerate(coco["annotations"][:n])]
    with open(annfile, "w") as f:
        json.dump(coco, f)
    cfgs = {}
    for task in TASKS:
        path = make_task_config(root, anno, annfile, task=task, steps=2)
        cfgs[task] = os.path.join(root, f"{task.replace('%', '_')}.json")
        os.replace(path, cfgs[task])
    return root, cfgs


@pytest.fixture(scope="module")
def checkpoint(synth):
    root, cfgs = synth
    jopts = jconfig.get_args(["--config", cfgs["cap%tvas"]])
    jcfg = JaxVASTConfig.from_model_cfg(jopts.model_cfg)
    init = jax.jit(functools.partial(jpipeline.init_params, JaxVAST(jcfg),
                                     jopts, j_tiny_tokenizer()))
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3)))
    path = os.path.join(root, "seeded.pt")
    torch.save({k: torch.tensor(v) for k, v in from_jax(params).items()},
               path)
    return path


def _output(out, task, step):
    """The caption or answer file of ``task``'s evaluation at ``step``."""
    if task.startswith("cap"):
        path = os.path.join(out, "results_test_synth", f"step_{step}_tvas.json")
    else:
        path = os.path.join(out, "predict_answers",
                            f"step{step}_pred_synth_tvas.json")
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("task", TASKS)
def test_testing_mode_equal_through_both_clis(synth, checkpoint, task,
                                              monkeypatch):
    import run as jrun

    root, cfgs = synth
    outs = {pkg: os.path.join(root, f"test_{task[:3]}_{pkg}")
            for pkg in ("port", "jax")}
    argv = ["--config", cfgs[task], "--mode", "testing", "--checkpoint",
            checkpoint]
    got = prun.main(argv + ["--output_dir", outs["port"], "--device",
                            "cpu"])
    logs = []
    real_test = jpipeline.test
    monkeypatch.setattr(jpipeline, "test", lambda *a, **k: logs.append(
        real_test(*a, **k)))
    monkeypatch.setattr(sys, "argv", ["run.py"] + argv
                        + ["--output_dir", outs["jax"]])
    jrun.main()
    assert got == logs[0]
    rows = _output(outs["port"], task, 0)
    assert rows == _output(outs["jax"], task, 0)
    assert len(rows) == 16
    texts = [r["caption"] if isinstance(r, dict) else r for r in rows]
    assert len(set(texts)) > 1, texts
    log = got[f"{task}--synth"]
    if task.startswith("cap"):
        assert set(log) == {"cap_tvas"}
        assert set(log["cap_tvas"]) == {"Bleu_1", "Bleu_2", "Bleu_3",
                                        "Bleu_4", "METEOR", "ROUGE_L",
                                        "CIDEr"}
        assert [r["video_id"] for r in rows] == [f"sample{i:03d}"
                                                 for i in range(16)]
    else:
        assert set(log) == {"vqa_tvas"}
        assert 0.0 <= log["vqa_tvas"]["accuracy"] <= 100.0


@pytest.mark.parametrize("task", TASKS)
def test_cli_trains_saves_and_retests(synth, checkpoint, task,
                                      monkeypatch):
    """Two steps from the seeded checkpoint (evaluations after steps 1
    and 2, a save at each), then ``--mode testing`` from model_step_2.pt:
    the same metrics and the same captions or answers as the run's
    evaluation at step 2."""
    root, cfgs = synth
    out = os.path.join(root, f"train_{task[:3]}")
    losses = []

    def recording(*a, **k):
        step = make_train_step(*a, **k)

        def run(state, batch, gen):
            state, m = step(state, batch, gen)
            losses.append({n: v.item() for n, v in m.items()})
            return state, m
        return run

    monkeypatch.setattr(pipeline, "make_train_step", recording)
    flags = ["--output_dir", out, "--device", "cpu", "--valid_freq", "1",
             "--checkpoint", checkpoint]
    state, logged = prun.main(["--config", cfgs[task]] + flags)
    head = "loss_cap" if task.startswith("cap") else "loss_qa"
    assert len(losses) == 2 and state.step == 2
    for row in losses:
        assert row.keys() == {head, "total_loss"}
        assert all(math.isfinite(v) for v in row.values())
    name = f"{task}--synth_{'cap' if head == 'loss_cap' else 'vqa'}_tvas"
    assert set(logged[name]) >= {"1", "2", "best_step", "best_value"}
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "model_step_2.pt", "optimizer_step_2.pt"]
    tested = prun.main(["--config", cfgs[task], "--mode", "testing",
                        "--checkpoint", os.path.join(out, "ckpt",
                                                     "model_step_2.pt"),
                        "--output_dir", os.path.join(out, "retest"),
                        "--device", "cpu"])
    rows = _output(out, task, 2)
    texts = [r["caption"] if isinstance(r, dict) else r for r in rows]
    assert len(set(texts)) > 1, texts
    key = f"{task}--synth"
    assert tested[key] == {name[len(key) + 1:]: logged[name]["2"]}
    assert _output(os.path.join(out, "retest"), task, 0) == rows


def test_build_model_takes_the_tokenizers_mask_id(synth):
    _, cfgs = synth
    opts = get_args(["--config", cfgs["cap%tvas"]])
    tok = j_tiny_tokenizer()
    tok.mask_token_id = 7
    model = pipeline.build_model(opts, "cpu", tok)
    want = jpipeline.build_model(jconfig.get_args(
        ["--config", cfgs["cap%tvas"]]), tokenizer=tok)
    assert model.cfg.mask_token_id == want.cfg.mask_token_id == 7
    assert pipeline.build_model(opts, "cpu").cfg.mask_token_id == 103


def test_captioner_mode_writes_gencap_files(synth, checkpoint, monkeypatch):
    """captioner_mode: generate_nums top-k samples a clip into
    results_test_synth/gencap_rank0_idx0_tvas.json ({video_id: [captions]}),
    no metrics, as vast_tpu's run.py writes them (its samples are drawn
    from another generator, so the files agree in form)."""
    import run as jrun

    root, cfgs = synth
    with open(cfgs["cap%tvas"]) as f:
        cfg = json.load(f)
    cfg["model_cfg"].update(captioner_mode=True, generate_nums=3)
    path = os.path.join(root, "captioner.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    outs = {pkg: os.path.join(root, f"captioner_{pkg}")
            for pkg in ("port", "jax")}
    argv = ["--config", path, "--mode", "testing", "--checkpoint", checkpoint]
    got = prun.main(argv + ["--output_dir", outs["port"], "--device", "cpu"])
    assert got == {"cap%tvas--synth": {}}
    monkeypatch.setattr(sys, "argv", ["run.py"] + argv
                        + ["--output_dir", outs["jax"]])
    jrun.main()
    files = {}
    for pkg, out in outs.items():
        rdir = os.path.join(out, "results_test_synth")
        assert sorted(os.listdir(rdir)) == ["gencap_rank0_idx0_tvas.json"]
        with open(os.path.join(rdir, "gencap_rank0_idx0_tvas.json")) as f:
            files[pkg] = json.load(f)
    assert list(files["port"]) == list(files["jax"]) == [
        f"sample{i:03d}" for i in range(16)]
    assert all(len(c) == 3 and all(isinstance(x, str) for x in c)
               for c in files["port"].values())
    assert len({x for c in files["port"].values() for x in c}) > 1
