"""The port's spans (``vast_tpu_torch.profiling``): off by default, nested
with parent and root ids and self times, mirrored as the profiler's host
events, the stage clock of ``evaluate_ret``, the train step's phases, the
rerank's counts and the garbage collector's spans. CPU, tiny sizes."""

import gc
import time

import numpy as np
import pytest
import torch

from tests.helpers import tiny_vast_config
from tests.test_torch_models import port_config, raw_batch
from vast_tpu_torch import profiling
from vast_tpu_torch.convert.from_jax import init_random_
from vast_tpu_torch.evaluation import evaluation_mm as em
from vast_tpu_torch.models.vast import VASTModel
from vast_tpu_torch.training.optimizer import build_optimizer
from vast_tpu_torch.training.step import create_train_state, make_train_step


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def model():
    m = VASTModel(port_config(tiny_vast_config()), device="cpu")
    return init_random_(m, torch.Generator().manual_seed(0))


def _by_name(recorded):
    return {r["name"]: r for r in recorded}


def test_spans_off_return_the_shared_no_op():
    a, b = profiling.span("vast.test.a"), profiling.span("vast.test.b")
    assert a is b
    with a as sp:
        sp.count("rows", 3)
    assert profiling.spans() == [] and profiling.summary() == {}


def test_nesting_ids_and_self_time():
    with profiling.recording():
        with profiling.span("vast.test.outer") as outer:
            time.sleep(0.002)
            with profiling.span("vast.test.inner"):
                time.sleep(0.002)
                with profiling.span("vast.test.leaf"):
                    time.sleep(0.001)
            with profiling.span("vast.test.inner"):
                time.sleep(0.001)
            outer.count("rows", 2)
            outer.count("rows")
    with profiling.span("vast.test.outer"):       # off again
        pass
    recorded = profiling.spans()
    assert [r["name"] for r in recorded] == [
        "vast.test.leaf", "vast.test.inner", "vast.test.inner",
        "vast.test.outer"]
    leaf, inner1, inner2, top = recorded
    assert top["parent"] is None and top["root"] == top["id"]
    assert inner1["parent"] == inner2["parent"] == top["id"]
    assert leaf["parent"] == inner1["id"]
    assert {r["root"] for r in recorded} == {top["id"]}
    assert top["counts"] == {"rows": 3}
    assert all(r["device_s"] is None for r in recorded)   # no CUDA here

    def ns(r):
        return r["end_ns"] - r["start_ns"]

    s = profiling.summary()
    assert s["vast.test.inner"]["count"] == 2
    assert s["vast.test.outer"]["counts"] == {"rows": 3}
    assert s["vast.test.outer"]["self_host_s"] == pytest.approx(
        (ns(top) - ns(inner1) - ns(inner2)) / 1e9, abs=1e-9)
    assert s["vast.test.inner"]["self_host_s"] == pytest.approx(
        (ns(inner1) - ns(leaf) + ns(inner2)) / 1e9, abs=1e-9)
    assert s["vast.test.leaf"]["self_host_s"] == pytest.approx(
        ns(leaf) / 1e9, abs=1e-9)
    assert s["vast.test.outer"]["host_s"] == pytest.approx(ns(top) / 1e9)


def test_spans_are_the_profilers_host_events():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("vast.test.outer"):
            with profiling.span("vast.test.inner"):
                torch.ones(8).add_(1)
    events = {e.name: e for e in prof.events()}
    assert {"vast.test.outer", "vast.test.inner"} <= set(events)
    recorded = _by_name(profiling.spans())
    assert recorded["vast.test.inner"]["parent"] == \
        recorded["vast.test.outer"]["id"]
    outer = events["vast.test.outer"].time_range
    inner = events["vast.test.inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end


def _ret_batches():
    rs = np.random.RandomState(4)
    batches = []
    for s in range(2):
        b = raw_batch(rs, b=3)
        b["ids"] = [f"clip{s}{i}" for i in range(3)]
        b["ids_txt"] = list(b["ids"])
        batches.append(b)
    return batches


def test_evaluate_ret_timings_and_spans(model):
    """``timings=`` fills the four stages with spans off and records
    nothing; under ``recording()`` the stages are the children of one
    ``vast.eval`` root."""
    run_cfg = {"itm_rerank_num": 2}
    timings = {}
    em.evaluate_ret(model, ["tva"], _ret_batches(), run_cfg, device="cpu",
                    timings=timings)
    assert set(timings) == {"condition_features", "text_features", "itc",
                            "itm_rerank"}
    assert all(v > 0 for v in timings.values())
    assert profiling.spans() == []
    with profiling.recording():
        em.evaluate_ret(model, ["tva"], _ret_batches(), run_cfg,
                        device="cpu")
    recorded = profiling.spans()
    root = recorded[-1]
    assert root["name"] == "vast.eval" and root["parent"] is None
    stages = [r["name"] for r in recorded if r["parent"] == root["id"]]
    assert stages == ["vast.eval.condition_features",
                      "vast.eval.text_features"] * 2 + [
        "vast.eval.itc", "vast.eval.itm_rerank"]
    rerank = _by_name(recorded)["vast.eval.itm_rerank"]["counts"]
    assert rerank["pairs"] == 6 * 2          # 6 captions x top 2


def test_train_step_phases(model):
    batch = dict(raw_batch(np.random.RandomState(3)),
                 itm_neg_cond_idx=np.array([[2, 0, 1]], np.int32),
                 itm_neg_text_idx=np.array([[1, 2, 0]], np.int32))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    run_cfg = {"learning_rate": 1e-4, "clip_lr": 1e-5, "betas": [0.9, 0.98],
               "weight_decay": 0.01, "scheduler": "warmup_linear",
               "warmup_ratio": 0.1}
    opt, _ = build_optimizer(model, run_cfg,
                             {"vision_encoder_type": "evaclip01_giant"}, 10)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, "ret%tva")
    with profiling.recording():
        step(state, batch, torch.Generator().manual_seed(0))
    recorded = [r for r in profiling.spans()
                if not r["name"].startswith("vast.gc.")]
    roots = [r for r in recorded if r["parent"] is None]
    assert [r["name"] for r in roots] == ["vast.train.step"]
    root = roots[0]
    children = sorted((r for r in recorded if r["parent"] == root["id"]),
                      key=lambda r: r["start_ns"])
    assert [r["name"] for r in children] == [
        "vast.train.forward", "vast.train.backward", "vast.train.optimizer"]
    assert all(r["root"] == root["id"] for r in recorded)
    for a, b in zip(children, children[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert root["start_ns"] <= children[0]["start_ns"]
    assert children[-1]["end_ns"] <= root["end_ns"]


def test_optimizer_span_counts_the_kernels_tensors_and_launches(model):
    """The optimizer's span counts what ``opt.last_counts`` says of each
    update: on the CPU no tensor of the kernel and no launch; summed over
    steps by ``summary``."""
    batch = dict(raw_batch(np.random.RandomState(3)),
                 itm_neg_cond_idx=np.array([[2, 0, 1]], np.int32),
                 itm_neg_text_idx=np.array([[1, 2, 0]], np.int32))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt, _ = build_optimizer(model, {"learning_rate": 1e-4}, {}, 10)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, "ret%tva")
    with profiling.recording():
        step(state, batch, torch.Generator().manual_seed(0))
    counts = _by_name(profiling.spans())["vast.train.optimizer"]["counts"]
    assert counts == {"tensors": 0, "launches": 0}
    plain_step = opt.step

    def step_as_on_the_card(**kw):
        applied = plain_step(**kw)
        opt.last_counts = {"tensors": len(opt.params), "launches": 1}
        return applied

    opt.step = step_as_on_the_card
    with profiling.recording():
        for _ in range(2):
            step(state, batch, torch.Generator().manual_seed(0))
    row = profiling.summary()["vast.train.optimizer"]
    assert row["count"] == 3
    assert row["counts"] == {"tensors": 2 * len(opt.params), "launches": 2}


class _GroupedScores:
    """A model whose grouped ITM call scores 0 and keeps each call's
    text rows."""

    def __init__(self):
        self.rows = []

    def compute_slice_scores_grouped(self, cond, ids, mask):
        self.rows.append(ids.shape[0])
        return torch.zeros(ids.shape[0])


def test_rerank_counts_pairs_rows_and_calls():
    """Five texts' ITC top 2 over three candidates: candidate 0 takes
    texts 0-3, candidate 1 texts 0, 1 and 4, candidate 2 texts 2-4. Two
    candidates a call: (0, 1) padded to 4 rows each, then 2 alone: 11
    rows, 10 pairs, 2 calls."""
    itc = np.array([[3, 2, 0], [3, 2, 0], [3, 0, 2], [3, 0, 2], [0, 3, 2]],
                   np.float32)
    m = _GroupedScores()
    cond = torch.zeros(3, 4, 8)
    ids = np.arange(5 * 6, dtype=np.int64).reshape(5, 6)
    timings = {}
    with profiling.recording():
        em.rerank_scores(m, cond, ids, np.ones_like(ids), itc, 2,
                         conds_per_call=2, timings=timings)
    (sp,) = profiling.spans()
    assert sp["name"] == "vast.eval.itm_rerank"
    assert sp["counts"] == {"pairs": 10, "rows": 11, "calls": 2}
    assert m.rows == [8, 3] and set(timings) == {"itm_rerank"}


def test_gc_spans_under_recording():
    gc.collect()                                  # off: nothing recorded
    assert profiling.spans() == []
    with profiling.recording():
        with profiling.span("vast.test.parent"):
            gc.collect()
    recorded = profiling.spans()
    gcs = [r for r in recorded if r["name"] == "vast.gc.gen2"]
    assert gcs and gcs[0]["device_s"] is None
    top = _by_name(recorded)["vast.test.parent"]
    assert gcs[0]["parent"] == top["id"]
    assert top["start_ns"] <= gcs[0]["start_ns"] <= gcs[0]["end_ns"] \
        <= top["end_ns"]
