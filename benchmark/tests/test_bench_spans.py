"""The span readers (``metrics/_spans.py`` and the seven metrics over
the program's spans): nothing without a trace or for another kind of
run, and their values from a recorder filled by hand."""

import pytest

from benchmark import spec

TRAIN = ("fwd_ms.train", "bwd_ms.train", "opt_ms.train", "gc_ms.train")
EVAL = ("cond_ms.eval", "rerank_ms.eval", "rerank_pad_share.eval")
TRACE = {"wall_s": 1.0, "busy_s": 0.5}


def _span(i, name, parent, start, end, device_s=None, root=1, **counts):
    return {"name": name, "id": i, "parent": parent, "root": root,
            "start_ns": int(start * 1e9), "end_ns": int(end * 1e9),
            "host_s": end - start, "device_s": device_s, "counts": counts}


def _train_spans():
    out, i = [], 0
    for k, (fwd, bwd, opt) in enumerate([(0.10, 0.20, 0.05),
                                         (0.12, 0.22, 0.07),
                                         (0.30, 0.40, 0.09)]):
        t0, root = 10.0 * k, i + 1
        out += [_span(root + 1, "vast.train.forward", root, t0, t0 + 1, fwd,
                      root),
                _span(root + 2, "vast.train.backward", root, t0 + 1, t0 + 2,
                      bwd, root),
                _span(root + 3, "vast.gc.gen0", root + 2, t0 + 1.5,
                      t0 + 1.503, None, root),
                _span(root + 4, "vast.train.optimizer", root, t0 + 2, t0 + 3,
                      opt, root),
                _span(root, "vast.train.step", None, t0, t0 + 3, 3.0, root)]
        i = root + 4
    # a collection after the traced steps is not theirs
    out.append(_span(i + 1, "vast.gc.gen2", None, 40.0, 40.2, None, i + 1))
    return out


def _eval_spans():
    cond = [_span(k + 2, "vast.eval.condition_features", 1, k, k + 0.5,
                  0.25) for k in range(4)]
    rerank = [_span(7, "vast.eval.itm_rerank", 1, 5, 6, 0.8, pairs=90,
                    rows=100, calls=3),
              _span(8, "vast.eval.itm_rerank", 1, 6, 7, 0.2, pairs=30,
                    rows=50, calls=1)]
    return cond + rerank + [_span(1, "vast.eval", None, 0, 8, 7.5)]


@pytest.fixture
def recorder(monkeypatch):
    from vast_tpu_torch import profiling

    def fill(spans):
        monkeypatch.setattr(profiling, "spans", lambda: spans)
    return fill


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_nothing_without_a_trace_or_of_another_kind(name, recorder):
    recorder(_train_spans() + _eval_spans())
    read = spec.metric_reader(name)
    kind = "train" if name in TRAIN else "eval"
    other = "eval" if kind == "train" else "train"
    assert read({"kind": kind}) is None
    assert read({"kind": other, "trace": TRACE}) is None
    assert read({"kind": kind, "trace": TRACE}) is not None


def test_nothing_from_an_empty_recorder(recorder):
    recorder([])
    for name in TRAIN + EVAL:
        kind = "train" if name in TRAIN else "eval"
        assert spec.metric_reader(name)({"kind": kind, "trace": TRACE}) \
            is None


def test_train_values(recorder):
    recorder(_train_spans())
    obs = {"kind": "train", "trace": TRACE}

    def read(name):
        return spec.metric_reader(name)(obs)

    assert read("fwd_ms.train") == pytest.approx(120.0)
    assert read("bwd_ms.train") == pytest.approx(220.0)
    assert read("opt_ms.train") == pytest.approx(70.0)
    assert read("gc_ms.train") == pytest.approx(3.0, rel=1e-6)


def test_eval_values(recorder):
    recorder(_eval_spans())
    obs = {"kind": "eval", "trace": TRACE}

    def read(name):
        return spec.metric_reader(name)(obs)

    assert read("cond_ms.eval") == pytest.approx(1000.0)
    assert read("rerank_ms.eval") == pytest.approx(1000.0)
    assert read("rerank_pad_share.eval") == pytest.approx(20.0)


def test_device_time_missing_reads_nothing(recorder):
    spans = _train_spans()
    spans[0]["device_s"] = None                  # a forward without events
    recorder(spans)
    obs = {"kind": "train", "trace": TRACE}
    assert spec.metric_reader("fwd_ms.train")(obs) is None
    assert spec.metric_reader("bwd_ms.train")(obs) == pytest.approx(220.0)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The parent program's ``profiling`` has no ``spans``."""
    from vast_tpu_torch import profiling

    monkeypatch.delattr(profiling, "spans")
    for name in TRAIN + EVAL:
        kind = "train" if name in TRAIN else "eval"
        assert spec.metric_reader(name)({"kind": kind, "trace": TRACE}) \
            is None
