"""The harness finds every piece of a cell by name."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness, run, spec

ROOT = spec.ROOT


def _bench():
    return spec.benchmark_json(ROOT)


def test_reads_every_cell():
    bench = _bench()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"]
        assert cell["traffic_spec"]["runner"]
        assert cell["limits"] and all(v > 0 for v in cell["limits"].values())


def test_unknown_cell_fails():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no_such_cell")
    assert run.main(["--workload", "no_such_cell", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2


def test_no_card_no_result(capsys):
    """Without a CUDA card a run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    name = _bench()["workloads"][0]["name"]
    rc = run.main(["--workload", name, "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_every_metric_has_its_reader_and_cells():
    bench = _bench()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        e, layer = spec.cell_metrics(w, bench)
        names = {m["name"] for m in e}
        assert "setup_s" in names and len(names) >= 2
        assert layer


def test_readers_return_nothing_without_observations():
    for m in _bench()["per_layer"]:
        assert spec.metric_reader(m["name"])({"kind": "none"}) is None


def test_config_files_match_benchmark_json():
    for c in _bench()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_paths_hold_no_jax_imports():
    """No module under the benchmark imports JAX or the JAX package, by
    whole top-level name; the reference imports nothing of the program
    either."""
    forbidden = {"jax", "jaxlib", "flax", "optax", "orbax", "vast_tpu"}
    here = os.path.join(ROOT, "benchmark")
    for dirpath, _, files in os.walk(here):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            tops = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops |= {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.module \
                        and not node.level:
                    tops.add(node.module.split(".")[0])
            assert not tops & forbidden, (path, tops & forbidden)
            if os.sep + "reference" + os.sep in path:
                assert "vast_tpu_torch" not in tops, path


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 1, 2300456122])
def test_itm_pairs_are_a_fixed_number(seed):
    """A few clips take most captions' ITC top k, as they do under the
    seeded weights: the check still compares the same number of reranked
    pairs on every seed, each among its caption's top k."""
    from benchmark.runners import ret_eval

    cell = spec.load_cell("clipl_ret_eval")
    tr = cell["traffic_spec"]
    n = tr["clips"]
    rng = np.random.default_rng(seed)
    itc = (3 * rng.normal(size=n)[None] + 0.3 * rng.normal(size=(n, n))
           ).astype(np.float32)
    ctx = harness.Ctx(cell=cell, seed=seed, seconds=0.0, trace=False,
                      device=torch.device("cpu"), t_start=0.0)
    clips, cols = ret_eval.itm_pairs(ctx, itc)
    top = np.argsort(-itc, axis=1)[:, :tr["itm_rerank_num"]]
    assert len(clips) == len(set(clips)) == tr["itm_checked_clips"]
    for c, rows in zip(clips, cols):
        assert len(rows) == tr["itm_checked_texts"]
        assert all(c in top[r] for r in rows)
    again = ret_eval.itm_pairs(ctx, itc)
    assert again[0] == clips
    assert all((a == b).all() for a, b in zip(again[1], cols))
