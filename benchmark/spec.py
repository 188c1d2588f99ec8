"""Finding the pieces of a cell by name.

A cell (``cells/<name>.json``) names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``) and holds the limits of its
correctness check. ``BENCHMARK.json`` at the checkout's root says which
end-to-end and per-layer metrics the cell reports; each per-layer metric
is read by ``metrics/<metric name>.py``. Adding a cell, a mix or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class SpecError(ValueError):
    """A name that no file of the benchmark defines."""


def _load(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, name + ".json")
    if not os.path.isfile(path):
        raise SpecError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell with its configuration and traffic mix resolved."""
    cell = _load("cells", name)
    cell["name"] = name
    cell["config_spec"] = _load("configs", cell["config"])
    cell["traffic_spec"] = _load("traffic", cell["traffic"])
    return cell


def benchmark_json(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(cell: str, bench: dict) -> tuple[list, list]:
    """(end-to-end entries, per-layer entries) that ``cell`` reports: an
    entry without ``workloads`` is reported wherever its end-to-end
    metric (``moves``) is."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def metric_reader(name: str):
    """The ``read(obs)`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.isfile(path):
        raise SpecError(f"no reader for metric {name!r} ({path})")
    mod_name = "benchmark_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
