"""Run one cell of the benchmark of ``vast_tpu_torch`` on this machine's
card:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``benchmark/cells/<cell>.json``) names its configuration and
traffic mix; the mix names the runner that runs it. The run builds the
program's model from the seed, warms up every shape it will use, runs
the window for ``--seconds``, then checks what the window's path
produced against the plain fp32 reference. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``, the
metrics (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), the device, with ``--trace 1`` the trace's
``breakdown``, and last the numbers compared with their limits, which
also end standard error.

    python benchmark/run.py --workload <cell> --seed <n> --seconds 0 \
        --calibrate <k> [--controls <j>] [--out <file>]

reads, instead of a run, what the cell's correctness limits are set
from, at the cell's own size: for each of the seeds n, n + 1, ...,
n + k - 1 the program's compared numbers after the same set-up as a
run's and no window, and for the first j of them also the control's and
each fault's (the runner's ``calibrate``). One JSON line a reading, on
standard output and appended to ``--out``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", "_cache")
HOST_THREADS = 4


def _fixed_caches() -> None:
    """Every compiler cache at a fixed place inside the checkout, no
    library asked to load JAX, and few host threads: one process, whose
    host work is its main thread's."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", type=int, default=0)
    p.add_argument("--controls", type=int, default=0)
    p.add_argument("--out", default="")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _fixed_caches()
    sys.path.insert(0, ROOT)
    from benchmark import harness, spec

    try:
        cell = spec.load_cell(args.workload)
        bench = spec.benchmark_json(ROOT)
    except (spec.SpecError, FileNotFoundError) as exc:
        harness.log(f"error: {exc}")
        return 2
    e2e, layer = spec.cell_metrics(args.workload, bench)

    import torch

    torch.set_num_threads(HOST_THREADS)
    chips = cell.get("chips", 1)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        harness.log(f"error: the cell needs {chips} CUDA card(s); {cards} "
                    f"available")
        return 3
    try:
        import vast_tpu_torch  # noqa: F401
    except ImportError as exc:
        harness.log(f"error: the program vast_tpu_torch is missing: {exc}")
        return 4
    runner = importlib.import_module(
        f"benchmark.runners.{cell['traffic_spec']['runner']}")
    if args.calibrate:
        return calibrate(runner, cell, args, harness)
    ctx = harness.Ctx(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace),
                      device=torch.device("cuda", 0), t_start=T_START)
    out = runner.run(ctx)
    return finish(out, e2e, layer, args.trace, harness, spec)


def calibrate(runner, cell, args, harness) -> int:
    """The readings of ``--calibrate``: one JSON line each."""
    import torch

    out = open(args.out, "a") if args.out else None
    for i in range(args.calibrate):
        seed = args.seed + i
        ctx = harness.Ctx(cell=cell, seed=seed, seconds=0.0, trace=False,
                          device=torch.device("cuda", 0),
                          t_start=time.perf_counter())
        for row in runner.calibrate(ctx, i < args.controls):
            row |= {"workload": cell["name"], "seed": seed,
                    "seconds": time.perf_counter() - ctx.t_start}
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


def finish(out: dict, e2e, layer, trace: int, harness, spec) -> int:
    """Print the result line from a runner's output."""
    found = harness.forbidden_modules()
    if found:
        harness.log(f"error: JAX modules loaded in this process: {found}")
        return 5
    metrics = {}
    if trace:
        for m in layer:
            value = spec.metric_reader(m["name"])(out["obs"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    checks = out["checks"]
    correct = bool(checks) and all(
        c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks.values())
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": out["device"]}
    if trace:
        s = out["obs"]["trace"]
        line["device"] = dict(line["device"], busy_s=s["busy_s"],
                              window_s=s["wall_s"])
        line["breakdown"] = {"device_ops": s["device_ops"],
                             "idle_gaps": s["idle_gaps"]}
    line["checks"] = checks
    for name, c in checks.items():
        harness.log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
