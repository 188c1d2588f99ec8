"""Where a checkpoint save's time goes, on the card.

The state is the one ``chip_smoke.py``'s CLI phases save: the released
retrieval-msrvtt.json model (EVA01-g, BEATs, BERT-base; fp32 parameters,
random seeded weights) and its AdamW moments in fp32, as
``training/saver.py`` writes them (``model_step_N.pt``, the model's state
dict; ``optimizer_step_N.pt``, the step and the optimizer's state). Each
measurement prints one JSON line, after the card's ``nvidia-smi`` name
and power limit:

  saver     - ``ModelSaver.save`` as the CLI calls it (``torch.save`` of
              the CUDA tensors to a temporary file, its device-to-host
              copies through pinned memory, renamed), both files, twice
              (the pinned blocks are the host allocator's from the first);
  variants  - ``torch.save`` of the CUDA tensors to the file with
              ``torch.save``'s defaults (each copy to fresh pageable
              memory), with pinned copies and no CRC32, and of a host
              copy made before, each twice;
  d2h       - the state's device-to-host copies: ``.cpu()`` of every
              tensor (pageable memory), and into pinned host memory
              (its allocation timed apart, the copies issued without a
              wait and synchronised once);
  serialize - ``torch.save`` of the host copy into an ``io.BytesIO``;
  disk      - those bytes written to a file in a new directory under
              each ``--dir`` (default: the temporary directory, where the
              CLI phases write; give it again for another file system,
              such as a tmpfs), its ``fsync`` apart;
  (the host copies and their bytes are freed between measurements).
``saver`` and ``variants`` write in the directory made under the first
``--dir``; every directory the script makes is removed at the end.

    python3 vast_tpu_torch/scripts/bench_save.py [--dir DIR ...]

Seconds are host wall times (each device copy synchronised). Needs a
CUDA GPU; it refuses to run without one.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
from torch.utils.serialization import config as serialization_config

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def emit(obj):
    print(json.dumps(obj), flush=True)


def tensors(tree):
    """Every tensor of a nested dict / list, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return []


def tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def cli_state():
    """(TrainState, the two files' trees) of the released retrieval
    config at full depth on the GPU."""
    from vast_tpu_torch.config import get_args
    from vast_tpu_torch.training import pipeline
    from vast_tpu_torch.training.optimizer import build_optimizer
    from vast_tpu_torch.training.step import create_train_state

    cfg = os.path.join(ROOT, "vast_tpu", "configs", "finetune_cfg",
                       "retrieval-msrvtt.json")
    opts = get_args(["--config", cfg])
    model = pipeline.build_model(opts, "cuda")
    pipeline.init_params(model, opts)
    opt, _ = build_optimizer(model, opts.run_cfg, opts.model_cfg, 100)
    state = create_train_state(model, opt)
    files = {"model": model.state_dict(),
             "optimizer": {"step": 0, "optimizer": opt.state_dict()}}
    return state, files


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def write(data: bytes, path: str):
    """(seconds to write, seconds to fsync)."""
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        f.write(data)
        t1 = time.perf_counter()
        f.flush()
        os.fsync(f.fileno())
    t2 = time.perf_counter()
    os.remove(path)
    return t1 - t0, t2 - t1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dir", action="append",
                   help="where to write (repeatable; default: the "
                        "temporary directory)")
    args = p.parse_args(argv)
    dirs = args.dir or [tempfile.gettempdir()]
    if not torch.cuda.is_available():
        print("bench_save: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from vast_tpu_torch.training.saver import ModelSaver

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    state, files = cli_state()
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "tensors": {k: len(tensors(v)) for k, v in files.items()},
          "bytes": {k: sum(t.numel() * t.element_size() for t in tensors(v))
                    for k, v in files.items()}})
    works = [tempfile.mkdtemp(prefix="bench_save_", dir=d) for d in dirs]
    work = works[0]
    try:
        saver = ModelSaver(work)
        for i in range(2):
            _, s = timed(lambda: saver.save(state, 1))
            emit({"phase": "saver", "run": i, "seconds": s, "dir": work,
                  "bytes": {k: os.path.getsize(saver.path(k, 1))
                            for k in ("model", "optimizer")}})
            for k in ("model", "optimizer"):
                os.remove(saver.path(k, 1))

        def save_files(tree, **options):
            with serialization_config.patch(
                    {f"save.{k}": v for k, v in options.items()}):
                for name, part in tree.items():
                    path = os.path.join(work, f"{name}.pt")
                    torch.save(part, path)
                    os.remove(path)

        cpu_copy = None
        for label, options in (
                ("defaults", {"use_pinned_memory_for_d2h": False}),
                ("pinned_no_crc32", {"use_pinned_memory_for_d2h": True,
                                     "compute_crc32": False}),
                ("host_copy_first", {})):
            if label == "host_copy_first":
                cpu_copy = tree_map(lambda t: t.cpu(), files)
            for i in range(2):
                _, s = timed(lambda: save_files(cpu_copy or files,
                                                **options))
                emit({"phase": "variants", "variant": label, "run": i,
                      "seconds": s})
        del cpu_copy

        host, s = timed(lambda: tree_map(lambda t: t.cpu(), files))
        emit({"phase": "d2h", "memory": "pageable", "seconds": s})
        del host
        pinned, alloc_s = timed(lambda: tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True),
            files))
        _, copy_s = timed(lambda: [d.copy_(t, non_blocking=True) for d, t in
                                   zip(tensors(pinned), tensors(files))])
        emit({"phase": "d2h", "memory": "pinned", "alloc_seconds": alloc_s,
              "copy_seconds": copy_s})

        blobs = {}
        for name, tree in pinned.items():
            buf = io.BytesIO()
            _, s = timed(lambda: torch.save(tree, buf))
            blobs[name] = buf.getvalue()
            emit({"phase": "serialize", "file": name, "seconds": s,
                  "bytes": len(blobs[name])})
        del pinned
        need = sum(len(b) for b in blobs.values())
        for where in works:
            free = shutil.disk_usage(where).free
            if free < 1.2 * need:
                emit({"phase": "disk", "target": where, "skipped":
                      f"{free} bytes free, {need} needed"})
                continue
            for name, data in blobs.items():
                w, f = write(data, os.path.join(where, f"{name}.bin"))
                emit({"phase": "disk", "target": where, "file": name,
                      "write_seconds": w, "fsync_seconds": f,
                      "bytes": len(data)})
        del blobs
    finally:
        for where in works:
            shutil.rmtree(where, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
