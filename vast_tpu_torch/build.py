"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` (the hash covers
the source, the flags and any macros defined, so an edited source
rebuilds; a benchmark may build a variant beside it with ``defines``),
then loaded with ctypes. A source whose entry points are grouped by
``VAST_PART_ON(k)`` is compiled once a part, all parts at once (one
``nvcc`` each, ``-DVAST_PART=k``: each instantiates only the kernels of
its own entries), and the objects are linked into the one library.
Nothing here runs at import time: the package imports on a machine
without ``nvcc`` or a GPU, and only a CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _flags(defines) -> tuple:
    return NVCC_FLAGS + tuple("-D" + d for d in defines)


def _target(name: str, defines=()) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()
                                + " ".join(_flags(defines)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _parts(name: str) -> int:
    """How many parts ``csrc/<name>.cu`` is compiled in: one more than
    the highest ``k`` of its ``VAST_PART_ON(k)`` guards; 1 without any."""
    with open(os.path.join(CSRC, name + ".cu")) as f:
        ks = [int(k) for k in re.findall(r"VAST_PART_ON\((\d+)\)", f.read())]
    return max(ks, default=0) + 1


def build(name: str, defines=()) -> str:
    """Compile ``csrc/<name>.cu``, with the macros ``defines`` ("NAME=value"
    each), unless it is built already: its parts in parallel, then one
    link.

    Returns the compiler's output (``-Xptxas -v`` prints registers, shared
    memory and spills per kernel), or "" when nothing was compiled. Raises
    if the compile fails.
    """
    target = _target(name, defines)
    if os.path.exists(target):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        src = os.path.join(CSRC, name + ".cu")
        flags = [f for f in _flags(defines) if f != "-shared"]
        objs = [os.path.join(work, f"part{k}.o")
                for k in range(_parts(name))]
        procs = [subprocess.Popen([nvcc, *flags, f"-DVAST_PART={k}", "-c",
                                   "-o", obj, src], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for k, obj in enumerate(objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [k for k, p in enumerate(procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed for {name} part {failed[0]}:\n"
                               f"{logs[failed[0]]}")
        tmp = os.path.join(work, name + ".so")
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed to link {name}:\n{proc.stdout}")
        os.replace(tmp, target)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return "".join(logs) + proc.stdout


def load(name: str, defines=()) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu`` (with ``defines``), built
    if needed."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        build(name, defines)
        lib = _loaded[key] = ctypes.CDLL(_target(name, defines))
    return lib
