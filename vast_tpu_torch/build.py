"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` (the hash covers
the source, the flags and any macros defined, so an edited source
rebuilds; a benchmark may build a variant beside it with ``defines``),
then loaded with ctypes. Nothing here runs at import time: the package imports on a
machine without ``nvcc`` or a GPU, and only a CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def build(name: str, defines=()) -> str:
    """Compile ``csrc/<name>.cu``, with the macros ``defines`` ("NAME=value"
    each), unless it is built already.

    Returns the compiler's output (``-Xptxas -v`` prints registers, shared
    memory and spills per kernel), or "" when nothing was compiled. Raises
    if the compile fails.
    """
    target = _target(name, defines)
    if os.path.exists(target):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *_flags(defines), "-o", tmp,
                           os.path.join(CSRC, name + ".cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, target)
    return proc.stdout


def load(name: str, defines=()) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu`` (with ``defines``), built
    if needed."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        build(name, defines)
        lib = _loaded[key] = ctypes.CDLL(_target(name, defines))
    return lib
