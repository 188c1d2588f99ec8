"""Where the port's CUDA kernels spill registers, on the card's machine.

ptxas reports each kernel's spilled bytes (``chip_smoke.py``'s build
phase prints them); this script says in whose code the spilled stores
and loads (STL, LDL in the SASS) lie. The Hopper kernels split their
threads with ``setmaxnreg``: the producer warpgroup gives registers up
(``USETMAXREG.DEALLOC``), the consumers take them
(``USETMAXREG.TRYALLOC``). Each STL or LDL is counted by the last
USETMAXREG before it in the code's layout: "producer", "consumers", or
"before_split" (no USETMAXREG before it, as in kernels without the
split). The layout follows the control flow closely but need not, so
read a count as where the compiler placed the code.

    python3 vast_tpu_torch/scripts/sass_spills.py [WORD ...]

builds csrc/flash_attention.cu if needed, disassembles it with the CUDA
toolkit's ``cuobjdump`` and prints one JSON line a kernel: every kernel
that spills, or with WORDs, every kernel whose name holds one of them.
It needs ``nvcc`` and ``cuobjdump``, not a GPU.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit")


def local_by_role(sass: str):
    """{kernel name: (instructions, {role: STL and LDL count})} of
    ``cuobjdump -sass`` output."""
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = chunk.split("\n", 1)
        role, n, counts = "before_split", 0, {}
        for line in body.splitlines():
            if not re.search(r"/\*[0-9a-f]{4,}\*/", line):
                continue
            n += 1
            if "USETMAXREG.DEALLOC" in line:
                role = "producer"
            elif "USETMAXREG" in line:
                role = "consumers"
            elif re.search(r"\b(STL|LDL)(\.[A-Z0-9]+)*\s", line):
                counts[role] = counts.get(role, 0) + 1
        out[name.strip()] = (n, counts)
    return out


def main(argv=None):
    words = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, ROOT)
    from vast_tpu_torch import build

    build.build("flash_attention")
    sass = subprocess.run([_cuobjdump(), "-sass",
                           build._target("flash_attention")],
                          capture_output=True, text=True, check=True).stdout
    for name, (n, counts) in sorted(local_by_role(sass).items()):
        if any(w in name for w in words) if words else counts:
            print(json.dumps({"kernel": name, "instructions": n,
                              "local_memory_ops": counts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
