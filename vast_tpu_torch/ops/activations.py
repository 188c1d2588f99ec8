"""GELU as ``vast_tpu.ops.activations`` picks it.

Exact erf in fp32 (torch nn.GELU parity on the eval and parity paths),
tanh approximation in bf16, where the two differ by less than bf16
rounding. ``approximate`` overrides the dtype rule (the ITM head is
exact in every dtype, as in ``vast_tpu``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor, approximate: bool | None = None) -> torch.Tensor:
    if approximate is None:
        approximate = x.dtype == torch.bfloat16
    return F.gelu(x, approximate="tanh" if approximate else "none")
