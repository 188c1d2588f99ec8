"""Device resolution for the port's entry points.

``None`` means the GPU. A CUDA request on a machine without a usable GPU
raises instead of carrying on on the CPU; the CPU is used only when the
caller asks for it by name (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vast_tpu_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
