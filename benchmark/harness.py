"""What every runner shares: the run's context, the program's model
built from a configuration file, the device's description, and the
check that no JAX module was loaded."""

from __future__ import annotations

import dataclasses
import gc
import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vast_tpu")


@dataclasses.dataclass
class Ctx:
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float              # the process's start, perf_counter

    @property
    def cfg(self) -> dict:
        return self.cell["config_spec"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic_spec"]

    @property
    def limits(self) -> dict:
        return self.cell["limits"]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def program_config(cfg: dict, dtype, param_dtype=None, remat=None):
    """The program's ``VASTConfig`` with every tower's sizes from ``cfg``.
    ``remat``: an activation-checkpointing policy for every tower, or
    None for the configuration's own."""
    from vast_tpu_torch.models.vast import VASTConfig

    remat = remat if remat is not None else cfg.get("remat_policy")
    m = {k: cfg[k] for k in ("vision_encoder_type", "audio_encoder_type",
                             "vision_resolution", "audio_melbins",
                             "audio_target_length", "contra_dim",
                             "itm_ratio", "max_vision_sample_num",
                             "max_caption_len", "beam_size")}
    towers = {}
    for key, sub in (("vision_cfg", "vision"), ("audio_cfg", "audio"),
                     ("bert_cfg", "bert")):
        towers[key] = dict(cfg[sub])
        if remat:
            towers[key].update(remat=True, remat_policy=remat)
    return VASTConfig.from_model_cfg(m | towers, dtype=dtype,
                                     param_dtype=param_dtype)


def build_program(cfg: dict, device, dtype, param_dtype=None, remat=None):
    from vast_tpu_torch.models.vast import VASTModel

    return VASTModel(program_config(cfg, dtype, param_dtype, remat),
                     device=device)


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference_backends(device) -> None:
    """fp32 products stay fp32 in the reference: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
