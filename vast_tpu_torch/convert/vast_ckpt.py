"""Reference-layout VAST checkpoints into the port: loading and surgery.

The part of ``vast_tpu.convert.vast_ckpt`` a torch port needs. The port's
modules carry the reference's state-dict names, so a checkpoint loads
with no key conversion, after the reference's surgery
(utils/build_model.py:19-61, general_module.py:110-190):

* ``load_torch_state_dict``: ``torch.load`` a ``.pt`` / ``.bin``, descend
  into a ``model`` sub-key, strip DDP's ``module.`` prefixes;
* ``find_pretrain_checkpoint``: the newest ``checkpoint-N/
  pytorch_model*.bin`` (one file or two shards) of a pretrain dir, else
  its newest ``ckpt/model_step_N.pt`` (what ``training.saver`` writes);
* ``rename_keys``: video -> vision, evaclip_model / clip_model ->
  vision_encoder;
* ``fit_to_model``: a frame embedding is resampled (nearest) to the
  model's sample count, a ViT position embedding (bilinear, the weights
  of ``jax.image.resize`` from ``ops/image.py``) to the model's patch
  grid; any other shape that differs raises, naming the key.

Only tensors are unpickled (``weights_only``).
"""

from __future__ import annotations

import os
import re

import torch

from vast_tpu_torch.logger import LOGGER
from vast_tpu_torch.ops.image import _resize_weights

POS_EMBED_KEYS = ("vision_encoder.visual.pos_embed",             # EVA
                  "vision_encoder.visual.positional_embedding")  # CLIP


def rename_keys(sd: dict) -> dict:
    """modify_checkpoint's renames (general_module.py:113-124)."""
    out = {}
    for k, v in sd.items():
        k = k.replace("video", "vision")
        if "evaclip_model" in k:
            k = k.replace("evaclip_model", "vision_encoder")
        elif "clip_model" in k:
            k = k.replace("clip_model", "vision_encoder")
        out[k] = v
    return out


def interp_frame_embedding(embed: torch.Tensor, n: int) -> torch.Tensor:
    """(1, N, D) -> (1, n, D), nearest (general_module.py:129-145)."""
    src = embed.shape[1]
    if src == n:
        return embed
    return embed[:, [i * src // n for i in range(n)]]


def interp_pos_embed(pos: torch.Tensor, new_grid: int) -> torch.Tensor:
    """(P+1, D), the CLS row then a square grid, -> the grid resized to
    ``new_grid`` bilinearly (general_module.py:147-181)."""
    cls_tok, rest = pos[:1], pos[1:]
    grid = round(rest.shape[0] ** 0.5)
    if grid == new_grid:
        return pos
    w = torch.from_numpy(_resize_weights(grid, new_grid))
    rest = rest.float().reshape(grid, grid, -1)
    rest = torch.einsum("hwd,hH,wW->HWd", rest, w, w)
    return torch.cat([cls_tok.float(), rest.reshape(new_grid ** 2, -1)]
                     ).to(pos.dtype)


def load_torch_state_dict(path: str) -> dict:
    """``torch.load`` a checkpoint onto the CPU: its ``model`` sub-dict if
    it has one, ``module.`` prefixes removed (build_model.py:40-46)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict):
        ckpt = ckpt["model"]
    return {k.replace("module.", ""): v for k, v in ckpt.items()}


def find_pretrain_checkpoint(pretrain_dir: str) -> list[str]:
    """The newest weight file(s) under a pretrain or training output dir,
    in the reference's order (build_model.py:65-103)."""
    steps = [int(m.group(1)) for name in os.listdir(pretrain_dir)
             if (m := re.fullmatch(r"checkpoint-(\d+)", name))
             and os.path.isdir(os.path.join(pretrain_dir, name))]
    if steps:
        cdir = os.path.join(pretrain_dir, f"checkpoint-{max(steps)}")
        single = os.path.join(cdir, "pytorch_model.bin")
        if os.path.exists(single):
            return [single]
        shards = [os.path.join(cdir, f"pytorch_model-{i:05d}-of-00002.bin")
                  for i in (1, 2)]
        if all(os.path.exists(s) for s in shards):
            return shards
    ckpt_dir = os.path.join(pretrain_dir, "ckpt")
    if os.path.isdir(ckpt_dir):
        steps = [int(m.group(1)) for name in os.listdir(ckpt_dir)
                 if (m := re.fullmatch(r"model_step_(\d+)\.pt", name))]
        if steps:
            return [os.path.join(ckpt_dir, f"model_step_{max(steps)}.pt")]
    raise FileNotFoundError(
        f"no checkpoint-N/pytorch_model*.bin or ckpt/model_step_N.pt "
        f"under {pretrain_dir}")


def fit_to_model(sd: dict, model: torch.nn.Module) -> dict:
    """Renames, then the frame- and position-embedding surgery to
    ``model``'s shapes; raises for any other tensor whose shape differs."""
    sd = rename_keys(sd)
    want = model.state_dict()
    out = {}
    for k, v in sd.items():
        if k not in want or tuple(v.shape) == tuple(want[k].shape):
            out[k] = v
        elif k.endswith("frame_embedding"):
            out[k] = interp_frame_embedding(v, want[k].shape[1])
        elif k in POS_EMBED_KEYS:
            grid = round((want[k].shape[-2] - 1) ** 0.5)
            pos = interp_pos_embed(v.reshape(v.shape[-2:]), grid)
            out[k] = pos.reshape(want[k].shape)
        else:
            raise ValueError(f"checkpoint tensor {k} has shape "
                             f"{tuple(v.shape)}, the model "
                             f"{tuple(want[k].shape)}")
    return out


def load_checkpoint(model: torch.nn.Module, path: str):
    """Load a ``.pt`` / ``.bin`` file, or the newest checkpoint of a
    pretrain or training output dir, into ``model`` after the surgery.
    Like the reference (build_model.py:50-56) the load is not strict:
    missing and unexpected keys are logged. Returns ``load_state_dict``'s
    (missing, unexpected)."""
    paths = find_pretrain_checkpoint(path) if os.path.isdir(path) \
        else [path]
    sd: dict = {}
    for p in paths:          # two shards merge by update (build_model.py:79)
        sd.update(load_torch_state_dict(p))
    result = model.load_state_dict(fit_to_model(sd, model), strict=False)
    LOGGER.info("loaded %s (missing %d keys, unexpected %d)", paths,
                len(result.missing_keys), len(result.unexpected_keys))
    if result.missing_keys:
        LOGGER.warning("not in the checkpoint: %s", result.missing_keys)
    if result.unexpected_keys:
        LOGGER.warning("not in the model: %s", result.unexpected_keys)
    return result
