"""Checkpoints in the reference's torch layout.

Counterpart of ``vast_tpu.training.saver`` (the reference's utils/save.py
and build_model.py:106-124), which saves orbax; the port writes what the
reference writes under ``<output_dir>/ckpt``:

* ``model_step_N.pt``: the model's state dict (reference names), which
  ``convert.vast_ckpt.load_checkpoint`` and ``vast_tpu``'s
  ``ingest_torch_checkpoint`` read;
* ``optimizer_step_N.pt``: the train step count and the optimizer's
  state (``GroupedAdam.state_dict``: moments in their dtype, update count,
  accumulation window).

Each save replaces the previous pair unless ``remove_before_ckpt`` is
false, and with ``save_best`` copies the model file to
``best_<metric>.pt`` for each metric at its best. Files are written under
a temporary name and renamed, so a cut run leaves no partial checkpoint.
In a data-parallel run rank 0 alone writes (the bare module's state, the
same on every rank) while the others wait at a barrier, and every rank
restores. A sharded state (``training.step.shard_state``) writes the
same files as an unsharded one: every rank joins the gathers of the
whole tensors (reference names and shapes, the packed q/k/v weights of
EVA01, CLIP, Swin and VideoSwin in reference row order: q of every head,
then k, then v), rank 0 writes them; a restore splits them again.
"""

from __future__ import annotations

import os
import re
import shutil

import torch
from torch.utils.serialization import config as serialization_config

from vast_tpu_torch import parallel
from vast_tpu_torch.logger import LOGGER


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    # each storage's device-to-host copy goes through pinned memory, which
    # the host allocator keeps for the next: a save of the CLI's 4.99 +
    # 9.98 GB of CUDA tensors took 16.2-16.5 s with pageable copies (a
    # fresh allocation every storage) and 9.0-9.3 s so, on the H100's
    # host (PERF.md; vast_tpu_torch/scripts/bench_save.py)
    with serialization_config.patch(
            {"save.use_pinned_memory_for_d2h": True}):
        torch.save(obj, tmp)
    os.replace(tmp, path)


class ModelSaver:
    def __init__(self, output_dir: str, remove_before_ckpt: bool = True):
        self.ckpt_dir = os.path.abspath(os.path.join(output_dir, "ckpt"))
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.remove_before_ckpt = remove_before_ckpt

    def path(self, kind: str, step: int) -> str:
        """``kind`` is ``model`` or ``optimizer``."""
        return os.path.join(self.ckpt_dir, f"{kind}_step_{step}.pt")

    def save(self, state, step: int, best_indicator: dict | None = None,
             save_best: bool = False) -> None:
        main = parallel.is_main()
        sh = getattr(state, "sharding", None)
        if sh is not None:
            # every rank gathers; rank 0 keeps and writes
            model_sd = sh.full_state_dict(keep=main)
            opt_sd = state.opt.state_dict()
        elif main:
            model_sd, opt_sd = state.model.state_dict(), state.opt.state_dict()
        if main:
            self._write(model_sd, opt_sd, state.step, step, best_indicator,
                        save_best)
        parallel.barrier()

    def _write(self, model_sd, opt_sd, state_step, step, best_indicator,
               save_best) -> None:
        prev = self.latest_step()
        _save(model_sd, self.path("model", step))
        _save({"step": state_step, "optimizer": opt_sd},
              self.path("optimizer", step))
        if save_best and best_indicator:
            for metric, is_best in best_indicator.items():
                if is_best:
                    shutil.copyfile(self.path("model", step), os.path.join(
                        self.ckpt_dir, f"best_{metric}.pt"))
        if self.remove_before_ckpt and prev is not None and prev != step:
            for kind in ("model", "optimizer"):
                if os.path.exists(self.path(kind, prev)):
                    os.remove(self.path(kind, prev))
        LOGGER.info("saved checkpoint step %d -> %s", step, self.ckpt_dir)

    def latest_step(self) -> int | None:
        """The newest step with both files written."""
        if not os.path.isdir(self.ckpt_dir):
            return None
        steps = [int(m.group(1)) for name in os.listdir(self.ckpt_dir)
                 if (m := re.fullmatch(r"model_step_(\d+)\.pt", name))
                 and os.path.exists(self.path("optimizer", int(m.group(1))))]
        return max(steps) if steps else None

    def restore_latest(self, state):
        """Resume (build_model.py:106-124): the newest pair into
        ``state``'s model (strictly) and optimizer, in place. Returns
        ``(state, start_step)``; ``(state, 0)`` when there is none."""
        step = self.latest_step()
        if step is None:
            return state, 0
        device = next(state.model.parameters()).device
        model_sd = torch.load(self.path("model", step), map_location=device,
                              weights_only=True)
        sh = getattr(state, "sharding", None)
        if sh is None:
            state.model.load_state_dict(model_sd)
        else:
            sh.load_full_state_dict(model_sd)
        saved = torch.load(self.path("optimizer", step), map_location=device,
                           weights_only=True)
        state.opt.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        LOGGER.info("resumed from step %d", step)
        return state, step
