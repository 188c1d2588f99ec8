"""The train step.

Counterpart of ``vast_tpu.training.step`` (step.py:24-93): one step is
the task's forward with its losses, the backward, and the optimizer
update. ``vast_tpu`` jits a pure function of a donated state; here the
model's parameters and the optimizer's moments are updated in place, and
the state carries the step count and references to both.

Data parallel (a process group runs, ``vast_tpu_torch.parallel``): the
forward goes through ``DistributedDataParallel`` (``data_parallel``), as
the reference wraps its model (utils/build_model.py:56-57), and each
rank's losses are written so that their mean over the ranks, and its
gradient, are the global batch's (``models/vast.py``). ``vast_tpu``
shards one global batch over its ``dp`` axis instead. The state keeps
the bare module, so the saver and evaluation never see DDP's
``module.`` prefix.

Per-step randomness (dropout, drop-path, the random crop and audio clip,
the ITM negatives) comes from the ``generator`` passed to each step, a
CPU ``torch.Generator`` that the caller seeds once and passes on; the
modules seed generators on the device from it (models/layers.py).
``vast_tpu`` splits its step key into mask / negatives / vision / audio /
dropout keys (step.py:36-41); the port's draws have no bit-for-bit
counterpart of those.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from vast_tpu_torch.parallel import collectives
from vast_tpu_torch.training.optimizer import GroupedAdam


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt: GroupedAdam


def create_train_state(model: nn.Module, opt: GroupedAdam) -> TrainState:
    return TrainState(step=0, model=model, opt=opt)


def data_parallel(model: nn.Module) -> DistributedDataParallel:
    """``model`` under ``DistributedDataParallel`` over the default group,
    as the reference wraps it: ``find_unused_parameters`` (each task
    reaches its own heads; frozen towers hold no gradient and DDP leaves
    them out); buffers are constants, so none is broadcast a step. The
    gradients are averaged by DDP's own all-reduce."""
    kw = ({"device_ids": [model.device.index]}
          if model.device.type == "cuda" else {})
    return DistributedDataParallel(model, find_unused_parameters=True,
                                   broadcast_buffers=False, **kw)


def make_train_step(model: nn.Module, opt: GroupedAdam, task: str,
                    vision_transforms: str = "none",
                    ddp: DistributedDataParallel | None = None):
    """Returns ``step(state, batch, generator) -> (state, metrics)``.

    ``batch`` holds tensors on the model's device; ``vision_transforms``
    selects the on-device augmentation ('none' or 'crop_flip'). Metrics
    are the task's losses and ``total_loss`` (their sum), as 0-d tensors
    on the device. The gradients stay in ``.grad`` until the next step.

    ``ddp``: ``model`` under ``data_parallel``; the forward runs through
    it and the metrics are the means over the ranks. Under gradient
    accumulation every micro-batch but a window's last runs under
    ``no_sync``, its gradient held in the optimizer's running mean, and
    the last one's synchronised backward averages the window's sum over
    the ranks (``GroupedAdam.grads_from_window``).
    """
    forward = model if ddp is None else ddp
    split = ddp is not None and opt.accum > 1

    def step(state: TrainState, batch, generator: torch.Generator):
        window_end = opt.mini_step == opt.accum - 1
        if split and window_end:
            opt.grads_from_window()
        else:
            model.zero_grad(set_to_none=True)
        batch_in = dict(batch)
        batch_in["vision_transforms"] = vision_transforms
        local = ddp is not None and not window_end
        with ddp.no_sync() if local else contextlib.nullcontext():
            out = forward(batch_in, task, compute_loss=True,
                          generator=generator)
            total = sum(out.values())
            total.backward()
        opt.step(window_sum=split and window_end)
        state.step += 1
        metrics = {k: v.detach() for k, v in out.items()}
        metrics["total_loss"] = total.detach()
        if ddp is not None:
            mean = collectives.all_reduce_mean(
                torch.stack([v.float() for v in metrics.values()]))
            metrics = dict(zip(metrics, mean.unbind()))
        return state, metrics

    return step
