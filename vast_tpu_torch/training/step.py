"""The train step.

Counterpart of ``vast_tpu.training.step`` (step.py:24-93): one step is
the task's forward with its losses, the backward, and the optimizer
update. ``vast_tpu`` jits a pure function of a donated state; here the
model's parameters and the optimizer's moments are updated in place, and
the state carries the step count and references to both.

Per-step randomness (dropout, drop-path, the random crop and audio clip,
the ITM negatives) comes from the ``generator`` passed to each step, a
CPU ``torch.Generator`` that the caller seeds once and passes on; the
modules seed generators on the device from it (models/layers.py).
``vast_tpu`` splits its step key into mask / negatives / vision / audio /
dropout keys (step.py:36-41); the port's draws have no bit-for-bit
counterpart of those.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vast_tpu_torch.training.optimizer import GroupedAdam


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt: GroupedAdam


def create_train_state(model: nn.Module, opt: GroupedAdam) -> TrainState:
    return TrainState(step=0, model=model, opt=opt)


def make_train_step(model: nn.Module, opt: GroupedAdam, task: str,
                    vision_transforms: str = "none"):
    """Returns ``step(state, batch, generator) -> (state, metrics)``.

    ``batch`` holds tensors on the model's device; ``vision_transforms``
    selects the on-device augmentation ('none' or 'crop_flip'). Metrics
    are the task's losses and ``total_loss`` (their sum), as 0-d tensors
    on the device. The gradients stay in ``.grad`` until the next step.
    """

    def step(state: TrainState, batch, generator: torch.Generator):
        model.zero_grad(set_to_none=True)
        batch_in = dict(batch)
        batch_in["vision_transforms"] = vision_transforms
        out = model(batch_in, task, compute_loss=True, generator=generator)
        total = sum(out.values())
        total.backward()
        opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in out.items()}
        metrics["total_loss"] = total.detach()
        return state, metrics

    return step
