"""The train step.

Counterpart of ``vast_tpu.training.step`` (step.py:24-93): one step is
the task's forward with its losses, the backward, and the optimizer
update. ``vast_tpu`` jits a pure function of a donated state; here the
model's parameters and the optimizer's moments are updated in place, and
the state carries the step count and references to both.

Data parallel (a process group runs, ``vast_tpu_torch.parallel``): the
forward goes through ``DistributedDataParallel`` (``data_parallel``) over
the mesh's data group, as the reference wraps its model
(utils/build_model.py:56-57), and each rank's losses are written so that
their mean over the ranks, and its gradient, are the global batch's
(``models/vast.py``). ``vast_tpu`` shards one global batch over its
``dp`` axis instead. The state keeps the bare module, so the saver and
evaluation never see DDP's ``module.`` prefix.

Parameter sharding (``shard_state``, the counterpart of step.py:96-154):
on a ``create_mesh(dp, fsdp, tp)`` mesh, ``fsdp`` splits parameters
over the fsdp axis and ``tp`` splits every tower's heads and MLPs (and
BERT's) over the tp axis, by ``combined_param_sharding``'s plan
(``parallel/fsdp.py``); the optimizer's moments are split with their
parameters. A sharded step needs no DDP: the gathers' backward and
``ShardedParams.reduce_grads`` average the gradients over the data
group.

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

from vast_tpu_torch import profiling
from vast_tpu_torch.logger import LOGGER
from vast_tpu_torch.parallel import collectives
from vast_tpu_torch.parallel import mesh as pmesh
from vast_tpu_torch.parallel.fsdp import ShardedParams
from vast_tpu_torch.training.optimizer import GroupedAdam


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt: GroupedAdam
    # the split parameters of a sharded state (shard_state), else None
    sharding: ShardedParams | None = None


def create_train_state(model: nn.Module, opt: GroupedAdam) -> TrainState:
    return TrainState(step=0, model=model, opt=opt)


def data_parallel(model: nn.Module,
                  group=None) -> DistributedDataParallel:
    """``model`` under ``DistributedDataParallel`` over ``group`` (None:
    the default group), as the reference wraps it:
    ``find_unused_parameters`` (each task reaches its own heads; frozen
    towers hold no gradient and DDP leaves them out); buffers are
    constants, so none is broadcast a step. The gradients are averaged
    by DDP's own all-reduce."""
    kw = ({"device_ids": [model.device.index]}
          if model.device.type == "cuda" else {})
    return DistributedDataParallel(model, find_unused_parameters=True,
                                   broadcast_buffers=False,
                                   process_group=group, **kw)


@torch.no_grad()
def shard_state(mesh, state: TrainState, fsdp: bool = False,
                tp: bool = False, opt: GroupedAdam | None = None,
                min_size: int | None = None) -> TrainState:
    """Place ``state`` on ``mesh`` (``parallel.create_mesh``), as
    ``vast_tpu``'s ``shard_state``: ``tp`` splits the column- and
    row-parallel layers of the towers and BERT over the ``tp`` axis,
    ``fsdp`` each other parameter of at least ``min_size`` elements over
    ``fsdp`` (``combined_param_sharding``), each only where that axis is
    above one. The optimizer's moments (``opt``, default the state's)
    are split with their parameters, so their memory scales with the
    parts; call it before restoring a resume, as ``pipeline.train``
    does. Every rank calls it with the same arguments, its model holding
    the same whole parameters. The model's losses and the state's
    metrics then run over the mesh's data group."""
    sizes = pmesh.mesh_shape(mesh)
    use_tp = tp and sizes["tp"] > 1
    use_fsdp = fsdp and sizes["fsdp"] > 1
    model = state.model
    model.data_group = pmesh.data_group(mesh)
    if not (use_tp or use_fsdp):
        return state
    plans = pmesh.combined_param_sharding(mesh, model, use_fsdp=use_fsdp,
                                          use_tp=use_tp, min_size=min_size)
    sh = ShardedParams(model, mesh, plans)
    if use_tp:
        split = pmesh.tp_modules(model, sizes["tp"], min_size
                                 if min_size is not None
                                 else pmesh.MIN_SHARD_SIZE)
        for mod in split.values():
            mod.enable_tp(sh.tp)
        kept = sorted({type(m).__name__ for m in model.modules()
                       if hasattr(m, "tp_linears")}
                      - {type(m).__name__ for m in split.values()})
        if kept and pmesh.is_main():
            LOGGER.info("tp %d: %s stay whole on every tp rank (heads or "
                        "hidden size indivisible)", sizes["tp"], kept)
    for name, p in model.named_parameters():
        p.data = sh.split(name, p.data)
    sh.install()
    opt = state.opt if opt is None else opt
    opt.reshard(sh)
    return dataclasses.replace(state, opt=opt, sharding=sh)


def make_train_step(model: nn.Module, opt: GroupedAdam, task: str,
                    vision_transforms: str = "none",
                    ddp: DistributedDataParallel | None = None,
                    sharding: ShardedParams | None = None):
    """Returns ``step(state, batch, generator) -> (state, metrics)``.

    ``batch`` holds tensors on the model's device; ``vision_transforms``
    selects the on-device augmentation ('none' or 'crop_flip'). Metrics
    are the task's losses and ``total_loss`` (their sum), as 0-d tensors
    on the device. The gradients stay in ``.grad`` until the next step.
    A step is the span ``vast.train.step``, with the children
    ``vast.train.forward``, ``.backward`` and ``.optimizer``
    (``profiling.py``).

    ``ddp``: ``model`` under ``data_parallel``; the forward runs through
    it and the metrics are the means over the ranks. Under gradient
    accumulation every micro-batch but a window's last runs under
    ``no_sync``, its gradient held in the optimizer's running mean, and
    the last one's synchronised backward averages the window's sum over
    the ranks (``GroupedAdam.grads_from_window``).

    ``sharding``: the state's ``ShardedParams`` (``shard_state``); each
    micro-batch's gradients are averaged over the data group after its
    backward, and the metrics are the means over it.
    """
    if ddp is not None and sharding is not None:
        raise ValueError("a sharded state averages its own gradients: "
                         "pass ddp or sharding, not both")
    forward = model if ddp is None else ddp
    split = ddp is not None and opt.accum > 1
    group = (sharding.data_group if sharding is not None
             else None if ddp is None else ddp.process_group)

    def step(state: TrainState, batch, generator: torch.Generator):
        with profiling.span("vast.train.step"):
            window_end = opt.mini_step == opt.accum - 1
            if split and window_end:
                opt.grads_from_window()
            else:
                model.zero_grad(set_to_none=True)
            batch_in = dict(batch)
            batch_in["vision_transforms"] = vision_transforms
            local = ddp is not None and not window_end
            with ddp.no_sync() if local else contextlib.nullcontext():
                with profiling.span("vast.train.forward"):
                    out = forward(batch_in, task, compute_loss=True,
                                  generator=generator)
                    total = sum(out.values())
                with profiling.span("vast.train.backward"):
                    total.backward()
                    if sharding is not None:
                        sharding.reduce_grads()
            with profiling.span("vast.train.optimizer"):
                opt.step(window_sum=split and window_end)
            state.step += 1
            metrics = {k: v.detach() for k, v in out.items()}
            metrics["total_loss"] = total.detach()
            if ddp is not None or sharding is not None:
                mean = collectives.all_reduce_mean(
                    torch.stack([v.float() for v in metrics.values()]),
                    group)
                metrics = dict(zip(metrics, mean.unbind()))
            return state, metrics

    return step
