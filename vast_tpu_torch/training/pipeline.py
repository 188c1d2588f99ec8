"""Builders and the train and test loops.

Counterpart of ``vast_tpu.training.pipeline`` (pipeline.py:39-362; the
reference's utils/pipeline.py, utils/build_model.py,
utils/build_dataloader.py and utils/initialize.py) on one device:

* ``build_model``: ``VASTConfig.from_model_cfg`` with fp32 parameters
  and bf16 compute when ``run_cfg.bf16`` (else fp32), on the GPU unless
  the caller names another device;
* ``init_params``: every parameter from the port's seeded
  ``init_random_`` (each head exists in the module tree);
* ``train``: one ``make_train_step`` per (task, vision_transforms); a
  one-deep prefetch of the next batch (pinned host memory, copied on a
  side CUDA stream); losses fetched to the host every ``metrics_every``
  steps, a run aborted after three non-finite checks in a row; an
  evaluation every ``valid_steps`` and at the end, the best step per
  task metric, and a checkpoint at each evaluation. ``first_eval`` /
  ``zero_shot`` evaluate before the first step, after a resume.

Each step's randomness comes from a CPU generator seeded from
(``seed``, step), and a resumed run skips the batches of the steps it
restored without reading them (``MetaLoader.skip``), so it continues an
unbroken run exactly where the host draws nothing itself (a video's training frames are drawn with
Python's global ``random`` on the loader's threads, as in ``vast_tpu``).
Meshes, ``fsdp`` and ``tp`` come with the multi-GPU slice and raise here.

``timings``, where a caller passes a dict, receives seconds per stage:
``train_loader_wait`` (blocked on the loader), ``train_step``
(synchronized after each step) and the evaluation's stages
(``evaluate_ret``, ``evaluate_cap``, ``evaluate_qa``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict

import numpy as np
import torch

from vast_tpu_torch import profiling
from vast_tpu_torch.convert.from_jax import init_random_
from vast_tpu_torch.data import data_registry
from vast_tpu_torch.data.loader import BatchLoader, MetaLoader, \
    compute_train_steps
from vast_tpu_torch.data.tokenizer import BertTokenizer, tiny_tokenizer
from vast_tpu_torch.evaluation.evaluation_mm import evaluate_mm
from vast_tpu_torch.logger import LOGGER, RunningMeter, add_log_to_file
from vast_tpu_torch.models.vast import VASTConfig, VASTModel
from vast_tpu_torch.training.optimizer import build_optimizer
from vast_tpu_torch.training.saver import ModelSaver
from vast_tpu_torch.training.step import create_train_state, \
    make_train_step


def initialize(opts) -> None:
    """Output dirs and the file log (utils/initialize.py:8-28)."""
    out = opts.run_cfg.output_dir
    if out and out != "none":
        for sub in ("log", "ckpt"):
            os.makedirs(os.path.join(out, sub), exist_ok=True)
        add_log_to_file(os.path.join(out, "log", "log.txt"))


def build_tokenizer(opts) -> BertTokenizer:
    vocab = opts.model_cfg.get("vocab_path") or os.environ.get(
        "VAST_TPU_VOCAB")
    if vocab and os.path.exists(vocab):
        return BertTokenizer.from_pretrained(vocab)
    LOGGER.warning("no vocab file configured; using built-in tiny vocab "
                   "(set model_cfg.vocab_path for real runs)")
    return tiny_tokenizer()


def build_model(opts, device=None, tokenizer=None) -> VASTModel:
    """The model of ``opts.model_cfg`` on ``device`` (None: the GPU),
    with the [MASK] id of ``tokenizer`` where one is given."""
    model_type = opts.model_cfg.get("model_type", "vast")
    if model_type != "vast":
        raise NotImplementedError(f"model_type {model_type!r}")
    dtype = torch.bfloat16 if opts.run_cfg.get("bf16") else torch.float32
    cfg = VASTConfig.from_model_cfg(opts.model_cfg, dtype=dtype,
                                    param_dtype=torch.float32)
    if getattr(tokenizer, "mask_token_id", None):
        cfg = dataclasses.replace(cfg, mask_token_id=tokenizer.mask_token_id)
    return VASTModel(cfg, device=device)


def init_params(model: VASTModel, opts) -> VASTModel:
    """Every parameter drawn from a generator seeded with ``seed``."""
    gen = torch.Generator(device=model.device).manual_seed(
        int(opts.run_cfg.get("seed", 50)))
    return init_random_(model, gen)


def create_train_dataloaders(opts, tokenizer) -> MetaLoader:
    run_cfg = opts.run_cfg
    accum = run_cfg.get("gradient_accumulation_steps", 1)
    loaders, lengths = {}, []
    for d_cfg in opts.data_cfg.train:
        ds = data_registry[d_cfg["type"]](d_cfg, opts, tokenizer)
        lengths.append(len(ds))
        loaders[f"{d_cfg['task']}--{d_cfg['name']}"] = BatchLoader(
            ds, max(d_cfg["batch_size"] // accum, 1), shuffle=True,
            num_workers=d_cfg.get("n_workers", 4),
            seed=run_cfg.get("seed", 50))
    steps = compute_train_steps(opts.data_cfg.train, run_cfg, lengths)
    named = {name: (loader, ratio)
             for (name, loader), ratio in zip(loaders.items(), steps)}
    return MetaLoader(named, accum_steps=accum,
                      seed=run_cfg.get("seed", 50))


def create_val_dataloaders(opts, tokenizer) -> dict:
    loaders = {}
    for d_cfg in opts.data_cfg.val:
        ds = data_registry[d_cfg["type"]](d_cfg, opts, tokenizer)
        loaders[f"{d_cfg['task']}--{d_cfg['name']}"] = BatchLoader(
            ds, d_cfg["batch_size"], shuffle=False, drop_last=False,
            num_workers=d_cfg.get("n_workers", 4))
    return loaders


def get_best_name(eval_name: str, metric: dict):
    """The metric that defines 'best' per task (utils/pipeline.py:168-179)."""
    if "cap" in eval_name:
        return "CIDEr" if "CIDEr" in metric else None
    if "vqa" in eval_name or "qa" in eval_name:
        return "accuracy"
    if "ret" in eval_name:
        return "video_r1" if "video_r1" in metric else None
    return None


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step ``step`` (0-based): a function of
    (seed, step) alone, as ``vast_tpu`` folds the step into its key."""
    s = np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(s))


def _device_batches(batches, device, timings=None):
    """``(name, vision_transforms, tensors, ready)`` for each
    ``(name, batch)`` of ``batches``, one batch ahead: batch N+1 is
    copied (from pinned memory, on a side stream) while step N runs.
    ``ready`` is the copy's CUDA event (None on the CPU)."""
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    buf = None
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        try:
            name, batch = next(it)
        except StopIteration:
            break
        if timings is not None:
            timings["train_loader_wait"] = (
                timings.get("train_loader_wait", 0.0)
                + time.perf_counter() - t0)
        vt = str(batch.get("vision_transforms", "none"))
        arrays = {k: torch.from_numpy(v) for k, v in batch.items()
                  if isinstance(v, np.ndarray)}
        ready = None
        if stream is not None:
            with torch.cuda.stream(stream):
                arrays = {k: v.pin_memory().to(device, non_blocking=True)
                          for k, v in arrays.items()}
                ready = torch.cuda.Event()
                ready.record(stream)
        item = (name, vt, arrays, ready)
        if buf is not None:
            yield buf
        buf = item
    if buf is not None:
        yield buf


def train(model: VASTModel, opts, tokenizer, train_loader, val_loaders,
          state=None, start_step: int = 0, timings: dict | None = None):
    """The train loop. ``state``: a ``TrainState`` of ``model`` (None:
    fresh parameters from ``init_params`` and a new optimizer).
    Returns ``(state, metric_logger_dict)``."""
    run_cfg = opts.run_cfg
    for key in ("fsdp", "tp"):
        if run_cfg.get(key):
            raise NotImplementedError(f"run_cfg.{key}: sharding comes with "
                                      f"the multi-GPU slice")
    num_steps = run_cfg.num_train_steps
    device = model.device
    if state is None:
        init_params(model, opts)
        opt, _ = build_optimizer(model, run_cfg, opts.model_cfg, num_steps)
        state = create_train_state(model, opt)

    saver = ModelSaver(run_cfg.output_dir,
                       run_cfg.get("remove_before_ckpt", True))
    if run_cfg.get("resume") and start_step == 0:
        state, start_step = saver.restore_latest(state)

    if run_cfg.get("first_eval") or run_cfg.get("zero_shot"):
        eval_log = evaluate_mm(model, tokenizer, val_loaders, run_cfg,
                               start_step, device=device, timings=timings)
        for task_name, val_log in eval_log.items():
            for eval_name, metric in val_log.items():
                LOGGER.info("eval %s_%s @ step %d: %s", task_name,
                            eval_name, start_step, metric)
        if run_cfg.get("zero_shot"):
            return state, {}

    step_fns, meters = {}, {}
    metric_logger_dict = defaultdict(dict)
    best_indicator = {}
    seed = run_cfg.get("seed", 50)
    metrics_every = int(run_cfg.get("metrics_every", 10))
    global_step = start_step
    timer = profiling.StepTimer()
    nan_strikes = 0
    profile_steps = int(run_cfg.get("profile_steps") or 0)
    profile_dir = os.path.join(run_cfg.output_dir, "log", "profile")
    prof = None

    if start_step:
        train_loader.skip(start_step)
    for name, vt, arrays, ready in _device_batches(train_loader, device,
                                                    timings):
        task = name.split("--")[0]
        if (task, vt) not in step_fns:
            step_fns[task, vt] = make_train_step(model, state.opt, task,
                                                 vision_transforms=vt)
        if ready is not None:
            cur = torch.cuda.current_stream(device)
            cur.wait_event(ready)
            for t in arrays.values():
                t.record_stream(cur)
        if profile_steps and global_step == start_step + 2:
            prof = profiling.start_trace(device)
        t0 = time.perf_counter()
        state, metrics = step_fns[task, vt](
            state, arrays, step_generator(seed, global_step))
        if timings is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timings["train_step"] = (timings.get("train_step", 0.0)
                                     + time.perf_counter() - t0)
        global_step += 1
        if prof is not None and \
                global_step == start_step + 2 + profile_steps:
            profiling.stop_trace(prof, profile_dir, device)
            prof = None

        if global_step % metrics_every == 0 or global_step >= num_steps:
            bad = 0
            for k, v in metrics.items():
                v = float(v)
                if not np.isfinite(v):
                    bad += 1
                mname = f"loss_{name}/{k}"
                meters.setdefault(mname, RunningMeter(mname))(v)
            if bad:
                nan_strikes += 1
                LOGGER.error("non-finite loss at step %d (%d strikes)",
                             global_step, nan_strikes)
                if nan_strikes >= 3:
                    raise FloatingPointError(
                        f"aborting: non-finite losses for {nan_strikes} "
                        f"consecutive checks (step {global_step})")
            else:
                nan_strikes = 0
        timer.tick()
        if global_step % 50 == 0:
            LOGGER.info({m.name: None if m.val is None else round(m.val, 4)
                         for m in meters.values()})
            if timer.ema_s:
                LOGGER.info("step time ema %.3fs (%.2f steps/s)",
                            timer.ema_s, 1.0 / timer.ema_s)

        if (global_step + 1) % run_cfg.valid_steps == 0 or \
                global_step >= num_steps:
            eval_log = evaluate_mm(model, tokenizer, val_loaders, run_cfg,
                                   global_step, device=device,
                                   timings=timings)
            for task_name, val_log in eval_log.items():
                for eval_name, metric in val_log.items():
                    eval_name = f"{task_name}_{eval_name}"
                    metric_logger_dict[eval_name][str(global_step)] = metric
                    LOGGER.info("eval %s @ step %d: %s", eval_name,
                                global_step, metric)
                    best_name = get_best_name(eval_name, metric)
                    if best_name is None:
                        continue
                    hist = metric_logger_dict[eval_name]
                    if ("best_step" not in hist
                            or metric[best_name] >= hist["best_value"]):
                        hist["best_step"] = global_step
                        hist["best_value"] = metric[best_name]
                        best_indicator[eval_name] = True
                    else:
                        best_indicator[eval_name] = False
            saver.save(state, global_step, best_indicator,
                       run_cfg.get("save_best", False))
        if global_step >= num_steps:
            break
    if prof is not None:
        # the run ended inside the profile window: keep what it recorded
        profiling.stop_trace(prof, profile_dir, device)
    if timer.summary():
        LOGGER.info("step timing: %s", timer.summary())
    return state, metric_logger_dict


def test(model: VASTModel, opts, tokenizer, val_loaders,
         timings: dict | None = None) -> dict:
    eval_log = evaluate_mm(model, tokenizer, val_loaders, opts.run_cfg, 0,
                           device=model.device, timings=timings)
    for task_name, val_log in eval_log.items():
        for eval_name, metric in val_log.items():
            LOGGER.info("eval %s_%s: %s", task_name, eval_name, metric)
    return eval_log
