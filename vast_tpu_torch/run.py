"""The port's entry point, with the CLI and flow of the repo's ``run.py``.

    python -m vast_tpu_torch.run --config <task.json> [--flags] [--device D]

``--config`` and the flags are those of ``config.build_arg_parser`` (the
reference's utils/args.py). ``--device`` (default: the GPU; ``cpu`` runs
the plain PyTorch versions of the kernels) is the one flag ``run.py``
does not have, since it takes its platform from JAX.

Data parallel on N cards, the counterpart of the reference's
``torch.distributed.launch``:

    torchrun --nproc_per_node N -m vast_tpu_torch.run --config <task.json>

Each rank joins the process group (``parallel.init_distributed``: NCCL,
one card a rank; ``VAST_DIST_BACKEND=gloo`` lets ranks share a card;
``--device cpu`` makes CPU ranks over gloo) before it builds its loaders,
and leaves it at the end (a group its caller started stays up). The
config's batch sizes are global.

``--checkpoint`` is a ``.pt`` / ``.bin`` file, a pretrain dir
(``checkpoint-N/pytorch_model*.bin``) or a training output root (its
newest ``ckpt/model_step_N.pt``); its weights go through the reference's
surgery (``convert.vast_ckpt``). Training without it starts from
``--pretrain_dir``'s weights, else from seeded random ones; ``--resume``
continues from the output dir's newest checkpoint. Testing without a
checkpoint evaluates random weights, with a warning.
"""

from __future__ import annotations

import argparse
import sys

import torch.distributed as dist

from vast_tpu_torch import parallel
from vast_tpu_torch.config import dump_hps, get_args
from vast_tpu_torch.convert.vast_ckpt import load_checkpoint
from vast_tpu_torch.logger import LOGGER
from vast_tpu_torch.training import pipeline
from vast_tpu_torch.training.optimizer import build_optimizer
from vast_tpu_torch.training.step import create_train_state


def main(argv=None, timings: dict | None = None):
    """Run ``argv`` (None: ``sys.argv[1:]``). Returns what the mode
    returns: ``(state, metric_logger_dict)`` for training, the eval log
    for testing. ``timings``: seconds per stage (``pipeline.train``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, argv = pre.parse_known_args(argv)
    joined = not dist.is_initialized()   # a caller's group stays up
    _, _, device = parallel.init_distributed(known.device)
    try:
        return _run(argv, device, timings)
    finally:
        if joined:
            parallel.destroy()


def _run(argv, device, timings):
    opts = get_args(argv)
    run_cfg = opts.run_cfg
    pipeline.initialize(opts)
    if run_cfg.output_dir and run_cfg.output_dir != "none" and \
            parallel.is_main():
        dump_hps(opts)
    tokenizer = pipeline.build_tokenizer(opts)
    model = pipeline.build_model(opts, device, tokenizer)
    val_loaders = pipeline.create_val_dataloaders(opts, tokenizer)

    if run_cfg.mode == "training":
        train_loader = pipeline.create_train_dataloaders(opts, tokenizer)
        loaded = False
        if run_cfg.get("checkpoint"):
            load_checkpoint(model, run_cfg.checkpoint)
            loaded = True
        elif run_cfg.get("pretrain_dir"):
            try:
                load_checkpoint(model, run_cfg.pretrain_dir)
                loaded = True
            except FileNotFoundError as e:
                LOGGER.warning("pretrain_dir has no weight files (%s); "
                               "config inherited only", e)
        state = None
        if loaded:
            opt, _ = build_optimizer(model, run_cfg, opts.model_cfg,
                                     run_cfg.num_train_steps or 1)
            state = create_train_state(model, opt)
        return pipeline.train(model, opts, tokenizer, train_loader,
                              val_loaders, state=state, timings=timings)
    if run_cfg.mode == "testing":
        if run_cfg.get("checkpoint"):
            load_checkpoint(model, run_cfg.checkpoint)
        else:
            pipeline.init_params(model, opts)
            LOGGER.warning("testing with randomly initialized params "
                           "(no --checkpoint given)")
        return pipeline.test(model, opts, tokenizer, val_loaders,
                             timings=timings)
    raise NotImplementedError(run_cfg.mode)


if __name__ == "__main__":
    main()
