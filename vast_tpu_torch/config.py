"""Layered JSON config system and the task-string grammar.

The port's own copy of ``vast_tpu.config`` (config.py:1-321), which
reproduces the reference's utils/args.py:12-135:

* a task config JSON holds three sections, ``run_cfg`` / ``model_cfg`` /
  ``data_cfg``; the first two name a ``default`` JSON that is loaded
  first and then overridden by the section's other keys. A default path
  that does not exist (the released ``./config/vast/default_*.json``)
  falls back to the copies under ``vast_tpu_torch/configs/``;
* a CLI flag overrides a key only when it was typed on the command line;
* ``--pretrain_dir`` pulls ``inherit_keys`` (and ``vision_encoder_type``,
  ``pool_video``) from the pretrain run's ``log/hps.json``;
* ``train_*`` / ``test_*`` flags fan out over the data configs;
* ``max_vision_sample_num`` / ``max_audio_sample_num`` are the largest
  sample counts over the data configs; ``bf16`` wins over ``fp16``;
* ``${VAR:-default}`` in any string is expanded from the environment
  (``${VAST_DATA:-datasets}`` roots the released dataset paths).

Task strings: ``_``-separated heads, each ``name%subtask%...`` with
subtask in {tv, ta, tva, tvs, tvas}, e.g. ``ret%tvas%tv_cap%tvas``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import sys
from typing import Any

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")

SUBTASKS = ("tv", "ta", "tva", "tvs", "tvas")


class EasyDict(dict):
    """Attribute-style dict (stand-in for the reference's easydict)."""

    def __init__(self, d: dict | None = None, **kwargs):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, EasyDict):
            value = EasyDict(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                EasyDict(v) if isinstance(v, dict) and not isinstance(v, EasyDict) else v
                for v in value
            )
        super().__setitem__(key, value)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return EasyDict(copy.deepcopy(dict(self), memo))


def parse_task_string(task: str) -> list[tuple[str, list[str]]]:
    """``'ret%tvas%tv_cap%tvas'`` -> ``[('ret', ['tvas','tv']), ('cap', ['tvas'])]``."""
    heads = []
    for head in task.split("_"):
        parts = head.split("%")
        name, subtasks = parts[0], parts[1:]
        for s in subtasks:
            if s not in SUBTASKS:
                raise ValueError(f"unknown subtask {s!r} in task string {task!r}")
        heads.append((name, subtasks))
    return heads


_ENV_RE = re.compile(r"\$\{(\w+)(?::-([^}]*))?\}")


def expand_env(value):
    """Expand ``${VAR}`` / ``${VAR:-default}`` placeholders in strings.

    The shipped config catalog roots dataset paths at ``${VAST_DATA:-datasets}``
    so one env var repoints every task config; expansion is recursive over
    dicts/lists so it applies uniformly to any cfg value.
    """
    if isinstance(value, str):
        return _ENV_RE.sub(
            lambda m: os.environ.get(m.group(1), m.group(2) or ""), value)
    if isinstance(value, dict):
        return type(value)({k: expand_env(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        return type(value)(expand_env(v) for v in value)
    return value


def _load_json(path: str) -> EasyDict:
    with open(path) as f:
        return EasyDict(expand_env(json.load(f)))


def _resolve_default(path: str) -> str:
    """Resolve a default-cfg path; falls back to the packaged configs dir.

    Accepts reference-style paths like ``./config/vast/default_run_cfg.json``
    so released task configs keep working.
    """
    if os.path.exists(path):
        return path
    candidate = os.path.join(_CONFIG_DIR, os.path.basename(path))
    if os.path.exists(candidate):
        return candidate
    raise FileNotFoundError(path)


def compute_max_sample_num(data_cfg: EasyDict, key: str, concatenated_nums: int = 1) -> int:
    """max over dataset cfgs of {vision,audio}_sample_num (utils/args.py:141-179)."""
    train_ls = [
        d.get(key, 1) * concatenated_nums for d in data_cfg.get("train", [])
    ]
    val_ls = [d.get(key, 1) for d in data_cfg.get("val", [])]
    if not train_ls and not val_ls:
        return 1  # model-only usage (no datasets configured)
    max_num = max(train_ls) if train_ls else max(val_ls)
    assert max_num > 0
    return max_num


def parse_with_config(
    config_path: str,
    cli_overrides: dict[str, Any] | None = None,
    explicit_keys: set[str] | None = None,
) -> EasyDict:
    """Build the merged (run_cfg, model_cfg, data_cfg) triple.

    ``cli_overrides`` maps flag name -> value; only keys in ``explicit_keys``
    (the flags literally typed on the command line) override file values,
    matching utils/args.py:18-28.
    """
    cli_overrides = cli_overrides or {}
    explicit_keys = explicit_keys if explicit_keys is not None else set(cli_overrides)

    file_cfg = _load_json(config_path)

    run_cfg = _load_json(_resolve_default(file_cfg.run_cfg.get("default",
                         os.path.join(_CONFIG_DIR, "default_run_cfg.json"))))
    run_cfg.update({k: v for k, v in file_cfg.run_cfg.items() if k != "default"})
    for k in explicit_keys:
        if k in run_cfg:
            run_cfg[k] = cli_overrides[k]

    model_cfg = _load_json(_resolve_default(file_cfg.model_cfg.get("default",
                           os.path.join(_CONFIG_DIR, "default_model_cfg.json"))))
    model_cfg.update({k: v for k, v in file_cfg.model_cfg.items() if k != "default"})

    pretrain_dir = cli_overrides.get("pretrain_dir") or run_cfg.get("pretrain_dir", "")
    if pretrain_dir:
        hps = _load_json(os.path.join(pretrain_dir, "log", "hps.json"))
        pretrain_model_cfg = hps.model_cfg
        global_inherit_keys = ["vision_encoder_type", "pool_video"]
        inherit_keys = set(global_inherit_keys) | set(model_cfg.get("inherit_keys", []))
        model_cfg.update(
            {k: v for k, v in pretrain_model_cfg.items() if k in inherit_keys}
        )

    for k in explicit_keys:
        if k in model_cfg:
            model_cfg[k] = cli_overrides[k]

    data_cfg = file_cfg.get("data_cfg", EasyDict({"train": [], "val": []}))
    data_cfg.setdefault("train", [])
    data_cfg.setdefault("val", [])

    # train_*/test_* fan-out flags (utils/args.py:64-96)
    for k in explicit_keys:
        v = cli_overrides[k]
        if k == "train_epoch":
            data_cfg.train[0].epoch = v
        elif k == "train_steps":
            data_cfg.train[0].steps = v
        elif k == "train_vision_sample_num":
            data_cfg.train[0].vision_sample_num = v
        elif k == "train_batch_size":
            for d in data_cfg.train:
                d.batch_size = v
        elif k == "train_task":
            for d in data_cfg.train:
                d.task = v
        elif k == "test_batch_size":
            for d in data_cfg.val:
                d.batch_size = v
        elif k == "test_vision_sample_num":
            for d in data_cfg.val:
                d.vision_sample_num = v
        elif k == "test_task":
            for d in data_cfg.val:
                d.task = v
        elif k == "vision_transforms":
            for d in list(data_cfg.train) + list(data_cfg.val):
                d.vision_transforms = v

    # special rules (utils/args.py:115-127)
    data_cfg.concatenated_nums = model_cfg.get("concatenated_nums", 1)
    model_cfg.max_vision_sample_num = compute_max_sample_num(
        data_cfg, "vision_sample_num", data_cfg.concatenated_nums
    )
    model_cfg.max_audio_sample_num = compute_max_sample_num(
        data_cfg, "audio_sample_num", data_cfg.concatenated_nums
    )
    if run_cfg.get("bf16"):
        run_cfg.fp16 = False

    return EasyDict(run_cfg=run_cfg, model_cfg=model_cfg, data_cfg=data_cfg)


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI flags (subset of utils/args.py:215-307 that is actually consumed)."""
    p = argparse.ArgumentParser("vast_tpu_torch")

    def str2bool(b):
        if b.lower() == "false":
            return False
        if b.lower() == "true":
            return True
        raise ValueError(f"invalid bool {b!r}")

    p.add_argument("--config", required=True)
    p.add_argument("--output_dir", type=str)
    p.add_argument("--checkpoint", type=str)
    p.add_argument("--pretrain_dir", type=str)
    p.add_argument("--mode", type=str, choices=["training", "testing"])
    p.add_argument("--learning_rate", type=float)
    p.add_argument("--clip_lr", type=float)
    p.add_argument("--new_lr", type=float)
    p.add_argument("--new_params_name", type=str, nargs="+")
    p.add_argument("--optim", type=str)
    p.add_argument("--betas", type=float, nargs="+")
    p.add_argument("--weight_decay", type=float)
    p.add_argument("--grad_norm", type=float)
    p.add_argument("--warmup_ratio", type=float)
    p.add_argument("--scheduler", type=str)
    p.add_argument("--seed", type=int)
    p.add_argument("--fp16", type=str2bool)
    p.add_argument("--bf16", type=str2bool)
    p.add_argument("--zero_shot", action="store_true", default=None)
    p.add_argument("--resume", action="store_true", default=None)
    p.add_argument("--first_eval", type=str2bool)
    p.add_argument("--save_best", type=str2bool)
    p.add_argument("--valid_freq", type=int)
    p.add_argument("--num_train_steps", type=int)
    p.add_argument("--gradient_accumulation_steps", type=int)
    p.add_argument("--log_steps", type=int)
    p.add_argument("--remove_before_ckpt", type=str2bool)
    p.add_argument("--dataset_mix_type", type=str)
    p.add_argument("--vision_resolution", type=int)
    p.add_argument("--vision_encoder_type", type=str)
    p.add_argument("--audio_encoder_type", type=str)
    p.add_argument("--frame_embedding_type", type=str)
    p.add_argument("--checkpointing", type=str2bool)
    p.add_argument("--frozen_vision", type=str2bool)
    p.add_argument("--frozen_audio", type=str2bool)
    p.add_argument("--itm_ratio", type=float)
    p.add_argument("--itm_rerank_num", type=int)
    p.add_argument("--profile_steps", type=int,
                   help="trace this many train steps (after a 2-step "
                        "warmup) with torch.profiler into log/profile")
    p.add_argument("--contra_dim", type=int)
    p.add_argument("--beam_size", type=int)
    p.add_argument("--captioner_mode", type=str2bool)
    p.add_argument("--generate_nums", type=int)
    p.add_argument("--ret_bidirection_evaluation", type=str2bool)
    p.add_argument("--train_batch_size", type=int)
    p.add_argument("--test_batch_size", type=int)
    p.add_argument("--train_epoch", type=float)
    p.add_argument("--train_steps", type=int)
    p.add_argument("--train_task", type=str)
    p.add_argument("--test_task", type=str)
    p.add_argument("--train_vision_sample_num", type=int)
    p.add_argument("--test_vision_sample_num", type=int)
    p.add_argument("--vision_transforms", type=str)
    return p


def get_args(argv: list[str] | None = None) -> EasyDict:
    argv = argv if argv is not None else sys.argv[1:]
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    explicit = {a[2:].split("=")[0] for a in argv if a.startswith("--")}
    overrides = {k: v for k, v in vars(args).items() if v is not None}
    opts = parse_with_config(args.config, overrides, explicit & set(overrides))
    return opts


def dump_hps(opts: EasyDict) -> None:
    """Dump resolved config to <output_dir>/log/hps.json (utils/args.py:182-184).

    The dump doubles as the inherit-keys source for downstream finetunes.
    """
    log_dir = os.path.join(opts.run_cfg.output_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "hps.json"), "w") as f:
        json.dump(opts, f, indent=4, default=str)
