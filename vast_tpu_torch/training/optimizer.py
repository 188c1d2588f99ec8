"""Param-grouped AdamW, Adam and Adamax in plain tensor ops.

The port's counterpart of ``vast_tpu.training.optimizer`` (optimizer.py:
54-167), which reproduces utils/build_optimizer.py:11-99's three LR
groups with optax (``run_cfg.optim``: ``adamw``, the default; ``adam``,
the same without weight decay, ``optax.adam``; ``adamax``, the infinity
norm in place of the second moment, ``optax.adamax``):

* ``new``: parameters whose name holds a ``new_params_name`` substring
  (reference torch names here; they are the port's names) -> ``new_lr``;
* ``clip``: the vision encoder (``vision_encoder.*``) when it is an
  (eva)clip tower -> ``clip_lr``;
* ``basic``: everything else -> ``learning_rate``;

each split into decay and no-decay (``_nd``). eps 1e-6, betas and weight
decay from run_cfg, one LR-ratio schedule for all groups evaluated at the
1-based update count (optimizer.py:117-122), optional global-norm
clipping, and true gradient accumulation (optax ``MultiSteps``: the mean
of ``gradient_accumulation_steps`` micro-batch gradients, one update).

``torch.optim.AdamW`` cannot keep bf16 moments beside fp32 parameters,
so the update is written out. With ``adam_nu_dtype`` set it follows
``vast_tpu``'s ``scale_by_adam_general`` (moments rounded to their dtype
before use); otherwise ``optax.adamw`` / ``optax.adam`` (mu rounded to
``adam_mu_dtype`` only for storage). Adamax keeps both moments in the
parameter's dtype (``optax.adamax`` takes no moment dtype) and refuses
``adam_nu_dtype``, as ``vast_tpu`` does (optimizer.py:142-144). The update itself is computed in fp32 and applied to
the parameters in place. A parameter the loss did not reach is updated
as optax updates a zero gradient: its moments decay and decoupled weight
decay still moves it.

The no-decay rule is ``vast_tpu``'s, which reads the JAX leaf name: only
``bias`` and LayerNorm ``scale`` are exempt (optimizer.py:27-36). In the
port's module tree those are every LayerNorm's weight and bias, the
bias of every Linear, Conv2d and Conv3d, and what a module lists in its
``no_decay_params`` (CLIP's ``in_proj_bias``, JAX ``in_proj/bias``);
``q_bias``/``v_bias``, EVA's layer scale ``gamma_1``/``gamma_2``,
Swin's ``relative_position_bias_table``, BEATs'
``pos_conv`` bias (JAX ``pos_conv_bias``), BERT's
``cls.predictions.bias`` (JAX ``decoder_bias``), embeddings and
``contra_temp`` are decayed.

Under parameter sharding (``reshard``, from ``training.step.
shard_state``) each rank steps its parts of the parameters with moments
of the same parts; the clipping norm is that of the whole gradient
(``ShardedParams.global_norm``: each element counted once, as
``vast_tpu``'s ``clip_by_global_norm`` sees the whole tree), and
``state_dict`` / ``load_state_dict`` keep the reference names and whole
shapes, gathered on save and split again on load.
"""

from __future__ import annotations

import torch
from torch import nn

from vast_tpu_torch.training.sched import get_lr_ratio

EPS = 1e-6


def _moment_dtype(name):
    """A run_cfg dtype name ("bfloat16", ...) or None/"" for the
    parameter's own dtype."""
    if not name:
        return None
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"not a floating dtype: {name!r}")
    return dtype


def _no_decay(module: nn.Module, pname: str) -> bool:
    if isinstance(module, nn.LayerNorm):
        return True
    if pname in getattr(module, "no_decay_params", ()):
        return True
    return pname == "bias" and isinstance(module, (nn.Linear, nn.Conv2d,
                                                   nn.Conv3d))


def param_labels(model: nn.Module, new_params_name=(),
                 vision_is_clip: bool = False) -> dict[str, str]:
    """Parameter name -> group label (``basic``/``new``/``clip``, with
    ``_nd`` for no decay), as ``vast_tpu``'s ``param_labels``."""
    labels = {}
    for mod_name, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            nd = "_nd" if _no_decay(mod, pname) else ""
            if any(n and n in name for n in new_params_name):
                labels[name] = "new" + nd
            elif vision_is_clip and name.startswith("vision_encoder."):
                labels[name] = "clip" + nd
            else:
                labels[name] = "basic" + nd
    return labels


OPTIMS = ("adamw", "adam", "adamax")


class GroupedAdam:
    """AdamW, Adam or Adamax (``run_cfg.optim``) over ``model``'s
    parameters; :meth:`step` reads their ``.grad`` and updates them in
    place."""

    def __init__(self, model: nn.Module, run_cfg, model_cfg,
                 num_train_steps: int):
        get = run_cfg.get
        self.b1, self.b2 = (float(b) for b in get("betas", (0.9, 0.98)))
        self.optim = get("optim", "adamw")
        if self.optim not in OPTIMS:
            raise ValueError(f"optim {self.optim!r}: one of {OPTIMS}")
        # optax.adam and optax.adamax decay no weight
        self.weight_decay = (float(get("weight_decay", 0.01))
                             if self.optim == "adamw" else 0.0)
        self.accum = int(get("gradient_accumulation_steps", 1) or 1)
        # the schedule advances once per update, so its horizon counts
        # updates, not micro-batches (optimizer.py:57-62)
        self.horizon = max(num_train_steps // self.accum, 1)
        self.scheduler = get("scheduler", "warmup_linear")
        self.warmup_ratio = get("warmup_ratio", 0.1)
        lr = get("learning_rate", 1e-4)
        self.lrs = {"basic": lr, "new": get("new_lr", 0.0) or lr,
                    "clip": get("clip_lr", 5e-7)}
        self.mu_dtype = _moment_dtype(get("adam_mu_dtype"))
        self.nu_dtype = _moment_dtype(get("adam_nu_dtype"))
        if self.optim == "adamax":
            if self.nu_dtype is not None:
                raise ValueError(
                    "adam_nu_dtype is not supported for optim='adamax'")
            self.mu_dtype = None
        self.max_norm = (get("grad_norm", -1)
                         if get("clip_grads", False) else None)
        vision_is_clip = "clip" in model_cfg.get("vision_encoder_type", "")
        self.labels = param_labels(model, tuple(get("new_params_name", [])),
                                   vision_is_clip)
        self.params = {n: p for n, p in model.named_parameters()
                       if p.requires_grad}
        self.mu = {n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=self.nu_dtype or p.dtype)
                   for n, p in self.params.items()}
        self.count = 0          # updates applied
        self.mini_step = 0      # micro-batches accumulated toward the next
        self.acc = ({n: torch.zeros_like(p) for n, p in self.params.items()}
                    if self.accum > 1 else None)
        self.sharding = None

    def _tensors(self):
        return ("mu", "nu") + (("acc",) if self.acc is not None else ())

    @torch.no_grad()
    def reshard(self, sharding) -> None:
        """The parameters were split (``shard_state``): keep this rank's
        part of each moment and of the running mean."""
        self.sharding = sharding
        for key in self._tensors():
            mine = getattr(self, key)
            for n in mine:
                mine[n] = sharding.split(n, mine[n]).clone()

    def state_dict(self) -> dict:
        """What a resumed run needs to continue exactly: the moments, the
        update count (the schedule's position) and the accumulation
        window's micro-batch count and mean gradient; whole tensors under
        sharding (every rank calls it)."""
        out = {"count": self.count, "mini_step": self.mini_step, "acc": None}
        for key in self._tensors():
            out[key] = {n: (t if self.sharding is None
                            else self.sharding.full(n, t))
                        for n, t in getattr(self, key).items()}
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` (:meth:`state_dict`'s form) into this optimizer's
        tensors, in their dtypes and on their device; under sharding this
        rank's parts of the whole tensors."""
        for key in self._tensors():
            mine, theirs = getattr(self, key), state[key]
            if theirs is None or set(theirs) != set(mine):
                raise ValueError(f"optimizer state {key!r} does not match "
                                 f"the model's trainable parameters")
            for n, t in mine.items():
                src = theirs[n].to(t.device)
                if self.sharding is not None:
                    src = self.sharding.split(n, src)
                t.copy_(src)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    def lr(self, group: str, update: int) -> float:
        """The LR of ``group`` at the 1-based ``update``."""
        return self.lrs[group] * get_lr_ratio(update, self.horizon,
                                              self.scheduler,
                                              self.warmup_ratio)

    @torch.no_grad()
    def grads_from_window(self) -> None:
        """Before the last backward of an accumulation window whose
        earlier micro-batches ran under DDP's ``no_sync``: each
        parameter's ``.grad`` becomes the sum of their gradients (the
        running mean times ``accum - 1``), which that backward adds its
        own to and DDP averages over the ranks, as ``no_sync`` would
        leave it; :meth:`step` with ``window_sum`` then takes the mean."""
        if self.acc is None or self.mini_step != self.accum - 1:
            raise RuntimeError("grads_from_window() belongs to the last "
                               "micro-batch of an accumulation window")
        for n, p in self.params.items():
            p.grad = self.acc[n] * (self.accum - 1)
            self.acc[n].zero_()

    @torch.no_grad()
    def step(self, window_sum: bool = False) -> bool:
        """Take this micro-batch's gradients; returns whether the
        parameters were updated (every ``accum``-th call).
        ``window_sum``: ``.grad`` holds the sum of the whole window's
        gradients (:meth:`grads_from_window`), whose mean is applied."""
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.params.items()}
        if window_sum:
            if self.acc is None or self.mini_step != self.accum - 1:
                raise RuntimeError("window_sum belongs to the last "
                                   "micro-batch of an accumulation window")
            self.mini_step = 0
            grads = {n: g / self.accum for n, g in grads.items()}
        elif self.acc is not None:
            k = self.mini_step
            for n, g in grads.items():
                self.acc[n].add_((g - self.acc[n]) / (k + 1))
            if k < self.accum - 1:
                self.mini_step += 1
                return False
            self.mini_step = 0
            grads = {n: a.clone() for n, a in self.acc.items()}
            for a in self.acc.values():
                a.zero_()
        if self.max_norm is not None and self.max_norm > 0:
            norm = (global_norm(grads.values()) if self.sharding is None
                    else self.sharding.global_norm(grads))
            if not bool(norm < self.max_norm):
                for g in grads.values():
                    g.copy_(g / norm.to(g.dtype) * self.max_norm)
        self.count += 1
        k = self.count
        c1, c2 = 1.0 - self.b1 ** k, 1.0 - self.b2 ** k
        for n, p in self.params.items():
            label = self.labels[n]
            group = label.removesuffix("_nd")
            wd = 0.0 if label.endswith("_nd") else self.weight_decay
            u = (self._adamax(n, grads[n].float(), c1)
                 if self.optim == "adamax"
                 else self._adam(n, grads[n].float(), c1, c2))
            if wd:
                u = u + wd * p.float()
            p.add_((u * -self.lr(group, k)).to(p.dtype))
        return True

    def _adam(self, n, g, c1, c2):
        b1, b2 = self.b1, self.b2
        mu, nu = self.mu[n], self.nu[n]
        if self.nu_dtype is not None:
            # scale_by_adam_general: both moments rounded before use
            mu.copy_(b1 * mu.float() + (1 - b1) * g)
            nu.copy_(b2 * nu.float() + (1 - b2) * g * g)
            return (mu.float() / c1) / (torch.sqrt(nu.float() / c2) + EPS)
        # optax.scale_by_adam: b1 * mu in mu's dtype, b1 rounded to it
        # first (JAX's weak-typed scalar); the update uses the new mu
        # before its rounding to mu's dtype
        m = (1 - b1) * g + mu * torch.tensor(b1, dtype=mu.dtype)
        nu.copy_((1 - b2) * g * g + b2 * nu)
        mu.copy_(m)
        return (m / c1) / (torch.sqrt(nu.float() / c2) + EPS)


    def _adamax(self, n, g, c1):
        # optax.scale_by_adamax: mu as Adam's, nu = max(b2 nu, |g| + eps),
        # the update mu / c1 / nu (no bias correction of nu)
        mu, nu = self.mu[n], self.nu[n]
        mu.copy_((1 - self.b1) * g + self.b1 * mu)
        nu.copy_(torch.maximum(g.abs() + EPS, self.b2 * nu))
        return (mu.float() / c1) / nu.float()


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of all ``tensors``, in fp32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def build_optimizer(model: nn.Module, run_cfg, model_cfg,
                    num_train_steps: int):
    """(optimizer, labels), as ``vast_tpu``'s ``build_optimizer``;
    ``num_train_steps`` counts micro-batches."""
    opt = GroupedAdam(model, run_cfg, model_cfg, num_train_steps)
    return opt, opt.labels
