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

On CUDA one launch of a hand-written kernel (``csrc/multi_tensor_adam.cu``,
built at the first CUDA step) updates every tensor, with the arithmetic
above element by element in fp32; it takes contiguous fp32 parameters on
one card with fp32 or bf16 moments, and the optimizer refuses any other
CUDA tensor. The per-tensor loop (``GroupedAdam._update_plain``) updates
CPU tensors and is the plain version the kernel is held to. The kernel's
tables of parameter and moment pointers are built at the first CUDA step
and again after ``reshard``, ``load_state_dict`` or a parameter's storage
moving; a step writes only its gradient pointers, into one pinned buffer
sent by one copy, and a clipping norm stays on the device. ``LAUNCHES``
counts the kernel's launches; ``GroupedAdam.last_counts`` holds the last
update's ``tensors`` (updated by the kernel) and ``launches``, which
``training/step.py`` counts on the span ``vast.train.optimizer``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from vast_tpu_torch.training.sched import get_lr_ratio

EPS = 1e-6
# elements a block of the kernel updates (csrc/multi_tensor_adam.cu kChunk)
CHUNK = 65536
# the kernel's group index of each label
GROUPS = ("basic", "basic_nd", "new", "new_nd", "clip", "clip_nd")
# the kernel's launches; tests read them
LAUNCHES = {"multi_tensor_adam": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
        self._fused = None      # the kernel's tables, built at a step
        # the last update's tensors updated by the kernel and its launches
        self.last_counts = {"tensors": 0, "launches": 0}

    def _tensors(self):
        return ("mu", "nu") + (("acc",) if self.acc is not None else ())

    @torch.no_grad()
    def reshard(self, sharding) -> None:
        """The parameters were split (``shard_state``): keep this rank's
        part of each moment and of the running mean."""
        self.sharding = sharding
        self._fused = None
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
        self._fused = None
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
        self.last_counts = {"tensors": 0, "launches": 0}
        # None: the loss did not reach the parameter, a zero gradient
        grads = {n: p.grad for n, p in self.params.items()}
        if window_sum:
            if self.acc is None or self.mini_step != self.accum - 1:
                raise RuntimeError("window_sum belongs to the last "
                                   "micro-batch of an accumulation window")
            self.mini_step = 0
            grads = {n: None if g is None else g / self.accum
                     for n, g in grads.items()}
        elif self.acc is not None:
            k = self.mini_step
            for n, g in grads.items():
                a = self.acc[n]
                a.add_(((torch.zeros_like(a) if g is None else g) - a)
                       / (k + 1))
            if k < self.accum - 1:
                self.mini_step += 1
                return False
            self.mini_step = 0
            grads = {n: a.clone() for n, a in self.acc.items()}
            for a in self.acc.values():
                a.zero_()
        norm = None
        if self.max_norm is not None and self.max_norm > 0:
            norm = (global_norm(g for g in grads.values() if g is not None)
                    if self.sharding is None
                    else self.sharding.global_norm(grads))
        self.count += 1
        k = self.count
        c1, c2 = 1.0 - self.b1 ** k, 1.0 - self.b2 ** k
        for n in self._fused_step(grads, norm, k, c1, c2):
            self._update_plain(n, grads[n], norm, k, c1, c2)
        return True

    def _fused_step(self, grads: dict, norm, k: int, c1: float,
                    c2: float) -> list:
        """The kernel's launch over the CUDA tensors; returns the names of
        the CPU ones, left to the per-tensor loop."""
        fused = self._fused
        if fused is None:
            fused = self._fused = _FusedUpdate(self)
        if not fused.names:
            return fused.plain
        values = self.kernel_scalars(k, c1, c2, norm is not None)
        scalars = (ctypes.c_float * len(values))(*values)
        if not fused.launch(grads, norm, scalars):
            # a parameter's storage moved since the tables were built
            self._fused = None
            return self._fused_step(grads, norm, k, c1, c2)
        self.last_counts = {"tensors": len(fused.names), "launches": 1}
        return fused.plain

    def kernel_scalars(self, k: int, c1: float, c2: float,
                       clipping: bool) -> list:
        """The kernel's scalars of the ``k``-th update, in its order:
        1 - b1, b1 in mu's dtype, b1, 1 - b2, b2, eps, c1, c2, max_norm,
        then -lr and the weight decay of each of ``GROUPS``."""
        groups = [(label.removesuffix("_nd"), label.endswith("_nd"))
                  for label in GROUPS]
        b1_mu = torch.tensor(self.b1, dtype=self.mu_dtype
                             or torch.float32).item()
        return [1.0 - self.b1, b1_mu, self.b1, 1.0 - self.b2, self.b2, EPS,
                c1, c2, float(self.max_norm) if clipping else 0.0,
                *(-self.lr(group, k) for group, _ in groups),
                *(0.0 if nd else self.weight_decay for _, nd in groups)]

    def _update_plain(self, n, g, norm, k, c1, c2):
        """The update of one tensor in plain tensor ops: CPU tensors, and
        the version the kernel is held to."""
        p = self.params[n]
        g = torch.zeros_like(p) if g is None else g
        if norm is not None:
            # optax.clip_by_global_norm, with no host wait
            g = torch.where(norm < self.max_norm, g,
                            g / norm.to(g.dtype) * self.max_norm)
        label = self.labels[n]
        group = label.removesuffix("_nd")
        wd = 0.0 if label.endswith("_nd") else self.weight_decay
        u = (self._adamax(n, g.float(), c1) if self.optim == "adamax"
             else self._adam(n, g.float(), c1, c2))
        if wd:
            u = u + wd * p.float()
        p.add_((u * -self.lr(group, k)).to(p.dtype))

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


class _FusedUpdate:
    """The kernel's tables over the CUDA tensors of ``opt``: ``names``
    lists them in table order, ``plain`` the CPU ones, which the
    per-tensor loop updates. The tables hold the parameters' and moments'
    pointers, so they are built again after a reshard or a load; a step
    writes only its gradient pointers (:meth:`launch`)."""

    def __init__(self, opt: GroupedAdam):
        self.names = [n for n, p in opt.params.items() if p.is_cuda]
        taken = set(self.names)
        self.plain = [n for n in opt.params if n not in taken]
        self.params = [opt.params[n] for n in self.names]
        self.param_ptrs = [p.data_ptr() for p in self.params]
        if not self.names:
            return
        check_kernel_takes(opt, self.names)
        device = self.params[0].device
        tensors, chunks = tables(opt, self.names)
        self.n_chunks = len(chunks)
        self.tensors = torch.from_numpy(tensors).to(device)
        self.chunks = torch.from_numpy(chunks).to(device)
        # this step's gradient pointers, written on the host, one copy
        self.host = torch.zeros(len(self.names), dtype=torch.int64,
                                pin_memory=True)
        self.host_ptrs = self.host.numpy()
        self.grads = torch.zeros(len(self.names), dtype=torch.int64,
                                 device=device)
        self.copied = torch.cuda.Event()  # that copy's end
        self.mode = (2 if opt.optim == "adamax"
                     else 1 if opt.nu_dtype is not None else 0)
        first = self.names[0]
        self.dtypes = (_DTYPE_CODES[opt.mu[first].dtype],
                       _DTYPE_CODES[opt.nu[first].dtype])

    def launch(self, grads: dict, norm, scalars) -> bool:
        """One launch over the tables with ``grads`` (name -> tensor or
        None) and ``norm`` (a device scalar, or None without clipping);
        False, launching nothing, where a parameter's storage moved since
        the tables were built."""
        ptrs = []
        for n, p, ptr in zip(self.names, self.params, self.param_ptrs):
            if p.data_ptr() != ptr:
                return False
            g = grads[n]
            if g is None:
                ptrs.append(0)
                continue
            if g.dtype is not torch.float32 or not g.is_contiguous():
                raise ValueError(f"{n}: the optimizer's kernel takes "
                                 f"contiguous float32 gradients")
            ptrs.append(g.data_ptr())
        self.copied.synchronize()   # the host buffer's last copy is done
        self.host_ptrs[:] = ptrs
        device = self.grads.device
        if norm is not None:
            norm = norm.to(device, torch.float32)
        with torch.cuda.device(device):
            self.grads.copy_(self.host, non_blocking=True)
            self.copied.record()
            err = _kernel()(
                _ptr(self.tensors), _ptr(self.chunks), _ptr(self.grads),
                self.n_chunks, self.mode, *self.dtypes, scalars, _ptr(norm),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"multi_tensor_adam kernel launch failed: "
                               f"CUDA error {err}")
        LAUNCHES["multi_tensor_adam"] += 1
        return True


def check_kernel_takes(opt: GroupedAdam, names) -> None:
    """Raise unless the kernel can update every tensor of ``names``: one
    card; contiguous fp32 parameters; contiguous moments, fp32 or bf16,
    one dtype each (the parameters' dtype fixes it)."""
    devices = {opt.params[n].device for n in names}
    if len(devices) > 1:
        raise ValueError(f"the optimizer's CUDA parameters lie on "
                         f"{sorted(map(str, devices))}; its kernel "
                         f"updates those of one card")
    for n in names:
        p, mu, nu = opt.params[n], opt.mu[n], opt.nu[n]
        if (p.dtype != torch.float32 or mu.dtype not in _DTYPE_CODES
                or nu.dtype not in _DTYPE_CODES):
            raise ValueError(
                f"{n}: the optimizer's kernel updates float32 parameters "
                f"with float32 or bfloat16 moments, not {p.dtype} with "
                f"{mu.dtype} and {nu.dtype} (adam_mu_dtype, adam_nu_dtype)")
        if not (p.is_contiguous() and mu.is_contiguous()
                and nu.is_contiguous()):
            raise ValueError(f"{n}: the optimizer's kernel updates "
                             f"contiguous parameters and moments")


def tables(opt: GroupedAdam, names) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's tables over ``opt``'s tensors ``names``, int64: a row
    per tensor (parameter, mu and nu pointers, elements, index in
    ``GROUPS`` of its label) and per chunk of ``CHUNK`` elements (the
    tensor's row, its first element)."""
    params = [opt.params[n] for n in names]
    tensors = np.array([(p.data_ptr(), opt.mu[n].data_ptr(),
                         opt.nu[n].data_ptr(), p.numel(),
                         GROUPS.index(opt.labels[n]))
                        for n, p in zip(names, params)],
                       np.int64).reshape(-1, 5)
    chunks = np.array([(t, s) for t, p in enumerate(params)
                       for s in range(0, p.numel(), CHUNK)],
                      np.int64).reshape(-1, 2)
    return tensors, chunks


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _kernel():
    from vast_tpu_torch.build import load

    fn = load("multi_tensor_adam").vast_multi_tensor_adam
    if fn.argtypes is None:
        fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                       ctypes.c_void_p, ctypes.c_void_p)
        fn.restype = ctypes.c_int
    return fn


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of all ``tensors``, in fp32 (0 for
    none)."""
    return torch.sqrt(sum((t.float().square().sum() for t in tensors),
                          torch.zeros(())))


def build_optimizer(model: nn.Module, run_cfg, model_cfg,
                    num_train_steps: int):
    """(optimizer, labels), as ``vast_tpu``'s ``build_optimizer``;
    ``num_train_steps`` counts micro-batches."""
    opt = GroupedAdam(model, run_cfg, model_cfg, num_train_steps)
    return opt, opt.labels
