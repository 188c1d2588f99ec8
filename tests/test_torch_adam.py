"""GroupedAdam's bookkeeping around its multi-tensor kernel, on the CPU:
the kernel's tables (each chunk's tensor, group, LR and weight decay; a
large tensor split into chunks), the moments as name -> tensor of the
parameter's shape through construction, ``reshard`` and
``load_state_dict``, the exact ``state_dict`` round trip, and a missing
gradient stepping as a zero one. The kernel itself runs in
``tests/test_torch_adam_gpu.py``."""

import math

import numpy as np
import pytest
import torch
from torch import nn

from vast_tpu_torch.training import optimizer as optim_mod
from vast_tpu_torch.training.optimizer import (CHUNK, GROUPS,
                                               build_optimizer, tables)

RUN_CFG = {"learning_rate": 1e-3, "clip_lr": 2e-4, "new_lr": 5e-3,
           "new_params_name": ["head_new"], "betas": [0.9, 0.98],
           "weight_decay": 0.01, "scheduler": "warmup_linear",
           "warmup_ratio": 0.1}
MODEL_CFG = {"vision_encoder_type": "clip_vit_large_336"}


class Toy(nn.Module):
    """Every group of GroupedAdam (``basic``, ``new``, ``clip``, each with
    and without decay) and the kernel's edges: one element (``scale``),
    lengths that are not a multiple of the vector width, a tensor of four
    chunks (``vision_encoder.weight``), a parameter 4 bytes past an
    aligned address (``offset``) and one the tests give no gradient
    (``unused``). Values drawn from ``generator`` on the CPU."""

    def __init__(self, generator, device="cpu"):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(1, device=device))
        self.proj = nn.Linear(5, 7, device=device)
        self.norm = nn.LayerNorm(7, device=device)
        self.head_new = nn.Linear(7, 3, device=device)
        self.vision_encoder = nn.Linear(513, 384, device=device)
        self.offset = nn.Parameter(torch.empty(12, device=device)[1:])
        self.unused = nn.Parameter(torch.empty(9, device=device))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=generator))


def grads_for(model, generator, scale=0.1) -> dict:
    """A gradient for each parameter but ``unused``, drawn on the CPU."""
    return {n: (torch.randn(p.shape, generator=generator) * scale)
            for n, p in model.named_parameters() if n != "unused"}


def set_grads(model, grads: dict) -> None:
    for n, p in model.named_parameters():
        p.grad = grads[n].to(p.device) if n in grads else None


def test_tables_give_each_chunk_its_tensor_group_lr_and_wd():
    model = Toy(torch.Generator().manual_seed(0))
    opt, labels = build_optimizer(model, RUN_CFG, MODEL_CFG, 10)
    assert {labels[n] for n in opt.params} == set(GROUPS)
    names = list(opt.params)
    tensors, chunks = tables(opt, names)
    assert tensors.shape == (len(names), 5)
    for row, n in zip(tensors, names):
        p = opt.params[n]
        assert tuple(row) == (p.data_ptr(), opt.mu[n].data_ptr(),
                              opt.nu[n].data_ptr(), p.numel(),
                              GROUPS.index(labels[n]))
    # every tensor in chunks of CHUNK elements from 0, one at least
    big = names.index("vision_encoder.weight")
    assert opt.params["vision_encoder.weight"].numel() > 3 * CHUNK
    for t, n in enumerate(names):
        starts = chunks[chunks[:, 0] == t, 1].tolist()
        assert starts == list(range(0, opt.params[n].numel(), CHUNK))
        assert len(starts) == (4 if t == big else 1)
    assert len(chunks) == sum(math.ceil(p.numel() / CHUNK)
                              for p in opt.params.values())
    # each chunk's LR and weight decay, from the scalars by its group
    k = 3
    scalars = np.float32(opt.kernel_scalars(k, 1 - 0.9 ** k, 1 - 0.98 ** k,
                                            False))
    assert len(scalars) == 9 + 2 * len(GROUPS)
    for t, _ in chunks:
        label = labels[names[t]]
        group = tensors[t, 4]
        assert scalars[9 + group] == np.float32(
            -opt.lr(label.removesuffix("_nd"), k))
        assert scalars[15 + group] == (0.0 if label.endswith("_nd")
                                       else np.float32(0.01))


@pytest.mark.parametrize("moments", [{}, {"adam_mu_dtype": "bfloat16"},
                                     {"adam_mu_dtype": "bfloat16",
                                      "adam_nu_dtype": "bfloat16"}],
                         ids=["fp32", "bf16_mu", "bf16_both"])
def test_moments_are_tensors_of_the_parameters_shapes(moments):
    model = Toy(torch.Generator().manual_seed(0))
    opt, _ = build_optimizer(model, dict(RUN_CFG, **moments), MODEL_CFG, 10)
    for key, dtype in (("mu", moments.get("adam_mu_dtype")),
                       ("nu", moments.get("adam_nu_dtype"))):
        mine = getattr(opt, key)
        assert list(mine) == list(opt.params)
        assert all(mine[n].shape == p.shape and mine[n].is_contiguous()
                   and mine[n].dtype == getattr(torch, dtype or "float32")
                   and not mine[n].any()
                   for n, p in opt.params.items())
    # a CPU model: the kernel takes nothing, the loop everything
    fused = optim_mod._FusedUpdate(opt)
    assert fused.names == [] and fused.plain == list(opt.params)


class HalfRows:
    """A sharding stub: the first half of the rows of each 2-D tensor,
    everything else whole (``ShardedParams.split``'s part)."""

    def split(self, name, full):
        if full.dim() != 2:
            return full
        return full[: full.shape[0] // 2].contiguous()

    def full(self, name, t):
        return t


def test_reshard_keeps_each_moments_part():
    model = Toy(torch.Generator().manual_seed(0))
    opt, _ = build_optimizer(model, RUN_CFG, MODEL_CFG, 10)
    set_grads(model, grads_for(model, torch.Generator().manual_seed(1)))
    opt.step()
    before = {key: {n: t.clone() for n, t in getattr(opt, key).items()}
              for key in ("mu", "nu")}
    sh = HalfRows()
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.data = sh.split(n, p.data)
    opt.reshard(sh)
    assert opt._fused is None
    for key in ("mu", "nu"):
        mine = getattr(opt, key)
        assert list(mine) == list(opt.params)
        for n, t in mine.items():
            assert t.shape == opt.params[n].shape and t.is_contiguous()
            assert torch.equal(t, sh.split(n, before[key][n]))
    # the split state steps, the kernel's tables rebuilt from it
    set_grads(model, grads_for(model, torch.Generator().manual_seed(2)))
    assert opt.step()
    assert opt._fused.plain == list(opt.params)


@pytest.mark.parametrize("cfg", [{}, {"optim": "adam",
                                      "adam_mu_dtype": "bfloat16"},
                                 {"adam_mu_dtype": "bfloat16",
                                  "adam_nu_dtype": "bfloat16"},
                                 {"optim": "adamax"}],
                         ids=["adamw", "adam_bf16_mu", "adamw_bf16_both",
                              "adamax"])
def test_state_dict_round_trip_is_exact(cfg):
    run_cfg = dict(RUN_CFG, **cfg)
    model = Toy(torch.Generator().manual_seed(0))
    opt, _ = build_optimizer(model, run_cfg, MODEL_CFG, 10)
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        set_grads(model, grads_for(model, g))
        opt.step()
    state = opt.state_dict()
    twin = Toy(torch.Generator().manual_seed(0))
    twin.load_state_dict(model.state_dict())
    other, _ = build_optimizer(twin, run_cfg, MODEL_CFG, 10)
    other.load_state_dict(state)
    assert other.count == opt.count == 2
    for key in ("mu", "nu"):
        for n, t in getattr(opt, key).items():
            assert torch.equal(getattr(other, key)[n], t), (key, n)
    # and both step on alike
    grads = grads_for(model, g)
    for m, o in ((model, opt), (twin, other)):
        set_grads(m, grads)
        o.step()
    for (n, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(ValueError, match="does not match"):
        other.load_state_dict(dict(state, mu={}))


@pytest.mark.parametrize("clip", [None, 0.5, 1e4],
                         ids=["no_clip", "clipped", "below_max_norm"])
def test_missing_gradient_steps_as_a_zero_gradient(clip):
    cfg = (dict(RUN_CFG, clip_grads=True, grad_norm=clip) if clip
           else RUN_CFG)
    runs = []
    for explicit in (False, True):
        model = Toy(torch.Generator().manual_seed(0))
        opt, _ = build_optimizer(model, cfg, MODEL_CFG, 10)
        g = torch.Generator().manual_seed(1)
        for _ in range(3):
            grads = grads_for(model, g)
            if explicit:
                grads["unused"] = torch.zeros(9)
            set_grads(model, grads)
            opt.step()
        runs.append({n: p.detach().clone()
                     for n, p in model.named_parameters()})
    start = dict(Toy(torch.Generator().manual_seed(0)).named_parameters())
    # weight decay still moves it
    assert not torch.equal(runs[0]["unused"], start["unused"])
    for n in runs[0]:
        assert torch.equal(runs[0][n], runs[1][n]), n
