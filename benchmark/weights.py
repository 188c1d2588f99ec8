"""Seeded weights, the same for the program and the reference.

Both models carry the released VAST checkpoint's parameter names, so one
rule over the sorted names fills either: every LayerNorm gain 1 and
every bias 0, as a trained model's stay near those values; the
contrastive temperature 0.07 and BEATs' gate gains 1 (their released
initial values); every other parameter N(0, 0.02), drawn in one call on
the device in fp32 and cut into the parameters in name order.
"""

from __future__ import annotations

import torch
from torch import nn

ONES = ("grep_a",)
CONSTANTS = {"contra_temp": 0.07}


def _layernorm_params(model: nn.Module) -> set:
    out = set()
    for mod_name, mod in model.named_modules():
        if isinstance(mod, nn.LayerNorm):
            out |= {f"{mod_name}.{p}" for p, _ in
                    mod.named_parameters(recurse=False)}
    return out


def _fill(name: str, ln: set):
    """'normal', or the constant the parameter ``name`` starts from."""
    leaf = name.rsplit(".", 1)[-1]
    if name in CONSTANTS:
        return CONSTANTS[name]
    if leaf in ONES or (name in ln and leaf == "weight"):
        return 1.0
    if leaf.endswith("bias") and not name.endswith("relative_attention_bias"
                                                   ".weight"):
        return 0.0
    return "normal"


@torch.no_grad()
def init_weights(model: nn.Module, seed: int, device) -> nn.Module:
    """Fill ``model``'s parameters from ``seed`` on ``device`` (each cast
    to its own dtype)."""
    ln = _layernorm_params(model)
    params = sorted(model.named_parameters(), key=lambda kv: kv[0])
    drawn = [(n, p) for n, p in params if _fill(n, ln) == "normal"]
    total = sum(p.numel() for _, p in drawn)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(0.0, 0.02, generator=g)
    off = 0
    for n, p in drawn:
        p.copy_(flat[off:off + p.numel()].view_as(p))
        off += p.numel()
    del flat
    for n, p in params:
        value = _fill(n, ln)
        if value != "normal":
            p.fill_(value)
    return model
