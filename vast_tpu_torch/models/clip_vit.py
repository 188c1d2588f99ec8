"""OpenAI CLIP vision transformer (VAST's ``clip_vit_*`` vision towers).

Counterpart of ``vast_tpu.models.clip_vit`` (reference:
model/vision_encoders/clip/clip.py, selected by ``vision_encoder_type``
``clip_vit_base_16`` / ``clip_vit_base_32`` / ``clip_vit_large_14_336px``,
general_module.py:361-373): a bias-free patch convolution, the class
embedding and learned positional embedding, ``ln_pre``, pre-norm blocks
with QuickGELU, and ``ln_post`` over every token (clip.py:257-262, what
VAST consumes). No drop-path and no dropout, as in ``vast_tpu``.

Each block's packed ``in_proj`` writes (B, L, 3 * W) in one matmul; the
head-major attention reads q, k and v out of it through strides, with no
transpose or copy (ops/flash_attention.py), and its output comes back
token-major, so ``out_proj`` reads it as it is. Backward, autograd stacks
the three gradients back into the packed layout: one copy of the packed
activation per block. Module and parameter names are the reference torch
ones (``transformer.resblocks.{i}.attn.in_proj_weight``, ...), so the
state dict is what ``vast_ckpt.convert_clip_vit`` (vast_ckpt.py:114-139)
reads. Blocks run under activation checkpointing when asked
(models/remat.py); parameters may be kept in ``param_dtype`` and cast to
``dtype`` at use (models/layers.py). Under tensor parallelism
(``parallel/tp.py``) each block's attention runs on this rank's heads
and its MLP on this rank's part of the hidden size, as ``vast_tpu``'s
plan splits ``in_proj``, ``out_proj``, ``c_fc`` and ``c_proj``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vast_tpu_torch.models import layers
from vast_tpu_torch.models.remat import check_policy, remat_call
from vast_tpu_torch.ops.attention import multi_head_attention_hmajor
from vast_tpu_torch.parallel import tp as tpl


@dataclasses.dataclass(frozen=True)
class ClipVitConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    param_dtype: Optional[torch.dtype] = None     # None: dtype
    remat: bool = False
    remat_policy: str = "dots"

    @property
    def pdtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size


CLIP_PRESETS = {
    "clip_vit_base_16": ClipVitConfig(),
    "clip_vit_base_32": ClipVitConfig(patch_size=32),
    "clip_vit_large_14_336px": ClipVitConfig(
        image_size=336, patch_size=14, width=1024, layers=24, heads=16),
}


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters: the packed ``in_proj``
    (q, k, v rows in that order) and ``out_proj``. Under tp the packed
    weight holds this rank's heads of each of q, k and v (its bias stays
    whole and is sliced alike), and ``out_proj`` is row-parallel."""

    # vast_tpu keeps this bias under the leaf name "bias", which its
    # optimizer does not decay (training/optimizer.py)
    no_decay_params = ("in_proj_bias",)

    def __init__(self, c: ClipVitConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.cfg = c
        self.heads = c.heads              # this rank's (tp: H / tp)
        self.tp = None
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * c.width, c.width,
                                                       **fk))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c.width, **fk))
        self.out_proj = layers.Linear(c.width, c.width, **fk)

    def tp_linears(self) -> dict:
        """{layer: (vast_tpu's owner name, runs)}; ``in_proj`` is the bare
        ``in_proj_weight`` / ``in_proj_bias`` pair."""
        return {"in_proj": ("in_proj", 3), "out_proj": ("out_proj", 1)}

    def tp_splits(self, tp: int) -> bool:
        return self.cfg.heads % tp == 0

    def tp_partial_params(self) -> list:
        return []

    def enable_tp(self, tp) -> None:
        tpl.split_module(self, tp)
        self.heads = self.cfg.heads // tp.size

    def forward(self, x):
        b, l, _ = x.shape
        d = self.cfg.width // self.cfg.heads
        x = tpl.copy_to(x, self.tp)
        bias = (self.in_proj_bias if self.tp is None
                else self.tp.part(self.in_proj_bias, 3))
        y = F.linear(x, self.in_proj_weight.to(x.dtype),
                     bias.to(x.dtype))                         # (B, L, 3hD)
        q, k, v = (t.transpose(1, 2) for t in
                   y.view(b, l, 3, self.heads, d).unbind(2))
        out = multi_head_attention_hmajor(q, k, v)             # (B, h, L, D)
        return self.out_proj(out.transpose(1, 2).reshape(b, l,
                                                         self.heads * d))


class ClipMlp(nn.Module):
    def __init__(self, c: ClipVitConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.c_fc = layers.Linear(c.width, 4 * c.width, **fk)
        self.c_proj = layers.Linear(4 * c.width, c.width, **fk)
        self.hidden = 4 * c.width
        self.tp = None

    def tp_linears(self) -> dict:
        return {"c_fc": ("c_fc", 1), "c_proj": ("c_proj", 1)}

    def tp_splits(self, tp: int) -> bool:
        return self.hidden % tp == 0

    def tp_partial_params(self) -> list:
        return []

    def enable_tp(self, tp) -> None:
        tpl.split_module(self, tp)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ClipBlock(nn.Module):
    def __init__(self, c: ClipVitConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.ln_1 = layers.LayerNorm(c.width, eps=c.ln_eps, **fk)
        self.attn = ClipAttention(c, device)
        self.ln_2 = layers.LayerNorm(c.width, eps=c.ln_eps, **fk)
        self.mlp = ClipMlp(c, device)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class ClipTransformer(nn.Module):
    def __init__(self, c: ClipVitConfig, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(ClipBlock(c, device)
                                       for _ in range(c.layers))


class ClipVisionTransformer(nn.Module):
    def __init__(self, c: ClipVitConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.cfg = c
        check_policy(c.remat_policy)
        self.conv1 = layers.Conv2d(3, c.width, c.patch_size, c.patch_size,
                                   bias=False, **fk)
        self.class_embedding = nn.Parameter(torch.zeros(c.width, **fk))
        self.positional_embedding = nn.Parameter(
            torch.zeros(c.grid_size ** 2 + 1, c.width, **fk))
        self.ln_pre = layers.LayerNorm(c.width, eps=c.ln_eps, **fk)
        self.transformer = ClipTransformer(c, device)
        self.ln_post = layers.LayerNorm(c.width, eps=c.ln_eps, **fk)

    def forward(self, pixels, generator: Optional[torch.Generator] = None):
        """pixels: (B, H, W, 3) normalized -> (B, 1+P, width) all tokens.
        CLIP draws nothing at random (no drop-path), so ``generator``, the
        vision towers' common argument, is not read."""
        c = self.cfg
        x = self.conv1(pixels.to(c.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                       # (B, P, W)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        policy = c.remat_policy if c.remat else "none"
        for blk in self.transformer.resblocks:
            x = remat_call(policy, blk, x)
        return self.ln_post(x)
