"""EVA01-CLIP vision transformer (the VAST default, EVA01-g/14).

Counterpart of ``vast_tpu.models.eva_vit`` for the EVA01 preset only:
rope-free, fused qkv with q/v biases (k bias zero), plain GELU MLP
(exact erf in fp32, tanh in bf16: vast_tpu eva_vit.py:75-81), pre-norm
blocks. The EVA02, bigE and 448 px presets (rope, sub-LN, SwiGLU,
post-norm) are not in ``EVA_PRESETS`` yet, and ``VASTConfig`` raises
``NotImplementedError`` for them; the CLIP towers are in
``models/clip_vit.py``.

Module and parameter names are the reference torch ones
(``blocks.{i}.attn.qkv.weight``, ``...q_bias``, ``...v_bias``), so
released weights load as they are. Attention runs through the
token-major CUDA kernels (forward and backward) with the query scale
baked into the fused weights (scale 1.0 in the kernel), at the true
L = 257: no padding. Training adds drop-path (eva_vit.py:299-303, one
keep decision per sample, rates rising linearly over the blocks) and
activation checkpointing per block (models/remat.py); parameters may be
kept in ``param_dtype`` and cast to ``dtype`` at use (models/layers.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vast_tpu_torch.models import layers
from vast_tpu_torch.models.hmajor import FusedCache, fuse_qkv
from vast_tpu_torch.models.remat import check_policy, remat_call
from vast_tpu_torch.ops.activations import gelu
from vast_tpu_torch.ops.flash_attention import self_attention_tmajor


@dataclasses.dataclass(frozen=True)
class EvaVitConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    layers: int = 40
    head_width: int = 88
    mlp_ratio: float = 4.3637
    ln_eps: float = 1e-6
    drop_path_rate: float = 0.0
    dtype: torch.dtype = torch.float32
    param_dtype: Optional[torch.dtype] = None     # None: dtype
    remat: bool = False
    remat_policy: str = "dots"

    @property
    def pdtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype

    @property
    def num_heads(self) -> int:
        return self.width // self.head_width

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


EVA_PRESETS = {"evaclip01_giant": EvaVitConfig()}


class EvaAttention(nn.Module):
    def __init__(self, c: EvaVitConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.cfg = c
        all_dim = c.num_heads * c.head_width
        self.qkv = layers.Linear(c.width, 3 * all_dim, bias=False, **fk)
        self.q_bias = nn.Parameter(torch.zeros(all_dim, **fk))
        self.v_bias = nn.Parameter(torch.zeros(all_dim, **fk))
        self.proj = layers.Linear(all_dim, c.width, **fk)
        self._fused = FusedCache()

    def fused_qkv(self):
        """(H*3*D, W) weight and (H*3*D,) bias in the kernel's layout."""
        c = self.cfg
        w, qb, vb = self.qkv.weight, self.q_bias, self.v_bias

        def build():
            wq, wk, wv = w.chunk(3, dim=0)
            return fuse_qkv(wq, wk, wv, qb, torch.zeros_like(qb), vb,
                            c.num_heads, q_scale=c.head_width ** -0.5)
        return self._fused.get((w, qb, vb), build)

    def forward(self, x):
        w, b = self.fused_qkv()
        y = F.linear(x, w.to(x.dtype), b.to(x.dtype))     # (B, L, H*3*D)
        out = self_attention_tmajor(y, heads=self.cfg.num_heads)
        return self.proj(out)


class EvaMlp(nn.Module):
    def __init__(self, c: EvaVitConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        hidden = int(c.width * c.mlp_ratio)
        self.fc1 = layers.Linear(c.width, hidden, **fk)
        self.fc2 = layers.Linear(hidden, c.width, **fk)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class EvaBlock(nn.Module):
    def __init__(self, c: EvaVitConfig, drop_path: float = 0.0,
                 device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.drop_path = drop_path
        self.norm1 = layers.LayerNorm(c.width, eps=c.ln_eps, **fk)
        self.attn = EvaAttention(c, device)
        self.norm2 = layers.LayerNorm(c.width, eps=c.ln_eps, **fk)
        self.mlp = EvaMlp(c, device)

    def _drop_path(self, x, generator):
        if generator is None or self.drop_path == 0.0:
            return x
        keep = 1.0 - self.drop_path
        mask = torch.empty((x.shape[0], 1, 1), dtype=x.dtype,
                           device=x.device).bernoulli_(keep,
                                                       generator=generator)
        return x * mask / keep

    def forward(self, x, seed: Optional[int] = None):
        """``seed`` (training): drop-path's draws; None: deterministic."""
        g = None if seed is None else layers.seeded(seed, x.device)
        x = x + self._drop_path(self.attn(self.norm1(x)), g)
        return x + self._drop_path(self.mlp(self.norm2(x)), g)


class PatchEmbed(nn.Module):
    def __init__(self, c: EvaVitConfig, device=None):
        super().__init__()
        self.proj = layers.Conv2d(3, c.width, c.patch_size, c.patch_size,
                                  device=device, dtype=c.pdtype)

    def forward(self, pixels):
        """(B, H, W, 3) channels-last -> (B, P, width), row-major P."""
        x = self.proj(pixels.permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)


class EvaVisionTransformer(nn.Module):
    def __init__(self, c: EvaVitConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.cfg = c
        check_policy(c.remat_policy)
        self.patch_embed = PatchEmbed(c, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width, **fk))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, c.num_patches + 1, c.width, **fk))
        rates = np.linspace(0, c.drop_path_rate, c.layers)
        self.blocks = nn.ModuleList(EvaBlock(c, float(r), device)
                                    for r in rates)
        self.norm = layers.LayerNorm(c.width, eps=c.ln_eps, **fk)

    def forward(self, pixels, generator: Optional[torch.Generator] = None):
        """pixels: (B, H, W, 3) normalized -> (B, 1+P, width) all tokens.
        ``generator`` (the step's, training): drop-path on; None: off."""
        c = self.cfg
        x = self.patch_embed(pixels.to(c.dtype))
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        policy = c.remat_policy if c.remat else "none"
        for blk in self.blocks:
            seed = None
            if generator is not None and blk.drop_path > 0.0:
                seed = layers.next_seed(generator)
            x = remat_call(policy, blk, x, seed)
        return self.norm(x)
