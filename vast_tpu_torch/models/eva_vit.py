"""EVA01-CLIP vision transformer (the VAST default, EVA01-g/14).

Counterpart of ``vast_tpu.models.eva_vit`` for the EVA01 preset only:
rope-free, fused qkv with q/v biases (k bias zero), plain GELU MLP
(exact erf in fp32, tanh in bf16: vast_tpu eva_vit.py:75-81), pre-norm
blocks. The EVA02 and bigE presets (rope, sub-LN, SwiGLU, post-norm) are
not in ``EVA_PRESETS`` yet; ``VASTConfig`` raises ``NotImplementedError``
for them.

Module and parameter names are the reference torch ones
(``blocks.{i}.attn.qkv.weight``, ``...q_bias``, ``...v_bias``), so
released weights load as they are. Attention runs through the
token-major CUDA kernel with the query scale baked into the fused
weights (scale 1.0 in the kernel), at the true L = 257: no padding.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vast_tpu_torch.models.hmajor import FusedCache, fuse_qkv
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
    dtype: torch.dtype = torch.float32

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
        fk = dict(device=device, dtype=c.dtype)
        self.cfg = c
        all_dim = c.num_heads * c.head_width
        self.qkv = nn.Linear(c.width, 3 * all_dim, bias=False, **fk)
        self.q_bias = nn.Parameter(torch.zeros(all_dim, **fk))
        self.v_bias = nn.Parameter(torch.zeros(all_dim, **fk))
        self.proj = nn.Linear(all_dim, c.width, **fk)
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
        y = F.linear(x, w, b)                             # (B, L, H*3*D)
        out = self_attention_tmajor(y, heads=self.cfg.num_heads)
        return self.proj(out)


class EvaMlp(nn.Module):
    def __init__(self, c: EvaVitConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.dtype)
        hidden = int(c.width * c.mlp_ratio)
        self.fc1 = nn.Linear(c.width, hidden, **fk)
        self.fc2 = nn.Linear(hidden, c.width, **fk)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class EvaBlock(nn.Module):
    def __init__(self, c: EvaVitConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.dtype)
        self.norm1 = nn.LayerNorm(c.width, eps=c.ln_eps, **fk)
        self.attn = EvaAttention(c, device)
        self.norm2 = nn.LayerNorm(c.width, eps=c.ln_eps, **fk)
        self.mlp = EvaMlp(c, device)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, c: EvaVitConfig, device=None):
        super().__init__()
        self.proj = nn.Conv2d(3, c.width, c.patch_size, c.patch_size,
                              device=device, dtype=c.dtype)

    def forward(self, pixels):
        """(B, H, W, 3) channels-last -> (B, P, width), row-major P."""
        x = self.proj(pixels.permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)


class EvaVisionTransformer(nn.Module):
    def __init__(self, c: EvaVitConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.dtype)
        self.cfg = c
        self.patch_embed = PatchEmbed(c, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width, **fk))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, c.num_patches + 1, c.width, **fk))
        self.blocks = nn.ModuleList(EvaBlock(c, device)
                                    for _ in range(c.layers))
        self.norm = nn.LayerNorm(c.width, eps=c.ln_eps, **fk)

    def forward(self, pixels):
        """pixels: (B, H, W, 3) normalized -> (B, 1+P, width) all tokens."""
        x = self.patch_embed(pixels.to(self.cfg.dtype))
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)
