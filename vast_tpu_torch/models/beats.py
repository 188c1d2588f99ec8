"""BEATs audio transformer.

Counterpart of ``vast_tpu.models.beats`` in the configuration of the
released BEATs_iter3_plus_AS2M checkpoint that VAST uses (deep norm,
post-LN, relative bias, gated relative position): 16x16 patch conv on the
(frames x mel) fbank, LN, projection to 768; the weight-norm grouped
conv positional embedding (weight_norm dim=2: one g per kernel tap);
the T5-style bucketed relative bias, built by layer 0 and threaded
through every layer; the GRU-style gate computed from the unscaled q
with its bias, scaling that bias per sample, head and query; deep-norm
post-LN layers.

Every layer's self-attention runs through the token-major CUDA kernel
with the gated bias, added after the scale ``D**-0.5`` (reference
beats.py:767-769; the alpha=32 rescaling is neutral under softmax).
Parameter names are the reference torch ones.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vast_tpu_torch.models.hmajor import FusedCache, fuse_qkv
from vast_tpu_torch.ops.activations import gelu
from vast_tpu_torch.ops.flash_attention import self_attention_tmajor


@dataclasses.dataclass(frozen=True)
class BeatsConfig:
    input_patch_size: int = 16
    embed_dim: int = 512
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    conv_pos: int = 128
    conv_pos_groups: int = 16
    num_buckets: int = 320
    max_distance: int = 800
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.encoder_embed_dim // self.encoder_attention_heads


def relative_position_bucket(relative_positions: np.ndarray,
                             num_buckets: int = 320,
                             max_distance: int = 800) -> np.ndarray:
    """Bidirectional T5-style bucket ids (beats.py _relative_positions_bucket)."""
    nb = num_buckets // 2
    buckets = (relative_positions > 0).astype(np.int64) * nb
    rp = np.abs(relative_positions)
    max_exact = nb // 2
    is_small = rp < max_exact
    large = max_exact + (
        np.log(np.maximum(rp, 1).astype(np.float64) / max_exact)
        / math.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(is_small, rp, large)


class BeatsAttention(nn.Module):
    def __init__(self, c: BeatsConfig, has_relative_attention_bias: bool,
                 device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.dtype)
        e, h = c.encoder_embed_dim, c.encoder_attention_heads
        self.cfg = c
        self.q_proj = nn.Linear(e, e, **fk)
        self.k_proj = nn.Linear(e, e, **fk)
        self.v_proj = nn.Linear(e, e, **fk)
        self.out_proj = nn.Linear(e, e, **fk)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(c.num_buckets, h,
                                                        **fk)
        self.grep_linear = nn.Linear(c.head_dim, 8, **fk)
        self.grep_a = nn.Parameter(torch.ones(1, h, 1, 1, **fk))
        self._fused = FusedCache()

    def compute_bias(self, length: int):
        """Raw relative bias (H, L, L) in fp32."""
        rel = np.arange(length)[None, :] - np.arange(length)[:, None]
        bucket = relative_position_bucket(rel, self.cfg.num_buckets,
                                          self.cfg.max_distance)
        table = self.relative_attention_bias.weight
        values = table[torch.from_numpy(bucket).to(table.device)]
        return values.permute(2, 0, 1).float()

    def fused_qkv(self):
        ps = (self.q_proj.weight, self.k_proj.weight, self.v_proj.weight,
              self.q_proj.bias, self.k_proj.bias, self.v_proj.bias)
        return self._fused.get(
            ps, lambda: fuse_qkv(*ps, self.cfg.encoder_attention_heads))

    def forward(self, x, position_bias=None):
        """x: (B, L, E) -> (out, position_bias); the raw (ungated) bias is
        threaded through the layers as in the reference."""
        c = self.cfg
        b, l, _ = x.shape
        h, d = c.encoder_attention_heads, c.head_dim
        if position_bias is None:                         # layer 0
            position_bias = self.compute_bias(l)
        w, bb = self.fused_qkv()
        y = F.linear(x, w, bb)                            # (B, L, H*3*D)
        # gate from the unscaled query (reference beats.py:905-915)
        qt = y.view(b, l, h, 3, d)[..., 0, :]             # (B, L, H, D)
        g = self.grep_linear(qt).view(b, l, h, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(g).chunk(2, dim=-1)
        gate = gate_a * (gate_b * self.grep_a.view(1, 1, h, 1) - 1.0) + 2.0
        bias = (gate.transpose(1, 2) * position_bias[None]).to(c.dtype)
        out = self_attention_tmajor(y, bias.contiguous(), heads=h,
                                    scale=d ** -0.5)
        return self.out_proj(out), position_bias


class BeatsLayer(nn.Module):
    def __init__(self, c: BeatsConfig, has_relative_attention_bias: bool,
                 device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.dtype)
        e = c.encoder_embed_dim
        self.self_attn = BeatsAttention(c, has_relative_attention_bias,
                                        device)
        self.self_attn_layer_norm = nn.LayerNorm(e, eps=c.ln_eps, **fk)
        self.fc1 = nn.Linear(e, c.encoder_ffn_embed_dim, **fk)
        self.fc2 = nn.Linear(c.encoder_ffn_embed_dim, e, **fk)
        self.final_layer_norm = nn.LayerNorm(e, eps=c.ln_eps, **fk)
        self.alpha = math.pow(2 * c.encoder_layers, 0.25)   # deep norm

    def forward(self, x, position_bias=None):
        y, position_bias = self.self_attn(x, position_bias)
        x = self.self_attn_layer_norm(x * self.alpha + y)
        y = self.fc2(gelu(self.fc1(x)))
        return self.final_layer_norm(x * self.alpha + y), position_bias


class WeightNormConv1d(nn.Module):
    """Grouped Conv1d under ``weight_norm(dim=2)``: weight = g * v / ||v||
    with the norm over (out, in/groups) per kernel tap; ``weight_v``
    (out, in/groups, k), ``weight_g`` (1, 1, k) as torch stores them."""

    def __init__(self, channels: int, kernel: int, groups: int, device=None,
                 dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.groups = groups
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel, **fk))
        self.weight_v = nn.Parameter(
            torch.zeros(channels, channels // groups, kernel, **fk))
        self.bias = nn.Parameter(torch.zeros(channels, **fk))

    def forward(self, x):
        """x: (B, C, L) -> (B, C, L + 1) (pad k//2 each side)."""
        v = self.weight_v.float()
        norm = torch.sqrt((v ** 2).sum(dim=(0, 1), keepdim=True) + 1e-12)
        w = (self.weight_g.float() / norm * v).to(x.dtype)
        k = v.shape[-1]
        return F.conv1d(x, w, self.bias, padding=k // 2, groups=self.groups)


class BeatsEncoder(nn.Module):
    def __init__(self, c: BeatsConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.dtype)
        self.cfg = c
        self.pos_conv = nn.ModuleList([WeightNormConv1d(
            c.encoder_embed_dim, c.conv_pos, c.conv_pos_groups, **fk)])
        self.layers = nn.ModuleList(
            BeatsLayer(c, i == 0, device)
            for i in range(c.encoder_layers))
        self.layer_norm = nn.LayerNorm(c.encoder_embed_dim, eps=c.ln_eps,
                                       **fk)

    def forward(self, x):
        c = self.cfg
        y = self.pos_conv[0](x.transpose(1, 2))
        if c.conv_pos % 2 == 0:
            y = y[:, :, :-1]               # SamePad trims one for even k
        x = self.layer_norm(x + gelu(y.transpose(1, 2)))
        position_bias = None
        for layer in self.layers:
            x, position_bias = layer(x, position_bias)
        return x


class BeatsModel(nn.Module):
    """fbank (B, T, M) -> tokens (B, (T/16)*(M/16), 768)."""

    def __init__(self, c: BeatsConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.dtype)
        self.cfg = c
        p = c.input_patch_size
        self.patch_embedding = nn.Conv2d(1, c.embed_dim, p, p, bias=False,
                                         **fk)
        self.layer_norm = nn.LayerNorm(c.embed_dim, eps=c.ln_eps, **fk)
        if c.embed_dim != c.encoder_embed_dim:
            self.post_extract_proj = nn.Linear(c.embed_dim,
                                               c.encoder_embed_dim, **fk)
        self.encoder = BeatsEncoder(c, device)

    def forward(self, fbank):
        x = self.patch_embedding(fbank[:, None].to(self.cfg.dtype))
        x = self.layer_norm(x.flatten(2).transpose(1, 2))
        if hasattr(self, "post_extract_proj"):
            x = self.post_extract_proj(x)
        return self.encoder(x)
