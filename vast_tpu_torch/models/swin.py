"""Swin Transformer image tower (``swin_base_22k_224``,
``swin_large_22k_224``).

Counterpart of ``vast_tpu.models.swin`` (reference:
model/vision_encoders/swin/swin.py, general_module.py:528-583): a 4 x 4
patch embedding with its LayerNorm, four stages of (shifted) 7 x 7 window
attention with a learned relative position bias, patch merging (2 x 2
concatenation, LayerNorm, a bias-free reduction) between the stages, and
a final LayerNorm over the last stage's token grid, which VAST
mean-pools. Every second block of a stage shifts its windows by half a
window, and the mask of ``shift_attn_mask`` keeps tokens of different
regions of the rolled image apart.

The window attention is ``ops.window_attention``'s, given the gathered
bias table and, in a shifted block, the region labels of the mask (made
once, a buffer); a window's 49 tokens take its plain route (49 x 49 is
under 128 x 128), as in ``vast_tpu``. Module and parameter names are
the reference torch ones (``patch_embed.proj``, ``patch_embed.norm``,
``layers.{s}.blocks.{b}.attn.qkv``, ``...attn.relative_position_bias_table``,
``layers.{s}.downsample.reduction``, ``norm``), so the state dict is what
``vast_ckpt.convert_swin`` reads; the position index and the masks are
buffers left out of it. Blocks run under activation checkpointing when
asked (models/remat.py). Under tensor parallelism (``parallel/tp.py``)
each block's attention runs on this rank's heads and its MLP on its part
of the hidden size, as ``vast_tpu``'s plan splits ``qkv``, ``proj``,
``fc1`` and ``fc2``; the patch merging's reduction is split over fsdp
only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from vast_tpu_torch.models import layers
from vast_tpu_torch.models.remat import check_policy, remat_call
from vast_tpu_torch.ops.activations import gelu
from vast_tpu_torch.ops.window_attention import region_labels, \
    window_attention
from vast_tpu_torch.parallel import tp as tpl


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    image_size: int = 224
    patch_size: int = 4
    embed_dim: int = 128
    depths: tuple = (2, 2, 18, 2)
    num_heads: tuple = (4, 8, 16, 32)
    window_size: int = 7
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    param_dtype: Optional[torch.dtype] = None     # None: dtype
    remat: bool = False
    remat_policy: str = "dots"

    @property
    def pdtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


SWIN_PRESETS = {
    "swin_base_22k_224": SwinConfig(),
    "swin_large_22k_224": SwinConfig(embed_dim=192, num_heads=(6, 12, 24, 48)),
}
SWIN_VISION_DIMS = {name: c.num_features for name, c in SWIN_PRESETS.items()}


def relative_position_index(window: int) -> np.ndarray:
    """(w^2, w^2) index of each token pair's offset into the bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def window_partition(x, w: int):
    """(B, H, W, C) -> (B * nW, w * w, C), windows in row-major order."""
    b, h, wd, c = x.shape
    x = x.view(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_reverse(x, w: int, h: int, wd: int):
    """:func:`window_partition`'s inverse."""
    b = x.shape[0] // ((h // w) * (wd // w))
    x = x.view(b, h // w, wd // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, -1)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, w^2, w^2) bool, True where two tokens of a window lie in the
    same region of the image rolled by ``shift`` (True = attend)."""
    img = np.zeros((h, w))
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    x = img.reshape(h // window, window, w // window, window)
    x = x.transpose(0, 2, 1, 3).reshape(-1, window * window)
    return x[:, :, None] == x[:, None, :]


class WindowAttention(nn.Module):
    """Multi-head attention inside each window, with the relative
    position bias ``relative_position_bias_table[index]`` (``index``: a
    window's (n, n) table rows) and an optional per-window region mask,
    as labels. Shared by the 2-D and 3-D towers. Under tp this rank runs
    its heads: ``qkv`` holds its heads of each of q, k and v, ``proj`` is
    row-parallel, and the table (whole) gives its heads' columns."""

    def __init__(self, dim, heads, index: np.ndarray, table_rows: int,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.num_heads = heads
        self.heads = heads                # this rank's (tp: H / tp)
        self.tp = None
        self.qkv = layers.Linear(dim, 3 * dim, **fk)
        self.proj = layers.Linear(dim, dim, **fk)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table_rows, heads, **fk))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(index.reshape(-1)).to(device),
                             persistent=False)

    def tp_linears(self) -> dict:
        return {"qkv": ("qkv", 3), "proj": ("proj", 1)}

    def tp_splits(self, tp: int) -> bool:
        return self.num_heads % tp == 0

    def tp_partial_params(self) -> list:
        return ["relative_position_bias_table"]

    def enable_tp(self, tp) -> None:
        tpl.split_module(self, tp)
        self.heads = self.num_heads // tp.size

    def forward(self, x, labels=None):
        """x (nB, n, C); ``labels`` the (nW, n) region labels of a shifted
        block's mask (``ops.window_attention.region_labels``) or None, nB
        a multiple of nW (the windows of each sample in order)."""
        nb, n, c = x.shape
        h, d = self.heads, c // self.num_heads
        q, k, v = self.qkv(x).view(nb, n, 3, h, d).transpose(1, 3).unbind(2)
        table = self.relative_position_bias_table
        if self.tp is not None:
            table = table[:, self.tp.block(self.num_heads)]
        # (h, n, n) with its keys contiguous, as the kernels read a bias
        bias = table[self.relative_position_index].view(n, n, h).permute(
            2, 0, 1).contiguous()
        out = window_attention(q, k, v, bias, labels, scale=d ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(nb, n, h * d))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, **fk):
        super().__init__()
        self.hidden = hidden
        self.tp = None
        self.fc1 = layers.Linear(dim, hidden, **fk)
        self.fc2 = layers.Linear(hidden, dim, **fk)

    def tp_linears(self) -> dict:
        return {"fc1": ("fc1", 1), "fc2": ("fc2", 1)}

    def tp_splits(self, tp: int) -> bool:
        return self.hidden % tp == 0

    def tp_partial_params(self) -> list:
        return []

    def enable_tp(self, tp) -> None:
        tpl.split_module(self, tp)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, c: SwinConfig, dim, heads, resolution, shift,
                 device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.resolution = resolution
        self.window = win = min(c.window_size, resolution)
        self.shift = shift if win < resolution else 0
        self.norm1 = layers.LayerNorm(dim, eps=c.ln_eps, **fk)
        self.attn = WindowAttention(dim, heads, relative_position_index(win),
                                    (2 * win - 1) ** 2, **fk)
        self.norm2 = layers.LayerNorm(dim, eps=c.ln_eps, **fk)
        self.mlp = Mlp(dim, int(dim * c.mlp_ratio), **fk)
        labels = None
        if self.shift:
            labels = region_labels(torch.from_numpy(shift_attn_mask(
                resolution, resolution, win, self.shift))).to(device)
        self.register_buffer("attn_labels", labels, persistent=False)

    def forward(self, x):
        b, l, ch = x.shape
        r, s = self.resolution, self.shift
        y = self.norm1(x).view(b, r, r, ch)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = self.attn(window_partition(y, self.window), self.attn_labels)
        y = window_reverse(y, self.window, r, r)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y.reshape(b, l, ch)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2 x 2 neighbours concatenated, LayerNorm, a bias-free reduction to
    twice the width."""

    def __init__(self, dim, eps, **fk):
        super().__init__()
        self.norm = layers.LayerNorm(4 * dim, eps=eps, **fk)
        self.reduction = layers.Linear(4 * dim, 2 * dim, bias=False, **fk)

    def forward(self, x):
        """x (..., H, W, C) -> (..., H/2 * W/2, 2C)."""
        x = torch.cat([x[..., 0::2, 0::2, :], x[..., 1::2, 0::2, :],
                       x[..., 0::2, 1::2, :], x[..., 1::2, 1::2, :]], dim=-1)
        return self.reduction(self.norm(x.flatten(-3, -2)))


class SwinStage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinPatchEmbed(nn.Module):
    def __init__(self, c: SwinConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.proj = layers.Conv2d(3, c.embed_dim, c.patch_size,
                                  c.patch_size, **fk)
        self.norm = layers.LayerNorm(c.embed_dim, eps=c.ln_eps, **fk)

    def forward(self, pixels):
        """(B, H, W, 3) -> (B, P, C), row-major P."""
        x = self.proj(pixels.permute(0, 3, 1, 2))
        return self.norm(x.flatten(2).transpose(1, 2))


class SwinTransformer(nn.Module):
    def __init__(self, c: SwinConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.cfg = c
        check_policy(c.remat_policy)
        self.patch_embed = SwinPatchEmbed(c, device)
        res, dim = c.image_size // c.patch_size, c.embed_dim
        stages = []
        for si, (depth, heads) in enumerate(zip(c.depths, c.num_heads)):
            blocks = [SwinBlock(c, dim, heads, res,
                                0 if bi % 2 == 0 else c.window_size // 2,
                                device) for bi in range(depth)]
            down = None
            if si < len(c.depths) - 1:
                down = PatchMerging(dim, c.ln_eps, **fk)
            stages.append(SwinStage(blocks, down))
            if down is not None:
                res, dim = res // 2, dim * 2
        self.layers = nn.ModuleList(stages)
        self.norm = layers.LayerNorm(dim, eps=c.ln_eps, **fk)

    def forward(self, pixels, generator: Optional[torch.Generator] = None):
        """(B, H, W, 3) normalized -> (B, L_final, num_features) after the
        final LayerNorm. Swin draws nothing (``generator`` unused)."""
        c = self.cfg
        x = self.patch_embed(pixels.to(c.dtype))
        res = c.image_size // c.patch_size
        policy = c.remat_policy if c.remat else "none"
        for stage in self.layers:
            for blk in stage.blocks:
                x = remat_call(policy, blk, x)
            if stage.downsample is not None:
                x = stage.downsample(x.view(x.shape[0], res, res, -1))
                res //= 2
        return self.norm(x)
