"""Video Swin Transformer tower (``videoswin``: 3-D shifted windows).

Counterpart of ``vast_tpu.models.videoswin`` (reference:
model/vision_encoders/videoswin/videoswin.py, general_module.py:230-243):
a (2, 4, 4) patch embedding over the whole clip, taken with temporal
stride ``time_stride`` (1 in VAST) after one trailing zero frame, so
that T' = T (videoswin.py:346-366); four stages of (8, 7, 7) window
attention with a 3-D relative position bias (``rel_index_3d``), every
second block shifted by half a window with ``shift_mask_3d``; spatial
patch merging between the stages; a final LayerNorm. The output is the
(B, T', H' * W', C) token grid, which VAST mean-pools.

A window's size is clamped to each stage's grid, and, as in
``vast_tpu``, the bias table of a block is sized for that clamped
window: the tower is therefore built for its input's frames and
resolution (``frames``, ``image_size``), and another input whose
windows clamp otherwise raises. A window of 8 x 7 x 7 = 392 tokens at
head width 32 takes whatever route ``ops.attention``'s rule gives it
(392^2 is over 128^2: the head-major kernel, with the bias and mask).

Each stage's forward is a span (``vast.videoswin.stage<S>``,
``profiling.py``) that counts its ``windows`` (clips times windows a
clip) and its ``shifted`` blocks, and, from ``ops.attention``, the
``bias_bytes`` its attention calls materialise: the fp32 sum of the
bias table and the region mask of each shifted block.

Module and parameter names are the reference torch ones (``patch_embed.
proj`` a Conv3d, ``layers.{s}.blocks.{b}.attn.relative_position_bias_
table``, ...), so the state dict is what ``vast_ckpt.convert_videoswin``
reads; the position index and the masks are left out of it. Its blocks'
attention and MLP are Swin's, and split over tp as Swin's do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vast_tpu_torch.models import layers
from vast_tpu_torch.models.remat import check_policy, remat_call
from vast_tpu_torch.models.swin import Mlp, PatchMerging, SwinStage, \
    WindowAttention
from vast_tpu_torch.profiling import span


@dataclasses.dataclass(frozen=True)
class VideoSwinConfig:
    patch_size: tuple = (2, 4, 4)
    embed_dim: int = 128
    depths: tuple = (2, 2, 18, 2)
    num_heads: tuple = (4, 8, 16, 32)
    window_size: tuple = (8, 7, 7)
    mlp_ratio: float = 4.0
    time_stride: int = 1
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


def rel_index_3d(wt: int, wh: int, ww: int) -> np.ndarray:
    """(n, n) bias-table row of each token pair of a (wt, wh, ww) window."""
    coords = np.stack(np.meshgrid(np.arange(wt), np.arange(wh),
                                  np.arange(ww), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wt - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


def window_partition_3d(x, w):
    """(B, T, H, W, C) -> (B * nW, wt * wh * ww, C)."""
    b, t, h, wd, c = x.shape
    wt, wh, ww = w
    x = x.reshape(b, t // wt, wt, h // wh, wh, wd // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wt * wh * ww, c)


def window_reverse_3d(x, w, t, h, wd):
    wt, wh, ww = w
    b = x.shape[0] // ((t // wt) * (h // wh) * (wd // ww))
    x = x.reshape(b, t // wt, h // wh, wd // ww, wt, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, t, h, wd, -1)


def shift_mask_3d(t, h, w, window, shift) -> np.ndarray:
    """(nW, n, n) bool: two tokens of a window in the same region of the
    rolled clip (True = attend)."""
    img = np.zeros((1, t, h, w, 1))
    cnt = 0

    def slc(size, win, sh):
        if sh == 0:
            return (slice(0, size),)
        return (slice(0, -win), slice(-win, -sh), slice(-sh, None))

    for ts in slc(t, window[0], shift[0]):
        for hs in slc(h, window[1], shift[1]):
            for ws in slc(w, window[2], shift[2]):
                img[:, ts, hs, ws, :] = cnt
                cnt += 1
    x = window_partition_3d(torch.from_numpy(img), window)[..., 0].numpy()
    return x[:, :, None] == x[:, None, :]


def _window_and_shift(c: VideoSwinConfig, grid, shifted: bool):
    """The window clamped to ``grid`` (T, H, W), and the shift (none on an
    axis the window covers whole)."""
    win = tuple(min(ws, g) for ws, g in zip(c.window_size, grid))
    shift = tuple(0 if win[i] >= grid[i] else win[i] // 2
                  for i in range(3)) if shifted else (0, 0, 0)
    return win, shift


class VideoSwinBlock(nn.Module):
    def __init__(self, c: VideoSwinConfig, dim, heads, grid, shifted,
                 device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.cfg, self.shifted = c, shifted
        self.window, _ = _window_and_shift(c, grid, shifted)
        wt, wh, ww = self.window
        self.norm1 = layers.LayerNorm(dim, eps=c.ln_eps, **fk)
        self.attn = WindowAttention(
            dim, heads, rel_index_3d(wt, wh, ww),
            (2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1), **fk)
        self.norm2 = layers.LayerNorm(dim, eps=c.ln_eps, **fk)
        self.mlp = Mlp(dim, int(dim * c.mlp_ratio), **fk)
        self._masks = {}

    def _mask(self, grid, win, shift, device):
        key = (grid, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                shift_mask_3d(*grid, win, shift)).to(device)
        return self._masks[key]

    def forward(self, x, grid):
        """x (B, T*H*W, C) over the token ``grid`` (T, H, W)."""
        win, shift = _window_and_shift(self.cfg, grid, self.shifted)
        if win != self.window:
            raise ValueError(f"grid {grid} clamps the window to {win}; this "
                             f"block's bias table is for {self.window}")
        b, _, ch = x.shape
        y = self.norm1(x).view(b, *grid, ch)
        mask = None
        if any(shift):
            y = torch.roll(y, tuple(-s for s in shift), dims=(1, 2, 3))
            mask = self._mask(grid, win, shift, x.device)
        y = self.attn(window_partition_3d(y, win), mask)
        y = window_reverse_3d(y, win, *grid)
        if any(shift):
            y = torch.roll(y, shift, dims=(1, 2, 3))
        x = x + y.reshape(b, -1, ch)
        return x + self.mlp(self.norm2(x))


class VideoPatchEmbed(nn.Module):
    def __init__(self, c: VideoSwinConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        pt, ph, pw = c.patch_size
        self.proj = layers.Conv3d(3, c.embed_dim, (pt, ph, pw),
                                  (c.time_stride, ph, pw), **fk)
        self.norm = layers.LayerNorm(c.embed_dim, eps=c.ln_eps, **fk)

    def forward(self, video):
        """(B, T, H, W, 3) -> (B, C, T', H', W') after one trailing zero
        frame (PatchEmbed3D, videoswin.py:354-366)."""
        x = F.pad(video.permute(0, 4, 1, 2, 3), (0, 0, 0, 0, 0, 1))
        return self.proj(x)


class VideoSwinTransformer(nn.Module):
    def __init__(self, c: VideoSwinConfig, device=None, frames: int = 8,
                 image_size: int = 224):
        """Built for clips of ``frames`` frames at ``image_size`` pixels
        (the grid that sizes each block's clamped window)."""
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.cfg = c
        check_policy(c.remat_policy)
        self.patch_embed = VideoPatchEmbed(c, device)
        pt, ph, pw = c.patch_size
        t = (frames + 1 - pt) // c.time_stride + 1
        h = w = image_size // ph
        dim = c.embed_dim
        stages = []
        # per stage: its span's name, windows a clip and shifted blocks
        self.stage_spans = []
        for si, (depth, heads) in enumerate(zip(c.depths, c.num_heads)):
            blocks = [VideoSwinBlock(c, dim, heads, (t, h, w), bi % 2 == 1,
                                     device) for bi in range(depth)]
            win, shift = _window_and_shift(c, (t, h, w), True)
            self.stage_spans.append((
                f"vast.videoswin.stage{si}",
                (t // win[0]) * (h // win[1]) * (w // win[2]),
                depth // 2 if any(shift) else 0))
            down = None
            if si < len(c.depths) - 1:
                down = PatchMerging(dim, c.ln_eps, **fk)
                h, w = h // 2, w // 2
            stages.append(SwinStage(blocks, down))
            if down is not None:
                dim *= 2
        self.layers = nn.ModuleList(stages)
        self.norm = layers.LayerNorm(dim, eps=c.ln_eps, **fk)

    def forward(self, video, generator: Optional[torch.Generator] = None):
        """(B, T, H, W, 3) normalized -> (B, T', H' * W', num_features).
        VideoSwin draws nothing (``generator`` unused)."""
        c = self.cfg
        x = self.patch_embed(video.to(c.dtype))          # (B, C, T, H, W)
        b, _, t, h, w = x.shape
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        policy = c.remat_policy if c.remat else "none"
        for (name, windows, shifted), stage in zip(self.stage_spans,
                                                   self.layers):
            with span(name) as sp:
                sp.count("windows", b * windows)
                sp.count("shifted", shifted)
                for blk in stage.blocks:
                    x = remat_call(policy, blk, x, (t, h, w))
                if stage.downsample is not None:
                    x = stage.downsample(x.view(b, t, h, w, -1)).reshape(
                        b, t * (h // 2) * (w // 2), -1)
                    h, w = h // 2, w // 2
        x = self.norm(x)
        return x.view(b, t, h * w, x.shape[-1])
