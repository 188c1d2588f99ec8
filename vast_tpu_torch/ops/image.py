"""Frame preprocessing for evaluation: resize, center crop, normalize.

Counterpart of the eval branches of ``vast_tpu.ops.image``. Frames arrive
as uint8 (B, N, H, W, 3) on the device and leave normalized float32 in
the same channels-last layout.

Resizing reproduces ``jax.image.resize(..., "bilinear")`` exactly: a
separable triangle filter whose support widens by the downscale factor
(antialiasing) and whose weights are renormalized at the borders.
``F.interpolate`` antialiases only with ``antialias=True`` and then uses
its own border rule, so the weights are built here instead and applied
as two small matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_image(x, mean=CLIP_MEAN, std=CLIP_STD):
    """x: (..., H, W, 3) in [0, 1] -> normalized."""
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


@functools.lru_cache(maxsize=16)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) bilinear weights of jax.image.resize
    (jax/_src/image/scale.py compute_weight_mat, translation 0)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)            # antialias on downscale
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def _resize_hw(x, out_h: int, out_w: int):
    """Bilinear resize of the (H, W) axes of (..., H, W, 3)."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    wh = torch.from_numpy(_resize_weights(h, out_h)).to(x.device, x.dtype)
    ww = torch.from_numpy(_resize_weights(w, out_w)).to(x.device, x.dtype)
    x = torch.einsum("...hwc,hH->...Hwc", x, wh)
    return torch.einsum("...hwc,wW->...hWc", x, ww)


def resize_frames(x, resolution: int):
    """Bilinear resize (..., H, W, 3) -> (..., R, R, 3)."""
    return _resize_hw(x, resolution, resolution)


def center_crop_resize(x, resolution: int):
    """Resize short side then center crop (eval 'crop_flip' path)."""
    h, w = x.shape[-3], x.shape[-2]
    scale = resolution / min(h, w)
    nh = max(resolution, round(h * scale))
    nw = max(resolution, round(w * scale))
    x = _resize_hw(x, nh, nw)
    top, left = (nh - resolution) // 2, (nw - resolution) // 2
    return x[..., top:top + resolution, left:left + resolution, :]


def yuv420_to_rgb(packed):
    """Packed YUV420 planes (..., t*t*3//2) uint8 -> RGB float32 0..255.

    Per frame Y[t*t] U[(t/2)^2] V[(t/2)^2]; BT.601 limited range, chroma
    upsampled 2x nearest (libswscale's default coefficients).
    """
    t = int(round((packed.shape[-1] * 2 / 3) ** 0.5))
    if t * t * 3 // 2 != packed.shape[-1]:
        raise ValueError(f"not a packed YUV420 square frame: {packed.shape}")
    lead = packed.shape[:-1]
    q = (t // 2) * (t // 2)
    p = packed.float()
    y = p[..., : t * t].reshape(lead + (t, t))
    u = p[..., t * t: t * t + q].reshape(lead + (t // 2, t // 2))
    v = p[..., t * t + q:].reshape(lead + (t // 2, t // 2))
    u = u.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)
    v = v.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)
    y = (y - 16.0) * (255.0 / 219.0)
    u = (u - 128.0) * (255.0 / 224.0)
    v = (v - 128.0) * (255.0 / 224.0)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def preprocess_frames(frames_uint8, resolution: int, *, mean=CLIP_MEAN,
                      std=CLIP_STD, transforms: str = "none"):
    """uint8 (B, N, H, W, 3) -> normalized float32 (B, N, R, R, 3).

    Evaluation only: ``'none'`` is a plain resize, ``'crop_flip'`` a
    short-side resize and center crop (data/vision_mapper.py:55-78). The
    random training crop is not ported yet.
    """
    x = frames_uint8.float() / 255.0
    if transforms == "crop_flip":
        x = center_crop_resize(x, resolution)
    elif transforms == "none":
        x = resize_frames(x, resolution)
    else:
        raise ValueError(f"unknown vision transforms {transforms!r}")
    return normalize_image(x, mean, std)
