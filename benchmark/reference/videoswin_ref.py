"""Plain fp32 reference of VAST with Video Swin-B as its vision tower.

Video Swin Transformer (Liu et al., arXiv:2106.13230), base size as
``swin_base_patch244_window877_kinetics600_22k`` publishes it, written
from the paper and its released code in plain ``torch`` operations, in
VAST's wiring (model/vision_encoders/videoswin/videoswin.py and
general_module.py:230-243 of the VAST repository):

* a (2, 4, 4) 3-D patch embedding (a Conv3d and its LayerNorm) over the
  whole clip with one trailing zero frame;
* four stages of blocks, each a pre-norm window attention and MLP: the
  tokens of each (8, 7, 7) window attend to each other with a learned
  3-D relative-position bias gathered from a (15 * 13 * 13, heads)
  table; every second block rolls the clip by half a window, (4, 3, 3),
  and masks the pairs of a window that lie in different regions of the
  rolled clip; a window or shift is clamped to a grid it covers whole;
* patch merging (2 x 2 neighbours, LayerNorm, a bias-free reduction)
  between the stages and a final LayerNorm;
* VAST around it: ImageNet statistics, the (B, T', 49, 1024) token grid
  as the condition sequence, its mean over tokens then frames as the
  contrastive feature.

The window partition and reverse, the roll, the region mask and the
table's index follow the released code (``window_partition``,
``compute_mask``, ``WindowAttention3D``), independent of the program.
BEATs, BERT, the heads, the preprocessing of audio and text, the losses
and the fp8 control are ``vast_ref.py``'s, reused: ``VastVideoSwinRef``
is its ``VastRef`` with this tower in place of the ViT. Module and
parameter names are the program's (``vision_encoder.layers.{s}.blocks.
{b}.attn.relative_position_bias_table``, ...), so
``benchmark/weights.init_weights`` fills both alike.

Precision: fp32 with TF32 off (the caller sets the backends). With
``fp8`` (the control) every product of the tower, the Conv3d and every
linear layer included, and both of every window attention's products,
round their operands to float8 e4m3 as ``vast_ref`` does. Every block is
recomputed in its backward (activation checkpointing).

Faults, for the calibration of the cell's limits: ``shift_mask=False``
drops the region mask of the shifted blocks (their roll kept);
``roll=False`` leaves the clip unrolled in the shifted blocks (their
mask kept).

Departures from the published model, each also VAST's and the
program's: the temporal stride of the patch embedding is 1 after one
trailing zero frame, so T' = T frames where the paper's stride 2 gives
T / 2 (VAST's ``time_stride``); no stochastic depth (VAST's tower draws
nothing); GELU is the exact erf form. The masked pairs get -100 before
the softmax, as the released code gives them (the program gives
-1e30): exp(-100) is below fp32's resolution of any row's sum. The
grids of 16 x 224 px clips divide by the windows, so no padding is
needed and none is written. Of the training reference
(``train_ref.AdamW``): it decays the Conv3d's bias, which the program
does not; that bias starts at 0 and moves by lr * wd * |b|, about 1e-6
of its step, below fp32's round-off of the change.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.vast_ref import (Beats, BertForMaskedLM, Linear,
                                          MatchHead, VastRef, _Head,
                                          _proj_ln, _q8, _random_crop_flip,
                                          attention, gelu, l2norm,
                                          next_seed, seeded)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MASKED = -100.0


class Conv3d(nn.Conv3d):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return self._conv_forward(_q8(x), _q8(self.weight), self.bias)
        return self._conv_forward(x, self.weight, self.bias)


def relative_position_index(window) -> torch.Tensor:
    """(n, n) row of the bias table for each token pair of a window."""
    wt, wh, ww = window
    coords = torch.stack(torch.meshgrid(
        torch.arange(wt), torch.arange(wh), torch.arange(ww),
        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([wt - 1, wh - 1, ww - 1])
    rel = rel * torch.tensor([(2 * wh - 1) * (2 * ww - 1), 2 * ww - 1, 1])
    return rel.sum(-1)


def window_partition(x, window):
    """(B, D, H, W, C) -> (B * nW, n, C)."""
    b, d, h, w, c = x.shape
    wt, wh, ww = window
    x = x.view(b, d // wt, wt, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wt * wh * ww, c)


def window_reverse(windows, window, b, d, h, w):
    wt, wh, ww = window
    x = windows.view(b, d // wt, h // wh, w // ww, wt, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def window_and_shift(grid, window, shift):
    """A window (and its shift) clamped to a grid it covers whole."""
    win = tuple(min(g, ws) for g, ws in zip(grid, window))
    sh = tuple(0 if g <= ws else s for g, ws, s in zip(grid, window, shift))
    return win, sh


def region_mask(grid, window, shift, device):
    """(nW, n, n) additive mask: 0 where two tokens of a window lie in the
    same region of the rolled clip, else -100 (``compute_mask``)."""
    d, h, w = grid
    img = torch.zeros((1, d, h, w, 1), device=device)
    cnt = 0
    for ds in (slice(-window[0]), slice(-window[0], -shift[0]),
               slice(-shift[0], None)):
        for hs in (slice(-window[1]), slice(-window[1], -shift[1]),
                   slice(-shift[1], None)):
            for ws in (slice(-window[2]), slice(-window[2], -shift[2]),
                       slice(-shift[2], None)):
                img[:, ds, hs, ws, :] = cnt
                cnt += 1
    labels = window_partition(img, window)[..., 0]
    same = labels[:, :, None] == labels[:, None, :]
    return torch.where(same, 0.0, MASKED)


class WindowAttention3D(nn.Module):
    fp8 = False

    def __init__(self, dim, heads, window):
        super().__init__()
        self.h = heads
        wt, wh, ww = window
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1), heads))
        self.register_buffer("index", relative_position_index(window),
                             persistent=False)

    def forward(self, x, mask=None):
        """x (B * nW, n, C); ``mask`` (nW, n, n) additive, or None."""
        nb, n, c = x.shape
        d = c // self.h
        q, k, v = self.qkv(x).view(nb, n, 3, self.h, d).permute(2, 0, 3, 1, 4)
        bias = self.relative_position_bias_table[self.index.reshape(-1)]
        bias = bias.view(n, n, self.h).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            bias = (bias[None] + mask[None, :, None]).reshape(
                nw, self.h, n, n).repeat(nb // nw, 1, 1, 1)
        o = attention(q * d ** -0.5, k, v, bias, self.fp8)
        return self.proj(o.transpose(1, 2).reshape(nb, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class Block3D(nn.Module):
    def __init__(self, c, dim, heads, grid, shifted, faults):
        super().__init__()
        half = tuple(w // 2 for w in c["window_size"])
        self.window, self.shift = window_and_shift(
            grid, c["window_size"], half if shifted else (0, 0, 0))
        self.faults = faults
        self.norm1 = nn.LayerNorm(dim, eps=c["ln_eps"])
        self.attn = WindowAttention3D(dim, heads, self.window)
        self.norm2 = nn.LayerNorm(dim, eps=c["ln_eps"])
        self.mlp = Mlp(dim, int(dim * c["mlp_ratio"]))

    def forward(self, x):
        """x (B, D, H, W, C)."""
        b, d, h, w, c = x.shape
        shifted = any(self.shift)
        roll = shifted and self.faults["roll"]
        y = self.norm1(x)
        if roll:
            y = torch.roll(y, tuple(-s for s in self.shift), dims=(1, 2, 3))
        mask = None
        if shifted and self.faults["shift_mask"]:
            mask = region_mask((d, h, w), self.window, self.shift, x.device)
        y = self.attn(window_partition(y, self.window), mask)
        y = window_reverse(y, self.window, b, d, h, w)
        if roll:
            y = torch.roll(y, self.shift, dims=(1, 2, 3))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=eps)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        """(B, D, H, W, C) -> (B, D, H/2, W/2, 2C)."""
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class PatchEmbed3D(nn.Module):
    def __init__(self, c):
        super().__init__()
        pt, ph, pw = c["patch_size"]
        self.proj = Conv3d(3, c["embed_dim"], (pt, ph, pw),
                           (c["time_stride"], ph, pw))
        self.norm = nn.LayerNorm(c["embed_dim"], eps=c["ln_eps"])

    def forward(self, video):
        """(B, T, H, W, 3) -> (B, T', H', W', C), one zero frame appended."""
        x = F.pad(video.permute(0, 4, 1, 2, 3), (0, 0, 0, 0, 0, 1))
        return self.norm(self.proj(x).permute(0, 2, 3, 4, 1))


class Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class VideoSwinRef(nn.Module):
    """Video Swin over clips of ``frames`` frames at ``resolution`` px:
    (B, T, H, W, 3) normalized -> (B, T', H' * W', num_features)."""

    def __init__(self, c, frames, resolution, shift_mask=True, roll=True):
        super().__init__()
        faults = {"shift_mask": shift_mask, "roll": roll}
        pt, ph, pw = c["patch_size"]
        grid = [(frames + 1 - pt) // c["time_stride"] + 1,
                resolution // ph, resolution // pw]
        self.patch_embed = PatchEmbed3D(c)
        dim, stages = c["embed_dim"], []
        last = len(c["depths"]) - 1
        for si, (depth, heads) in enumerate(zip(c["depths"],
                                                c["num_heads"])):
            blocks = [Block3D(c, dim, heads, tuple(grid), bi % 2 == 1,
                              faults) for bi in range(depth)]
            down = PatchMerging(dim, c["ln_eps"]) if si < last else None
            stages.append(Stage(blocks, down))
            if down is not None:
                dim, grid[1], grid[2] = 2 * dim, grid[1] // 2, grid[2] // 2
        self.layers = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(dim, eps=c["ln_eps"])

    def forward(self, video):
        x = self.patch_embed(video)
        for stage in self.layers:
            for blk in stage.blocks:
                x = (checkpoint(blk, x, use_reentrant=False)
                     if torch.is_grad_enabled() else blk(x))
            if stage.downsample is not None:
                x = stage.downsample(x)
        x = self.norm(x)
        return x.flatten(2, 3)


def preprocess_frames(frames, res, generator):
    """uint8 (B, T, R, R, 3) -> ImageNet-normalized fp32: the random
    resized crop and flip of ``vast_ref`` with ``generator``
    (training), else the frames as they are (the configuration's
    resolution)."""
    x = frames.float() / 255.0
    if generator is not None:
        x = _random_crop_flip(x, res, seeded(next_seed(generator), x.device))
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


class VastVideoSwinRef(VastRef):
    """``VastRef`` with Video Swin as its vision tower: the same BEATs,
    BERT, heads and losses, built here beside the tower (``VastRef``'s
    own constructor builds a ViT)."""

    def __init__(self, cfg, fp8: bool = False, shift_mask: bool = True,
                 roll: bool = True):
        nn.Module.__init__(self)
        self.cfg = cfg
        v, a, b = cfg["vision"], cfg["audio"], cfg["bert"]
        self.vision_encoder = VideoSwinRef(
            v, cfg["max_vision_sample_num"], cfg["vision_resolution"],
            shift_mask, roll)
        vd = v["embed_dim"] * 2 ** (len(v["depths"]) - 1)
        ad, md, d = a["encoder_embed_dim"], b["hidden_size"], \
            cfg["contra_dim"]
        self.audio_encoder = Beats(a)
        self.multimodal_encoder = BertForMaskedLM(b)
        self.contra_head_t = _Head(md, d)
        self.contra_head_s = _Head(md, d)
        self.contra_head_v = _Head(vd, d)
        self.contra_head_a = _Head(ad, d)
        self.contra_head_va = Linear(vd + ad, d)
        self.contra_head_vs = Linear(vd + md, d)
        self.contra_head_vas = Linear(vd + ad + md, d)
        self.contra_temp = nn.Parameter(torch.tensor(0.07))
        self.itm_head = MatchHead(md)
        self.vision_frame_embedding = nn.Parameter(
            torch.zeros(1, cfg["max_vision_sample_num"], md))
        self.audio_frame_embedding = nn.Parameter(torch.zeros(1, 1, md))
        self.hidden_trans_vision_multimodal = _proj_ln(vd, md)
        self.hidden_trans_audio_multimodal = _proj_ln(ad, md)
        self.hidden_trans_subtitle_multimodal = _proj_ln(md, md)
        self.vision_type_embeddings = nn.Parameter(torch.zeros(1, 1, md))
        self.audio_type_embeddings = nn.Parameter(torch.zeros(1, 1, md))
        self.subtitle_type_embeddings = nn.Parameter(torch.zeros(1, 1, md))
        for m in self.modules():
            if hasattr(type(m), "fp8"):
                m.fp8 = fp8

    def vision(self, frames, generator=None):
        """uint8 frames -> (B, T', tokens, width): the whole clip at once."""
        pix = preprocess_frames(frames, self.cfg["vision_resolution"],
                                generator)
        return self.vision_encoder(pix)

    def features(self, batch, generator=None):
        """``VastRef.features`` with the vision feature pooled as VAST
        pools a Swin tower's: the mean over tokens, then frames."""
        mm = self.multimodal_encoder
        cap = mm.encode(batch["caption_tokens"],
                        batch["caption_attention_mask"], generator=generator)
        vis = self.vision(batch["vision_frames"], generator)
        aud = self.audio(batch["audio_waveforms"], generator)
        sub = mm.encode(batch["subtitle_tokens"],
                        batch["subtitle_attention_mask"], generator=generator)
        pooled = torch.cat([vis.mean(2).mean(1), aud.mean(2).mean(1),
                            sub[:, 0]], 1)
        cond = torch.cat([
            self._cond_seq(vis, self.hidden_trans_vision_multimodal,
                           self.vision_frame_embedding,
                           self.vision_type_embeddings),
            self._cond_seq(aud, self.hidden_trans_audio_multimodal,
                           self.audio_frame_embedding,
                           self.audio_type_embeddings),
            self.hidden_trans_subtitle_multimodal(sub)
            + self.subtitle_type_embeddings], 1)
        return {"feat_t": l2norm(self.contra_head_t.linear(cap[:, 0])),
                "feat_cond": l2norm(self.contra_head_vas(pooled)),
                "cond": cond}
