"""EVA-CLIP vision transformers: EVA01-g/14 (the VAST default), EVA02
B/16 and L/14, and EVA02-bigE.

Counterpart of ``vast_tpu.models.eva_vit``, every preset of
``EVA_PRESETS`` (eva_vit.py:97-113):

* EVA01-g/14: rope-free, fused qkv with q/v biases (k bias zero), plain
  GELU MLP (``gelu_approx`` None: exact erf in fp32, tanh in bf16; True
  or False force the tanh or the exact one: vast_tpu eva_vit.py:75-81),
  pre-norm blocks;
* EVA02 (``subln``): separate q/k/v projections without a k bias, the
  2-D rotary angles of ``rope_2d_freqs`` (interleaved pairs, ``intp_freq``
  rescaling the grid onto the pretraining one) on the patch tokens only,
  an inner LayerNorm before the output projection, and a SwiGLU MLP with
  its own inner LayerNorm;
* bigE: EVA01's attention at head width 112, post-norm blocks (the norm
  after the attention and after the MLP); any tower may carry layer
  scale (``ls_init_value``: ``gamma_1`` / ``gamma_2``).

The patch grid, and so the position embedding, follows ``image_size``.

Module and parameter names are the reference torch ones
(``blocks.{i}.attn.qkv.weight``, ``...q_bias``, ``...attn.q_proj``,
``...attn.inner_attn_ln``, ``...mlp.w1``, ``...mlp.ffn_ln``,
``blocks.{i}.gamma_1``), so released weights load as they are and
``vast_ckpt.convert_eva_vit`` reads the state dict. A rope-free
attention runs through the token-major CUDA kernels (forward and
backward) with the query scale baked into the fused weights (scale 1.0
in the kernel), at the true L: no padding. EVA02 applies rope between
the projection and the attention, so it takes the head-major route
(``ops.attention.multi_head_attention``), as ``vast_tpu`` does. Training
adds drop-path (eva_vit.py:299-303, one keep decision per sample, rates
rising linearly over the blocks) and activation checkpointing per block
(models/remat.py); parameters may be kept in ``param_dtype`` and cast to
``dtype`` at use (models/layers.py).

Tensor parallel (``parallel/tp.py``): an attention whose heads divide by
the tp size splits them (EVA01's fused ``qkv`` rows of this rank's heads
from each of its q, k and v thirds; EVA02's ``q/k/v_proj`` rows; the
``proj`` columns), and an MLP whose hidden size divides splits it
(``fc1`` / ``w1`` / ``w2`` rows, ``fc2`` / ``w3`` columns). The q and v
biases stay whole and are sliced; EVA02's sub-LayerNorms normalise the
split channels with the statistics of all of them.
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
from vast_tpu_torch.parallel import tp as tpl
from vast_tpu_torch.ops.attention import multi_head_attention
from vast_tpu_torch.ops.flash_attention import self_attention_tmajor


@dataclasses.dataclass(frozen=True)
class EvaVitConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    layers: int = 40
    head_width: int = 88
    mlp_ratio: float = 4.3637
    qkv_bias: bool = True            # q/v biases, the k bias zero
    subln: bool = False              # separate q/k/v, inner LayerNorms
    swiglu: bool = False             # the SwiGLU MLP (w1, w2, w3)
    rope: bool = False               # 2-D rotary angles over the grid
    pt_hw_seq_len: int = 16          # pretraining grid side (intp_freq)
    intp_freq: bool = False
    postnorm: bool = False
    ls_init_value: Optional[float] = None     # layer scale gamma_1/2
    ln_eps: float = 1e-6
    drop_path_rate: float = 0.0
    dtype: torch.dtype = torch.float32
    param_dtype: Optional[torch.dtype] = None     # None: dtype
    remat: bool = False
    remat_policy: str = "dots"
    # the MLP's GELU: None by the compute dtype (tanh in bf16, exact
    # erf otherwise); True / False force the tanh or the exact one
    gelu_approx: Optional[bool] = None

    @property
    def pdtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype

    @property
    def num_heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2


# the presets of general_module.py:328-350 / model_configs/*.json
EVA_PRESETS = {
    "evaclip01_giant": EvaVitConfig(),
    "evaclip02_base": EvaVitConfig(
        patch_size=16, width=768, layers=12, head_width=64,
        mlp_ratio=2.6667, subln=True, swiglu=True, rope=True, intp_freq=True),
    "evaclip02_large": EvaVitConfig(
        patch_size=14, width=1024, layers=24, head_width=64,
        mlp_ratio=2.6667, subln=True, swiglu=True, rope=True, intp_freq=True),
    "evaclip02_bige": EvaVitConfig(
        patch_size=14, width=1792, layers=64, head_width=112,
        mlp_ratio=8.571428571428571, postnorm=True),
}

EVA_VISION_DIMS = {name: c.width for name, c in EVA_PRESETS.items()}


def rope_2d_freqs(cfg: EvaVitConfig) -> np.ndarray:
    """Interleaved 2-D rotary angles, (grid * grid, head_width / 2) fp32
    (evaclip/rope.py:79 VisionRotaryEmbeddingFast): each axis takes
    head_width / 4 pairs, theta 10000; ``intp_freq`` rescales the grid's
    positions onto the pretraining grid of ``pt_hw_seq_len``."""
    dim = cfg.head_width // 2
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    ft = cfg.grid_size
    t = np.arange(ft, dtype=np.float64)
    if cfg.intp_freq:
        t = t * (cfg.pt_hw_seq_len / ft)
    angles = np.repeat(np.outer(t, freqs), 2, axis=-1)     # (g, dim)
    row = np.broadcast_to(angles[:, None, :], (ft, ft, dim))
    col = np.broadcast_to(angles[None, :, :], (ft, ft, dim))
    out = np.concatenate([row, col], axis=-1).reshape(ft * ft, 2 * dim)
    return out.astype(np.float32)


def apply_rope(x, angles):
    """Rotate the interleaved pairs of x (B, L, H, D) by ``angles`` (L,
    D) fp32, cos and sin cast to x's dtype (evaclip/rope.py)."""
    cos = angles.cos()[None, :, None, :].to(x.dtype)
    sin = angles.sin()[None, :, None, :].to(x.dtype)
    x2 = x.unflatten(-1, (-1, 2))
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)
    return x * cos + rot * sin


class EvaAttention(nn.Module):
    def __init__(self, c: EvaVitConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.cfg = c
        all_dim = c.num_heads * c.head_width
        if c.subln:
            self.q_proj = layers.Linear(c.width, all_dim, bias=False, **fk)
            self.k_proj = layers.Linear(c.width, all_dim, bias=False, **fk)
            self.v_proj = layers.Linear(c.width, all_dim, bias=False, **fk)
        else:
            self.qkv = layers.Linear(c.width, 3 * all_dim, bias=False, **fk)
        if c.qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(all_dim, **fk))
            self.v_bias = nn.Parameter(torch.zeros(all_dim, **fk))
        if c.subln:
            self.inner_attn_ln = layers.LayerNorm(all_dim, eps=c.ln_eps, **fk)
        self.proj = layers.Linear(all_dim, c.width, **fk)
        self._fused = FusedCache()
        self.heads = c.num_heads          # this rank's (tp: H / tp)
        self.tp = None

    # the fused qkv weight is read here, not through its layer
    GATHER_CHILDREN = ("qkv",)

    def tp_linears(self) -> dict:
        """{layer: (vast_tpu's owner name, runs)}: the layers a tp split
        cuts (``parallel.mesh.combined_param_sharding``)."""
        if self.cfg.subln:
            return {n: (n, 1) for n in ("q_proj", "k_proj", "v_proj",
                                        "proj")}
        return {"qkv": ("qkv", 3), "proj": ("proj", 1)}

    def tp_splits(self, tp: int) -> bool:
        return self.cfg.num_heads % tp == 0

    def tp_partial_params(self) -> list:
        out = ["q_bias", "v_bias"] if self.cfg.qkv_bias else []
        if self.cfg.subln:
            out += ["inner_attn_ln.weight", "inner_attn_ln.bias"]
        return out

    def enable_tp(self, tp) -> None:
        tpl.split_module(self, tp)
        self.heads = self.cfg.num_heads // tp.size

    def _rows(self, n: int):
        return slice(None) if self.tp is None else self.tp.block(n)

    def _biases(self, like):
        if self.cfg.qkv_bias:
            rows = self._rows(self.q_bias.shape[0])
            return self.q_bias[rows], self.v_bias[rows]
        zero = torch.zeros(like.shape[0] // 3, dtype=like.dtype,
                           device=like.device)
        return zero, zero

    def fused_qkv(self):
        """(H*3*D, W) weight and (H*3*D,) bias in the kernel's layout, of
        this rank's heads."""
        c = self.cfg
        w = self.qkv.weight
        qb, vb = self._biases(w)

        def build():
            wq, wk, wv = w.chunk(3, dim=0)
            return fuse_qkv(wq, wk, wv, qb, torch.zeros_like(qb), vb,
                            self.heads, q_scale=c.head_width ** -0.5)
        key = [w] + ([self.q_bias, self.v_bias] if c.qkv_bias else [])
        return self._fused.get(key, build)

    def forward(self, x, rope_angles=None):
        c = self.cfg
        if not c.subln:
            # the column-parallel region of the fused projection (the
            # separate projections are column-parallel layers themselves)
            x = tpl.copy_to(x, self.tp)
            w, b = self.fused_qkv()
            y = F.linear(x, w.to(x.dtype), b.to(x.dtype))  # (B, L, H*3*D)
            out = self_attention_tmajor(y, heads=self.heads)
            return self.proj(out)
        bsz, l, _ = x.shape
        h, d = self.heads, c.head_width
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if c.qkv_bias:
            qb, vb = self._biases(q)
            q = q + qb.to(q.dtype)
            v = v + vb.to(v.dtype)
        q, k, v = (t.view(bsz, l, h, d) for t in (q, k, v))
        if rope_angles is not None:
            # the patch tokens only; the cls token is not rotated
            # (eva_vit.py:211-217 of vast_tpu)
            q = torch.cat([q[:, :1], apply_rope(q[:, 1:], rope_angles)], 1)
            k = torch.cat([k[:, :1], apply_rope(k[:, 1:], rope_angles)], 1)
        out = multi_head_attention(q, k, v, scale=d ** -0.5)
        out = tpl.layer_norm(out.reshape(bsz, l, h * d), self.inner_attn_ln,
                             self.tp)
        return self.proj(out)


class EvaMlp(nn.Module):
    def __init__(self, c: EvaVitConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        hidden = int(c.width * c.mlp_ratio)
        self.hidden = hidden
        self.gelu_approx = c.gelu_approx
        self.tp = None
        self.swiglu = c.swiglu
        if c.swiglu:
            self.w1 = layers.Linear(c.width, hidden, **fk)
            self.w2 = layers.Linear(c.width, hidden, **fk)
        else:
            self.fc1 = layers.Linear(c.width, hidden, **fk)
        self.ffn_ln = (layers.LayerNorm(hidden, eps=c.ln_eps, **fk)
                       if c.subln else None)
        if c.swiglu:
            self.w3 = layers.Linear(hidden, c.width, **fk)
        else:
            self.fc2 = layers.Linear(hidden, c.width, **fk)

    def tp_linears(self) -> dict:
        names = ("w1", "w2", "w3") if self.swiglu else ("fc1", "fc2")
        return {n: (n, 1) for n in names}

    def tp_splits(self, tp: int) -> bool:
        return self.hidden % tp == 0

    def tp_partial_params(self) -> list:
        return [] if self.ffn_ln is None else ["ffn_ln.weight",
                                               "ffn_ln.bias"]

    def enable_tp(self, tp) -> None:
        tpl.split_module(self, tp)

    def forward(self, x):
        if self.swiglu:
            x = F.silu(self.w1(x)) * self.w2(x)
        else:
            x = gelu(self.fc1(x), approximate=self.gelu_approx)
        if self.ffn_ln is not None:
            x = tpl.layer_norm(x, self.ffn_ln, self.tp)
        return self.w3(x) if self.swiglu else self.fc2(x)


class EvaBlock(nn.Module):
    def __init__(self, c: EvaVitConfig, drop_path: float = 0.0,
                 device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.drop_path = drop_path
        self.postnorm = c.postnorm
        self.norm1 = layers.LayerNorm(c.width, eps=c.ln_eps, **fk)
        self.attn = EvaAttention(c, device)
        self.norm2 = layers.LayerNorm(c.width, eps=c.ln_eps, **fk)
        self.mlp = EvaMlp(c, device)
        if c.ls_init_value is not None:
            self.gamma_1 = nn.Parameter(torch.full((c.width,),
                                                   c.ls_init_value, **fk))
            self.gamma_2 = nn.Parameter(torch.full((c.width,),
                                                   c.ls_init_value, **fk))
        else:
            self.gamma_1 = self.gamma_2 = None

    def _drop_path(self, x, generator):
        if generator is None or self.drop_path == 0.0:
            return x
        keep = 1.0 - self.drop_path
        mask = torch.empty((x.shape[0], 1, 1), dtype=x.dtype,
                           device=x.device).bernoulli_(keep,
                                                       generator=generator)
        return x * mask / keep

    @staticmethod
    def _scaled(x, gamma):
        return x if gamma is None else x * gamma.to(x.dtype)

    def forward(self, x, seed: Optional[int] = None, rope_angles=None):
        """``seed`` (training): drop-path's draws; None: deterministic.
        ``rope_angles``: EVA02's (the patch tokens') or None."""
        g = None if seed is None else layers.seeded(seed, x.device)
        if self.postnorm:
            a = self.norm1(self.attn(x, rope_angles))
            x = x + self._drop_path(self._scaled(a, self.gamma_1), g)
            m = self.norm2(self.mlp(x))
            return x + self._drop_path(self._scaled(m, self.gamma_2), g)
        a = self.attn(self.norm1(x), rope_angles)
        x = x + self._drop_path(self._scaled(a, self.gamma_1), g)
        m = self.mlp(self.norm2(x))
        return x + self._drop_path(self._scaled(m, self.gamma_2), g)


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
        if c.rope and not c.subln:
            raise ValueError("rope needs subln: a rope-free attention is "
                             "the fused token-major one (every preset with "
                             "rope has subln)")
        self.patch_embed = PatchEmbed(c, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width, **fk))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, c.num_patches + 1, c.width, **fk))
        rates = np.linspace(0, c.drop_path_rate, c.layers)
        self.blocks = nn.ModuleList(EvaBlock(c, float(r), device)
                                    for r in rates)
        self.norm = layers.LayerNorm(c.width, eps=c.ln_eps, **fk)
        self.register_buffer(
            "rope_angles", torch.from_numpy(rope_2d_freqs(c)).to(device)
            if c.rope else None, persistent=False)

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
            x = remat_call(policy, blk, x, seed, self.rope_angles)
        return self.norm(x)
