"""AST audio transformer (VAST's ``ast`` audio tower, the alternative to
BEATs).

Counterpart of ``vast_tpu.models.ast`` (reference:
model/audio_encoders/ast/ast.py): a plain pre-norm ViT over the fbank
transposed to (mel, frames) (general_module.py:405-408): a 16 x 16 patch
convolution, the CLS token and learned positional embedding, pre-norm
layers with exact-GELU MLPs (tanh in bf16, as ``vast_tpu``'s gelu picks
it) and a final LayerNorm. Each layer's q, k and v projections are read
head-major by the attention through strides, and their gradients come
back in the projections' own token-major layout: no transpose or copy
either way (ops/flash_attention.py).

The reference splits AST into two top-level modules of the VAST model,
and the names here follow it (vast_ckpt.py:184-218):
``audio_embeddings.{first_conv, cls_token, position_embeddings}`` and
``audio_encoder.layer.{i}.{layernorm1, attention.linears.{0..3},
layernorm2, ff_layer.linear{1,2}}``, ``audio_encoder.last_layernorm``.
:class:`AstModel` holds the two; ``VASTModel`` adopts them under those
names. Layers run under activation checkpointing when asked
(models/remat.py), as ``vast_tpu`` wraps them (ast.py:91-94). Under
tensor parallelism (``parallel/tp.py``) each layer's attention runs on
this rank's heads and its feed-forward on its part of the hidden size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vast_tpu_torch.models import layers
from vast_tpu_torch.models.remat import check_policy, remat_call
from vast_tpu_torch.ops.activations import gelu
from vast_tpu_torch.ops.attention import multi_head_attention_hmajor
from vast_tpu_torch.parallel import tp as tpl


@dataclasses.dataclass(frozen=True)
class AstConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    audio_melbins: int = 64
    audio_target_length: int = 1024
    patch_size: int = 16
    ln_eps: float = 1e-12
    dtype: torch.dtype = torch.float32
    param_dtype: Optional[torch.dtype] = None     # None: dtype
    remat: bool = False
    remat_policy: str = "dots"

    @property
    def pdtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype

    @property
    def tokens_per_clip(self) -> int:
        return ((self.audio_melbins // self.patch_size)
                * (self.audio_target_length // self.patch_size))


class AstEmbeddings(nn.Module):
    def __init__(self, c: AstConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.cfg = c
        self.first_conv = layers.Conv2d(1, c.hidden_size, c.patch_size,
                                        c.patch_size, **fk)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size, **fk))
        self.position_embeddings = nn.Embedding(c.tokens_per_clip + 1,
                                                c.hidden_size, **fk)

    def forward(self, fbank):
        """(B, T, M) fbank -> (B, 1 + (M/p)(T/p), hidden) tokens."""
        x = self.first_conv(fbank.transpose(-1, -2)[:, None].to(self.cfg.dtype))
        x = x.flatten(2).transpose(1, 2)                # (mel, time) order
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embeddings.weight[:x.shape[1]].to(x.dtype)


class AstAttention(nn.Module):
    """q, k, v and the output projection as ``linears.{0..3}``. Under tp
    this rank runs its heads: q, k and v stay whole, as ``vast_tpu``'s
    plan keeps them (their owner names ``q``, ``k``, ``v`` are neither
    column- nor row-parallel), and each rank uses its heads' rows of them
    (``tp_partial``); the output projection is row-parallel."""

    def __init__(self, c: AstConfig, device=None):
        super().__init__()
        self.cfg = c
        self.heads = c.num_attention_heads    # this rank's (tp: H / tp)
        self.tp = None
        self.linears = nn.ModuleList(
            layers.Linear(c.hidden_size, c.hidden_size, device=device,
                          dtype=c.pdtype) for _ in range(4))

    def tp_linears(self) -> dict:
        return {"linears.3": ("proj", 1)}

    def tp_splits(self, tp: int) -> bool:
        return self.cfg.num_attention_heads % tp == 0

    def tp_partial_params(self) -> list:
        return [f"linears.{i}.{p}" for i in range(3)
                for p in ("weight", "bias")]

    def enable_tp(self, tp) -> None:
        tpl.split_module(self, tp)
        for lin in self.linears[:3]:
            tpl.parallelize(lin, "part", tp)
        self.heads = self.cfg.num_attention_heads // tp.size

    def forward(self, x):
        b, l, _ = x.shape
        d = self.cfg.hidden_size // self.cfg.num_attention_heads
        q, k, v = (lin(x).view(b, l, self.heads, d).transpose(1, 2)
                   for lin in self.linears[:3])
        out = multi_head_attention_hmajor(q, k, v)             # (B, h, L, D)
        return self.linears[3](out.transpose(1, 2).reshape(b, l,
                                                           self.heads * d))


class AstFeedForward(nn.Module):
    def __init__(self, c: AstConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.cfg = c
        self.tp = None
        self.linear1 = layers.Linear(c.hidden_size, c.intermediate_size, **fk)
        self.linear2 = layers.Linear(c.intermediate_size, c.hidden_size, **fk)

    def tp_linears(self) -> dict:
        return {"linear1": ("fc1", 1), "linear2": ("fc2", 1)}

    def tp_splits(self, tp: int) -> bool:
        return self.cfg.intermediate_size % tp == 0

    def tp_partial_params(self) -> list:
        return []

    def enable_tp(self, tp) -> None:
        tpl.split_module(self, tp)

    def forward(self, x):
        return self.linear2(gelu(self.linear1(x)))


class AstLayer(nn.Module):
    def __init__(self, c: AstConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.layernorm1 = layers.LayerNorm(c.hidden_size, eps=c.ln_eps, **fk)
        self.attention = AstAttention(c, device)
        self.layernorm2 = layers.LayerNorm(c.hidden_size, eps=c.ln_eps, **fk)
        self.ff_layer = AstFeedForward(c, device)

    def forward(self, x):
        x = x + self.attention(self.layernorm1(x))
        return x + self.ff_layer(self.layernorm2(x))


class AstEncoder(nn.Module):
    def __init__(self, c: AstConfig, device=None):
        super().__init__()
        self.cfg = c
        check_policy(c.remat_policy)
        self.layer = nn.ModuleList(AstLayer(c, device)
                                   for _ in range(c.num_hidden_layers))
        self.last_layernorm = layers.LayerNorm(c.hidden_size, eps=c.ln_eps,
                                               device=device, dtype=c.pdtype)

    def forward(self, x):
        c = self.cfg
        policy = c.remat_policy if c.remat else "none"
        for layer in self.layer:
            x = remat_call(policy, layer, x)
        return self.last_layernorm(x)


class AstModel(nn.Module):
    """fbank clip (B, T, M) -> tokens (B, 1 + (M/p)(T/p), hidden)."""

    def __init__(self, c: AstConfig, device=None):
        super().__init__()
        self.audio_embeddings = AstEmbeddings(c, device)
        self.audio_encoder = AstEncoder(c, device)

    def forward(self, fbank):
        return self.audio_encoder(self.audio_embeddings(fbank))
