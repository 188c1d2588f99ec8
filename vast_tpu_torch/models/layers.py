"""Layers that keep their parameters in one dtype and compute in another,
and the randomness of training.

Flax's ``nn.Dense(dtype=bf16)`` keeps fp32 parameters and casts them to
bf16 at use; ``vast_tpu`` trains that way. These subclasses of the torch
layers do the same: each casts its weight and bias to the dtype of its
input (or, for the embedding, to its ``compute_dtype``) at use, so a
model built with ``param_dtype=float32`` and ``dtype=bfloat16`` trains
fp32 weights through bf16 arithmetic, and the gradient reaches the fp32
weight. When the two dtypes agree (inference in bf16, tests in fp32) the
cast returns the parameter itself.

Randomness: a training forward gets one CPU ``torch.Generator`` (the
step's). Every module that draws (drop-path, dropout, the random crop,
the audio clip, the ITM negatives) takes a seed from it with
:func:`next_seed` and draws from a generator on its own device made by
:func:`seeded`. A block that is recomputed under activation
checkpointing rebuilds its generator from the same seed, so its masks
are the same in the recompute as in the forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class Conv3d(nn.Conv3d):
    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class Embedding(nn.Embedding):
    """Looks rows up in the parameter's dtype, returns ``compute_dtype``."""

    def __init__(self, num, dim, *, compute_dtype, device=None, dtype=None):
        super().__init__(num, dim, device=device, dtype=dtype)
        self.compute_dtype = compute_dtype

    def forward(self, ids):
        return super().forward(ids).to(self.compute_dtype)


def next_seed(generator: torch.Generator) -> int:
    """A seed for one module's draws, from the step's CPU generator."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator))


def seeded(seed: int, device) -> torch.Generator:
    """A generator on ``device`` started from ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x, rate: float, generator):
    """Inverted dropout with its mask from ``generator`` (None or rate 0:
    the identity), as flax's ``nn.Dropout``: keep with 1 - rate, scale the
    kept values by 1 / (1 - rate)."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return x * mask / keep
