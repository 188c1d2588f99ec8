"""MLM token corruption for the captioning and QA losses.

Counterpart of ``vast_tpu.ops.masking`` (the reference's TokenMasker,
model/general_module.py:52-98), vectorized over the batch:

* only non-pad positions from index 1 onward are candidates;
* every row with a candidate gets at least one masked position (the
  reference loops until one lands; here a row that drew none has one of
  its candidates forced, uniformly);
* of the selected positions, 80% become ``mask_token``, 10% a random id in
  ``[range_start, range_end)`` and 10% stay; the labels hold the original
  token there and ``IGNORE_LABEL`` elsewhere.

The draws come from an explicit ``torch.Generator`` on the tokens'
device, so they agree with ``vast_tpu``'s ``jax.random`` draws in
distribution only.
"""

from __future__ import annotations

import torch

IGNORE_LABEL = -100


def mask_tokens(generator: torch.Generator, tokens: torch.Tensor,
                mask_prob: float, *, mask_token: int,
                range_start: int = 106, range_end: int = 30522,
                pad_token: int = 0):
    """tokens: (B, L) integer -> (corrupted, labels), both like tokens."""
    b, l = tokens.shape
    dev = tokens.device

    def uniform():
        return torch.rand((b, l), generator=generator, device=dev)

    candidate = tokens != pad_token
    candidate[:, 0] = False
    sel = (uniform() < mask_prob) & candidate

    # force one uniformly drawn candidate in each row that selected none
    scores = torch.where(candidate, uniform(), -1.0)
    forced = torch.zeros_like(sel)
    forced.scatter_(1, scores.argmax(dim=1, keepdim=True), True)
    need = ~sel.any(dim=1) & candidate.any(dim=1)
    sel = sel | (forced & need[:, None])

    kind = uniform()
    rand_tok = torch.randint(range_start, range_end, (b, l),
                             generator=generator, device=dev,
                             dtype=tokens.dtype)
    corrupted = torch.where(sel & (kind < 0.8), mask_token, tokens)
    corrupted = torch.where(sel & (kind >= 0.8) & (kind < 0.9), rand_tok,
                            corrupted)
    labels = torch.where(sel, tokens, IGNORE_LABEL)
    return corrupted, labels
