"""The one generator of the benchmark's inputs, driven by a traffic file.

Every input is drawn from ``--seed`` with a generator on the device and
in a few large calls: uint8 frames at the configuration's resolution,
waveforms at int16 scale, and BERT token ids whose lengths follow a
heavy-tailed (log-normal) law clipped to the mix's range, each text
``[CLS] ids [SEP]`` and padded with 0, its attention mask 1 over its
tokens. A text spec in a traffic file reads
``{"max_len": 40, "median": 10, "sigma": 0.6, "min": 4}``.
"""

from __future__ import annotations

import math

import torch

CLS, SEP, FIRST_ID = 101, 102, 1000


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator for one stream of draws of a run."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream * 7919) % (2 ** 63))


def texts(n: int, spec: dict, vocab: int, g: torch.Generator, device):
    """(ids, mask), int64 (n, max_len) each."""
    max_len = spec["max_len"]
    z = torch.randn(n, generator=g, device=device)
    lengths = torch.exp(math.log(spec["median"]) + spec["sigma"] * z)
    lengths = lengths.round().long().clamp(spec["min"], max_len)
    ids = torch.randint(FIRST_ID, vocab, (n, max_len), generator=g,
                        device=device)
    pos = torch.arange(max_len, device=device)[None]
    ids[:, 0] = CLS
    ids = torch.where(pos == lengths[:, None] - 1, SEP, ids)
    mask = (pos < lengths[:, None]).long()
    return ids * mask, mask


def clips(n: int, frames: int, resolution: int, audio_samples: int,
          g: torch.Generator, device):
    """uint8 frames (n, frames, R, R, 3) and waveforms (n, samples)."""
    vision = torch.randint(0, 256, (n, frames, resolution, resolution, 3),
                           dtype=torch.uint8, generator=g, device=device)
    audio = torch.randn(n, audio_samples, generator=g,
                        device=device) * 2 ** 12
    return vision, audio


def clip_batch(n: int, traffic: dict, cfg: dict, vocab: int,
               g: torch.Generator, device) -> dict:
    """One batch of ``n`` clips of a ``ret%tvas`` mix: frames, audio, a
    subtitle and a caption per clip, as tensors on ``device``."""
    vision, audio = clips(n, traffic["frames"], cfg["vision_resolution"],
                          traffic["audio_samples"], g, device)
    cap, cap_mask = texts(n, traffic["caption"], vocab, g, device)
    sub, sub_mask = texts(n, traffic["subtitle"], vocab, g, device)
    return {"vision_frames": vision, "audio_waveforms": audio,
            "caption_tokens": cap, "caption_attention_mask": cap_mask,
            "subtitle_tokens": sub, "subtitle_attention_mask": sub_mask}


def negatives(n: int, g: torch.Generator, device) -> tuple:
    """ITM negatives of a batch of ``n``: for each caption another clip,
    for each clip another caption, (1, n) each."""
    shift_c = torch.randint(1, n, (n,), generator=g, device=device)
    shift_t = torch.randint(1, n, (n,), generator=g, device=device)
    rows = torch.arange(n, device=device)
    return ((rows + shift_c) % n)[None], ((rows + shift_t) % n)[None]
