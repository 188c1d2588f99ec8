"""Kaldi-compatible log-mel filterbank in plain PyTorch.

Counterpart of ``vast_tpu.ops.fbank`` (torchaudio.compliance.kaldi.fbank
semantics, dither 0): snip-edges framing (25 ms / 10 ms), per-frame DC
removal, preemphasis 0.97, povey window, zero-pad to the next power of
two, |rfft|^2 without the Nyquist bin (its mel weight is zero), kaldi
triangular mel banks, log(max(x, eps)).

This is not a kernel port: ``vast_tpu`` left it to XLA, the port leaves
it to PyTorch's own ops (``torch.fft.rfft`` and one matmul).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

EPS = 1.1920928955078125e-07  # float32 machine epsilon (kaldi's floor)
LOW_FREQ = 20.0                # Hz; the high edge is Nyquist
FRAME_MS, SHIFT_MS = 25.0, 10.0
PREEMPHASIS = 0.97


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


@functools.lru_cache(maxsize=8)
def mel_banks(num_bins: int, fft_len: int, sample_rate: float) -> np.ndarray:
    """Kaldi MelBanks weights, shape (fft_len // 2, num_bins) fp32."""
    num_fft_bins = fft_len // 2
    fft_bin_width = sample_rate / fft_len
    mel_low = _mel(LOW_FREQ)
    mel_high = _mel(0.5 * sample_rate)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bins = np.arange(num_bins)[:, None]
    left = mel_low + bins * mel_delta
    center = mel_low + (bins + 1) * mel_delta
    right = mel_low + (bins + 2) * mel_delta

    mel_f = _mel(fft_bin_width * np.arange(num_fft_bins)[None, :])
    up = (mel_f - left) / (center - left)
    down = (right - mel_f) / (right - center)
    w = np.maximum(0.0, np.minimum(up, down))
    return w.astype(np.float32).T


def _window(window_type: str, n: int) -> np.ndarray:
    a = 2 * math.pi / (n - 1)
    i = np.arange(n)
    if window_type == "povey":
        return ((0.5 - 0.5 * np.cos(a * i)) ** 0.85).astype(np.float32)
    if window_type == "hanning":
        return (0.5 - 0.5 * np.cos(a * i)).astype(np.float32)
    raise ValueError(window_type)


def kaldi_fbank(waveform, *, sample_rate: int = 16000,
                num_mel_bins: int = 128, window_type: str = "povey"):
    """Log-mel fbank of (..., num_samples) -> (..., frames, bins) float32.

    The waveform is at int16 scale for the BEATs preset (the reference
    multiplies by 2**15, data/audio_mapper.py:59). Energy columns
    (``use_energy``) are not used by VAST and are not ported.
    """
    frame_len = int(sample_rate * FRAME_MS / 1000)
    frame_shift = int(sample_rate * SHIFT_MS / 1000)
    fft_len = 1 << (frame_len - 1).bit_length()
    if waveform.shape[-1] < frame_len:
        raise ValueError(f"waveform too short: {waveform.shape[-1]} samples "
                         f"< frame {frame_len}")

    frames = waveform.float().unfold(-1, frame_len, frame_shift)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - PREEMPHASIS * prev
    window = torch.from_numpy(_window(window_type, frame_len))
    frames = frames * window.to(frames.device)
    spec = torch.fft.rfft(frames, n=fft_len, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[..., : fft_len // 2]
    banks = torch.from_numpy(mel_banks(num_mel_bins, fft_len,
                                       float(sample_rate))).to(frames.device)
    return torch.log(torch.clamp(power @ banks, min=EPS))


def beats_fbank(waveform_int16_scale):
    """BEATs preset (data/audio_mapper.py:55-62): 128 bins, 16 kHz."""
    return kaldi_fbank(waveform_int16_scale, num_mel_bins=128)
