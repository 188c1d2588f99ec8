"""Host-side audio reading: decode and resample to fixed-length 16 kHz.

The port's own copy of ``vast_tpu.data.audio``. WAV goes through the
native runtime (``runtime/``, the repo's C++ host decode library) when it
is built, else the stdlib ``wave`` reader and a windowed-sinc resampler;
other containers (mp3, mkv, mp4) need the runtime's FFmpeg path. The
fbank, normalization and clip choice run on the device
(``VASTModel._preprocess_audio``). Missing audio gives a zero waveform
with ``audio_valid=0``, which the device path turns into a zero
spectrogram (the reference's audio_mapper.py:40-42).
"""

from __future__ import annotations

import math
import os
import wave

import numpy as np

from vast_tpu_torch.logger import LOGGER


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """PCM WAV -> (float32 mono in [-1, 1], sample_rate). stdlib-only."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def resample_sinc(x: np.ndarray, sr: int, target_sr: int,
                  lowpass_filter_width: int = 6,
                  rolloff: float = 0.99) -> np.ndarray:
    """Polyphase windowed-sinc resampler (WAV fallback path).

    Same construction the reference gets from torchaudio.load's resample
    (data/audio_mapper.py:30-48): a Hann-windowed sinc low-pass at
    ``rolloff`` x the smaller Nyquist with ``lowpass_filter_width`` zero
    crossings per side, evaluated per output phase. The native runtime
    resamples with libswresample instead.
    """
    if sr == target_sr:
        return x.astype(np.float32)
    g = math.gcd(sr, target_sr)
    orig, new = sr // g, target_sr // g
    base = min(orig, new) * rolloff
    width = int(np.ceil(lowpass_filter_width * orig / base))
    # kernel[i, j]: phase i of the output, taps at (-width .. width+orig-1)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    tp = t * np.pi
    kernel = np.where(tp == 0, 1.0,
                      np.sin(tp) / np.where(tp == 0, 1.0, tp))
    kernel *= window * base / orig
    n_in = len(x)
    n_out = int(np.ceil(n_in * new / orig))
    n_frames = (n_in + orig - 1) // orig
    xp = np.pad(np.asarray(x, np.float64), (width, width + orig))
    frames = np.lib.stride_tricks.sliding_window_view(
        xp, kernel.shape[1])[::orig][:n_frames]
    out = frames @ kernel.T  # (n_frames, new): frame-major, phase-minor
    return out.reshape(-1)[:n_out].astype(np.float32)


class AudioMapper:
    """Delivers fixed-length waveforms; fbank happens on device.

    Fixed length = enough frames for ``sample_num`` clips of
    ``target_length`` fbank frames plus margin, so the device's even-split
    clip sampling sees the whole clip budget (audio_mapper.py:70-88).
    """

    def __init__(self, d_cfg, args):
        self.audio_dir = d_cfg["audio"]
        self.training = d_cfg["training"]
        self.sample_num = d_cfg.get("audio_sample_num", 1)
        self.target_length = args.model_cfg.audio_target_length
        self.frame_shift = 160  # 10 ms @ 16 kHz
        self.frame_len = 400    # 25 ms
        self.num_samples = (self.target_length * self.sample_num
                            * self.frame_shift + self.frame_len)

    def read(self, id_) -> tuple[np.ndarray, int]:
        """Returns (waveform float32 int16-scale (S,), valid flag)."""
        path = os.path.join(self.audio_dir, str(id_))
        for suffix in ("", ".wav", ".mp3", ".mkv"):
            if os.path.exists(path + suffix):
                path = path + suffix
                break
        if not os.path.exists(path):
            # missing audio -> zero waveform (audio_mapper.py:40-42)
            return np.zeros(self.num_samples, np.float32), 0
        from vast_tpu_torch.data.vision import _native_runtime
        nat = _native_runtime()
        if not path.endswith(".wav"):
            # mp3/mkv/mp4/...: native FFmpeg decode (the reference used
            # torchaudio here, audio_mapper.py:30-48)
            if nat is not None and nat.media_available():
                out, valid = nat.load_audio_batch([path], self.num_samples,
                                                  n_threads=1)
                if valid[0]:
                    return out[0], 1
            LOGGER.info("cannot decode %s (no media runtime); zero fallback",
                        path)
            return np.zeros(self.num_samples, np.float32), 0
        if nat is not None:
            out, valid = nat.load_wav_batch([path], self.num_samples,
                                            n_threads=1)
            return out[0], int(valid[0])
        try:
            x, sr = read_wav(path)
        except Exception as e:
            LOGGER.info("audio read failed for %s: %s", id_, e)
            return np.zeros(self.num_samples, np.float32), 0
        x = resample_sinc(x, sr, 16000) * 2.0 ** 15  # beats int16 scale
        if len(x) >= self.num_samples:
            x = x[: self.num_samples]
        else:
            x = np.pad(x, (0, self.num_samples - len(x)))
        return x.astype(np.float32), 1
