"""The port's plain ops against vast_tpu's: GELU, frame preprocessing,
YUV420 expansion, and the kaldi fbank (also against the committed goldens).

Inputs are made with numpy from a seed and given to both packages. JAX
runs on the CPU at "highest" matmul precision (tests/conftest.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_fbank_golden import GOLDEN_DIR, _fixture_waveform
from vast_tpu.ops import fbank as jfbank
from vast_tpu.ops import image as jimage
from vast_tpu.ops.activations import gelu as jgelu
from vast_tpu_torch.ops import fbank, image
from vast_tpu_torch.ops.activations import gelu


def test_gelu_exact_fp32_and_tanh_bf16():
    x = np.random.RandomState(0).randn(4, 257).astype(np.float32) * 3
    # fp32 picks exact erf; both sides evaluate the same formula in fp32
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jgelu(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    # the explicit override gives the tanh form in fp32 too
    np.testing.assert_allclose(
        gelu(torch.from_numpy(x), approximate=True).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)),
        atol=1e-6, rtol=1e-6)
    # bf16 picks tanh; the two frameworks round at different places, so
    # they may differ by one bf16 ulp (2**-7 relative) of the output
    xb = torch.from_numpy(x).bfloat16()
    got = gelu(xb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jgelu(jnp.asarray(xb.float().numpy(), jnp.bfloat16)),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("hw", [(40, 48), (20, 24)],
                         ids=["downscale", "upscale"])
@pytest.mark.parametrize("transforms", ["none", "crop_flip"])
def test_preprocess_frames_matches_jax(hw, transforms):
    frames = np.random.RandomState(1).randint(
        0, 256, (2, 3) + hw + (3,)).astype(np.uint8)
    got = image.preprocess_frames(torch.from_numpy(frames), 32,
                                  transforms=transforms)
    want = jimage.preprocess_frames(jnp.asarray(frames), 32, train=False,
                                    transforms=transforms)
    assert tuple(got.shape) == (2, 3, 32, 32, 3)
    # normalized values are O(2); fp32 sums of <= 8 weighted taps per axis
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_yuv420_to_rgb_matches_jax():
    packed = np.random.RandomState(2).randint(
        0, 256, (2, 3, 16 * 16 * 3 // 2)).astype(np.uint8)
    got = image.yuv420_to_rgb(torch.from_numpy(packed))
    want = jimage.yuv420_to_rgb(jnp.asarray(packed))
    assert tuple(got.shape) == (2, 3, 16, 16, 3)
    # 0..255 scale, a few fp32 multiply-adds per channel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_kaldi_fbank_matches_jax():
    wav = (np.random.RandomState(3).randn(2, 1024 * 16 + 400) * 3000
           ).astype(np.float32)
    for bins in (64, 128):
        got = fbank.kaldi_fbank(torch.from_numpy(wav), num_mel_bins=bins)
        want = jfbank.kaldi_fbank(jnp.asarray(wav), num_mel_bins=bins)
        assert tuple(got.shape) == (2, 103, bins)
        # both sides are fp32 with different FFT and DC-mean summation
        # orders; at int16 scale a weak mel band's power carries ~3e-5
        # relative error (measured 1.7e-4 absolute in the log), under the
        # 1e-3 the goldens are held to
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
    np.testing.assert_array_equal(fbank.mel_banks(64, 512, 16000.0),
                                  jfbank.mel_banks(64, 512, 16000.0))


def test_fbank_goldens():
    """Both VAST presets against the committed torchaudio-algorithm
    goldens, at tests/test_fbank_golden.py's bound (1e-3)."""
    wav = _fixture_waveform()
    beats = np.load(os.path.join(GOLDEN_DIR, "fbank_beats_128.npy"))
    got = fbank.beats_fbank(
        torch.from_numpy(wav.astype(np.float32) / 32768.0 * 2 ** 15))
    assert tuple(got.shape) == beats.shape == (48, 128)
    assert np.abs(got.numpy() - beats).max() < 1e-3

    ast = np.load(os.path.join(GOLDEN_DIR, "fbank_ast_64.npy"))
    x = wav.astype(np.float32) / 32768.0
    # the AST preset (data/audio_mapper.py:46-52): hanning window; its
    # htk_compat flag only moves the energy column, which VAST leaves off
    got = fbank.kaldi_fbank(torch.from_numpy(x - x.mean()), num_mel_bins=64,
                            window_type="hanning")
    assert tuple(got.shape) == ast.shape == (48, 64)
    assert np.abs(got.numpy() - ast).max() < 1e-3
