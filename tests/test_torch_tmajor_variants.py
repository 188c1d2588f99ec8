"""The token-major layout probe's kernels and script against the JAX one.

On CPU tensors the port's ``attention_dma`` and ``attention_sect``
(vast_tpu_torch/scripts/bench_tmajor_variants.py) are their plain versions;
they are held against the Pallas ``attention_dma`` and ``attention_sect``
of scripts/bench_tmajor_variants.py (loaded by path) run in interpret mode,
in fp32 and bf16, with and without ``lk_true``. Then the layouts against
each other and the probe's ``run`` and ``main`` on the CPU. The CUDA
kernels are held against the same plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vast_tpu_torch.ops import flash_attention as fa
from vast_tpu_torch.scripts import bench_tmajor_variants as tv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "jax_bench_tmajor_variants",
    os.path.join(ROOT, "scripts", "bench_tmajor_variants.py"))
jtv = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jtv)

CASES = {
    # name: (B, L, H, D, lk_true); B a multiple of attention_dma's batch
    # group of 4
    "d16": (8, 24, 2, 16, 0),
    # EVA01-g's head width, keys and values past lk_true large (masked)
    "d88_lk_true": (8, 20, 2, 88, 13),
}
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _qkv(case):
    """A fused (B, L, H*3*D) qkv and its section-major permutation, fp32
    numpy."""
    b, l, h, d, lk_true = CASES[case]
    rs = np.random.RandomState(0)
    x = (rs.randn(b, l, h, 3, d) * 0.5).astype(np.float32)
    if lk_true:
        x[:, lk_true:, :, 1:] *= 50.0
    fused = x.reshape(b, l, h * 3 * d)
    sect = np.ascontiguousarray(x.transpose(0, 1, 3, 2, 4)).reshape(
        b, l, 3 * h * d)
    return fused, sect


def _assert_close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "fp32":
        # fp32 sums over <= 24 keys and 88 dims in another order
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        # both round p / l to bf16 (scores in fp32 from the same bf16
        # inputs) and the output once: one bf16 ulp (2^-7 relative) of
        # the output's largest entry
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, atol=ulp, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("variant", ["dma", "sect"])
def test_plain_matches_pallas_interpret(variant, case, dtype):
    b, l, h, d, lk_true = CASES[case]
    fused, sect = _qkv(case)
    x = fused if variant == "dma" else sect
    t_dtype, j_dtype = DTYPES[dtype]
    before = dict(fa.LAUNCHES)
    port = tv.attention_dma if variant == "dma" else tv.attention_sect
    got = port(torch.from_numpy(x).to(t_dtype), heads=h, lk_true=lk_true)
    assert fa.LAUNCHES == before        # the CPU path launches no kernel
    assert got.dtype == t_dtype and tuple(got.shape) == (b, l, h * d)
    assert not got.requires_grad
    jax_fn = jtv.attention_dma if variant == "dma" else jtv.attention_sect
    want = jax_fn(jnp.asarray(x).astype(j_dtype), heads=h, lk_true=lk_true,
                  interpret=True)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("case", list(CASES))
def test_sect_on_the_permutation_equals_dma(case):
    """The section-major layout of the same values gives the same output:
    the plain versions do the same fp32 arithmetic on other views."""
    b, l, h, d, lk_true = CASES[case]
    fused, sect = _qkv(case)
    for dtype in (torch.float32, torch.bfloat16):
        a = tv.attention_dma(torch.from_numpy(fused).to(dtype), heads=h,
                             lk_true=lk_true)
        s = tv.attention_sect(torch.from_numpy(sect).to(dtype), heads=h,
                              lk_true=lk_true)
        torch.testing.assert_close(s, a, atol=1e-6, rtol=1e-6)


def test_pad128_sliced_back_equals_cur():
    """Zero lanes add nothing to the scores and give zero output lanes."""
    b, lp, h, d, lk_true = 2, 24, 2, 88, 20
    inputs = {k: x.float() for k, x in
              tv.make_inputs(b, lp, h, d, device="cpu").items()}
    cur = fa.self_attention_tmajor(inputs["fused"], heads=h, lk_true=lk_true)
    pad = fa.self_attention_tmajor(inputs["pad128"], heads=h,
                                   lk_true=lk_true).view(b, lp, h, tv.PAD_D)
    assert pad[..., d:].abs().max().item() == 0.0
    # fp32 sums over 88 or 128 lanes (the extra ones zero) in another order
    torch.testing.assert_close(pad[..., :d].reshape(b, lp, h * d), cur,
                               atol=1e-6, rtol=1e-5)


def test_make_inputs_lays_out_the_same_values():
    b, lp, h, d = 2, 5, 3, 16
    inputs = tv.make_inputs(b, lp, h, d, device="cpu")
    rs = np.random.RandomState(0)
    want = torch.from_numpy((rs.randn(b, lp, h * 3 * d) * 0.05).astype(
        np.float32)).to(torch.bfloat16)
    assert torch.equal(inputs["fused"], want)
    per_head = want.view(b, lp, h, 3, d)
    sect = inputs["sect"].view(b, lp, 3, h, d)
    pad = inputs["pad128"].view(b, lp, h, 3, tv.PAD_D)
    for j in range(3):
        assert torch.equal(sect[:, :, j], per_head[:, :, :, j])
    assert torch.equal(pad[..., :d], per_head)
    assert not pad[..., d:].any()


def test_main_on_the_cpu_prints_a_line_per_variant(capsys):
    rc = tv.main(["--device", "cpu", "--batch", "4", "--length", "24",
                  "--heads", "2", "--head-dim", "16", "--lk-true", "20",
                  "--iters", "2"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"device": "cpu"}
    assert [r["variant"] for r in lines[1:]] == list(tv.VARIANTS)
    for rec in lines[1:]:
        assert "error" not in rec and rec["fwd_ms"] > 0
        if rec["variant"] in ("dma", "sect"):
            assert rec["fwd_bwd"].startswith("n/a")
            # the cross-check, one warm-up, two timed calls
            assert rec["calls"] == {"fwd": 4, "bwd": 0}
        else:
            assert rec["fwd_bwd_ms"] > 0
            assert rec["calls"] == {"fwd": 7, "bwd": 3}


def test_run_reports_a_variant_that_disagrees_and_goes_on():
    """A variant whose rows differ from cur's by more than 2e-2 gives an
    error record; the rest still run."""
    inputs = tv.make_inputs(4, 24, 2, 16, device="cpu")
    inputs["sect"] = inputs["sect"] * 40.0
    records = []
    out = tv.run(("cur", "sect", "dma"), heads=2, lk_true=20, iters=1,
                 device="cpu", inputs=inputs, emit=records.append)
    assert records[0] == {"device": "cpu"} and records[1:] == out
    assert "error" not in out[0] and "error" not in out[2]
    assert out[1]["error"].startswith("AssertionError: first two rows")


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 4, 2 * 3 * 16)
    for fn in (tv.attention_dma, tv.attention_sect):
        with pytest.raises(ValueError):
            fn(x, heads=5)                      # not H * 3 * D
        with pytest.raises(ValueError):
            fn(x, heads=2, lk_true=5)           # beyond L
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 4, 3 * 136), heads=1)   # D > 128
        with pytest.raises(TypeError):
            fn(x.half(), heads=2)
        with pytest.raises(ValueError):
            fn(x[0], heads=2)                   # not (B, L, H*3*D)
    with pytest.raises(ValueError):
        tv.run(("cur", "nope"), device="cpu")
