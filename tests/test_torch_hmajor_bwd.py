"""The head-major attention's lse forward and backward against vast_tpu's.

On CPU tensors the port's ``flash_attention`` (with ``return_lse``) and
``flash_attention_bwd`` are their plain versions; they are held against
vast_tpu's Pallas ``flash_attention(..., return_lse=True)`` and
``flash_attention_bwd`` run in interpret mode, at a shape of its fused
backward (Lq <= 512, row 7) and one of its tiled backward (Lq > 512,
rows 8-9), each plain, with ``lk_true``, with a mask bias and with
``return_dbias``. Then the differentiable op against ``jax.grad`` of
``multi_head_attention_hmajor(..., impl="pallas", interpret=True)``. The
CUDA kernels are held against the same plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py). fp32 throughout; JAX
matmuls run at "highest" precision (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vast_tpu.ops.attention import multi_head_attention_hmajor as j_mha
from vast_tpu.ops.flash_attention import flash_attention as j_flash
from vast_tpu.ops.flash_attention import flash_attention_bwd as j_flash_bwd
from vast_tpu_torch.ops import attention
from vast_tpu_torch.ops import flash_attention as fa
from vast_tpu_torch.ops.attention import multi_head_attention_hmajor

SHAPES = {
    # Lq <= 512: vast_tpu's fused backward (row 7)
    "fused": dict(b=2, h=3, lq=96, lk=160, d=32),
    # Lq > 512: its tiled backward (rows 8 and 9), ragged against its tiles
    "tiled": dict(b=1, h=2, lq=530, lk=530, d=16),
}
VARIANTS = ("plain", "lk_true", "mask_bias", "dbias")
# fp32 sums over <= 530 keys in another order: ~1e-6 of the largest
# entry measured; this bound is 30x that
TOL = 3e-5


def _inputs(shape, variant, seed):
    """q (already scaled: the JAX kernels take it so; the port gets scale
    1), k, v, the output cotangent, the bias and lk_true, as numpy."""
    s = SHAPES[shape]
    b, h, lq, lk, d = (s[n] for n in ("b", "h", "lq", "lk", "d"))
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, h, lq, d) * d ** -0.5).astype(np.float32)
    k, v = (rs.randn(b, h, lk, d).astype(np.float32) for _ in range(2))
    do = rs.randn(b, h, lq, d).astype(np.float32)
    bias, lk_true = None, 0
    if variant == "lk_true":
        # keys past lk_true hold garbage and are masked
        lk_true = lk - 23
        k[:, :, lk_true:] *= 50.0
        v[:, :, lk_true:] *= 50.0
    elif variant == "mask_bias":
        # BERT's kind: 0 / -1e30 from a mask, one per batch row
        mask = rs.rand(b, 1, lq, lk) > 0.3
        mask[..., 0] = True
        bias = np.where(mask, 0.0, -1e30).astype(np.float32)
    elif variant == "dbias":
        bias = rs.randn(b, h, lq, lk).astype(np.float32)
    return q, k, v, do, bias, lk_true


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, want, name):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, atol=TOL * scale,
                               rtol=TOL, err_msg=name)


def _j_forward(q, k, v, bias, lk_true):
    """vast_tpu's forward with the lse; a query length past 512 is padded
    to its 128-row tiles, as its wrapper pads it (attention.py:95-97)."""
    lq = q.shape[2]
    pad = 0 if lq <= 512 else -lq % 128
    qp = np.pad(q, [(0, 0), (0, 0), (0, pad), (0, 0)])
    bp = None if bias is None else np.pad(
        bias, [(0, 0), (0, 0), (0, pad), (0, 0)])
    o, lse = j_flash(_j(qp), _j(k), _j(v), _j(bp), return_lse=True,
                     lk_true=lk_true, interpret=True)
    return np.asarray(o)[:, :, :lq], np.asarray(lse)[:, :, :lq, 0]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_lse_forward_matches_pallas(shape, variant):
    q, k, v, _, bias, lk_true = _inputs(shape, variant, 0)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention(_t(q), _t(k), _t(v), _t(bias),
                                lk_true=lk_true, return_lse=True)
    assert fa.LAUNCHES == before        # the CPU path launches no kernel
    want_o, want_lse = _j_forward(q, k, v, bias, lk_true)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert tuple(lse.shape) == q.shape[:3]
    _close(o, want_o, "o")
    _close(lse, want_lse, "lse")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_backward_matches_pallas(shape, variant):
    """The plain backward against vast_tpu's flash_attention_bwd on the
    same q, k, v, bias, o, lse and cotangent; with ``return_dbias`` the
    raw ds too. Keys past lk_true get exactly zero gradients in both."""
    q, k, v, do, bias, lk_true = _inputs(shape, variant, 1)
    o, lse = fa.flash_attention(_t(q), _t(k), _t(v), _t(bias),
                                lk_true=lk_true, return_lse=True)
    with_ds = variant == "dbias"
    got = fa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(bias), o, lse,
                                 _t(do), scale=1.0, lk_true=lk_true,
                                 return_dbias=with_ds)
    want = j_flash_bwd(_j(q), _j(k), _j(v), _j(bias), _j(o.numpy()),
                       _j(lse.numpy()[..., None]), _j(do),
                       return_dbias=with_ds, lk_true=lk_true,
                       interpret=True)
    assert len(got) == len(want) == 3 + with_ds
    for name, g, w in zip(("dq", "dk", "dv", "ds"), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        _close(g, w, name)
    if lk_true:
        for g, w in zip(got[1:3], want[1:3]):
            assert not g[:, :, lk_true:].any()
            assert not np.asarray(w)[:, :, lk_true:].any()


OP_CASES = {
    # name: (B, H, Lq, Lk, D, bias kind)
    "self_160": (2, 2, 160, 160, 16, None),
    "mask_cross": (2, 2, 120, 200, 16, "mask"),
    "learned_shared_bias": (2, 2, 144, 144, 16, "learned"),
    "tiled_530": (1, 2, 530, 530, 16, None),
}


@pytest.mark.parametrize("case", list(OP_CASES))
def test_op_gradient_matches_jax_grad(case):
    """torch.autograd through ``multi_head_attention_hmajor`` (the
    head-major op at these shapes) against jax.grad of vast_tpu's, with
    its Pallas kernels in interpret mode. A mask bias gets no gradient; a
    learned (1, H, Lq, Lk) bias gets ds summed over the batch."""
    b, h, lq, lk, d, kind = OP_CASES[case]
    assert not attention._plain_route(lq, lk, d)
    rs = np.random.RandomState(2)
    q = rs.randn(b, h, lq, d).astype(np.float32)
    k, v = (rs.randn(b, h, lk, d).astype(np.float32) for _ in range(2))
    do = rs.randn(b, h, lq, d).astype(np.float32)
    mask = bias = None
    if kind == "mask":
        mask = rs.rand(b, 1, lq, lk) > 0.3
        mask[..., 0] = True
    elif kind == "learned":
        bias = rs.randn(1, h, lq, lk).astype(np.float32)

    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (q, k, v) + (() if bias is None else (bias,))]
    out = multi_head_attention_hmajor(
        *leaves[:3], bias=leaves[3] if bias is not None else None,
        mask=_t(mask))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))

    def loss(*args):
        y = j_mha(*args[:3], bias=args[3] if bias is not None else None,
                  mask=_j(mask), impl="pallas", interpret=True)
        return jnp.sum(y * jnp.asarray(do))

    jargs = [jnp.asarray(x) for x in (q, k, v)] + (
        [] if bias is None else [jnp.asarray(bias)])
    want = jax.grad(loss, argnums=tuple(range(len(jargs))))(*jargs)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, name)


def test_rows_with_no_finite_score_give_zero_and_no_nan():
    """A row whose bias is -inf on every key: output 0 and lse +inf in
    the forward, and in the backward zero dq for it, finite gradients,
    and dk, dv as if its cotangent were 0 (its p is 0)."""
    rs = np.random.RandomState(3)
    b, h, lq, lk, d = 1, 2, 40, 50, 8
    q, k, v, do = (torch.from_numpy(rs.randn(b, h, n, d).astype(np.float32))
                   for n in (lq, lk, lk, lq))
    bias = torch.from_numpy(rs.randn(b, 1, lq, lk).astype(np.float32))
    bias[0, 0, 7] = float("-inf")
    o, lse = fa.flash_attention(q, k, v, bias, scale=0.5, return_lse=True)
    assert not o[:, :, 7].any() and bool(torch.isinf(lse[:, :, 7]).all())
    grads = fa.flash_attention_bwd(q, k, v, bias, o, lse, do, scale=0.5,
                                   return_dbias=True)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert not grads[0][:, :, 7].any() and not grads[3][:, :, 7].any()
    do_zeroed = do.clone()
    do_zeroed[:, :, 7] = 0.0
    again = fa.flash_attention_bwd(q, k, v, bias, o, lse, do_zeroed,
                                   scale=0.5)
    for g, w in zip(grads[1:3], again[1:3]):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_lse_only_when_a_gradient_is_recorded(monkeypatch):
    """Without a gradient to record the op runs the forward without the
    lse (vast_tpu's primal); with one, the forward with the lse."""
    calls = []
    op = fa.FLASH_OP

    def spy(*args):
        calls.append(args[-1])
        return op(*args)

    monkeypatch.setattr(fa, "FLASH_OP", spy)
    x = torch.randn(1, 2, 16, 8)
    with torch.no_grad():
        fa.flash_attention(x, x, x)
    fa.flash_attention(x, x, x)                        # no leaf needs grad
    y = x.clone().requires_grad_(True)
    fa.flash_attention(y, x, x)
    _, lse = fa.flash_attention(x, x, x, return_lse=True)
    assert calls == [False, False, True, True]
    assert tuple(lse.shape) == (1, 2, 16)


def test_broadcast_bias_gradient_sums_over_its_broadcast_axes():
    """A (1, 1, Lq, Lk) bias gets the sum of the full ds over batch and
    heads: the same as the gradient of its broadcast copy, summed."""
    rs = np.random.RandomState(4)
    b, h, lq, lk, d = 3, 2, 24, 30, 8
    q, k, v, do = (torch.from_numpy(rs.randn(b, h, n, d).astype(np.float32))
                   for n in (lq, lk, lk, lq))
    bias = torch.from_numpy(rs.randn(1, 1, lq, lk).astype(np.float32))
    shared = bias.clone().requires_grad_(True)
    wide = bias.expand(b, h, lq, lk).clone().requires_grad_(True)
    g_shared = torch.autograd.grad(fa.flash_attention(q, k, v, shared), shared,
                                   do)[0]
    g_wide = torch.autograd.grad(fa.flash_attention(q, k, v, wide), wide,
                                 do)[0]
    assert g_shared.shape == (1, 1, lq, lk)
    torch.testing.assert_close(g_shared, g_wide.sum((0, 1), keepdim=True),
                               atol=1e-5, rtol=1e-5)


def test_backward_wrapper_rejects_what_it_does_not_take():
    x = torch.zeros(2, 3, 8, 16)
    lse = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError):                     # lse shape
        fa.flash_attention_bwd(x, x, x, None, x, lse[:, :, :4], x, scale=1.0)
    with pytest.raises(ValueError):                     # lse dtype
        fa.flash_attention_bwd(x, x, x, None, x, lse.double(), x, scale=1.0)
    with pytest.raises(ValueError):                     # do shape
        fa.flash_attention_bwd(x, x, x, None, x, lse, x[:, :2], scale=1.0)
    with pytest.raises(ValueError):                     # ds without bias
        fa.flash_attention_bwd(x, x, x, None, x, lse, x, scale=1.0,
                               return_dbias=True)
