"""The token-major forward's Hopper body and its lse, on the CPU.

``self_attention_tmajor`` takes the Hopper body
(``vast_tmajor_attention_fwd_sm90``: wgmma fed by the copy engine) for
bf16 operands the copy engine can read, decided before the launch by
``_sm90_ok(d, qkv[, bias])``: here the fused views of EVA01-g's, BEATs'
and the layout probe's blocks (on the meta device at their full shapes)
must take it, and what the copy engine cannot read must not. While
autograd records, the forward also writes the lse (B, H, L), which the
op saves and hands to ``self_attention_tmajor_bwd``: here the plain
version's lse is held against vast_tpu's Pallas forward in interpret
mode, the gradient with the lse saved against vast_tpu's backward and
against the port's own lse-free backward, and the 'attn' checkpoint
policy against re-running the forward. The kernels themselves run on the
card only (tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_attention import TMAJOR_CASES
from tests.test_torch_bwd_sm90 import fused
from tests.test_torch_train import BWD_CASES, _bwd_inputs
from vast_tpu.ops.flash_attention import flash_attention as j_flash
from vast_tpu.ops.flash_attention import self_attention_tmajor_bwd as j_bwd
from vast_tpu_torch.convert.from_jax import init_random_
from vast_tpu_torch.models.beats import BeatsConfig, BeatsLayer
from vast_tpu_torch.models.eva_vit import EvaBlock, EvaVitConfig
from vast_tpu_torch.models.remat import remat_call
from vast_tpu_torch.ops import flash_attention as fa
from vast_tpu_torch.ops.flash_attention import _sm90_ok
from vast_tpu_torch.scripts import bench_fwd

BF16 = torch.bfloat16


def with_bias(b, l, h, d, shared=False, device="meta", dtype=BF16):
    """BEATs' question: D, its fused qkv and its gated bias (B or 1, H, L,
    L), contiguous as models/beats.py passes it."""
    d, qkv, _, _ = fused(b, l, h, d, device=device, dtype=dtype)
    bias = torch.empty(1 if shared else b, h, l, l, device=device,
                       dtype=dtype)
    return d, qkv, bias


def forward_operands(d, qkv, *rest):
    """The forward's operands of :func:`fused`'s tuple (qkv alone) or of
    :func:`with_bias`' (qkv and the bias)."""
    return (d, qkv, *rest) if rest and rest[0].dim() == 4 else (d, qkv)


TAKEN = {
    # chip_smoke.py's rows 1 and 2: EVA01-g (64 frames, 257 tokens, 16 x
    # 88: head stride 264, row stride 4224, k and v 176 and 352 bytes on)
    # and BEATs (8 clips, 256 tokens, 12 x 64) with its per-sample bias;
    # a bias shared by the batch
    "eva_fused_d88": lambda: forward_operands(*fused(64, 257, 16, 88)),
    "beats_per_sample_bias": lambda: with_bias(8, 256, 12, 64),
    "beats_shared_bias": lambda: with_bias(8, 256, 12, 64, shared=True),
    # the layout probe's cur (L 272, D 88) and pad128 (D 128) variants
    "probe_cur": lambda: forward_operands(*fused(256, 272, 16, 88)),
    "probe_pad128": lambda: forward_operands(*fused(256, 272, 16, 128)),
    # the widths the body is built for: D 8 to 128 in steps of 8
    "d8_one_row": lambda: forward_operands(*fused(2, 1, 1, 8)),
    "d96_bias": lambda: with_bias(2, 136, 2, 96),
}


@pytest.mark.parametrize("case", list(TAKEN))
def test_hopper_forward_takes_the_fused_views(case):
    assert _sm90_ok(*TAKEN[case]())


def misaligned_qkv(b, l, h, d):
    """A fused qkv one element (2 bytes) past a 16-byte boundary (a real
    CPU tensor: the pointer is what counts)."""
    n = b * l * h * 3 * d
    return d, torch.zeros(n + 1, dtype=BF16)[1:].view(b, l, h * 3 * d)


def misaligned_bias(b, l, h, d):
    d, qkv, bias = with_bias(b, l, h, d, device="cpu")
    n = bias.numel()
    return d, qkv, torch.zeros(n + 8 + 1, dtype=BF16)[9:].view(bias.shape)


REFUSED = {
    "fp32": lambda: forward_operands(*fused(2, 40, 2, 64,
                                            dtype=torch.float32)),
    "fp32_bias": lambda: with_bias(2, 40, 2, 64, dtype=torch.float32),
    # D not a multiple of 8: heads 3D apart, k D in, off 16 bytes
    "d20": lambda: forward_operands(*fused(2, 40, 2, 20)),
    "d136": lambda: forward_operands(*fused(1, 8, 1, 136)),
    "base_offset_one_element": lambda: misaligned_qkv(2, 40, 3, 64),
    # the bias's rows 257 elements apart (BEATs' layer at L 257): the copy
    # engine reads rows from 16-byte boundaries only
    "bias_rows_257": lambda: with_bias(2, 257, 2, 64),
    "bias_base_offset": lambda: misaligned_bias(2, 40, 2, 64),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_hopper_forward_refuses_what_the_copy_engine_cannot_read(case):
    assert not _sm90_ok(*REFUSED[case]())


def _tmajor_inputs(c, seed=0):
    rs = np.random.RandomState(seed)
    b, l, h, d = c["b"], c["l"], c["h"], c["d"]
    qkv = rs.randn(b, l, h * 3 * d).astype(np.float32)
    if c["lk_true"]:
        qkv[:, c["lk_true"]:] = 50.0 * rs.randn(b, l - c["lk_true"],
                                                h * 3 * d)
    bias = None
    if c.get("bias") in ("per_sample", "shared", True):
        bias = rs.randn(1 if c["bias"] == "shared" else b, h, l,
                        l).astype(np.float32)
    return qkv, bias


@pytest.mark.parametrize("case", list(TMAJOR_CASES))
def test_tmajor_lse_matches_pallas(case):
    """The plain token-major forward's lse (what the kernels write, and
    the backward reads) against vast_tpu's head-major Pallas forward with
    ``return_lse`` in interpret mode on the head-major views of the same
    qkv. Pallas takes q already scaled, so q is scaled for it (in fp32,
    exact for the unit scale). fp32 on both sides: the lse is a log of a
    sum of at most 128 exponentials of D-term dots, so the two differ by
    fp32 rounding, ~1e-7 relative; 1e-5 x max |lse| leaves room for the
    other order of the sums."""
    c = TMAJOR_CASES[case]
    qkv, bias = _tmajor_inputs(c)
    b, l, h, d, lk = c["b"], c["l"], c["h"], c["d"], c["lk_true"]
    out, lse = fa._self_attention_tmajor_plain(
        torch.from_numpy(qkv), None if bias is None else
        torch.from_numpy(bias), heads=h, lk_true=lk, scale=c["scale"],
        return_lse=True)
    assert tuple(lse.shape) == (b, h, l) and lse.dtype == torch.float32
    assert torch.equal(out, fa._self_attention_tmajor_plain(
        torch.from_numpy(qkv), None if bias is None else
        torch.from_numpy(bias), heads=h, lk_true=lk, scale=c["scale"]))
    x = qkv.reshape(b, l, h, 3, d).transpose(3, 0, 2, 1, 4)
    jbias = None if bias is None else jnp.asarray(bias)
    _, want = j_flash(jnp.asarray(x[0] * np.float32(c["scale"])),
                      jnp.asarray(x[1]), jnp.asarray(x[2]), jbias,
                      interpret=True, return_lse=True, lk_true=lk)
    want = np.asarray(want)[..., 0]
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(lse.numpy(), want, atol=tol, rtol=0)


def _fp32_limits(c, qkv, bias, do, o, lse):
    """The fp32 error factor and each gradient's sum of |terms| of its
    last product, from which its limit is derived.

    p = exp(s + bias - lse) is exact to the rounding of its exponent's
    terms: an absolute error of up to ~2^-24 x A, A the largest |s|
    term sum (sum |q| |k| x scale, plus |bias|) plus |lse| of a row whose
    cotangent is not zero (the others add no term), so p errs by up to
    2^-24 x A relative; each gradient is a sum of terms proportional to p
    (ds = p (dp - delta)), and the sums' own order adds ~2^-24 x sqrt(n)
    of their |terms| (n keys, random roundings). So each errs by at most
    2^-24 x (A + sqrt(n)) x max(|ref| + the sum of |terms| of its last
    product), the span the GPU tests' fp32 limits use, taken over dqkv's
    three parts together (measured on the CPU over seeds 0-7: errors of
    5-32% of the limit against Pallas, 3-12% between the port's
    backwards; an lse 1e-5 too large reads 1.1-3.0x the limit in the
    d64 cases, 0.7x at d128)."""
    b, l, _ = qkv.shape
    h, d, scale = c["h"], c["d"], c["scale"]
    nk = c["lk_true"] or l
    q, k = (qkv.view(b, l, h, 3, d)[:, :, :, i].abs().transpose(1, 2)
            for i in (0, 1))
    terms = torch.matmul(q, k.transpose(-1, -2))[..., :nk] * scale
    if bias is not None:
        terms = terms + bias.abs()[..., :nk]
    live = do.view(b, l, h, d).transpose(1, 2).abs().sum(-1) > 0
    a = (terms.amax(-1) + lse.abs())[live].max().item()
    t = fa._self_attention_tmajor_bwd_abs_terms(qkv, o, do, bias, heads=h,
                                                lk_true=c["lk_true"],
                                                scale=scale)
    fused_terms = torch.stack([t["dq"], t["dk"], t["dv"]], 3)  # B H L 3 D
    spans = [fused_terms.permute(0, 2, 1, 3, 4).reshape(b, l, -1)]
    if bias is not None:
        spans.append(t["dbias"])
    return 2.0 ** -24 * (a + nk ** 0.5), spans


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_tmajor_grad_with_saved_lse_matches_pallas(case, seed):
    """torch.autograd through the op, which saves the forward's lse and
    hands it to the backward (p = exp(s - lse)), against vast_tpu's
    token-major Pallas backward in interpret mode (which recomputes the
    row statistics) and against the port's own backward called without
    the lse, on tests/test_torch_train.py's backward cases at four seeds.
    fp32, each gradient within the limit :func:`_fp32_limits` derives
    from the magnitudes it sums."""
    c = BWD_CASES[case]
    qkv, bias, do = _bwd_inputs(c, seed)
    h, lk, scale = c["h"], c["lk_true"], c["scale"]
    x = torch.from_numpy(qkv).requires_grad_(True)
    inputs = [x]
    tb = None
    if bias is not None:
        tb = torch.from_numpy(bias).requires_grad_(True)
        inputs.append(tb)
    seen = []
    bwd = fa.self_attention_tmajor_bwd

    def spy(*args, **kwargs):
        seen.append(kwargs.get("lse"))
        return bwd(*args, **kwargs)

    fa.self_attention_tmajor_bwd = spy
    try:
        out = fa.self_attention_tmajor(x, tb, heads=h, lk_true=lk,
                                       scale=scale)
        got = torch.autograd.grad(out, inputs, torch.from_numpy(do))
    finally:
        fa.self_attention_tmajor_bwd = bwd
    assert len(seen) == 1 and tuple(seen[0].shape) == (c["b"], h, c["l"])
    o = out.detach()
    want = j_bwd(jnp.asarray(qkv), jnp.asarray(o.numpy()), jnp.asarray(do),
                 None if bias is None else jnp.asarray(bias), heads=h,
                 lk_true=lk, scale=scale, interpret=True)
    free = fa.self_attention_tmajor_bwd(torch.from_numpy(qkv), o,
                                        torch.from_numpy(do), tb if tb is
                                        None else tb.detach(), heads=h,
                                        lk_true=lk, scale=scale)
    if bias is None:
        want, free = (want,), (free,)
    factor, terms = _fp32_limits(c, torch.from_numpy(qkv), tb if tb is
                                 None else tb.detach(),
                                 torch.from_numpy(do), o, seen[0])
    for g, w, f, t in zip(got, want, free, terms):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        w = torch.from_numpy(np.array(w))
        tol = factor * (w.abs() + t).max().item()
        assert (g - w).abs().max().item() <= tol
        assert (g - f).abs().max().item() <= tol


def test_lse_is_written_only_while_autograd_records():
    """No gradient to record: the forward alone (no lse), as the slice's
    inference runs; a gradient: the lse beside the output."""
    c = BWD_CASES["d64_lk_true"]
    qkv, _, _ = _bwd_inputs(c, 3)
    x = torch.from_numpy(qkv)
    args = (None, c["h"], c["lk_true"], c["scale"])
    _, lse = fa.TMAJOR_OP(x, *args, False)
    assert lse.numel() == 0
    _, lse = fa.TMAJOR_OP(x, *args, True)
    assert tuple(lse.shape) == (c["b"], c["h"], c["l"])
    with pytest.raises(ValueError, match="lse must be"):
        fa.self_attention_tmajor_bwd(x, x[..., :x.shape[-1] // 3], x[
            ..., :x.shape[-1] // 3], heads=c["h"], lse=lse[:, :1])


def _eva_block():
    cfg = EvaVitConfig(image_size=32, patch_size=8, width=32, layers=2,
                       head_width=8, mlp_ratio=2.0)
    blk = init_random_(EvaBlock(cfg, device="cpu"),
                       torch.Generator().manual_seed(0))
    x = torch.randn(2, 17, 32, generator=torch.Generator().manual_seed(1))
    return (lambda t: blk(t)), x, cfg.num_heads


def _beats_layer():
    cfg = BeatsConfig(input_patch_size=8, embed_dim=24, encoder_embed_dim=32,
                      encoder_layers=2, encoder_ffn_embed_dim=64,
                      encoder_attention_heads=4, conv_pos=16,
                      conv_pos_groups=4, num_buckets=32, max_distance=64)
    layer = init_random_(BeatsLayer(cfg, True, device="cpu"),
                         torch.Generator().manual_seed(0))
    x = torch.randn(2, 24, 32, generator=torch.Generator().manual_seed(1))
    return (lambda t: layer(t)[0]), x, cfg.encoder_attention_heads


@pytest.mark.parametrize("block", [_eva_block, _beats_layer],
                         ids=["eva", "beats"])
def test_attn_remat_saves_the_lse_and_reruns_no_forward(block,
                                                       monkeypatch):
    """Under the 'attn' policy a tiny EVA block and BEATs layer keep the
    op's two outputs: the backward gets the forward's lse, and the
    recompute runs no attention forward (one forward a block); 'full'
    re-runs it (two)."""
    fn, x, heads = block()
    for policy, runs in (("attn", 1), ("full", 2)):
        fwd_calls, lses = [], []
        plain, bwd = fa._self_attention_tmajor_plain, \
            fa.self_attention_tmajor_bwd

        def spy_fwd(*args, **kwargs):
            fwd_calls.append(kwargs.get("return_lse", False))
            return plain(*args, **kwargs)

        def spy_bwd(*args, **kwargs):
            lses.append(kwargs.get("lse"))
            return bwd(*args, **kwargs)

        monkeypatch.setattr(fa, "_self_attention_tmajor_plain", spy_fwd)
        monkeypatch.setattr(fa, "self_attention_tmajor_bwd", spy_bwd)
        xi = x.clone().requires_grad_(True)
        remat_call(policy, fn, xi).square().sum().backward()
        monkeypatch.undo()
        assert fwd_calls == [True] * runs, policy
        assert len(lses) == 1 and lses[0] is not None, policy
        assert tuple(lses[0].shape) == (x.shape[0], heads, x.shape[1])
        assert torch.isfinite(xi.grad).all()


def test_lever_bench_refuses_without_a_card(capsys):
    """The forward's A/B against a parent's source needs the card."""
    assert bench_fwd.main(["--parent", "flash_attention.cu"]) == 2
    assert "no CUDA GPU" in capsys.readouterr().err
