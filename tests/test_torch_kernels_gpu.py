"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where there is no CUDA GPU. On a machine with
one, run them without the JAX test settings (tests/conftest.py):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py

The shapes cover the main paths' (EVA01-g 257 x 16 x 88, BEATs 256 x 12
x 64 with a per-sample bias, BERT's grouped rerank 320 x 2312 x 12 x 64;
EVA02-bigE's 257 x 16 x 112 token-major, EVA02-L's 257 x 16 x 64 and
B's 197 x 12 x 64 head-major, VideoSwin's 392-token window at D 32 with
a learned bias;
CLIP-L/14-336's 577 x 16 x 64 read out of its packed projection, AST's
257 x 12 x 64, and the 4873 condition tokens of the CLIP + AST rerank)
and the edges of the kernels' tiling: L of 1 and of tiles plus one, D
from 1 to 128, lk_true, shared and broadcast biases, strided views, and
rows whose keys are all masked; for the head-major kernels the lse
forward and the backward (with and without a bias and its ds); and the
token-major layout probe's two kernels (attention_dma through the copy
engine, attention_sect) at the probe's shape (256 x 272 x 16 x 88,
lk_true 257) and a ragged one, and attention_dma's refusal of rows the
copy engine cannot read; their Hopper bodies (attention_dma's resident
strip, attention_sect on the shared forward body) at the probe's shape,
one head, D 64, last query tiles of 1, 15, 16, 17 and 63 rows, kend
below L and at the strip's room, against the plain versions and cur, a
kend above the room on the mma.sync body, and the entries' refusals; the
head-major forward's Hopper body (wgmma fed by the copy engine) at D 16
to 128, Lq 1 to 577, Lk 1 to 4873, lk_true, packed, token-major and
contiguous views, fp32 and bf16 biases broadcast over heads or the
batch, with and without the lse, and its entry's refusal of layouts the
copy engine cannot read; the token-major forward's Hopper body at
EVA01-g's, BEATs' (per-sample and shared bias), the probe's
lk_true-padded shape and the edges of its tiles, with its lse, and its
entry's refusals; and the backward's Hopper body (both entries) at L 1
to 4873, Lq != Lk, lk_true, D 8 to 128, with and without a bias and its
ds, the token-major one also given the forward's lse: each output
against the plain version, bitwise repeats, its counters, and its
entry's refusals.
"""

import pytest
import torch

from vast_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

CASES = {
    # name: (B, L, H, D, lk_true, bias, scale)
    "single_token": (1, 1, 1, 1, 0, None, 1.0),
    "eva01g": (4, 257, 16, 88, 0, None, 1.0),
    "ragged_lk_true": (2, 272, 16, 88, 257, None, 1.0),
    "tile_plus_one": (3, 65, 2, 33, 0, None, 0.5),
    "beats_bias": (2, 256, 12, 64, 0, "per_sample", 64 ** -0.5),
    "shared_bias_d128": (3, 100, 2, 128, 0, "shared", 128 ** -0.5),
    "odd_bias_lk_true": (2, 70, 3, 7, 40, "per_sample", 0.3),
    # EVA02-bigE/14: EVA01's fused qkv at head width 112
    "bige_d112": (4, 257, 16, 112, 0, None, 1.0),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cuda, case, dtype):
    b, l, h, d, lk_true, bias_kind, scale = CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(b, l, h * 3 * d, device=cuda, generator=gen).to(dtype)
    bias = None
    if bias_kind:
        nb = b if bias_kind == "per_sample" else 1
        bias = torch.randn(nb, h, l, l, device=cuda, generator=gen).to(dtype)
    key = "tmajor_attention_fwd" + ("" if bias is None else "_bias")
    before = fa.LAUNCHES[key]
    out = fa.self_attention_tmajor(qkv, bias, heads=h, lk_true=lk_true,
                                   scale=scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[key] == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (b, l, h * d)
    ref = fa._self_attention_tmajor_plain(qkv, bias, heads=h,
                                          lk_true=lk_true, scale=scale)
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    if dtype == torch.bfloat16:
        # the kernel rounds p (<= 1) to bf16 for p . v (<= 2^-8 x max |v|
        # in the output) and both round the output once (one ulp, 2^-7)
        v_max = qkv.view(b, l, h, 3, d)[..., 2, :].float().abs().max().item()
        assert err <= ref_max * 2 ** -7 + v_max * 2 ** -8, (err, ref_max)
    else:
        # fp32, other summation order over <= 272 keys
        assert err <= 2e-5 * max(ref_max, 1.0), (err, ref_max)


FLASH_CASES = {
    # name: (B, H, Lq, Lk, D, lk_true, bias shape or None, views)
    "bert_grouped_rerank": (4, 12, 320, 2312, 64, 0, None, True),
    "single_query": (1, 1, 1, 1, 8, 0, None, False),
    "ragged_lk_true": (2, 3, 130, 200, 88, 150, None, True),
    "long_keys": (1, 2, 64, 4500, 128, 0, None, False),
    "per_head_bias": (2, 3, 70, 90, 33, 0, (2, 3), False),
    "mask_rows_broadcast": (2, 4, 100, 120, 64, 0, (2, 1), True),
    # EVA02-L/14 and B/16 (rope, so head-major): 257 and 197 tokens
    "eva02_l": (2, 16, 257, 257, 64, 0, None, True),
    "eva02_b": (2, 12, 197, 197, 64, 0, None, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, h, lq, lk, d, lk_true, bias_shape, views = FLASH_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(1)

    def operand(n):
        x = torch.randn(b, n, h, d, device=cuda, generator=gen).to(dtype)
        x = x.transpose(1, 2)                  # token-major storage
        return x if views else x.contiguous()

    q, k, v = operand(lq), operand(lk), operand(lk)
    bias = None
    if bias_shape:
        bias = torch.randn(*bias_shape, lq, lk, device=cuda, generator=gen)
        bias[0, 0, 3] = float("-inf")          # a row with no key at all
    before = fa.LAUNCHES["flash_attention_fwd"]
    out = fa.flash_attention(q, k, v, bias, scale=d ** -0.5,
                             lk_true=lk_true)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd"] == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (b, h, lq, d)
    ref = fa._flash_attention_plain(q, k, v, bias, scale=d ** -0.5,
                                    lk_true=lk_true).float()
    diff = out.float() - ref
    err = diff.abs().max().item()
    ref_max = ref.abs().max().item()
    if bias_shape:
        assert out[0, 0, 3].abs().max().item() == 0.0
    if dtype == torch.bfloat16:
        # as above; and rms of two roundings of <= 2^-8 relative each
        v_max = v.float().abs().max().item()
        assert err <= ref_max * 2 ** -7 + v_max * 2 ** -8, (err, ref_max)
        rms = (diff.square().mean() / ref.square().mean()).sqrt().item()
        assert rms <= 2 ** -6, rms
    else:
        # fp32, other summation order over <= 4500 keys
        assert err <= 2e-5 * max(ref_max, 1.0), (err, ref_max)


BWD_CASES = {
    # name: (B, L, H, D, lk_true, bias, scale)
    "single_token": (1, 1, 1, 1, 0, None, 1.0),
    "bige_d112": (2, 257, 16, 112, 0, None, 1.0),
    "eva01g": (4, 257, 16, 88, 0, None, 1.0),
    "ragged_lk_true_d33": (2, 100, 2, 33, 77, None, 0.5),
    "tile_plus_one": (3, 65, 2, 32, 0, None, 0.7),
    "beats_bias": (2, 256, 12, 64, 0, "per_sample", 64 ** -0.5),
    "shared_bias_d128": (3, 100, 2, 128, 0, "shared", 128 ** -0.5),
    # keys 70..129 masked: dbias past the last key tile (96.. on the
    # mma.sync body's 32-key tiles, 128.. on the Hopper body's 64)
    # is the wrapper's zero fill
    "bias_lk_true_d88": (2, 130, 2, 88, 70, "per_sample", 0.3),
}


def split_dqkv(dqkv, heads):
    b, l, total = dqkv.shape
    x = dqkv.float().view(b, l, heads, 3, total // (3 * heads))
    return {n: x[:, :, :, i].transpose(1, 2)
            for i, n in enumerate(("dq", "dk", "dv"))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_kernel_matches_plain(cuda, case, dtype):
    b, l, h, d, lk_true, bias_kind, scale = BWD_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(b, l, h * 3 * d, device=cuda, generator=gen).to(dtype)
    bias = None
    if bias_kind:
        nb = b if bias_kind == "per_sample" else 1
        bias = torch.randn(nb, h, l, l, device=cuda, generator=gen).to(dtype)
    o = fa._self_attention_tmajor_plain(qkv, bias, heads=h, lk_true=lk_true,
                                        scale=scale)
    do = torch.randn(b, l, h * d, device=cuda, generator=gen).to(dtype)
    key = "tmajor_attention_bwd" + ("" if bias is None else "_bias")
    before = fa.LAUNCHES[key]
    got = fa.self_attention_tmajor_bwd(qkv, o, do, bias, heads=h,
                                       lk_true=lk_true, scale=scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[key] == before + 1
    want = fa._self_attention_tmajor_bwd_plain(qkv, o, do, bias, heads=h,
                                               lk_true=lk_true, scale=scale)
    if bias is None:
        got, want = (got,), (want,)
    assert got[0].dtype == dtype and got[0].shape == qkv.shape
    outs = split_dqkv(got[0], h)
    refs = split_dqkv(want[0], h)
    if bias is not None:
        assert got[1].dtype == dtype and got[1].shape == bias.shape
        outs["dbias"], refs["dbias"] = got[1].float(), want[1].float()
    scales = fa._self_attention_tmajor_bwd_abs_terms(
        qkv, o, do, bias, heads=h, lk_true=lk_true, scale=scale)
    if bias is not None and bias.shape[0] == 1:
        scales["dbias"] = scales["dbias"].sum(0, keepdim=True)
    for name, out in outs.items():
        ref = refs[name]
        diff = out - ref
        err = diff.abs().max().item()
        span = (ref.abs() + scales[name]).max().item()
        if dtype == torch.bfloat16:
            # p or ds rounded to bf16 before the last product (<= 2^-8 x
            # the sum of |terms|) and the output rounded once (<= 2^-8 x
            # |out|); 10% for the fp32 recomputation of p and ds
            assert err <= 1.1 * 2 ** -8 * span, (name, err, span)
            rms = (diff.square().mean()
                   / ref.square().mean().clamp_min(1e-30)).sqrt().item()
            assert rms <= 2 ** -6, (name, rms)
        else:
            # fp32 sums of <= 257 terms in another order
            assert err <= 5e-5 * max(span, 1e-6), (name, err, span)
        if lk_true and name in ("dk", "dv"):
            assert out[:, :, lk_true:].abs().max().item() == 0.0, name
        if lk_true and name == "dbias":
            assert out[..., lk_true:].abs().max().item() == 0.0


def test_tmajor_grad_on_cuda_goes_through_the_kernels(cuda):
    """The differentiable op launches the forward and backward kernels and
    matches autograd through the plain version; without a gradient it
    launches the forward kernel alone."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, l, h, d = 2, 70, 3, 24
    qkv = torch.randn(b, l, h * 3 * d, device=cuda, generator=gen)
    bias = torch.randn(b, h, l, l, device=cuda, generator=gen)
    do = torch.randn(b, l, h * d, device=cuda, generator=gen)
    grads = []
    for route in ("kernel", "plain"):
        x = qkv.clone().requires_grad_(True)
        bb = bias.clone().requires_grad_(True)
        before = dict(fa.LAUNCHES)
        if route == "kernel":
            out = fa.self_attention_tmajor(x, bb, heads=h, scale=0.4)
        else:
            out = fa._self_attention_tmajor_plain(x, bb, heads=h, scale=0.4)
        grads.append(torch.autograd.grad(out, (x, bb), do))
        launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
        if route == "kernel":
            # fp32: the CUDA-core bodies, the backward given the lse
            assert launched == {k: int(k in (
                "tmajor_attention_fwd_bias", "tmajor_attention_bwd_bias",
                "tmajor_attention_bwd_lse")) for k in before}
    for got, want in zip(*grads):
        assert (got - want).abs().max().item() <= 5e-5 * max(
            want.abs().max().item(), 1.0)
    before = dict(fa.LAUNCHES)
    with torch.no_grad():
        fa.self_attention_tmajor(qkv.clone().requires_grad_(True), heads=h)
    launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    assert launched == {k: int(k == "tmajor_attention_fwd") for k in before}
    # bf16 (D 24, no bias): the Hopper forward with the lse, and the Hopper
    # backward given it
    x = qkv.to(torch.bfloat16).requires_grad_(True)
    before = dict(fa.LAUNCHES)
    torch.autograd.grad(fa.self_attention_tmajor(x, heads=h, scale=0.4), x,
                        do.to(torch.bfloat16))
    launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    assert launched == {k: int(k in (
        "tmajor_attention_fwd", "tmajor_attention_fwd_sm90",
        "tmajor_attention_bwd", "tmajor_attention_bwd_sm90",
        "tmajor_attention_bwd_lse")) for k in before}


TMAJOR_SM90_CASES = {
    # name: (B, L, H, D, lk_true, bias, scale); each a bf16 view the copy
    # engine reads, so each takes the Hopper forward
    "eva01g": (4, 257, 16, 88, 0, None, 1.0),
    "beats_bias": (2, 256, 12, 64, 0, "per_sample", 64 ** -0.5),
    "shared_bias": (3, 128, 2, 64, 0, "shared", 0.125),
    "ragged_lk_true": (2, 272, 16, 88, 257, None, 1.0),
    # D > 64 with a bias: the body reads the bias by scalar loads
    "bias_d96": (2, 136, 2, 96, 0, "per_sample", 0.1),
    "one_row_d8": (2, 1, 1, 8, 0, None, 1.0),
    # a last key tile of exactly 16 keys (the N-16 tile, full)
    "tail_16_d128": (2, 144, 2, 128, 0, None, 0.1),
    # EVA02-bigE/14: D 112 (the <128, 8> instantiation)
    "bige_d112": (4, 257, 16, 112, 0, None, 1.0),
}


def tmajor_inputs(case, dtype, gen, cuda):
    b, l, h, d, lk_true, bias_kind, scale = case
    qkv = torch.randn(b, l, h, 3, d, device=cuda, generator=gen)
    if scale == 1.0:
        qkv[:, :, :, 0] *= d ** -0.5                  # q scale baked in
    qkv = qkv.reshape(b, l, h * 3 * d).to(dtype)
    bias = None
    if bias_kind:
        nb = b if bias_kind == "per_sample" else 1
        bias = torch.randn(nb, h, l, l, device=cuda, generator=gen).to(dtype)
    return qkv, bias


@pytest.mark.parametrize("case", list(TMAJOR_SM90_CASES))
def test_tmajor_sm90_matches_plain(cuda, case):
    """The token-major Hopper forward, with its lse, against the plain
    version: bf16, within the limits chip_smoke.py derives (one bf16 ulp
    of max |out|, 2^-7, plus p rounded to bf16, 2^-8 x max |v|; an rms of
    2^-6); the lse within 1e-5 x max |lse| (fp32 sums of the same exact
    products); the output without the lse the same bits, and a repeat
    too (no atomics)."""
    b, l, h, d, lk_true, _, scale = TMAJOR_SM90_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(4)
    qkv, bias = tmajor_inputs(TMAJOR_SM90_CASES[case], torch.bfloat16, gen,
                              cuda)
    before = dict(fa.LAUNCHES)
    out, lse = fa.TMAJOR_OP(qkv, bias, h, lk_true, scale, True)
    torch.cuda.synchronize()
    launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    key = "tmajor_attention_fwd" + ("" if bias is None else "_bias")
    assert launched == {k: int(k in (key, "tmajor_attention_fwd_sm90"))
                        for k in before}
    ref, ref_lse = fa._self_attention_tmajor_plain(
        qkv, bias, heads=h, lk_true=lk_true, scale=scale, return_lse=True)
    ref = ref.float()
    diff = out.float() - ref
    v_max = qkv.view(b, l, h, 3, d)[..., 2, :].float().abs().max().item()
    err = diff.abs().max().item()
    assert err <= ref.abs().max().item() * 2 ** -7 + v_max * 2 ** -8, err
    rms = (diff.square().mean() / ref.square().mean()).sqrt().item()
    assert rms <= 2 ** -6, rms
    lse_err = (lse - ref_lse).abs().max().item()
    assert lse_err <= 1e-5 * max(ref_lse.abs().max().item(), 1.0), lse_err
    again, no_lse = fa.TMAJOR_OP(qkv, bias, h, lk_true, scale, False)
    assert no_lse.numel() == 0 and torch.equal(again, out)
    assert torch.equal(fa.TMAJOR_OP(qkv, bias, h, lk_true, scale, True)[1],
                       lse)


def tmajor_entry_args(qkv, bias, out, heads, d=None):
    b, l, total = qkv.shape
    d = d or total // (3 * heads)
    return (fa._ptr(qkv), fa._ptr(bias), fa._ptr(out), fa._ptr(None),
            fa._DTYPE_CODES[qkv.dtype], b, l, heads, d, l,
            0 if bias is None or bias.shape[0] == 1 else bias.stride(0),
            1.0, fa._stream())


def test_tmajor_sm90_entry_refuses_what_the_copy_engine_cannot_read(cuda):
    """The Hopper entry returns cudaErrorInvalidValue (1) and writes
    nothing for what its rule refuses, as the op's _sm90_ok decides
    before the launch: fp32, D not a multiple of 8, a qkv base off 16
    bytes, a bias whose rows are not 16-byte multiples or whose base is
    off 16 bytes."""
    entry = fa._kernel("vast_tmajor_attention_fwd_sm90")
    bf16 = torch.bfloat16

    def qkv_of(b, l, h, d, dtype=bf16, offset=0):
        n = b * l * h * 3 * d
        return torch.zeros(n + offset, device=cuda, dtype=dtype)[
            offset:].view(b, l, h * 3 * d)

    def bias_of(b, h, l, offset=0):
        n = b * h * l * l
        return torch.zeros(n + offset, device=cuda, dtype=bf16)[
            offset:].view(b, h, l, l)

    refused = {
        "fp32": (qkv_of(2, 64, 2, 64, torch.float32), None),
        "d20": (qkv_of(2, 64, 2, 20), None),
        "qkv_offset_one": (qkv_of(2, 64, 2, 64, offset=1), None),
        "bias_rows_257": (qkv_of(2, 257, 2, 64), bias_of(2, 2, 257)),
        "bias_offset_one": (qkv_of(2, 64, 2, 64), bias_of(2, 2, 64, 1)),
    }
    for name, (qkv, bias) in refused.items():
        b, l, total = qkv.shape
        out = torch.full((b, l, total // 3), 7.0, device=cuda,
                         dtype=qkv.dtype)
        assert entry(*tmajor_entry_args(qkv, bias, out, 2)) == 1, name
        torch.cuda.synchronize()
        assert bool((out == 7.0).all()), name
        d = total // 6
        assert not fa._sm90_ok(d, qkv, *([] if bias is None else [bias]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["eva01g", "beats_bias", "ragged_lk_true"])
def test_tmajor_bwd_given_lse_matches_plain(cuda, case, dtype):
    """The token-major backward given the forward's lse (the dQ kernel
    reads it and does not sweep the keys) against the plain version and
    within the same limits as the backward without it (test_bwd_kernel_
    matches_plain's): p or ds rounded to bf16 before the last product,
    1.1 x 2^-8 of |ref| plus the sum of |terms|, rms 2^-6 (fp32: 5e-5);
    the lse is read, not written."""
    b, l, h, d, lk_true, _, scale = TMAJOR_SM90_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(5)
    qkv, bias = tmajor_inputs(TMAJOR_SM90_CASES[case], dtype, gen, cuda)
    o, lse = fa._self_attention_tmajor_plain(
        qkv, bias, heads=h, lk_true=lk_true, scale=scale, return_lse=True)
    do = torch.randn(b, l, h * d, device=cuda, generator=gen).to(dtype)
    kw = dict(heads=h, lk_true=lk_true, scale=scale)
    saved = lse.clone()
    before = dict(fa.LAUNCHES)
    given = fa.self_attention_tmajor_bwd(qkv, o, do, bias, lse=lse, **kw)
    torch.cuda.synchronize()
    launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    key = "tmajor_attention_bwd" + ("" if bias is None else "_bias")
    sm90 = int(dtype == torch.bfloat16)
    assert launched == {k: (1 if k in (key, "tmajor_attention_bwd_lse")
                            else sm90 if k == "tmajor_attention_bwd_sm90"
                            else 0) for k in before}
    assert torch.equal(lse, saved)
    swept = fa.self_attention_tmajor_bwd(qkv, o, do, bias, **kw)
    want = fa._self_attention_tmajor_bwd_plain(qkv, o, do, bias, **kw)
    scales = fa._self_attention_tmajor_bwd_abs_terms(qkv, o, do, bias, **kw)
    if bias is None:
        given, swept, want = (given,), (swept,), (want,)
    for res in (given, swept):
        outs, refs = split_dqkv(res[0], h), split_dqkv(want[0], h)
        if bias is not None:
            outs["dbias"], refs["dbias"] = res[1].float(), want[1].float()
        for name, out in outs.items():
            diff = out - refs[name]
            span = (refs[name].abs() + scales[name]).max().item()
            err = diff.abs().max().item()
            if dtype == torch.bfloat16:
                assert err <= 1.1 * 2 ** -8 * span, (name, err, span)
                rms = (diff.square().mean() / refs[name].square().mean()
                       .clamp_min(1e-30)).sqrt().item()
                assert rms <= 2 ** -6, (name, rms)
            else:
                assert err <= 5e-5 * max(span, 1e-6), (name, err, span)


HMAJOR_CASES = {
    # name: (B, H, Lq, Lk, D, lk_true, bias kind, layout)
    # CLIP-L/14-336's and AST's self-attention at two images / clips:
    # q, k, v strided views of one packed projection, or of three
    "clip_packed": (2, 16, 577, 577, 64, 0, None, "packed"),
    "ast_token_major": (2, 12, 257, 257, 64, 0, None, "token_major"),
    "single_query": (1, 1, 1, 1, 8, 0, None, "contiguous"),
    "ragged_lk_true_d33": (2, 3, 100, 130, 33, 77, None, "contiguous"),
    "mask_bias": (2, 4, 100, 120, 64, 0, "mask", "token_major"),
    "learned_bias": (2, 3, 70, 90, 24, 0, "learned", "contiguous"),
    # keys 70..149 masked: ds past the last key tile (96.., or 128..
    # on the Hopper body) is the wrapper's zero fill
    "learned_bias_lk_true_d88": (2, 2, 130, 150, 88, 70, "learned",
                                 "token_major"),
    # the rerank's condition length (8 x 577 + 257): row 6's shapes
    "long_keys": (1, 2, 64, 4873, 64, 0, None, "contiguous"),
    # EVA02-L/14 and B/16 after rope, and VideoSwin's 8 x 7 x 7 window
    # at D 32 with its learned relative bias (ds)
    "eva02_l": (2, 16, 257, 257, 64, 0, None, "token_major"),
    "eva02_b": (2, 12, 197, 197, 64, 0, None, "token_major"),
    "videoswin_window": (2, 4, 392, 392, 32, 0, "learned", "packed"),
}


def hmajor_inputs(case, dtype, cuda, gen):
    """q, k, v, the cotangent do (in the layout the models' autograd gives
    it) and the bias of a case."""
    b, h, lq, lk, d, lk_true, kind, layout = HMAJOR_CASES[case]

    def randn(*shape):
        return torch.randn(*shape, device=cuda, generator=gen).to(dtype)

    if layout == "packed":
        q, k, v = (t.transpose(1, 2) for t in randn(b, lq, 3, h, d).unbind(2))
    elif layout == "token_major":
        q, k, v = (randn(b, n, h, d).transpose(1, 2) for n in (lq, lk, lk))
    else:
        q, k, v = (randn(b, h, n, d) for n in (lq, lk, lk))
    do = randn(b, lq, h, d).transpose(1, 2)
    bias = None
    if kind == "mask":
        keep = torch.rand(b, 1, lq, lk, device=cuda, generator=gen) > 0.3
        keep[..., 0] = True
        bias = torch.where(keep, 0.0, -1e30)
    elif kind == "learned":
        bias = randn(b, h, lq, lk)
        bias[0, 0, 3] = float("-inf")          # a row with no key at all
    return q, k, v, do, bias, lk_true, d ** -0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(HMAJOR_CASES))
def test_flash_lse_kernel_matches_plain(cuda, case, dtype):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, _, bias, lk_true, scale = hmajor_inputs(case, dtype, cuda, gen)
    before = fa.LAUNCHES["flash_attention_fwd_lse"]
    out, lse = fa.flash_attention(q, k, v, bias, scale=scale,
                                  lk_true=lk_true, return_lse=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd_lse"] == before + 1
    ref, ref_lse = fa._flash_attention_plain(q, k, v, bias, scale=scale,
                                             lk_true=lk_true,
                                             return_lse=True)
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    if dtype == torch.bfloat16:
        # as test_flash_kernel_matches_plain
        v_max = v.float().abs().max().item()
        assert err <= ref_max * 2 ** -7 + v_max * 2 ** -8, (err, ref_max)
    else:
        assert err <= 2e-5 * max(ref_max, 1.0), (err, ref_max)
    # the scores are fp32 sums of exact products of the same inputs on
    # both sides: the lse differs by fp32 rounding, ~1e-6 of |lse|
    finite = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    lerr = (lse - ref_lse)[finite].abs().max().item()
    assert lerr <= 1e-5 * max(ref_lse[finite].abs().max().item(), 1.0), lerr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(HMAJOR_CASES))
def test_flash_bwd_kernel_matches_plain(cuda, case, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do, bias, lk_true, scale = hmajor_inputs(case, dtype, cuda, gen)
    kw = dict(scale=scale, lk_true=lk_true)
    o, lse = fa._flash_attention_plain(q, k, v, bias, return_lse=True, **kw)
    with_ds = HMAJOR_CASES[case][6] == "learned"
    key = "flash_attention_bwd" + ("_dbias" if with_ds else "")
    before = fa.LAUNCHES[key]
    got = fa.flash_attention_bwd(q, k, v, bias, o, lse, do,
                                 return_dbias=with_ds, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[key] == before + 1
    want = fa._flash_attention_bwd_plain(q, k, v, bias, o, lse, do,
                                         return_dbias=with_ds, **kw)
    scales = fa._flash_attention_bwd_abs_terms(q, k, v, bias, o, lse, do,
                                               **kw)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        diff = g.float() - w.float()
        err = diff.abs().max().item()
        span = (w.float().abs() + scales[name]).max().item()
        assert bool(torch.isfinite(g.float()).all()), name
        if dtype == torch.bfloat16:
            # as test_bwd_kernel_matches_plain
            assert err <= 1.1 * 2 ** -8 * span, (name, err, span)
            rms = (diff.square().mean() / w.float().square().mean()
                   .clamp_min(1e-30)).sqrt().item()
            assert rms <= 2 ** -6, (name, rms)
        else:
            # fp32 sums of <= 4873 terms in another order
            assert err <= 5e-5 * max(span, 1e-6), (name, err, span)
        if lk_true and name in ("dk", "dv"):
            assert g[:, :, lk_true:].abs().max().item() == 0.0, name
        if lk_true and name == "dbias":
            assert g[..., lk_true:].abs().max().item() == 0.0


def test_flash_grad_on_cuda_goes_through_the_kernels(cuda):
    """The differentiable head-major op launches the lse forward and the
    backward kernels and matches autograd through the plain version; a
    mask bias gets no ds, a learned one its ds summed over the batch;
    without a gradient it launches the forward without the lse alone."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    b, h, l, d = 2, 3, 150, 32
    q, k, v, do = (torch.randn(b, h, l, d, device=cuda, generator=gen)
                   for _ in range(4))
    bias = torch.randn(1, h, l, l, device=cuda, generator=gen)
    grads = []
    for route in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        before = dict(fa.LAUNCHES)
        if route == "kernel":
            out = fa.flash_attention(*leaves, scale=0.3)
        else:
            out = fa._flash_attention_plain(*leaves, scale=0.3)
        grads.append(torch.autograd.grad(out, leaves, do))
        launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
        if route == "kernel":
            assert launched == {k: int(k in ("flash_attention_fwd_lse",
                                             "flash_attention_bwd_dbias"))
                                for k in before}
    for got, want in zip(*grads):
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 5e-5 * max(
            want.abs().max().item(), 1.0)
    mask = torch.zeros(b, 1, l, l, device=cuda)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q.clone().requires_grad_(True), k, v, mask)
    out.backward(do)
    launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    assert launched == {k: int(k in ("flash_attention_fwd_lse",
                                     "flash_attention_bwd"))
                        for k in before}
    before = dict(fa.LAUNCHES)
    with torch.no_grad():
        fa.flash_attention(q.clone().requires_grad_(True), k, v)
    launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    assert launched == {k: int(k == "flash_attention_fwd") for k in before}


VARIANT_CASES = {
    # name: (B, L, H, D, lk_true)
    # the layout probe's shape: EVA01-g's flagship attention, 32 clips x 8
    # frames, 257 tokens padded to 272
    "probe": (256, 272, 16, 88, 257),
    "ragged": (3, 257, 16, 88, 200),
}


def probe_tolerance(ref_max, v_max, dtype):
    """The probe kernels' max abs error against their plain versions. bf16:
    each side rounds every softmax weight to bf16 once (the kernel p before
    the division by l, the plain version p / l), <= 2^-8 of max |v| each,
    and rounds the output once (one ulp, 2^-7 of max |out| between them).
    fp32: another summation order over <= 257 keys."""
    if dtype == torch.bfloat16:
        return ref_max * 2 ** -7 + v_max * 2 ** -7
    return 2e-5 * max(ref_max, 1.0)


def variant_qkv(case, dtype, cuda):
    """The same values as a fused per-head [q|k|v] qkv and section-major;
    q scaled by D^-0.5, as the probe's callers bake the scale into q."""
    b, l, h, d, _ = VARIANT_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(b, l, h, 3, d, device=cuda, generator=gen)
    x[:, :, :, 0] *= d ** -0.5
    x = x.to(dtype)
    return (x.reshape(b, l, h * 3 * d),
            x.transpose(2, 3).reshape(b, l, 3 * h * d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(VARIANT_CASES))
@pytest.mark.parametrize("kernel", ["attention_dma", "attention_sect"])
def test_tmajor_variant_kernel_matches_plain(cuda, kernel, case, dtype):
    from vast_tpu_torch.scripts import bench_tmajor_variants as tv

    b, l, h, d, lk_true = VARIANT_CASES[case]
    fused, sect = variant_qkv(case, dtype, cuda)
    qkv = fused if kernel == "attention_dma" else sect
    before = dict(fa.LAUNCHES)
    out = getattr(tv, kernel)(qkv, heads=h, lk_true=lk_true)
    torch.cuda.synchronize()
    launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    # bf16 takes the kernel's Hopper body (both cases fit the resident
    # strip), fp32 its mma.sync / CUDA-core one
    hopper = {kernel + "_sm90"} if dtype == torch.bfloat16 else set()
    assert launched == {k: int(k == kernel or k in hopper) for k in before}
    assert out.dtype == dtype and tuple(out.shape) == (b, l, h * d)
    plain = getattr(tv, "_" + kernel + "_plain")
    ref = plain(qkv, heads=h, lk_true=lk_true).float()
    diff = out.float() - ref
    err = diff.abs().max().item()
    ref_max = ref.abs().max().item()
    v_max = fused.view(b, l, h, 3, d)[..., 2, :].float().abs().max().item()
    assert err <= probe_tolerance(ref_max, v_max, dtype), (err, ref_max)
    if dtype == torch.bfloat16:
        rms = (diff.square().mean() / ref.square().mean()).sqrt().item()
        assert rms <= 2 ** -6, rms
    # the other layout of the same values, through the other kernel
    other = tv.attention_sect(sect, heads=h, lk_true=lk_true) \
        if kernel == "attention_dma" else \
        tv.attention_dma(fused, heads=h, lk_true=lk_true)
    assert (other.float() - out.float()).abs().max().item() <= 2 * err + 1e-6


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 12), (torch.float32, 6)],
                         ids=["bf16_d12", "fp32_d6"])
def test_dma_kernel_raises_on_rows_the_copy_engine_cannot_read(cuda, dtype,
                                                               d):
    """D x itemsize = 24 bytes, not a multiple of 16: the copy engine
    cannot read the strips, so attention_dma raises and launches nothing
    (it does not fall back to another kernel); attention_sect's kernel
    reads that layout with plain loads."""
    from vast_tpu_torch.scripts import bench_tmajor_variants as tv

    b, l, h = 2, 40, 3
    gen = torch.Generator(device=cuda).manual_seed(8)
    qkv = torch.randn(b, l, h * 3 * d, device=cuda, generator=gen).to(dtype)
    before = dict(fa.LAUNCHES)
    with pytest.raises(RuntimeError, match="copy engine"):
        tv.attention_dma(qkv, heads=h)
    assert fa.LAUNCHES == before
    # D x itemsize a multiple of 16, the base 2 elements past a 16-byte
    # boundary: refused too
    with pytest.raises(RuntimeError, match="copy engine"):
        tv.attention_dma(torch.zeros(b * l * h * 3 * 16 + 2, device=cuda,
                                     dtype=dtype)[2:].view(b, l, h * 3 * 16),
                         heads=h)
    assert fa.LAUNCHES == before
    out = tv.attention_sect(qkv, heads=h)
    torch.cuda.synchronize()
    ref = tv._attention_sect_plain(qkv, heads=h).float()
    v_max = qkv.view(b, l, 3, h, d)[:, :, 2].float().abs().max().item()
    assert (out.float() - ref).abs().max().item() <= probe_tolerance(
        ref.abs().max().item(), v_max, dtype)


PROBE_SM90_CASES = {
    # name: (B, L, H, D, lk_true); bf16, every one on the Hopper bodies
    "probe": (256, 272, 16, 88, 257),
    "ragged": (3, 257, 16, 88, 200),
    "one_head": (4, 272, 1, 88, 257),
    "d64": (4, 272, 16, 64, 257),
    # the last query tile's rows 1, 15, 16 (the key tiles split between
    # the warpgroups), 17 and 63, each with as many keys (a last key tile
    # of as many: wgmma N 16, 16, 16, 64, 64)
    "last_rows_1": (3, 257, 4, 88, 0),
    "last_rows_15": (3, 271, 4, 88, 0),
    "last_rows_16": (3, 272, 4, 88, 0),
    "last_rows_17": (3, 273, 4, 88, 0),
    "last_rows_63": (3, 319, 4, 88, 0),
    # kend below L; three query tiles, two rows in the last, split over
    # two key tiles; kend at the resident room (320 keys at D above 64,
    # 768 at D 64, six key tiles)
    "kend_below_l": (3, 300, 4, 88, 130),
    "split_two_key_tiles": (2, 130, 3, 128, 0),
    "room_d88": (2, 320, 4, 88, 0),
    "room_d64": (2, 768, 2, 64, 0),
}


def probe_qkv(b, l, h, d, dtype, cuda, seed=7):
    """Random values as a fused per-head [q|k|v] qkv (B, L, H*3*D) and
    section-major; q scaled by D^-0.5, as the probe's callers bake the
    scale into q."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, l, h, 3, d, device=cuda, generator=gen)
    x[:, :, :, 0] *= d ** -0.5
    x = x.to(dtype)
    return (x.reshape(b, l, h * 3 * d),
            x.transpose(2, 3).reshape(b, l, 3 * h * d))


@pytest.mark.parametrize("case", list(PROBE_SM90_CASES))
@pytest.mark.parametrize("kernel", ["attention_dma", "attention_sect"])
def test_probe_hopper_body_matches_plain(cuda, kernel, case):
    """bf16 attention_dma on the resident strip and attention_sect on the
    shared Hopper forward body (one launch of each wrapper counted in its
    ``_sm90`` key too), each against its plain version and its first two
    rows against cur's (the token-major op on the fused layout), at the
    probe's shapes, the edges of the query and key tiles and the
    resident room."""
    from vast_tpu_torch.scripts import bench_tmajor_variants as tv

    b, l, h, d, lk_true = PROBE_SM90_CASES[case]
    fused, sect = probe_qkv(b, l, h, d, torch.bfloat16, cuda)
    qkv = fused if kernel == "attention_dma" else sect
    before = dict(fa.LAUNCHES)
    out = getattr(tv, kernel)(qkv, heads=h, lk_true=lk_true)
    torch.cuda.synchronize()
    launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    assert launched == {k: int(k in (kernel, kernel + "_sm90"))
                        for k in before}
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (b, l, h * d)
    ref = getattr(tv, "_" + kernel + "_plain")(qkv, heads=h,
                                               lk_true=lk_true).float()
    diff = out.float() - ref
    err = diff.abs().max().item()
    ref_max = ref.abs().max().item()
    v_max = fused.view(b, l, h, 3, d)[..., 2, :].float().abs().max().item()
    assert err <= probe_tolerance(ref_max, v_max, torch.bfloat16), (
        err, ref_max)
    rms = (diff.square().mean() / ref.square().mean()).sqrt().item()
    assert rms <= 2 ** -6, rms
    cur = fa.self_attention_tmajor(fused[:2], heads=h, lk_true=lk_true)
    assert (out[:2].float() - cur.float()).abs().max().item() <= \
        tv.CROSS_ATOL


@pytest.mark.parametrize("shape", [(2, 640, 2, 88, 600), (1, 800, 2, 64, 780)],
                         ids=["d88_kend_600", "d64_kend_780"])
def test_dma_above_the_resident_room_takes_the_mma_body(cuda, shape):
    """A kend whose keys do not fit in shared memory (above 320 at D 88,
    768 at D 64) takes attention_fwd_tma_kernel: one attention_dma launch,
    none of the resident strip, against the plain version."""
    from vast_tpu_torch.scripts import bench_tmajor_variants as tv

    b, l, h, d, lk_true = shape
    fused, _ = probe_qkv(b, l, h, d, torch.bfloat16, cuda)
    assert tv.dma_entry(fused, h, lk_true) == tv.DMA_MMA
    before = dict(fa.LAUNCHES)
    out = tv.attention_dma(fused, heads=h, lk_true=lk_true)
    torch.cuda.synchronize()
    launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
    assert launched == {k: int(k == "attention_dma") for k in before}
    ref = tv._attention_dma_plain(fused, heads=h, lk_true=lk_true).float()
    v_max = fused.view(b, l, h, 3, d)[..., 2, :].float().abs().max().item()
    assert (out.float() - ref).abs().max().item() <= probe_tolerance(
        ref.abs().max().item(), v_max, torch.bfloat16)


def test_probe_hopper_entries_refuse(cuda):
    """The two Hopper entries refuse what their bodies do not take: the
    probe's launch raises and no wrapper counts a launch (fp32, D 12, a
    base 2 elements off a 16-byte boundary; for the resident strip a kend
    above its room)."""
    from vast_tpu_torch.scripts import bench_tmajor_variants as tv

    b, l, h = 2, 40, 3
    fp32, _ = probe_qkv(b, l, h, 16, torch.float32, cuda)
    d12, _ = probe_qkv(b, l, h, 12, torch.bfloat16, cuda)
    off = torch.zeros(b * l * h * 3 * 16 + 2, device=cuda,
                      dtype=torch.bfloat16)[2:].view(b, l, h * 3 * 16)
    before = dict(fa.LAUNCHES)
    for symbol in (tv.DMA_SM90, tv.SECT_SM90):
        for qkv, heads in ((fp32, h), (d12, h), (off, h)):
            with pytest.raises(RuntimeError, match="CUDA error"):
                tv._launch(symbol, qkv, heads, 0)
    long_keys, _ = probe_qkv(1, 640, 1, 88, torch.bfloat16, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tv._launch(tv.DMA_SM90, long_keys, 1, 600)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before


SM90_CASES = {
    # name: (B, H, Lq, Lk, D, lk_true, bias kind, layout, lse)
    "d16_lq1_lk1": (1, 2, 1, 1, 16, 0, None, "contiguous", False),
    "d64_lq65_lk130_lse": (2, 3, 65, 130, 64, 0, None, "token_major", True),
    "clip_packed_577": (2, 16, 577, 577, 64, 0, None, "packed", False),
    "clip_packed_577_lse": (2, 16, 577, 577, 64, 0, None, "packed", True),
    "d88_lk_true": (2, 3, 65, 130, 88, 100, None, "token_major", True),
    "d128_4873_keys": (1, 2, 577, 4873, 128, 0, None, "contiguous", True),
    "rerank_4873_lk_true": (1, 4, 65, 4873, 64, 4800, None, "token_major",
                            False),
    # an fp32 mask over heads (head stride 0) and a bf16 bias over the
    # batch (batch stride 0), each with a row of no finite score
    "f32_bias_heads_broadcast": (2, 4, 65, 130, 64, 0, "f32_heads",
                                 "token_major", True),
    "bf16_bias_batch_broadcast": (2, 3, 577, 130, 16, 0, "bf16_batch",
                                  "contiguous", True),
    "eva02_l_257": (2, 16, 257, 257, 64, 0, None, "token_major", False),
    "eva02_l_257_lse": (2, 16, 257, 257, 64, 0, None, "token_major", True),
    "eva02_b_197_lse": (2, 12, 197, 197, 64, 0, None, "token_major", True),
}


@pytest.mark.parametrize("case", list(SM90_CASES))
def test_hopper_forward_matches_plain(cuda, case):
    """bf16 head-major forwards the copy engine can read take the Hopper
    body (one flash_attention_fwd_sm90 launch) and match the plain
    version: the output within one bf16 ulp of max |out| plus 2^-8 x max
    |v| (the kernel rounds p), rms 2^-6; the lse within fp32 rounding; a
    row with no finite score gives zeros and lse +inf."""
    b, h, lq, lk, d, lk_true, kind, layout, lse = SM90_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(9)

    def randn(*shape):
        return torch.randn(*shape, device=cuda, generator=gen).to(
            torch.bfloat16)

    if layout == "packed":
        q, k, v = (t.transpose(1, 2) for t in randn(b, lq, 3, h, d).unbind(2))
    elif layout == "token_major":
        q, k, v = (randn(b, n, h, d).transpose(1, 2) for n in (lq, lk, lk))
    else:
        q, k, v = (randn(b, h, n, d) for n in (lq, lk, lk))
    bias = None
    if kind:
        shape = (b, 1) if kind == "f32_heads" else (1, h)
        bias = torch.randn(*shape, lq, lk, device=cuda, generator=gen)
        bias[0, 0, min(3, lq - 1)] = float("-inf")
        if kind == "bf16_batch":
            bias = bias.to(torch.bfloat16)
    assert fa._sm90_ok(d, q, k, v)
    key = "flash_attention_fwd_lse" if lse else "flash_attention_fwd"
    before = dict(fa.LAUNCHES)
    res = fa.flash_attention(q, k, v, bias, scale=d ** -0.5, lk_true=lk_true,
                             return_lse=lse)
    torch.cuda.synchronize()
    launched = {n: fa.LAUNCHES[n] - before[n] for n in before}
    assert launched == {n: int(n in (key, "flash_attention_fwd_sm90"))
                        for n in before}
    ref = fa._flash_attention_plain(q, k, v, bias, scale=d ** -0.5,
                                    lk_true=lk_true, return_lse=lse)
    out, ref = (res[0], ref[0]) if lse else (res, ref)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (b, h, lq, d)
    ref = ref.float()
    diff = out.float() - ref
    err = diff.abs().max().item()
    ref_max = ref.abs().max().item()
    v_max = v.float().abs().max().item()
    assert err <= ref_max * 2 ** -7 + v_max * 2 ** -8, (err, ref_max)
    rms = (diff.square().mean() / ref.square().mean()).sqrt().item()
    assert rms <= 2 ** -6, rms
    if kind:
        assert out[0, 0, min(3, lq - 1)].abs().max().item() == 0.0
    if lse:
        got, want = res[1], fa._flash_attention_plain(
            q, k, v, bias, scale=d ** -0.5, lk_true=lk_true,
            return_lse=True)[1]
        finite = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), finite)
        assert torch.equal(got[~finite], want[~finite])      # +inf
        lerr = (got - want)[finite].abs().max().item()
        assert lerr <= 1e-5 * max(want[finite].abs().max().item(), 1.0), lerr


@pytest.mark.parametrize("layout", ["base_offset", "d33", "fp32"])
def test_hopper_entry_refuses_what_the_copy_engine_cannot_read(cuda, layout):
    """Called directly, the Hopper entry refuses operands the copy engine
    cannot read (a q one element past a 16-byte boundary, D 33, fp32)
    with cudaErrorInvalidValue (1) and launches nothing: its output keeps
    its fill. The op sends them to the mma.sync / CUDA-core bodies, which
    match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    b, h, lq, lk = 2, 3, 65, 130
    d = 33 if layout == "d33" else 64
    dtype = torch.float32 if layout == "fp32" else torch.bfloat16
    k, v = (torch.randn(b, h, lk, d, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    q = torch.randn(b * h * lq * d + 1, device=cuda, generator=gen).to(dtype)
    q = q[1:] if layout == "base_offset" else q[:-1]
    q = q.view(b, h, lq, d)
    assert not fa._sm90_ok(d, q, k, v)
    out = torch.full((b, h, lq, d), float("nan"), device=cuda, dtype=dtype)
    err = fa._kernel("vast_flash_attention_fwd_sm90")(
        *fa._flash_fwd_args(q, k, v, None, out, None, d ** -0.5, 0))
    torch.cuda.synchronize()
    assert err == 1
    assert bool(out.isnan().all())
    with pytest.raises(RuntimeError, match="vast_flash_attention_fwd_sm90"):
        fa._flash_fwd_launch("vast_flash_attention_fwd_sm90", q, k, v, None,
                             d ** -0.5, 0, False)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, scale=d ** -0.5)
    torch.cuda.synchronize()
    launched = {n: fa.LAUNCHES[n] - before[n] for n in before}
    assert launched == {n: int(n == "flash_attention_fwd") for n in before}
    ref = fa._flash_attention_plain(q, k, v, scale=d ** -0.5).float()
    err = (got.float() - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    if dtype == torch.bfloat16:
        assert err <= ref_max * 2 ** -7 + v.float().abs().max().item() \
            * 2 ** -8, (err, ref_max)
    else:
        assert err <= 2e-5 * max(ref_max, 1.0), (err, ref_max)


BWD_SM90_CASES = {
    # name: (B, H, Lq, Lk, D, lk_true, bias kind, layout); "tmajor" is the
    # fused token-major qkv (Lq == Lk) through self_attention_tmajor_bwd,
    # the others head-major views through flash_attention_bwd
    "tmajor_l1_d8": (1, 2, 1, 1, 8, 0, None, "tmajor"),
    "tmajor_l65_d64": (2, 3, 65, 65, 64, 0, None, "tmajor"),
    "tmajor_l129_d88_lk_true": (2, 3, 129, 129, 88, 100, None, "tmajor"),
    "eva01g_l257_d88": (2, 16, 257, 257, 88, 0, None, "tmajor"),
    "beats_bias_ds": (2, 12, 256, 256, 64, 0, "bf16_per_sample", "tmajor"),
    "shared_bias_ds_d128_lk_true": (3, 2, 129, 129, 128, 70, "bf16_shared",
                                    "tmajor"),
    "clip_packed_577": (2, 16, 577, 577, 64, 0, None, "packed"),
    "ast_token_major_257": (2, 12, 257, 257, 64, 0, None, "token_major"),
    "lq65_lk257_d128": (2, 3, 65, 257, 128, 0, None, "contiguous"),
    "long_keys_4873_lk_true": (1, 2, 129, 4873, 64, 4800, None,
                               "token_major"),
    "mask_bias_lq65_lk129": (2, 4, 65, 129, 64, 0, "f32_mask",
                             "token_major"),
    "learned_bias_ds_d88_lk_true": (2, 3, 129, 257, 88, 200, "f32_learned",
                                    "contiguous"),
    "bige_l257_d112": (2, 16, 257, 257, 112, 0, None, "tmajor"),
    "eva02_l_257": (2, 16, 257, 257, 64, 0, None, "token_major"),
    "eva02_b_197": (2, 12, 197, 197, 64, 0, None, "token_major"),
    "videoswin_window_ds_d32": (2, 4, 392, 392, 32, 0, "f32_learned",
                                "packed"),
}


def bwd_sm90_case(case, cuda, gen):
    """The call of a BWD_SM90_CASES case through its public wrapper (a
    function of no argument returning {dq, dk, dv[, dbias]}), the same
    from its plain version, the sum of |terms| of each output, the counter
    keys it must bump and the (b, h, row) of its row of no finite score
    (head-major cases with a bias; None for the others)."""
    b, h, lq, lk, d, lk_true, kind, layout = BWD_SM90_CASES[case]
    scale = d ** -0.5

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=cuda, generator=gen).to(dtype)

    if layout == "tmajor":
        # no row without a key here: the token-major plain versions
        # (torch.softmax) give NaN for one, and no token-major path has one
        qkv = randn(b, lq, h * 3 * d)
        bias = None
        if kind:
            bias = randn(b if kind == "bf16_per_sample" else 1, h, lq, lk)
        kw = dict(heads=h, lk_true=lk_true, scale=scale)
        o = fa._self_attention_tmajor_plain(qkv, bias, **kw)
        do = randn(b, lq, h * d)

        def grads(res):
            out = split_dqkv(res if bias is None else res[0], h)
            if bias is not None:
                out["dbias"] = res[1].float()
            return out

        scales = fa._self_attention_tmajor_bwd_abs_terms(qkv, o, do, bias,
                                                         **kw)
        if bias is not None and bias.shape[0] == 1:
            scales["dbias"] = scales["dbias"].sum(0, keepdim=True)
        key = "tmajor_attention_bwd" + ("" if bias is None else "_bias")
        return (lambda: grads(fa.self_attention_tmajor_bwd(qkv, o, do, bias,
                                                           **kw)),
                lambda: grads(fa._self_attention_tmajor_bwd_plain(
                    qkv, o, do, bias, **kw)),
                scales, (key, "tmajor_attention_bwd_sm90"), None)
    if layout == "packed":
        q, k, v = (t.transpose(1, 2) for t in randn(b, lq, 3, h, d).unbind(2))
    elif layout == "token_major":
        q, k, v = (randn(b, n, h, d).transpose(1, 2) for n in (lq, lk, lk))
    else:
        q, k, v = (randn(b, h, n, d) for n in (lq, lk, lk))
    do = randn(b, lq, h, d).transpose(1, 2)
    bias = None
    dead = None if kind is None else (0, 0, 3)  # a row with no key at all
    if kind == "f32_mask":
        keep = torch.rand(b, 1, lq, lk, device=cuda, generator=gen) > 0.3
        keep[..., 0] = True
        bias = torch.where(keep, 0.0, -1e30)
        bias[dead[0], 0, dead[2]] = float("-inf")
    elif kind == "f32_learned":
        bias = randn(b, h, lq, lk, dtype=torch.float32)
        bias[dead] = float("-inf")
    with_ds = kind == "f32_learned"
    kw = dict(scale=scale, lk_true=lk_true)
    o, lse = fa._flash_attention_plain(q, k, v, bias, return_lse=True, **kw)
    names = ("dq", "dk", "dv", "dbias")

    def run():
        return {n: g.float() for n, g in zip(names, fa.flash_attention_bwd(
            q, k, v, bias, o, lse, do, return_dbias=with_ds, **kw))}

    def plain():
        return {n: g.float() for n, g in zip(
            names, fa._flash_attention_bwd_plain(
                q, k, v, bias, o, lse, do, return_dbias=with_ds, **kw))}

    scales = fa._flash_attention_bwd_abs_terms(q, k, v, bias, o, lse, do,
                                               **kw)
    key = "flash_attention_bwd" + ("_dbias" if with_ds else "")
    return run, plain, scales, (key, "flash_attention_bwd_sm90"), dead


@pytest.mark.parametrize("case", list(BWD_SM90_CASES))
def test_hopper_backward_matches_plain(cuda, case):
    """bf16 backwards whose operands the copy engine can read take the
    Hopper body (each call one launch of the op's counter and of its
    _sm90 counter), match the plain version within the derived bf16
    limits for dq, dk, dv and dbias separately, repeat bitwise (no
    atomics), give zero gradients to keys past lk_true, and give a row of
    no finite score (the head-major cases with a bias) zeros and no
    NaN."""
    lk_true = BWD_SM90_CASES[case][5]
    gen = torch.Generator(device=cuda).manual_seed(11)
    run, plain, scales, keys, dead = bwd_sm90_case(case, cuda, gen)
    before = dict(fa.LAUNCHES)
    got = run()
    torch.cuda.synchronize()
    launched = {n: fa.LAUNCHES[n] - before[n] for n in before}
    assert launched == {n: int(n in keys) for n in before}
    again = run()
    torch.cuda.synchronize()
    for name, g in got.items():
        assert torch.equal(g, again[name]), name
    want = plain()
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        diff = g - w
        err = diff.abs().max().item()
        span = (w.abs() + scales[name]).max().item()
        # as test_bwd_kernel_matches_plain: p or ds rounded to bf16 before
        # the last product and the output rounded once
        assert err <= 1.1 * 2 ** -8 * span, (name, err, span)
        rms = (diff.square().mean()
               / w.square().mean().clamp_min(1e-30)).sqrt().item()
        assert rms <= 2 ** -6, (name, rms)
        if lk_true and name in ("dk", "dv"):
            assert g[:, :, lk_true:].abs().max().item() == 0.0, name
        if lk_true and name == "dbias":
            assert g[..., lk_true:].abs().max().item() == 0.0
    if dead is not None:
        b, h, row = dead
        assert got["dq"][b, h, row].abs().max().item() == 0.0
        if "dbias" in got:
            assert got["dbias"][b, h, row].abs().max().item() == 0.0


@pytest.mark.parametrize("layout", ["base_offset", "d36", "fp32"])
def test_hopper_backward_entry_refuses_what_the_copy_engine_cannot_read(
        cuda, layout):
    """Called directly, the Hopper backward entry refuses operands the copy
    engine cannot read (a q one element past a 16-byte boundary, D 36,
    fp32) with cudaErrorInvalidValue (1) and launches nothing: its outputs
    keep their fill, and its launch helper raises naming it. The wrapper
    sends them to the mma.sync / CUDA-core bodies (no _sm90 count)."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    b, h, lq, lk = 2, 3, 65, 130
    d = 36 if layout == "d36" else 64
    dtype = torch.float32 if layout == "fp32" else torch.bfloat16
    k, v = (torch.randn(b, h, lk, d, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    q = torch.randn(b * h * lq * d + 1, device=cuda, generator=gen).to(dtype)
    q = (q[1:] if layout == "base_offset" else q[:-1]).view(b, h, lq, d)
    o, lse = fa._flash_attention_plain(q, k, v, scale=d ** -0.5,
                                       return_lse=True)
    do = torch.randn(b, h, lq, d, device=cuda, generator=gen).to(dtype)
    assert not fa._sm90_ok(d, q, k, v, o, do)
    outs = [torch.full(t.shape, float("nan"), device=cuda, dtype=dtype)
            for t in (q, k, v)]
    delta = torch.empty_like(lse)
    err = fa._kernel("vast_flash_attention_bwd_sm90")(
        *(fa._ptr(t) for t in (q, k, v, o, do, None, *outs, None, lse,
                               delta)),
        fa._DTYPE_CODES[dtype], b, h, lq, lk, d, lk,
        fa._strides(q, k, v, o, do, *outs, None, None), d ** -0.5,
        fa._stream())
    torch.cuda.synchronize()
    assert err == 1
    assert all(bool(t.isnan().all()) for t in outs)
    with pytest.raises(RuntimeError, match="vast_flash_attention_bwd_sm90"):
        fa._flash_bwd_launch("vast_flash_attention_bwd_sm90", q, k, v, None,
                             o, lse, do, d ** -0.5, 0, False)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_bwd(q, k, v, None, o, lse, do, scale=d ** -0.5)
    torch.cuda.synchronize()
    launched = {n: fa.LAUNCHES[n] - before[n] for n in before}
    assert launched == {n: int(n == "flash_attention_bwd") for n in before}
    want = fa._flash_attention_bwd_plain(q, k, v, None, o, lse, do,
                                         scale=d ** -0.5)
    scales = fa._flash_attention_bwd_abs_terms(q, k, v, None, o, lse, do,
                                               scale=d ** -0.5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w.float()).abs().max().item()
        span = (w.float().abs() + scales[name]).max().item()
        # as test_flash_bwd_kernel_matches_plain
        tol = 1.1 * 2 ** -8 * span if dtype == torch.bfloat16 else 5e-5 * span
        assert err <= tol, (name, err, span)


@pytest.mark.parametrize("task", ["cap%tvas", "qa%tvas"])
def test_tiny_cap_qa_train_step_matches_the_cpu(cuda, task, monkeypatch):
    """chip_smoke.py's tiny_cap_qa step: the tiny model's captioning or QA
    loss (injected masks), every gradient and the parameters after one
    'attn' train step, the GPU against the CPU, with its launches."""
    import numpy as np

    import chip_smoke as cs

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    row = cs.tiny_cap_qa_step(torch, np, task)
    assert row["launches"] == {k: cs.TINY_STEP_LAUNCHES.get(k, 0)
                               for k in fa.LAUNCHES}
    assert row["grad_max_rel_err"] <= row["grad_tolerance_rel"]


def test_tiny_beam_decode_matches_the_cpu(cuda, monkeypatch):
    """chip_smoke.py's tiny_cap_qa decode: prefill and decode-window
    logits, greedy and beam-3 tokens for captions and padded QA prompts,
    the GPU against the CPU; rows and beams that differ."""
    import numpy as np

    import chip_smoke as cs

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    out = cs.tiny_cap_qa_decode(torch, np)
    assert max(out["logits_rel_err"].values()) <= out["tolerance_rel"]
    tokens = out["tokens"]
    assert len({tuple(r) for r in tokens["greedy"]}) > 1
    assert tokens["beam3_lp0.6"] != tokens["greedy"]


# Video Swin-B's window attention at the four stages of its 16 x 56 x 56
# token grid ((8, 7, 7) windows of 392 tokens at D 32; 128, 32, 8 and 2
# windows a clip, 4 to 32 heads), with fewer clips than a batch's 8:
# name: (grid, heads, clips, shifted)
WINDOW_CASES = {
    "stage0_shifted": ((16, 56, 56), 4, 1, True),
    "stage0": ((16, 56, 56), 4, 1, False),
    "stage1_shifted": ((16, 28, 28), 8, 2, True),
    "stage1": ((16, 28, 28), 8, 2, False),
    "stage2_shifted": ((16, 14, 14), 16, 2, True),
    "stage2": ((16, 14, 14), 16, 2, False),
    "stage3_shifted": ((16, 7, 7), 32, 2, True),
    "stage3": ((16, 7, 7), 32, 2, False),
}


def window_case(case, cuda, seed=13):
    """q, k, v (packed views), the fp32 table, the labels (or None), the
    upstream gradient and the plain version's table-plus-mask sum, output
    and lse of a WINDOW_CASES case."""
    from vast_tpu_torch.models import videoswin
    from vast_tpu_torch.ops import window_attention as wa

    grid, h, clips, shifted = WINDOW_CASES[case]
    win = tuple(min(a, b) for a, b in zip((8, 7, 7), grid))
    shift = tuple(0 if w >= g else w // 2 for w, g in zip(win, grid))
    n_win = (grid[0] // win[0]) * (grid[1] // win[1]) * (grid[2] // win[2])
    n, d, w = 392, 32, clips * n_win
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (t.transpose(1, 2) for t in torch.randn(
        w, n, 3, h, d, device=cuda, generator=gen).to(
            torch.bfloat16).unbind(2))
    table = torch.randn(h, n, n, device=cuda, generator=gen)
    labels = None
    if shifted:
        labels = wa.region_labels(torch.from_numpy(videoswin.shift_mask_3d(
            *grid, win, shift))).to(cuda)
    do = torch.randn(w, n, h, d, device=cuda, generator=gen).to(
        torch.bfloat16).transpose(1, 2)
    full = wa._window_bias_plain(table, labels, w)
    o, lse = fa._flash_attention_plain(q, k, v, full, scale=d ** -0.5,
                                       return_lse=True)
    return q, k, v, table, labels, do, full, o, lse


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_forward_matches_plain(cuda, case):
    """The window forward kernel (the op on bf16 CUDA operands: one
    flash_attention_fwd_lse and one window_attention_fwd launch) against
    the plain version on the table-plus-mask sum: the output within the
    Hopper forward's bf16 rule, the lse within fp32 rounding; without a
    gradient, no lse and a flash_attention_fwd launch."""
    from vast_tpu_torch.ops import window_attention as wa

    q, k, v, table, labels, _, _, ref, ref_lse = window_case(case, cuda)
    d = q.shape[-1]
    for need_lse in (True, False):
        key = "flash_attention_fwd_lse" if need_lse else "flash_attention_fwd"
        before = dict(fa.LAUNCHES)
        out, lse = wa.WINDOW_OP(q, k, v, table, labels, d ** -0.5, need_lse)
        torch.cuda.synchronize()
        launched = {n: fa.LAUNCHES[n] - before[n] for n in before}
        assert launched == {n: int(n in (key, "window_attention_fwd"))
                            for n in before}
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        diff = out.float() - ref.float()
        err = diff.abs().max().item()
        ref_max = ref.float().abs().max().item()
        v_max = v.float().abs().max().item()
        assert err <= ref_max * 2 ** -7 + v_max * 2 ** -8, (err, ref_max)
        rms = (diff.square().mean() / ref.float().square().mean()).sqrt()
        assert rms.item() <= 2 ** -6, rms.item()
        if need_lse:
            lerr = (lse - ref_lse).abs().max().item()
            assert lerr <= 1e-5 * max(ref_lse.abs().max().item(), 1.0), lerr
        else:
            assert lse.numel() == 0


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_backward_matches_plain(cuda, case):
    """The window backward kernels (one flash_attention_bwd_dbias and one
    window_attention_bwd launch a call) against the plain version: dq, dk
    and dv within the Hopper backward's bf16 rule; the table's gradient,
    the windows' fp32 ds summed in another order than the plain sum's
    (chunks of windows, then the chunks), within 2^-16 of its sum of
    |terms|; every output repeats bit for bit (no atomics)."""
    from vast_tpu_torch.ops import window_attention as wa

    q, k, v, table, labels, do, full, o, lse = window_case(case, cuda)
    scale = q.shape[-1] ** -0.5
    before = dict(fa.LAUNCHES)
    got = wa.window_attention_bwd(q, k, v, table, labels, o, lse, do,
                                  scale=scale)
    torch.cuda.synchronize()
    launched = {n: fa.LAUNCHES[n] - before[n] for n in before}
    assert launched == {n: int(n in ("flash_attention_bwd_dbias",
                                     "window_attention_bwd"))
                        for n in before}
    again = wa.window_attention_bwd(q, k, v, table, labels, o, lse, do,
                                    scale=scale)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    want = fa._flash_attention_bwd_plain(q, k, v, full, o, lse, do,
                                         scale=scale, return_dbias=True)
    want = (*want[:3], want[3].sum(dim=0))
    terms = fa._flash_attention_bwd_abs_terms(q, k, v, full, o, lse, do,
                                              scale=scale)
    terms["dbias"] = terms["dbias"].sum(dim=0)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        g, w = g.float(), w.float()
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        diff = g - w
        err = diff.abs().max().item()
        span = (w.abs() + terms[name]).max().item()
        if name == "dbias":
            assert err <= 2 ** -16 * span, (name, err, span)
            continue
        assert err <= 1.1 * 2 ** -8 * span, (name, err, span)
        rms = (diff.square().mean()
               / w.square().mean().clamp_min(1e-30)).sqrt().item()
        assert rms <= 2 ** -6, (name, rms)


def test_window_attention_grad_allocates_no_window_sized_tensor(cuda):
    """Through the public function at the first stage's shape (one clip,
    shifted), a forward and backward recorded by autograd launch the
    window kernels once each and allocate less than one fp32 (W, H, n, n)
    tensor beyond their inputs; the table gets its gradient."""
    from vast_tpu_torch.ops import window_attention as wa

    q, k, v, table, labels, do, _, _, _ = window_case("stage0_shifted",
                                                      cuda)
    w, h, n, d = q.shape
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    table = table.detach().requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(fa.LAUNCHES)
    out = wa.window_attention(q, k, v, table, labels, scale=d ** -0.5)
    out.backward(do)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert fa.LAUNCHES["window_attention_fwd"] == \
        before["window_attention_fwd"] + 1
    assert fa.LAUNCHES["window_attention_bwd"] == \
        before["window_attention_bwd"] + 1
    assert peak < w * h * n * n * 4, (peak, w * h * n * n * 4)
    assert table.grad is not None and bool(torch.isfinite(table.grad).all())


def test_window_entries_refuse_what_the_kernels_do_not_take(cuda):
    """Called on fp32 operands or at D 72 (above one 64-column box), the
    window forward entry refuses with cudaErrorInvalidValue and launches
    nothing. The public function sends fp32 to the general op, raises at
    D 72 in bf16 before any launch, and launches the window kernels on
    copies of bf16 views the copy engine cannot read (a base 2 bytes off
    16), with the packed views' output bit for bit."""
    from vast_tpu_torch.ops import window_attention as wa

    q, k, v, table, labels, _, _, _, _ = window_case("stage3_shifted", cuda)
    f32 = (q.float(), k.float(), v.float())
    d72 = tuple(torch.cat([t, t, t[..., :8]], -1) for t in (q, k, v))
    for qq, kk, vv in (f32, d72):
        before = dict(fa.LAUNCHES)
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            wa._window_fwd_launch(qq, kk, vv, table, labels, 0.2, True)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == before
    before = dict(fa.LAUNCHES)
    wa.window_attention(*f32, table, labels, scale=0.2)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["window_attention_fwd"] == \
        before["window_attention_fwd"]
    assert fa.LAUNCHES["flash_attention_fwd"] == \
        before["flash_attention_fwd"] + 1
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="window kernels take"):
        wa.window_attention(*d72, table, labels, scale=0.2)
    assert fa.LAUNCHES == before
    packed = wa.window_attention(q, k, v, table, labels, scale=0.2)
    off = []
    for t in (q, k, v):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        off.append(flat[1:].view(t.shape).copy_(t))
    assert not fa._sm90_ok(q.shape[-1], off[0])
    before = dict(fa.LAUNCHES)
    copied = wa.window_attention(*off, table, labels, scale=0.2)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["window_attention_fwd"] == \
        before["window_attention_fwd"] + 1
    assert torch.equal(copied, packed)
