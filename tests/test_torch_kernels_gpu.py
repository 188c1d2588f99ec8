"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where there is no CUDA GPU. On a machine with
one, run them without the JAX test settings (tests/conftest.py):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py

The shapes cover the main path's (EVA01-g 257 x 16 x 88, BEATs 256 x 12
x 64 with a per-sample bias, BERT's grouped rerank 320 x 2312 x 12 x 64)
and the edges of the kernel's tiling: L of 1 and of tiles plus one, D
from 1 to 128, lk_true, shared and broadcast biases, strided views, and
rows whose keys are all masked.
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
