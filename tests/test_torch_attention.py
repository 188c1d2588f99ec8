"""The port's attention against vast_tpu's, on the CPU.

``self_attention_tmajor`` and ``flash_attention`` on CPU tensors are the
port's plain versions; they are held against JAX's Pallas kernels run in
interpret mode (as tests/test_ops.py runs them). The CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py and
tests/test_torch_kernels_gpu.py. fp32 throughout: JAX matmuls run at
"highest" precision (tests/conftest.py), so the bounds are fp32 noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vast_tpu.ops.attention import multi_head_attention as j_mha
from vast_tpu.ops.flash_attention import flash_attention as j_flash
from vast_tpu.ops.flash_attention import self_attention_tmajor as j_tmajor
from vast_tpu_torch.ops import attention
from vast_tpu_torch.ops import flash_attention as fa
from vast_tpu_torch.ops.attention import multi_head_attention

TMAJOR_CASES = {
    # EVA01-g head layout (16 x 88) at a padded Lp with lk_true and
    # garbage in the padded tail, unit scale (q pre-scaled)
    "eva_padded_no_bias": dict(b=2, l=32, h=16, d=88, lk_true=27,
                               scale=1.0, bias=None),
    # BEATs head width, per-sample bias after the scale
    "beats_per_sample_bias": dict(b=2, l=128, h=4, d=64, lk_true=0,
                                  scale=64 ** -0.5, bias="per_sample"),
    # one (1, H, L, L) bias shared by the batch (stride-0 read on CUDA)
    "shared_bias": dict(b=2, l=128, h=4, d=64, lk_true=0,
                        scale=64 ** -0.5, bias="shared"),
}


@pytest.mark.parametrize("case", list(TMAJOR_CASES))
def test_self_attention_tmajor_matches_pallas(case):
    c = TMAJOR_CASES[case]
    rs = np.random.RandomState(0)
    b, l, h, d = c["b"], c["l"], c["h"], c["d"]
    qkv = rs.randn(b, l, h * 3 * d).astype(np.float32)
    if c["lk_true"]:
        qkv[:, c["lk_true"]:] = 50.0 * rs.randn(b, l - c["lk_true"],
                                                h * 3 * d)
    bias = None
    if c["bias"] is not None:
        bias = rs.randn(b if c["bias"] == "per_sample" else 1, h, l,
                        l).astype(np.float32)
    before = dict(fa.LAUNCHES)
    got = fa.self_attention_tmajor(
        torch.from_numpy(qkv),
        None if bias is None else torch.from_numpy(bias),
        heads=h, lk_true=c["lk_true"], scale=c["scale"])
    assert fa.LAUNCHES == before        # the CPU path launches no kernel
    # the Pallas kernel indexes its bias by batch row, so JAX gets the
    # shared bias broadcast (as flash_self_attention_tmajor_biased does)
    jbias = None if bias is None else jnp.broadcast_to(
        jnp.asarray(bias), (b, h, l, l))
    want = j_tmajor(jnp.asarray(qkv), jbias, heads=h, lk_true=c["lk_true"],
                    scale=c["scale"], interpret=True)
    assert tuple(got.shape) == (b, l, h * d) and got.dtype == torch.float32
    valid = c["lk_true"] or l
    # fp32 softmax over <= 128 keys and a D-term dot: ~1e-6 relative
    np.testing.assert_allclose(got.numpy()[:, :valid],
                               np.asarray(want)[:, :valid], atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("lq,lk", [(12, 12), (12, 40)],
                         ids=["self", "cross"])
def test_multi_head_attention_plain_route_matches_jax(lq, lk):
    rs = np.random.RandomState(1)
    q = rs.randn(3, lq, 4, 8).astype(np.float32)
    k = rs.randn(3, lk, 4, 8).astype(np.float32)
    v = rs.randn(3, lk, 4, 8).astype(np.float32)
    mask = rs.rand(3, 1, lq, lk) > 0.3
    mask[..., 0] = True                 # every row attends somewhere
    got = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               mask=torch.from_numpy(mask))
    want = j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


FLASH_CASES = {
    # BERT's layout: token-major (B, L, H, D) projections read through a
    # transposed view, no bias
    "token_major_views": dict(bias=None, lk_true=0, views=True),
    # keys past lk_true hold garbage and are masked
    "lk_true_tail": dict(bias=None, lk_true=61, views=False),
    # one bias per (batch, head)
    "per_head_bias": dict(bias=(2, 3), lk_true=0, views=False),
    # one bias plane shared by batch and heads (stride-0 reads on CUDA)
    "shared_bias": dict(bias=(1, 1), lk_true=0, views=True),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_pallas(case):
    c = FLASH_CASES[case]
    rs = np.random.RandomState(2)
    b, h, lq, lk, d = 2, 3, 48, 80, 64
    scale = d ** -0.5
    q, k, v = (rs.randn(b, n, h, d).astype(np.float32)
               for n in (lq, lk, lk))                     # (B, L, H, D)
    if c["lk_true"]:
        k[:, c["lk_true"]:] *= 50.0
        v[:, c["lk_true"]:] *= 50.0
    bias = None
    if c["bias"] is not None:
        bias = rs.randn(*c["bias"], lq, lk).astype(np.float32)

    def hmajor(x):
        t = torch.from_numpy(x).transpose(1, 2)
        return t if c["views"] else t.contiguous()

    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(
        hmajor(q), hmajor(k), hmajor(v),
        None if bias is None else torch.from_numpy(bias),
        scale=scale, lk_true=c["lk_true"])
    assert fa.LAUNCHES == before        # the CPU path launches no kernel
    # the JAX function takes q already scaled
    jq, jk, jv = (jnp.asarray(np.swapaxes(x, 1, 2)) for x in (q, k, v))
    want = j_flash(jq * scale, jk, jv,
                   None if bias is None else jnp.asarray(bias),
                   lk_true=c["lk_true"], interpret=True)
    assert tuple(got.shape) == (b, h, lq, d) and got.dtype == torch.float32
    # fp32 softmax over <= 80 keys and a 64-term dot: ~1e-6 relative
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("lq,lk,plain", [
    (40, 40, True), (40, 2312, True), (7 * 40, 2312, True),
    (8 * 40, 2312, False), (32 * 40, 2312, False)],
    ids=["caption_self", "caption_cross", "rerank_7_texts",
         "rerank_8_texts", "rerank_32_texts"])
def test_routing_rule_at_flagship_bert_shapes(lq, lk, plain):
    """BERT-base (D 64) over the flagship's 8 x 257 + 256 = 2312 condition
    tokens: a caption's attention is plain, and the grouped rerank's query
    of 40 T rows takes the kernel from T = 8 on, where vast_tpu's rule
    (attention.py:234-251) also leaves the plain route."""
    assert attention._plain_route(lq, lk, 64) is plain


def test_multi_head_attention_kernel_route_matches_jax(monkeypatch):
    """A shape off the plain route, with a bool mask: the port goes
    through ``flash_attention`` (its plain version on the CPU), JAX
    through its Pallas kernel in interpret mode."""
    calls = []

    def spy(q, *args, **kwargs):
        calls.append(tuple(q.shape))
        return fa.flash_attention(q, *args, **kwargs)

    monkeypatch.setattr(attention, "flash_attention", spy)
    rs = np.random.RandomState(3)
    q, k, v = (rs.randn(2, 160, 2, 16).astype(np.float32) for _ in range(3))
    mask = rs.rand(2, 1, 160, 160) > 0.3
    mask[..., 0] = True
    got = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               mask=torch.from_numpy(mask))
    assert calls == [(2, 2, 160, 16)]
    want = j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 mask=jnp.asarray(mask), impl="pallas", interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)


def test_flash_wrapper_rejects_what_it_does_not_take():
    x = torch.zeros(2, 3, 8, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(x[0], x, x)                         # not 4-D
    with pytest.raises(ValueError):
        fa.flash_attention(x, torch.zeros(2, 4, 8, 16), x)     # k != v
    with pytest.raises(ValueError):
        fa.flash_attention(x, x[:, :2], x[:, :2])              # heads
    with pytest.raises(ValueError):
        big = torch.zeros(1, 1, 4, 136)
        fa.flash_attention(big, big, big)                      # D > 128
    with pytest.raises(ValueError):
        fa.flash_attention(x, x, x, lk_true=9)
    with pytest.raises(RuntimeError):                          # broadcast
        fa.flash_attention(x, x, x, torch.zeros(2, 2, 8, 8))
    with pytest.raises(TypeError):
        fa.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError):                            # no kernel
        m = x.to("meta")
        fa.flash_attention(m, m, m)


def test_tmajor_wrapper_rejects_what_it_does_not_take():
    x = torch.zeros(2, 8, 4 * 3 * 8)
    with pytest.raises(ValueError):
        fa.self_attention_tmajor(x, heads=5)                  # not H*3*D
    with pytest.raises(ValueError):
        fa.self_attention_tmajor(x, torch.zeros(3, 4, 8, 8), heads=4)
    with pytest.raises(ValueError):
        fa.self_attention_tmajor(torch.zeros(1, 8, 3 * 136), heads=1)
    with pytest.raises(TypeError):
        fa.self_attention_tmajor(x.half(), heads=4)
    with pytest.raises(ValueError):                           # no kernel
        fa.self_attention_tmajor(x.to("meta"), heads=4)


def test_cuda_request_without_gpu_raises():
    """No entry point falls back to the CPU: asking for the GPU (the
    default) where there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only refusal")
    from vast_tpu_torch.device import resolve_device
    from vast_tpu_torch.evaluation.evaluation_mm import evaluate_ret
    from vast_tpu_torch.models.vast import VASTConfig, VASTModel

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        VASTModel(VASTConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_ret(None, ("tva",), [], {})
