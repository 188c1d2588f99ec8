"""Which body a head-major forward takes: ``_sm90_ok``, on the CPU.

The Hopper body (``vast_flash_attention_fwd_sm90``: wgmma fed by the
copy engine) reads q, k and v through tensor maps, so it takes bf16
operands with D a multiple of 8 up to 128, every batch, head and row
stride a non-zero multiple of 8 elements and 16-byte aligned bases; the
op decides that from dtype, shapes, strides and data pointers before it
launches anything. Here the views every path makes, built as the models
build them at the full shapes of chip_smoke.py's head-major rows (on the
meta device: strides and offsets without memory), must take it, and
layouts the copy engine cannot read must not. The kernels themselves run
on the card only (tests/test_torch_kernels_gpu.py).
"""

import pytest
import torch

from vast_tpu_torch.ops.flash_attention import _sm90_ok

BF16 = torch.bfloat16


def _sm90_fwd_ok(q, k, v):
    """The rule as the forward asks it: of q, k and v at q's head width."""
    return _sm90_ok(q.shape[-1], q, k, v)


def packed(b, l, h, d, device="meta", dtype=BF16):
    """CLIP's q, k, v: its in_proj output (B, L, 3*W) viewed as (B, L, 3,
    H, D), unbound and transposed (models/clip_vit.py:93-94)."""
    y = torch.empty(b, l, 3 * h * d, device=device, dtype=dtype)
    return tuple(t.transpose(1, 2) for t in y.view(b, l, 3, h, d).unbind(2))


def token_major(b, lq, lk, h, d, device="meta", dtype=BF16, texts=1):
    """AST's and BERT's q, k, v: each projection (B, L, W) viewed as (B,
    L, H, D) and transposed (models/ast.py:95-96, models/bert.py:124-130,
    ops/attention.py:91); BERT's rerank folds ``texts`` texts of one
    candidate into the query length first (models/bert.py:150-151)."""
    def proj(n, rows):
        return torch.empty(rows, n, h * d, device=device, dtype=dtype).view(
            rows, n, h, d)

    q = proj(lq, b * texts).reshape(b, texts * lq, h, d)
    return tuple(t.transpose(1, 2) for t in (q, proj(lk, b), proj(lk, b)))


def contiguous(b, lq, lk, h, d, device="meta", dtype=BF16):
    return tuple(torch.empty(b, h, n, d, device=device, dtype=dtype)
                 for n in (lq, lk, lk))


TAKEN = {
    # chip_smoke.py's head-major rows: CLIP-L/14-336 (64 images), AST (8
    # clips), the flagship rerank (8 texts x 40 tokens over 8 x 257 + 256
    # condition tokens) and the CLIP + AST rerank (16 texts over 8 x 577 +
    # 257), 4 candidates a call
    "clip_packed": lambda: packed(64, 577, 16, 64),
    "ast_token_major": lambda: token_major(8, 257, 257, 12, 64),
    "flagship_rerank": lambda: token_major(4, 40, 2312, 12, 64, texts=8),
    "clip_ast_rerank": lambda: token_major(4, 40, 4873, 12, 64, texts=16),
    "contiguous_d64": lambda: contiguous(2, 577, 577, 16, 64),
    # the widths the body is built for: D 8 to 128 in steps of 8
    "contiguous_d8": lambda: contiguous(2, 1, 1, 1, 8),
    "token_major_d88": lambda: token_major(2, 65, 130, 3, 88),
    "packed_d128": lambda: packed(2, 100, 2, 128),
}


@pytest.mark.parametrize("case", list(TAKEN))
def test_hopper_body_takes_the_paths_views(case):
    q, k, v = TAKEN[case]()
    assert _sm90_fwd_ok(q, k, v)


def offset_by_one(b, l, h, d):
    """Contiguous q, k, v whose q starts one element (2 bytes) past a
    16-byte boundary (a real CPU tensor: the pointer is what counts)."""
    q = torch.zeros(b * h * l * d + 1, dtype=BF16)[1:].view(b, h, l, d)
    _, k, v = contiguous(b, l, l, h, d, device="cpu")
    return q, k, v


REFUSED = {
    "fp32": lambda: contiguous(2, 65, 130, 3, 64, dtype=torch.float32),
    "bf16_q_fp32_kv": lambda: (contiguous(2, 65, 130, 3, 64)[0],)
    + contiguous(2, 65, 130, 3, 64, dtype=torch.float32)[1:],
    "d33": lambda: contiguous(2, 65, 130, 3, 33),
    "d7": lambda: token_major(2, 65, 130, 3, 7),
    "d136": lambda: contiguous(1, 8, 8, 1, 136),
    # k and v of one batch row shared by all: batch stride 0
    "stride0_expand": lambda: (contiguous(4, 65, 130, 3, 64)[0],)
    + tuple(t.expand(4, -1, -1, -1)
            for t in contiguous(1, 65, 130, 3, 64)[1:]),
    "base_offset_one_element": lambda: offset_by_one(2, 40, 3, 64),
    # heads 92 elements apart, 88 wide: not a multiple of 8
    "odd_head_stride": lambda: tuple(
        torch.empty(2, 50, 3, 92, device="meta", dtype=BF16)[..., :88]
        .transpose(1, 2) for _ in range(3)),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_hopper_body_refuses_what_the_copy_engine_cannot_read(case):
    q, k, v = REFUSED[case]()
    assert not _sm90_fwd_ok(q, k, v)


def test_rule_reads_every_operand():
    """The rule holds for q, k and v alike: a readable q alone is not
    enough, and the offset of a view inside its storage counts."""
    q, k, v = contiguous(2, 65, 130, 3, 64, device="cpu")
    assert _sm90_fwd_ok(q, k, v)
    storage = torch.zeros(k.numel() + 8, dtype=BF16)
    k8 = storage[8:].view(k.shape)             # 16 bytes in: aligned
    k1 = storage[1:k.numel() + 1].view(k.shape)
    assert _sm90_fwd_ok(q, k8, v)
    assert not _sm90_fwd_ok(q, k1, v)
