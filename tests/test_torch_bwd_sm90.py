"""Which body a backward takes: ``_sm90_ok``, on the CPU.

The Hopper backward (``vast_tmajor_attention_bwd_sm90`` and
``vast_flash_attention_bwd_sm90``: wgmma fed by the copy engine) reads
q, k, v, the forward's output o and its cotangent do through tensor
maps, so it takes bf16 operands with D a multiple of 8 up to 128, every
batch, head and row stride a non-zero multiple of 8 elements and 16-byte
aligned bases; the wrappers decide that from dtype, shapes, strides and
data pointers before they launch anything (``_sm90_ok(d, q, k, v, o,
do)`` head-major, ``_sm90_ok(d, qkv, o, do)`` token-major). Here the operands every path
gives the backward, built as the models build them at the full shapes of
chip_smoke.py's backward rows (on the meta device: strides and offsets
without memory), must take it, and layouts the copy engine cannot read
must not. The kernels themselves run on the card only
(tests/test_torch_kernels_gpu.py).
"""

import pytest
import torch

from vast_tpu_torch.ops.flash_attention import _empty_like_layout, _sm90_ok
from tests.test_torch_hmajor_sm90 import contiguous, packed, token_major

BF16 = torch.bfloat16


def fused(b, l, h, d, device="meta", dtype=BF16):
    """The token-major backward's question: D, a fused per-head [q|k|v]
    (B, L, H*3*D) and the (B, L, H*D) output and cotangent (EVA01-g's and
    BEATs' blocks, the layout probe's cur and pad128 variants)."""
    qkv = torch.empty(b, l, h * 3 * d, device=device, dtype=dtype)
    o, do = (torch.empty(b, l, h * d, device=device, dtype=dtype)
             for _ in range(2))
    return d, qkv, o, do


def tmajor_views(qkv, o, do, h):
    """q, k, v, o and do (B, H, L, D) as the token-major entry reads them:
    head h's [q|k|v] at elements h * 3D + j * D of each row of qkv."""
    b, l, total = qkv.shape
    d = total // (3 * h)
    x = qkv.view(b, l, h, 3, d)
    return tuple(x[:, :, :, j].transpose(1, 2) for j in range(3)) + tuple(
        t.view(b, l, h, d).transpose(1, 2) for t in (o, do))


def with_out(q, k, v, device="meta", dtype=BF16):
    """The head-major backward's question: D, q, k, v with the head-major
    forward's output (laid out as q, ops/flash_attention.py's
    _empty_like_layout) and the cotangent the output projection's autograd
    gives it (token-major)."""
    b, h, lq, d = q.shape
    o = _empty_like_layout(q, dtype=dtype)
    do = torch.empty(b, lq, h, d, device=device, dtype=dtype).transpose(1, 2)
    return d, q, k, v, o, do


TAKEN = {
    # chip_smoke.py's backward rows: EVA01-g (64 frames, D 88) and BEATs
    # (8 clips, D 64, whose bias the predicate does not read), CLIP-L/14-336
    # (64 images, packed), AST (8 clips), the 640 x 4873 shape (16 texts x
    # 40 tokens over 8 x 577 + 257 condition tokens, 4 candidates)
    "eva_fused_d88": lambda: fused(64, 257, 16, 88),
    "beats_fused_d64": lambda: fused(8, 256, 12, 64),
    "clip_packed": lambda: with_out(*packed(64, 577, 16, 64)),
    "ast_token_major": lambda: with_out(*token_major(8, 257, 257, 12, 64)),
    "long_keys_4873": lambda: with_out(*token_major(4, 40, 4873, 12, 64,
                                                    texts=16)),
    # the layout probe's cur (L 272, D 88) and pad128 (D 128) variants
    "probe_cur": lambda: fused(256, 272, 16, 88),
    "probe_pad128": lambda: fused(256, 272, 16, 128),
    # the widths the body is built for: D 8 to 128 in steps of 8
    "contiguous_d8": lambda: with_out(*contiguous(2, 1, 1, 1, 8)),
    "contiguous_d128": lambda: with_out(*contiguous(2, 65, 130, 3, 128)),
}


@pytest.mark.parametrize("case", list(TAKEN))
def test_hopper_backward_takes_the_paths_views(case):
    assert _sm90_ok(*TAKEN[case]())


def offset_by_one(b, l, h, d, which):
    """Contiguous operands whose ``which``-th one starts one element (2
    bytes) past a 16-byte boundary (real CPU tensors: the pointer is what
    counts)."""
    ops = list(with_out(*contiguous(b, l, l, h, d, device="cpu"),
                        device="cpu"))
    ops[1 + which] = torch.zeros(b * h * l * d + 1, dtype=BF16)[1:].view(
        b, h, l, d)
    return tuple(ops)


REFUSED = {
    "fp32": lambda: with_out(*contiguous(2, 65, 130, 3, 64,
                                         dtype=torch.float32),
                             dtype=torch.float32),
    "fp32_fused": lambda: fused(2, 65, 3, 64, dtype=torch.float32),
    "bf16_qkv_fp32_out": lambda: with_out(*contiguous(2, 65, 130, 3, 64),
                                          dtype=torch.float32),
    "d36": lambda: with_out(*contiguous(2, 65, 130, 3, 36)),
    "d36_fused": lambda: fused(2, 65, 3, 36),
    "d136": lambda: with_out(*contiguous(1, 8, 8, 1, 136)),
    # heads 92 apart, 88 wide: not a multiple of 8
    "odd_head_stride": lambda: with_out(*(
        torch.empty(2, 50, 3, 92, device="meta", dtype=BF16)[..., :88]
        .transpose(1, 2) for _ in range(3))),
    # a cotangent whose heads lie 68 elements apart
    "odd_do_stride": lambda: with_out(*contiguous(2, 50, 50, 3, 64))[:5] + (
        torch.empty(2, 50, 3, 68, device="meta", dtype=BF16)[..., :64]
        .transpose(1, 2),),
    # k and v of one batch row shared by all: batch stride 0
    "stride0_expand": lambda: with_out(
        contiguous(4, 65, 130, 3, 64)[0],
        *(t.expand(4, -1, -1, -1) for t in contiguous(1, 65, 130, 3, 64)[1:])),
    "base_offset_q": lambda: offset_by_one(2, 40, 3, 64, 0),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_hopper_backward_refuses_what_the_copy_engine_cannot_read(case):
    assert not _sm90_ok(*REFUSED[case]())


@pytest.mark.parametrize("which", range(5), ids=["q", "k", "v", "o", "do"])
def test_rule_reads_every_backward_operand(which):
    """The rule holds for q, k, v, o and do alike: any one of them off a
    16-byte boundary sends the backward to the other body."""
    assert _sm90_ok(*with_out(*contiguous(2, 40, 40, 3, 64, device="cpu"),
                              device="cpu"))
    assert not _sm90_ok(*offset_by_one(2, 40, 3, 64, which))


def test_tmajor_views_are_the_entrys_operands():
    """The token-major rule, asked of qkv, o and do, is the rule asked of
    the views the entry reads (:func:`tmajor_views`): q, k and v lie D
    apart in qkv's rows and 3D apart a head, so they are read wherever
    qkv is; and the views are the entry's operands."""
    b, l, h, d = 2, 5, 3, 8
    qkv = torch.arange(b * l * h * 3 * d, dtype=torch.float32).view(
        b, l, h * 3 * d)
    o = torch.randn(b, l, h * d)
    do = torch.randn(b, l, h * d)
    q, k, v, o4, do4 = tmajor_views(qkv, o, do, h)
    x = qkv.view(b, l, h, 3, d)
    for j, t in enumerate((q, k, v)):
        assert t.shape == (b, h, l, d)
        assert torch.equal(t, x[:, :, :, j].permute(0, 2, 1, 3))
        assert t.data_ptr() == qkv.data_ptr() + 4 * j * d
    assert torch.equal(o4, o.view(b, l, h, d).transpose(1, 2))
    assert torch.equal(do4, do.view(b, l, h, d).transpose(1, 2))
    for make in (TAKEN["eva_fused_d88"], TAKEN["probe_pad128"],
                 REFUSED["fp32_fused"], REFUSED["d36_fused"],
                 lambda: fused(2, 7, 3, 64, device="cpu")):
        dd, *ops = make()
        assert _sm90_ok(dd, *ops) == _sm90_ok(dd, *tmajor_views(*ops, h=(
            ops[0].shape[-1] // (3 * dd))))
    # a qkv off a 16-byte boundary moves q, k and v with it
    dd, qkv, o, do = fused(2, 7, 3, 64, device="cpu")
    qkv = torch.zeros(qkv.numel() + 1, dtype=BF16)[1:].view(qkv.shape)
    assert not _sm90_ok(dd, qkv, o, do)
    assert not _sm90_ok(dd, *tmajor_views(qkv, o, do, 3))
