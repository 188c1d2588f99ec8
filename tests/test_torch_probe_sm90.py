"""Which body the layout probe's two kernels take, on the CPU.

``attention_dma`` (vast_tpu_torch/scripts/bench_tmajor_variants.py) takes
the resident strip (``vast_tmajor_dma_attention_fwd_sm90``: wgmma, each
head's K and V held in shared memory) for bf16 qkv that the copy engine
can read (``_sm90_ok``) whose masked key count ``kend`` leaves a head's K
and V room in shared memory (``_strip_ok``: 320 keys at D above 64, 768
at and below); ``attention_sect`` takes the shared Hopper forward body
(``vast_tmajor_sect_attention_fwd_sm90``) for bf16 qkv the copy engine
can read. The rest keep the mma.sync / CUDA-core entries. Both are
decided from dtype, shape, strides and data pointers before any launch:
here on meta-device tensors at the probe's full shape (strides and
offsets without memory), and on real CPU tensors where the pointer is
what counts. The kernels themselves run on the card only
(tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import pytest
import torch

from vast_tpu_torch.ops import flash_attention as fa
from vast_tpu_torch.scripts import bench_tmajor_variants as tv

BF16 = torch.bfloat16


def fused(b, l, h, d, device="meta", dtype=BF16):
    """A fused per-head [q|k|v] qkv (B, L, H*3*D), as make_inputs lays it
    out (the section-major one has the same shape and strides)."""
    return torch.empty(b, l, h * 3 * d, device=device, dtype=dtype)


TAKEN = {
    # name: (B, L, H, D, lk_true): the probe's full shape, EVA01-g's slice
    # shape (its first rows, no mask), one head, D 64, and the resident
    # room's edges
    "probe": (256, 272, 16, 88, 257),
    "eva_slice": (64, 257, 16, 88, 0),
    "ragged": (3, 257, 16, 88, 200),
    "one_head": (4, 272, 1, 88, 257),
    "d64": (4, 272, 16, 64, 257),
    "room_d88": (2, 320, 4, 88, 0),
    "room_d128": (2, 320, 4, 128, 0),
    "room_d64": (2, 768, 2, 64, 0),
    "d8_one_key": (1, 1, 1, 8, 0),
}


@pytest.mark.parametrize("case", list(TAKEN))
def test_probe_views_take_the_hopper_bodies(case):
    b, l, h, d, lk_true = TAKEN[case]
    qkv = fused(b, l, h, d)
    assert tv.dma_entry(qkv, h, lk_true) == tv.DMA_SM90
    assert tv.sect_entry(qkv, h) == tv.SECT_SM90


def test_make_inputs_views_take_the_hopper_bodies():
    """The probe's own tensors (make_inputs at a small shape on the CPU:
    the section-major one is a copy, the pointers are real)."""
    b, l, h, d, lk_true = 2, 24, 2, 16, 20
    inputs = tv.make_inputs(b, l, h, d, device="cpu")
    assert tv.dma_entry(inputs["fused"], h, lk_true) == tv.DMA_SM90
    assert tv.sect_entry(inputs["sect"], h) == tv.SECT_SM90


def off_boundary(b, l, h, d):
    """A contiguous bf16 qkv whose base lies 2 elements (4 bytes) past a
    16-byte boundary (a real CPU tensor: the pointer is what counts)."""
    return torch.zeros(b * l * h * 3 * d + 2, dtype=BF16)[2:].view(
        b, l, h * 3 * d)


REFUSED = {
    # name: (qkv, heads, lk_true): neither Hopper body takes these
    "fp32": (lambda: fused(256, 272, 16, 88, dtype=torch.float32), 16, 257),
    "d12": (lambda: fused(2, 40, 3, 12), 3, 0),
    "d100": (lambda: fused(2, 40, 3, 100), 3, 0),
    "base_off_16_bytes": (lambda: off_boundary(2, 40, 3, 16), 3, 0),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_neither_hopper_body_takes(case):
    make, h, lk_true = REFUSED[case]
    qkv = make()
    assert tv.dma_entry(qkv, h, lk_true) == tv.DMA_MMA
    assert tv.sect_entry(qkv, h) == tv.SECT_MMA


LONG_KEYS = {
    # name: (B, L, H, D, lk_true): kend past the resident room, which the
    # shared body (streaming its keys) still takes
    "d88_kend_600": (2, 640, 2, 88, 600),
    "d88_kend_321": (2, 321, 2, 88, 0),
    "d72_kend_321": (2, 330, 2, 72, 321),
    "d64_kend_769": (1, 800, 2, 64, 769),
}


@pytest.mark.parametrize("case", list(LONG_KEYS))
def test_keys_past_the_resident_room_keep_the_mma_body(case):
    b, l, h, d, lk_true = LONG_KEYS[case]
    qkv = fused(b, l, h, d)
    assert tv.dma_entry(qkv, h, lk_true) == tv.DMA_MMA
    assert tv.sect_entry(qkv, h) == tv.SECT_SM90


@pytest.mark.parametrize("kend,rows", [
    (1, 16), (16, 16), (17, 64), (64, 64), (65, 128), (128, 128),
    (129, 144), (200, 256), (257, 272), (272, 272), (273, 320), (319, 320),
    (320, 320), (321, 384), (768, 768), (769, 784)])
def test_strip_rows(kend, rows):
    """128 rows a key tile but the last, which takes 16, 64 or 128 (wgmma's
    N): 257 keys take 272 rows, 273 take 320."""
    assert fa._strip_rows(kend) == rows


@pytest.mark.parametrize("d,room", [(8, 768), (64, 768), (72, 320),
                                    (88, 320), (128, 320)])
def test_strip_room_by_head_width(d, room):
    """The largest kend the resident strip takes at head width d: every
    kend up to it, none above (the C entry's strip_takes, mirrored)."""
    qkv = fused(1, room + 1, 1, d)
    assert fa._strip_ok(d, room, qkv)
    assert not fa._strip_ok(d, room + 1, qkv)
    assert all(fa._strip_ok(d, kend, qkv) for kend in range(1, room + 1))


def test_sass_spills_counts_local_memory_by_role():
    """vast_tpu_torch/scripts/sass_spills.py (run on the card's machine)
    counts each STL and LDL by the last USETMAXREG before it, on
    cuobjdump's layout of the SASS."""
    from vast_tpu_torch.scripts.sass_spills import local_by_role

    sass = """
        code for sm_90a
                Function : kernel_a
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   STL [R1+0x4], R2 ;
        /*0020*/                   USETMAXREG.DEALLOC.CTAPOOL 0x18 ;
        /*0030*/                   LDL.LU R3, [R1+0x8] ;
        /*0040*/                   STL [R1], R3 ;
        /*0050*/                   USETMAXREG.TRYALLOC.CTAPOOL 0xf0 ;
        /*0060*/                   ULDC UR8, c[0x0][0x4a4] ;
        /*0070*/                   LDL R4, [R1+0x10] ;
                Function : kernel_b
        /*0000*/                   EXIT ;
"""
    assert local_by_role(sass) == {
        "kernel_a": (8, {"before_split": 1, "producer": 2, "consumers": 1}),
        "kernel_b": (1, {})}
