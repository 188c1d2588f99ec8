"""The window attention op (``ops.window_attention``) on the CPU.

Its plain version against the path it replaces, ``multi_head_attention``
on the materialised table-plus-mask sum: outputs and the gradients of the
packed qkv and of the bias table, fp32, at kernel-route shapes (Video
Swin's 392-token window, shifted and not, a 2-D 12 x 12 window, this tp
rank's heads of the table); at a plain-route shape (Swin's 7 x 7) the
same numbers as before; the region labels; the op's place in the
checkpoint policies; the card route's shapes and operand copies. The kernels themselves are held to the plain
version on the card (``tests/test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

from vast_tpu_torch.models import remat, swin, videoswin
from vast_tpu_torch.ops import flash_attention as fa
from vast_tpu_torch.ops.attention import _plain_route, multi_head_attention
from vast_tpu_torch.ops.window_attention import (WINDOW_OP, region_labels,
                                                 window_attention)


def window_3d(shifted):
    """Video Swin's (8, 7, 7) window of a 16 x 14 x 14 grid: 8 windows a
    clip, shifted by (4, 3, 3)."""
    win = (8, 7, 7)
    mask = (videoswin.shift_mask_3d(16, 14, 14, win, (4, 3, 3))
            if shifted else None)
    return videoswin.rel_index_3d(*win), 15 * 13 * 13, mask, 8


def window_2d(w, grid):
    """Swin's w x w window of a grid x grid image, shifted by w // 2."""
    return (swin.relative_position_index(w), (2 * w - 1) ** 2,
            swin.shift_attn_mask(grid, grid, w, w // 2),
            (grid // w) ** 2)


CASES = {
    # name: (window, clips, heads of the table, this rank's heads, D)
    "vswin_shifted_2clips": (lambda: window_3d(True), 2, 2, slice(0, 2), 8),
    "vswin_unshifted_2clips": (lambda: window_3d(False), 2, 2, slice(0, 2),
                               8),
    "swin2d_12x12_shifted": (lambda: window_2d(12, 24), 3, 3, slice(0, 3),
                             16),
    "vswin_shifted_tp_rank1": (lambda: window_3d(True), 2, 4, slice(2, 4),
                               8),
}


def two_paths(case):
    """(new, old): the output and the gradients of qkv and of the whole
    table through ``window_attention`` and through ``multi_head_attention``
    on the materialised sum, from the same seeded inputs."""
    make, clips, heads, cols, d = CASES[case]
    index, rows, mask, n_win = make()
    n = index.shape[0]
    h = cols.stop - cols.start
    w = clips * n_win
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(rows, heads, generator=gen)
    qkv = torch.randn(w, n, 3, h, d, generator=gen)
    do = torch.randn(w, n, h, d, generator=gen)
    index = torch.from_numpy(index.reshape(-1))
    mask = None if mask is None else torch.from_numpy(mask)
    labels = None if mask is None else region_labels(mask)

    def path(attend):
        tab = table.clone().requires_grad_()
        x = qkv.clone().requires_grad_()
        bias = tab[:, cols][index].view(n, n, h).permute(2, 0, 1).contiguous()
        q, k, v = x.transpose(1, 3).unbind(2)          # (W, h, n, d) views
        out = attend(q, k, v, bias)
        (out.transpose(1, 2) * do).sum().backward()
        return {"out": out.detach(), "dqkv": x.grad, "dtable": tab.grad}

    def old(q, k, v, bias):
        attn_mask = None
        if mask is not None:
            attn_mask = mask[:, None].repeat(clips, 1, 1, 1)
        return multi_head_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            bias=bias[None], mask=attn_mask).transpose(1, 2)

    assert not _plain_route(n, n, d)
    return (path(lambda q, k, v, b: window_attention(
        q, k, v, b, labels, scale=d ** -0.5)), path(old))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_the_materialised_path(case):
    """At a kernel-route shape the op's plain version gives what
    ``multi_head_attention`` gives on the table-plus-mask sum, output and
    every gradient (the table's summed over the windows), within fp32
    round-off of the same arithmetic, and launches nothing on the CPU."""
    before = dict(fa.LAUNCHES)
    new, old = two_paths(case)
    assert fa.LAUNCHES == before
    for name, got in new.items():
        want = old[name]
        assert got.shape == want.shape, name
        scale = want.abs().max().item()
        assert scale > 0, name
        err = (got - want).abs().max().item()
        assert err <= 1e-6 * scale, (name, err, scale)
    # the tp rank's table gradient is zero outside its heads' columns
    cols = CASES[case][3]
    outside = torch.ones(new["dtable"].shape[1], dtype=torch.bool)
    outside[cols] = False
    if outside.any():
        assert new["dtable"][:, outside].abs().max().item() == 0.0


def test_a_dropped_mask_is_seen():
    """The comparison above sees the mask: without the labels the shifted
    windows' output moves by far more than round-off."""
    index, rows, mask, n_win = window_3d(True)
    n, d = index.shape[0], 8
    gen = torch.Generator().manual_seed(4)
    q, k, v = torch.randn(3, 2 * n_win, 2, n, d, generator=gen).unbind(0)
    bias = torch.randn(2, n, n, generator=gen)
    labels = region_labels(torch.from_numpy(mask))
    with_mask = window_attention(q, k, v, bias, labels, scale=d ** -0.5)
    without = window_attention(q, k, v, bias, None, scale=d ** -0.5)
    assert (with_mask - without).abs().max().item() > 1e-2


def test_plain_route_shape_keeps_todays_numbers():
    """Swin's 7 x 7 windows (49 tokens) stay on the plain route: the
    block's attention, given the labels, gives bit for bit what
    ``multi_head_attention`` gives on the tiled mask."""
    torch.manual_seed(0)
    index = swin.relative_position_index(7)
    attn = swin.WindowAttention(32, 4, index, 13 * 13)
    with torch.no_grad():
        attn.relative_position_bias_table.normal_()
    mask = torch.from_numpy(swin.shift_attn_mask(14, 14, 7, 3))
    x = torch.randn(2 * 4, 49, 32)
    got = attn(x, region_labels(mask))
    nb, n, c = x.shape
    q, k, v = attn.qkv(x).view(nb, n, 3, 4, 8).unbind(2)
    bias = attn.relative_position_bias_table[
        attn.relative_position_index].view(n, n, 4).permute(2, 0, 1)
    out = multi_head_attention(q, k, v, bias=bias.contiguous()[None],
                               mask=mask[:, None].repeat(2, 1, 1, 1))
    assert torch.equal(got, attn.proj(out.reshape(nb, n, c)))


@pytest.mark.parametrize("mask_of", ["swin_2d", "videoswin_3d"])
def test_region_labels_are_the_mask(mask_of):
    """Labels equal exactly where the mask attends, for both towers'
    masks; a mask that is no equivalence of regions raises."""
    mask = torch.from_numpy(
        swin.shift_attn_mask(14, 14, 7, 3) if mask_of == "swin_2d"
        else videoswin.shift_mask_3d(16, 14, 14, (8, 7, 7), (4, 3, 3)))
    labels = region_labels(mask)
    assert labels.dtype == torch.int32 and labels.shape == mask.shape[:2]
    assert torch.equal(labels[:, :, None] == labels[:, None, :], mask)
    assert len(np.unique(labels.numpy())) > 1
    broken = mask.clone()
    broken[0, 0, -1] = ~broken[0, 0, -1]
    with pytest.raises(ValueError):
        region_labels(broken)


def test_op_is_saved_by_the_attention_policies():
    """The 'attn' and 'dots' checkpoint policies save the window op's
    outputs, as they save the head-major op's."""
    assert WINDOW_OP in remat._ATTN
    assert remat._save_attn(None, WINDOW_OP) == \
        remat.CheckpointPolicy.MUST_SAVE
    assert remat._save_dots(None, WINDOW_OP) == \
        remat.CheckpointPolicy.MUST_SAVE


@pytest.mark.parametrize("windows,heads", [(1024, 4), (256, 8), (64, 16),
                                           (16, 32), (3, 2)])
def test_table_gradient_chunks_cover_the_windows(windows, heads):
    """The table gradient's chunks (Video Swin-B's stages at 8 clips, and
    a tiny call) cover every window once, none empty, and give the 132
    SMs' 264 warpgroups at least four (head, tile, chunk) items each where
    there are windows enough; at the stages the busiest warpgroup runs
    within 2% of the mean windows a warpgroup."""
    from vast_tpu_torch.ops.window_attention import dtable_chunks

    per, chunks = dtable_chunks(windows, heads, 392, 132)
    assert per * (chunks - 1) < windows <= per * chunks
    items = chunks * heads * 7 * 7
    assert items >= 4 * 264 or chunks == windows
    if windows >= 16:
        busiest = -(-items // 264) * per
        assert busiest <= 1.02 * windows * heads * 7 * 7 / 264


def test_kernel_operands_are_copied_where_the_copy_engine_cannot_read():
    """The route's bf16 rule without a card: the window kernels' shapes (D
    a multiple of 8 up to 64, windows of a multiple of 4 tokens), the
    packed views passed as they are, and a view 2 bytes off a 16-byte base
    or with a stride not in 16 bytes copied into one the copy engine
    reads, with equal values."""
    from vast_tpu_torch.ops.window_attention import (_readable,
                                                     _window_shape_ok)

    assert _window_shape_ok(392, 32) and _window_shape_ok(144, 64)
    assert not any(_window_shape_ok(n, d) for n, d in
                   ((392, 72), (392, 20), (390, 32), (392, 0)))
    qkv = torch.randn(4, 392, 3, 2, 32).to(torch.bfloat16)
    packed = qkv[:, :, 0].transpose(1, 2)               # (W, H, n, D)
    assert fa._sm90_ok(32, packed) and _readable(packed, 32) is packed
    flat = torch.empty(packed.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(packed.shape).copy_(packed)
    odd = torch.randn(4, 2, 392, 36).to(torch.bfloat16)[..., :32]
    for t in (shifted, odd):
        assert not fa._sm90_ok(32, t)
        got = _readable(t, 32)
        assert fa._sm90_ok(32, got) and torch.equal(got, t)
