"""The port's Video Swin and VAST around it against the benchmark's plain
reference (``benchmark/reference/videoswin_ref.py``) on the CPU.

A tiny Video Swin that keeps the mechanism of the published grid: clips
of 16 frames at 56 px give a 16 x 14 x 14 token grid, so that with (8,
7, 7) windows there are two temporal windows and the full (4, 3, 3)
shift with its 3-D region mask in the first stage, and a temporal shift
alone in the second (its 7 x 7 grid is one window wide). Embed 16,
depths (2, 2), heads (2, 4); BEATs and BERT at the benchmark's tiny
widths. Both sides fp32, weights from one seed
(``benchmark/weights.init_weights``, the same names on both sides).
"""

import statistics

import numpy as np
import pytest
import torch

from benchmark import generator, harness, spec, weights
from benchmark.reference import videoswin_ref as ref_mod
from benchmark.tests import tiny
from vast_tpu_torch.models import videoswin

VSWIN = {"patch_size": [2, 4, 4], "embed_dim": 16, "depths": [2, 2],
         "num_heads": [2, 4], "window_size": [8, 7, 7], "mlp_ratio": 4.0,
         "time_stride": 1, "ln_eps": 1e-5}
FRAMES, RES, SEED = 16, 56, 5
# fp32 on both sides, which differ by summation order and by the masked
# pairs' -1e30 against the reference's -100 (exp(-100) is under fp32's
# resolution of a softmax row): ~1e-7 of the largest value measured, so
# 1e-5 holds; dropping the shift mask or the roll moves the tower's
# output by ~3e-3 and the shifted tables' gradients by 60-120%
RTOL = 1e-5
# leaves whose gradient is round-off (a key bias under softmax: its
# gradient cancels to ~1e-13), as the benchmark's training comparison
# leaves them out: under a thousandth of the median leaf's norm. The
# bias tables stay compared below that too: their gradients (~1e-7 in
# the first stage) are sums the mechanism makes, not cancellations
ROUNDOFF = 1e-3


def tower(**faults):
    if faults:
        return ref_mod.VideoSwinRef(VSWIN, FRAMES, RES, **faults)
    cfg = videoswin.VideoSwinConfig(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in VSWIN.items()})
    return videoswin.VideoSwinTransformer(cfg, "cpu", FRAMES, RES)


def rel_gap(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max())


def test_tower_output_matches_reference():
    prog, ref = tower(), ref_mod.VideoSwinRef(VSWIN, FRAMES, RES)
    assert sorted(n for n, _ in prog.named_parameters()) == sorted(
        n for n, _ in ref.named_parameters())
    weights.init_weights(prog, SEED, "cpu")
    weights.init_weights(ref, SEED, "cpu")
    x = torch.randn(2, FRAMES, RES, RES, 3,
                    generator=torch.Generator().manual_seed(1))
    got, want = prog(x), ref(x)
    assert got.shape == want.shape == (2, 16, 49, 32)
    assert rel_gap(got, want) < RTOL


def _cell_config():
    cell = spec.load_cell("videoswin_ret_train")
    cfg, tr = cell["config_spec"], cell["traffic_spec"]
    cfg.update(vision=VSWIN, audio=dict(tiny.BEATS),
               bert=dict(cfg["bert"], **tiny.BERT), vision_resolution=RES,
               audio_melbins=32, audio_target_length=64)
    tr.update(audio_samples=400 + 63 * 160)
    g = generator.generator(7, 0, "cpu")
    batch = generator.clip_batch(3, tr, cfg, cfg["bert"]["vocab_size"], g,
                                 "cpu")
    neg_c, neg_t = generator.negatives(3, g, "cpu")
    return cfg, batch | {"itm_neg_cond_idx": neg_c,
                         "itm_neg_text_idx": neg_t}


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


@pytest.fixture(scope="module")
def trained():
    """(config, batch, the program's losses and gradients, the
    reference's) of one ret%tvas step's forward and backward, the same
    step generator on both sides (crop, flip, audio clip, dropout)."""
    cfg, batch = _cell_config()
    prog = harness.build_program(cfg, "cpu", torch.float32, torch.float32)
    weights.init_weights(prog, SEED, "cpu")
    out = prog(dict(batch, vision_transforms="crop_flip"), "ret%tvas",
               compute_loss=True, generator=torch.Generator().manual_seed(3))
    sum(out.values()).backward()
    losses = {k: float(v.detach()) for k, v in out.items()}
    return cfg, batch, (losses, _grads(prog)), reference_step(cfg, batch)


def reference_step(cfg, batch, **faults):
    ref = ref_mod.VastVideoSwinRef(cfg, **faults)
    weights.init_weights(ref, SEED, "cpu")
    out = ref.ret_losses(batch, torch.Generator().manual_seed(3))
    sum(out.values()).backward()
    return {k: float(v.detach()) for k, v in out.items()}, _grads(ref)


def compared(grads):
    med = statistics.median(float(g.norm()) for g in grads.values())
    return [n for n, g in grads.items()
            if float(g.norm()) >= ROUNDOFF * med or n in tables(grads)]


def tables(grads):
    return [n for n in grads if n.endswith("relative_position_bias_table")]


def test_ret_losses_match_reference(trained):
    _, _, (losses, _), (want, _) = trained
    assert losses.keys() == want.keys()
    for k in want:
        assert abs(losses[k] - want[k]) <= RTOL * abs(want[k]), k


def test_gradients_match_reference(trained):
    _, _, (_, grads), (_, want) = trained
    assert grads.keys() == want.keys()
    keep = compared(want)
    assert len(tables(want)) == 4
    worst = max(keep, key=lambda n: rel_gap(grads[n], want[n]))
    assert rel_gap(grads[worst], want[worst]) < RTOL, worst


@pytest.mark.parametrize("fault", ["shift_mask", "roll"])
def test_reference_without_the_shift_fails(trained, fault):
    """The comparison sees the mechanism: the reference with the region
    mask dropped, or with the roll undone, fails the tower's and the
    shifted blocks' tables' tolerances."""
    cfg, batch, (_, grads), _ = trained
    prog, bad = tower(), tower(**{fault: False})
    weights.init_weights(prog, SEED, "cpu")
    weights.init_weights(bad, SEED, "cpu")
    x = torch.randn(2, FRAMES, RES, RES, 3,
                    generator=torch.Generator().manual_seed(1))
    assert rel_gap(prog(x), bad(x)) > 100 * RTOL
    _, bad_grads = reference_step(cfg, batch, **{fault: False})
    shifted = [n for n in tables(grads) if ".blocks.1." in n]
    assert len(shifted) == 2
    for n in shifted:
        assert rel_gap(grads[n], bad_grads[n]) > 0.1, n


@pytest.mark.parametrize("frames, temporal", [(8, False), (16, True)])
def test_shift_mask_temporal_regions(frames, temporal):
    """At 8 frames the grid's 8 frames are one temporal window: no
    temporal shift, and the mask's regions are the spatial ones alone.
    At 16 the window splits the frames in two and the mask separates
    frames too. Both the program's mask and the reference's."""
    c = videoswin.VideoSwinConfig()
    grid = (frames, 14, 14)
    win, shift = videoswin._window_and_shift(c, grid, True)
    assert (shift[0] > 0) == temporal and shift[1:] == (3, 3)
    prog = videoswin.shift_mask_3d(*grid, win, shift)
    ref = ref_mod.region_mask(grid, *ref_mod.window_and_shift(
        grid, c.window_size, (4, 3, 3)), "cpu").numpy() == 0
    np.testing.assert_array_equal(prog, ref)
    # token pairs of one window that differ only in their frame
    n_t = win[0]
    same_place = np.kron(np.ones((n_t, n_t), bool), np.eye(win[1] * win[2],
                                                           dtype=bool))
    split_in_time = (~prog & same_place).any()
    assert split_in_time == temporal


def test_stage_spans_count_windows_and_materialised_bias():
    """The tower's stage spans, recorded: each stage's clips x windows,
    its shifted blocks and the bytes of the fp32 table-plus-mask sums its
    shifted blocks hand the kernel (2 clips; stage 0: 8 windows a clip
    of 392 tokens, 2 heads; stage 1: 2 windows, 4 heads). Off, nothing
    is recorded."""
    from vast_tpu_torch import profiling

    prog = tower()
    x = torch.randn(2, FRAMES, RES, RES, 3)
    profiling.clear()
    with torch.no_grad():
        prog(x)
    assert profiling.spans() == []
    with profiling.recording(), torch.no_grad():
        prog(x)
    got = {s["name"]: s["counts"] for s in profiling.spans()}
    profiling.clear()
    n = 392
    assert got == {
        "vast.videoswin.stage0": {"windows": 16, "shifted": 1,
                                  "bias_bytes": 16 * 2 * n * n * 4},
        "vast.videoswin.stage1": {"windows": 4, "shifted": 1,
                                  "bias_bytes": 4 * 4 * n * n * 4}}
