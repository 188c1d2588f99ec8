"""The Video Swin cell's counts (``counts/window_attention.py``), its
three readers, and the keys of its runner's observations that the train
cells' readers read."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, spec
from benchmark.counts import attention, flops, window_attention as wa
from benchmark.reference.videoswin_ref import VastVideoSwinRef
from benchmark.tests import tiny

CONFIG = "vast_videoswinb_beats"
TRACE = {"wall_s": 1.0, "busy_s": 0.5, "attention_s": 0.2}
H100 = "NVIDIA H100 80GB HBM3"


def _counted(fn):
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def ref():
    cfg = copy.deepcopy(spec._load("configs", CONFIG))
    with torch.device("meta"):
        model = VastVideoSwinRef(cfg)
    return cfg, model


def test_vision_tower_flops(ref):
    """PyTorch's own counter over the plain reference at the published
    widths and 16 frames (on the meta device)."""
    cfg, model = ref
    r = cfg["vision_resolution"]
    pix = torch.empty(2, 16, r, r, 3, device="meta")
    assert _counted(lambda: model.vision_encoder(pix)) == \
        wa.vision_forward(cfg, 2, 16)


def test_condition_and_text_flops(ref):
    cfg, model = ref
    r, n, frames, samples = cfg["vision_resolution"], 2, 16, 400 + 1023 * 160
    meta = dict(device="meta")
    batch = {
        "vision_frames": torch.empty(n, frames, r, r, 3, dtype=torch.uint8,
                                     **meta),
        "audio_waveforms": torch.empty(n, samples, **meta),
        "caption_tokens": torch.zeros(n, 40, dtype=torch.long, **meta),
        "caption_attention_mask": torch.ones(n, 40, dtype=torch.long,
                                             **meta),
        "subtitle_tokens": torch.zeros(n, 70, dtype=torch.long, **meta),
        "subtitle_attention_mask": torch.ones(n, 70, dtype=torch.long,
                                              **meta)}
    want = (flops.preprocess(cfg, n, frames, r, samples, False)
            + wa.condition_forward(cfg, n, frames, 70)
            + flops.text_forward(cfg, n, 40))
    assert _counted(lambda: model.features(batch)) == want


def test_stages_at_16_and_8_frames(ref):
    cfg, _ = ref
    st = wa.stages(cfg, 16)
    assert [s["grid"] for s in st] == [(16, 56, 56), (16, 28, 28),
                                       (16, 14, 14), (16, 7, 7)]
    assert all(s["window"] == (8, 7, 7) and s["shifts"] for s in st)
    assert wa.vision_tokens(cfg, 16) == 16 * 49
    # at 8 frames the last stage's 8 x 7 x 7 grid is one window: no shift
    assert not wa.stages(cfg, 8)[-1]["shifts"]


def test_window_launch_by_hand():
    """2 windows of 4 tokens, 2 heads of width 8, a mask of 1 window."""
    q = 2 * 2 * 4 * 8 * 2                  # q, k, v, o, do, dq, ...: bf16
    table, mask, lse = 2 * 4 * 4 * 4, 1 * 4 * 4 * 1, 2 * 2 * 4 * 4
    assert wa.window_work("window_fwd", 2, 2, 4, 8, 1, True) == (
        4 * q + table + mask + lse, 4.0 * 2 * 2 * 4 * 4 * 8)
    assert wa.window_work("window_fwd", 2, 2, 4, 8, 0, False) == (
        4 * q + table, 4.0 * 2 * 2 * 4 * 4 * 8)
    assert wa.window_work("window_bwd", 2, 2, 4, 8, 1, True) == (
        8 * q + lse + 2 * table + mask, 10.0 * 2 * 2 * 4 * 4 * 8)


def test_step_launches(ref):
    cfg, _ = ref
    launches = wa.step_launches(cfg, 8, 16)
    assert len(launches) == 2 * (24 + 12)
    windows = [x for x in launches if x[0] == "window_fwd"]
    # stage 0: 8 clips x 128 windows, 4 heads of 32, 392 tokens
    assert windows[0] == ("window_fwd", 1024, 4, 392, 32, 0, True)
    assert windows[1] == ("window_fwd", 1024, 4, 392, 32, 128, True)
    assert sum(1 for x in windows if x[5]) == 1 + 1 + 9 + 1
    beats = ("fwd", 8, 12, 256, 256, 64, True, True)
    assert launches.count(beats) == 12
    want = sum(attention.bound_s(H100, *(wa.window_work(*x)
                                         if x[0].startswith("window")
                                         else attention.launch_work(*x)))
               for x in launches)
    assert wa.launches_bound_s(H100, launches) == pytest.approx(want)


def _span(i, name, root, device_s, **counts):
    return {"name": name, "id": i, "parent": root, "root": root,
            "start_ns": i, "end_ns": i + 1, "host_s": 1e-9,
            "device_s": device_s, "counts": counts}


def _spans():
    out = []
    for step, ms in ((1, 10.0), (20, 12.0), (40, 30.0)):
        out.append(_span(step, "vast.train.step", step, 0.5))
        out += [_span(step + 1 + s, f"vast.videoswin.stage{s}", step,
                      ms / 4e3, windows=4, shifted=1,
                      bias_bytes=(s + 1) * 10 ** 6) for s in range(4)]
    return out


@pytest.fixture
def recorder(monkeypatch):
    from vast_tpu_torch import profiling

    def fill(spans):
        monkeypatch.setattr(profiling, "spans", lambda: spans)
    return fill


def test_span_readers(recorder):
    obs = {"kind": "train", "trace": TRACE}
    vswin = spec.metric_reader("vswin_fwd_ms.train")
    bias = spec.metric_reader("attn_bias_mb.train")
    recorder(_spans())
    assert vswin(obs) == pytest.approx(12.0)
    assert bias(obs) == pytest.approx(10.0)
    assert vswin({"kind": "train"}) is None
    assert bias({"kind": "eval", "trace": TRACE}) is None
    # a program whose tower records no stage spans, as the parent's
    recorder([s for s in _spans() if s["name"] == "vast.train.step"])
    assert vswin(obs) is None and bias(obs) is None


def test_runner_obs_feed_the_train_readers(monkeypatch):
    """A tiny Video Swin cell run on the CPU: the train cells' readers
    find their keys in its observations, and the window roofline reads
    its launches once a trace is there."""
    from benchmark.runners import train_videoswin

    ctx = tiny.ctx("videoswin_ret_train", seconds=1.0)     # two steps
    cfg = ctx.cell["config_spec"]
    cfg.update(vision={"patch_size": [2, 4, 4], "embed_dim": 16,
                       "depths": [2, 2], "num_heads": [2, 4],
                       "window_size": [8, 7, 7], "mlp_ratio": 4.0,
                       "time_stride": 1, "ln_eps": 1e-5},
               vision_resolution=56)
    ctx.cell["traffic_spec"].update(batch_size=2)
    out = train_videoswin.run(ctx)
    assert set(out["checks"]) == set(ctx.limits)
    assert harness.forbidden_modules() == []
    obs = out["obs"]
    obs["device_name"] = H100
    for name in ("train_mfu", "train_step_ms_p90"):
        assert spec.metric_reader(name)(obs) is not None, name
    launches = wa.step_launches(cfg, 2, 16)
    obs |= {"trace": TRACE, "profiled": 1, "window_launches": launches,
            "attention_launches_counted": len(launches)}
    assert spec.metric_reader("device_idle_share.train")(obs) is not None
    share = spec.metric_reader("window_attn_roofline_share.train")
    assert share(obs) == pytest.approx(
        100 * wa.launches_bound_s(H100, launches) / 0.2)
    obs["attention_launches_counted"] += 1
    assert share(obs) is None


def test_the_cell_reports_its_metrics():
    bench = spec.benchmark_json()
    e2e, layer = spec.cell_metrics("videoswin_ret_train", bench)
    assert {m["name"] for m in e2e} == {"train_clips_per_s", "setup_s"}
    names = {m["name"] for m in layer}
    assert {"window_attn_roofline_share.train", "vswin_fwd_ms.train",
            "attn_bias_mb.train", "train_mfu"} <= names
    assert "attn_roofline_share.train" not in names
    for name in names:
        spec.metric_reader(name)
