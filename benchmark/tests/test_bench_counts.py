"""The benchmark's FLOP counts against PyTorch's own counter, run over the
plain reference on the meta device at the configurations' published
widths."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import spec
from benchmark.counts import flops
from benchmark.reference.vast_ref import VastRef

CONFIGS = ("vast_evaclip01g_beats", "vast_clipl336_ast")


def _cfg(name):
    return copy.deepcopy(spec._load("configs", name))


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module", params=CONFIGS)
def ref(request):
    cfg = _cfg(request.param)
    with torch.device("meta"):
        model = VastRef(cfg)
    return cfg, model


def test_vision_tower(ref):
    cfg, model = ref
    r = cfg["vision_resolution"]
    pix = torch.empty(2, r, r, 3, device="meta")
    got = _counted(lambda: model.vision_encoder["visual"](pix))
    assert got == flops.vision_forward(cfg, 2)


def test_audio_tower(ref):
    cfg, model = ref
    fb = torch.empty(2, cfg["audio_target_length"], cfg["audio_melbins"],
                     device="meta")

    def run():
        if cfg["audio_encoder_type"] == "ast":
            model.audio_encoder(model.audio_embeddings(fb))
        else:
            model.audio_encoder(fb)
    assert _counted(run) == flops.audio_forward(cfg, 2)


@pytest.mark.parametrize("cond", [0, 97])
def test_bert_encode(ref, cond):
    cfg, model = ref
    ids = torch.zeros(3, 40, dtype=torch.long, device="meta")
    mask = torch.ones(3, 40, dtype=torch.long, device="meta")
    c = torch.empty(3, cond, 768, device="meta") if cond else None
    got = _counted(lambda: model.multimodal_encoder.encode(ids, mask, c))
    assert got == flops.bert_encode(cfg, 3, 40, cond, 3 if cond else 0)


def test_grouped_itm_call(ref):
    """Texts folded onto one candidate's condition, as the rerank calls."""
    cfg, model = ref
    ids = torch.zeros(5, 40, dtype=torch.long, device="meta")
    mask = torch.ones(5, 40, dtype=torch.long, device="meta")
    c = torch.empty(1, 211, 768, device="meta")
    got = _counted(lambda: model.itm_prob(c, ids, mask))
    assert got == flops.rerank_call(cfg, 1, 211, 5, 40)


def test_features_and_text(ref):
    """The evaluation's condition side, text side and preprocessing."""
    cfg, model = ref
    r, n, frames = cfg["vision_resolution"], 2, 3
    samples = 400 + 1023 * 160
    batch = {
        "vision_frames": torch.empty(n, frames, r, r, 3, dtype=torch.uint8,
                                     device="meta"),
        "audio_waveforms": torch.empty(n, samples, device="meta"),
        "caption_tokens": torch.zeros(n, 40, dtype=torch.long,
                                      device="meta"),
        "caption_attention_mask": torch.ones(n, 40, dtype=torch.long,
                                             device="meta"),
        "subtitle_tokens": torch.zeros(n, 70, dtype=torch.long,
                                       device="meta"),
        "subtitle_attention_mask": torch.ones(n, 70, dtype=torch.long,
                                              device="meta")}
    got = _counted(lambda: model.features(batch))
    want = (flops.preprocess(cfg, n, frames, r, samples, False)
            + flops.condition_forward(cfg, n, frames, 70)
            + flops.text_forward(cfg, n, 40))
    assert got == want


def test_random_crop_products():
    """The training crop's two resize products, on the CPU."""
    from benchmark.reference.vast_ref import _random_crop_flip

    cfg = {"vision_resolution": 16, "audio_melbins": 64}
    x = torch.rand(2, 3, 20, 20, 3)
    g = torch.Generator().manual_seed(0)
    got = _counted(lambda: _random_crop_flip(x, 16, g))
    mel = flops.preprocess(cfg, 2, 3, 20, 400, False)
    assert got == flops.preprocess(cfg, 2, 3, 20, 400, True) - mel
