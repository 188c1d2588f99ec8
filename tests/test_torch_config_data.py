"""The port's config grammar, tokenizer, dataset and loaders against
vast_tpu's, on the CPU.

``get_args`` on every released task config, with and without the
``train_*`` / ``test_*`` fan-out flags, with ``${VAST_DATA}`` expanded
and with ``inherit_keys`` from a pretrain dir's ``log/hps.json``: the
run, model and data configs equal ``vast_tpu.config.get_args``'. The
tokenizer's ids, ``AnnoIndexedDataset.collate``'s arrays (bit for bit,
``image_rawimage`` and ``video_frame``, with subtitles), the
``BatchLoader``'s order, padding and counts, the producer's exception,
``MetaLoader``'s task sequence and ``_full_batches``' accounting equal
vast_tpu's (tests/test_loader.py's cases).
"""

import glob
import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest

from tests.helpers import make_synth_dataset, make_task_config
from vast_tpu import config as jconfig
from vast_tpu.data import anno_dataset as janno
from vast_tpu.data import loader as jloader
from vast_tpu.data import tokenizer as jtok
from vast_tpu.evaluation.evaluation_mm import _full_batches as j_full
from vast_tpu_torch import config as pconfig
from vast_tpu_torch.data import anno_dataset as panno
from vast_tpu_torch.data import data_registry
from vast_tpu_torch.data import loader as ploader
from vast_tpu_torch.data import tokenizer as ptok
from vast_tpu_torch.data import vision as pvision
from vast_tpu_torch.evaluation.evaluation_mm import _full_batches as p_full

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "vast_tpu", "configs", "*",
                                        "*.json")))
FAN_OUT = ["--train_batch_size", "8", "--test_batch_size", "4",
           "--train_vision_sample_num", "4", "--test_vision_sample_num", "6",
           "--train_task", "ret%tv", "--test_task", "ret%tva",
           "--train_epoch", "2.5", "--train_steps", "7",
           "--vision_transforms", "none", "--checkpointing", "true",
           "--num_train_steps", "6", "--valid_freq", "1", "--bf16", "false",
           "--output_dir", "out", "--itm_rerank_num", "16"]


def _same(got, want):
    """Equal as the JSON that dump_hps writes."""
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)


@pytest.mark.parametrize("flags", [[], FAN_OUT], ids=["plain", "fan_out"])
@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_get_args_equal(monkeypatch, path, flags):
    monkeypatch.setenv("VAST_DATA", "/data/vast")
    argv = ["--config", path] + flags
    try:
        want = jconfig.get_args(argv)
    except IndexError:
        # a train_* flag on a config without training data (the
        # captioner configs) fails alike in both
        with pytest.raises(IndexError):
            pconfig.get_args(argv)
        return
    got = pconfig.get_args(argv)
    _same(got, want)
    for d in got.data_cfg.train + got.data_cfg.val:
        for key in ("txt", "vision", "audio"):
            assert "${" not in str(d.get(key, "")), d
    if flags and got.data_cfg.train:
        assert got.data_cfg.train[0].steps == 7
        assert all(d.batch_size == 4 for d in got.data_cfg.val)


def test_expand_env_default_and_set(monkeypatch):
    value = {"a": ["${VAST_DATA:-datasets}/x", "${NOPE}"], "b": 3}
    monkeypatch.delenv("VAST_DATA", raising=False)
    assert pconfig.expand_env(value) == jconfig.expand_env(value) == \
        {"a": ["datasets/x", ""], "b": 3}
    monkeypatch.setenv("VAST_DATA", "/d")
    assert pconfig.expand_env(value) == jconfig.expand_env(value)
    assert pconfig.expand_env(value)["a"][0] == "/d/x"


def test_inherit_keys_from_hps(tmp_path):
    pre = tmp_path / "pretrain"
    (pre / "log").mkdir(parents=True)
    hps = {"model_cfg": {"vision_encoder_type": "clip_vit_large_14_336px",
                         "audio_encoder_type": "ast", "audio_melbins": 128,
                         "audio_target_length": 512, "pool_video": "avg",
                         "contra_dim": 999}}
    (pre / "log" / "hps.json").write_text(json.dumps(hps))
    path = os.path.join(ROOT, "vast_tpu", "configs", "finetune_cfg",
                        "retrieval-msrvtt.json")
    argv = ["--config", path, "--pretrain_dir", str(pre)]
    got = pconfig.get_args(argv)
    _same(got, jconfig.get_args(argv))
    m = got.model_cfg
    assert (m.vision_encoder_type, m.audio_encoder_type, m.audio_melbins,
            m.audio_target_length, m.pool_video) == \
        ("clip_vit_large_14_336px", "ast", 128, 512, "avg")
    assert m.contra_dim == 512          # not an inherited key


def test_dump_hps_round_trip(tmp_path):
    path = os.path.join(ROOT, "vast_tpu", "configs", "finetune_cfg",
                        "retrieval-msrvtt.json")
    opts = pconfig.get_args(["--config", path, "--output_dir",
                             str(tmp_path)])
    pconfig.dump_hps(opts)
    with open(tmp_path / "log" / "hps.json") as f:
        _same(json.load(f), opts)


TEXTS = ["A man is running in the park!", "two DOGS play, at the beach...",
         "Café naïve résumé", "猫 and 狗 sing", "unknownword walking",
         "", "a " * 80, "red\tblue\ngreen  car", "playing runs walks"]


@pytest.mark.parametrize("max_length", [12, 70])
def test_tokenizer_ids_equal(tmp_path, max_length):
    extra = ["café", "naive", "resume", "猫", "##ing"]
    for p_tok, j_tok in ((ptok.tiny_tokenizer(extra),
                          jtok.tiny_tokenizer(extra)),):
        got, want = p_tok(TEXTS, max_length), j_tok(TEXTS, max_length)
        for k in ("input_ids", "attention_mask"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert [p_tok.decode(r) for r in got["input_ids"]] == \
            [j_tok.decode(r) for r in want["input_ids"]]
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(ptok.tiny_tokenizer().inv_vocab[i] for i in
                               range(ptok.tiny_tokenizer().vocab_size)))
    got = ptok.BertTokenizer.from_pretrained(str(tmp_path))(TEXTS,
                                                            max_length)
    want = jtok.BertTokenizer.from_pretrained(str(tmp_path))(TEXTS,
                                                             max_length)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])


SUBTITLE = "a woman talks with a man near the blue car and a dog "


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A synthetic set with subtitles and multi-caption eval rows, its
    images, 3-frame JPEG directories and wavs; the task config."""
    from PIL import Image

    root = str(tmp_path_factory.mktemp("synth"))
    anno, annfile = make_synth_dataset(root, n=10)
    with open(anno) as f:
        annos = json.load(f)
    rs = np.random.RandomState(0)
    frames = os.path.join(root, "frames")
    for i, a in enumerate(annos):
        a["subtitle"] = SUBTITLE * (1 + i % 4)
        d = os.path.join(frames, a["video_id"])
        os.makedirs(d)
        for j in range(3):
            Image.fromarray((rs.rand(30, 44, 3) * 255).astype(np.uint8)
                            ).save(os.path.join(d, f"{j:03d}.jpg"))
    with open(anno, "w") as f:
        json.dump(annos, f)
    multi = os.path.join(root, "multi.json")
    with open(multi, "w") as f:
        json.dump([dict(a, caption=[a["caption"], a["caption"] + " fast"]
                        [: 1 + i % 2]) for i, a in enumerate(annos)], f)
    cfg = make_task_config(root, anno, annfile, task="ret%tvas",
                           batch_size=4)
    return root, cfg, frames, multi


def _datasets(synth, training, **d_over):
    _, cfg, _, _ = synth
    popts, jopts = (pconfig.get_args(["--config", cfg]),
                    jconfig.get_args(["--config", cfg]))
    out = []
    for opts, mod, tok in ((popts, panno, ptok), (jopts, janno, jtok)):
        d_cfg = dict((opts.data_cfg.train if training
                      else opts.data_cfg.val)[0], **d_over)
        out.append(mod.AnnoIndexedDataset(d_cfg, opts, tok.tiny_tokenizer()))
    return out


def _equal_batches(got, want):
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("fmt", ["image_rawimage", "video_frame"])
@pytest.mark.parametrize("training", [False, True])
def test_collate_equal(synth, fmt, training):
    """The collated batch of 4 samples (subtitles tokenized to
    max_subtitle_len), bit for bit. video_frame's training draw is the
    global ``random``'s, as in vast_tpu: it is seeded alike per side."""
    import random

    over = {} if fmt == "image_rawimage" else {
        "vision_format": fmt, "vision": synth[2], "vision_sample_num": 2}
    pds, jds = _datasets(synth, training, **over)
    idx = [3, 0, 7, 5]
    random.seed(5)
    got = pds.collate([pds[i] for i in idx])
    random.seed(5)
    want = jds.collate([jds[i] for i in idx])
    _equal_batches(got, want)
    assert got["subtitle_tokens"].shape == (4, 12)
    assert got["vision_frames"].dtype == np.uint8
    if fmt == "video_frame":
        assert got["vision_frames"].shape[1] == 2


def test_collate_multi_caption_rows(synth):
    pds, jds = _datasets(synth, False, txt=synth[3])
    idx = list(range(5))
    got = pds.collate([pds[i] for i in idx])
    _equal_batches(got, jds.collate([jds[i] for i in idx]))
    assert len(got["ids_txt"]) == got["caption_tokens"].shape[0] == 7


def test_native_runtime_probe_waits_for_the_first(monkeypatch):
    """Loader threads that ask for the native runtime while the first of
    them is still loading it all get the runtime. Before the probe held
    a lock, a thread that came second got None and decoded with PIL, so
    a process's first batch of JPEGs could differ from later ones."""
    fake = types.ModuleType("runtime")

    def available():
        time.sleep(0.2)        # a slow library load
        return True
    fake.available = available
    monkeypatch.setitem(sys.modules, "runtime", fake)
    monkeypatch.setattr(pvision, "_NATIVE", None)
    monkeypatch.setattr(pvision, "_NATIVE_TRIED", False)
    start, got = threading.Barrier(4), []

    def probe():
        start.wait()
        got.append(pvision._native_runtime())
    threads = [threading.Thread(target=probe) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == [fake] * 4


def test_registry_srcindexed_waits():
    from vast_tpu_torch.data.src_dataset import SrcIndexedDataset

    assert data_registry["annoindexed"] is panno.AnnoIndexedDataset
    assert data_registry["srcindexed"] is SrcIndexedDataset
    with pytest.raises(KeyError):
        data_registry["webdataset"]


class _DS:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i

    def collate(self, samples):
        return {"x": np.asarray(samples), "ids": [f"id{s}" for s in samples]}


def _rows(loader):
    return [list(b["x"]) for b in loader]


@pytest.mark.parametrize("n,hosts,bs,shuffle,drop_last", [
    (17, 4, 3, False, False), (16, 4, 4, False, False),
    (5, 4, 2, False, False), (3, 4, 2, False, False),
    (10, 1, 3, True, False), (17, 4, 3, True, True), (23, 1, 4, True, True)])
def test_batch_loader_equal(n, hosts, bs, shuffle, drop_last):
    """Order for a seed over two epochs, padded_tail and batch counts on
    every host, as vast_tpu's BatchLoader."""
    for h in range(hosts):
        kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=2,
                  seed=9, host_id=h, num_hosts=hosts)
        p = ploader.BatchLoader(_DS(n), bs, **kw)
        j = jloader.BatchLoader(_DS(n), bs, **kw)
        for epoch in (0, 1):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            got, want = _rows(p), _rows(j)
            assert got == want and len(got) == len(p) == len(j)
            assert p.padded_tail == j.padded_tail


class _RaisingDS(_DS):
    def collate(self, samples):
        raise ValueError("collate boom")


def test_producer_exception_propagates():
    ld = ploader.BatchLoader(_RaisingDS(6), 3, shuffle=False,
                             drop_last=False, num_workers=1)
    with pytest.raises(ValueError, match="collate boom"):
        list(ld)


class _Endless:
    def __init__(self, tag):
        self.tag = tag

    def __iter__(self):
        i = 0
        while True:
            yield {"x": (self.tag, i)}
            i += 1


@pytest.mark.parametrize("ratios,accum", [((3, 1, 0), 1), ((2, 5, 1), 2)])
def test_meta_loader_task_sequence_equal(ratios, accum):
    names = ["ret%tvas--a", "ret%tv--b", "ret%ta--c"]

    def seq(mod):
        ml = mod.MetaLoader({nm: (_Endless(nm), r)
                             for nm, r in zip(names, ratios)},
                            accum_steps=accum, seed=4)
        return [(nm, b["x"]) for (nm, b), _ in zip(ml, range(40))]

    got = seq(ploader)
    assert got == seq(jloader) and len({nm for nm, _ in got}) == 3


class _ReadsDS(_DS):
    """Records the index of every sample read."""
    def __init__(self, n):
        super().__init__(n)
        self.reads = []

    def __getitem__(self, i):
        self.reads.append(i)
        return i


@pytest.mark.parametrize("n,accum", [(0, 1), (5, 1), (13, 1), (14, 2)])
def test_meta_loader_skip_reads_nothing(n, accum):
    """``skip(n)`` then iteration yields what steps n.. of an unbroken
    MetaLoader yield (task draws, epochs, batches), and each dataset's
    first reads are the samples of the first batch it yields: nothing
    of the skipped batches is read."""
    names, ratios, bs = ["ret%tvas--a", "ret%tv--b"], (3, 2), 3

    def meta():
        dss = {nm: _ReadsDS(10 + i) for i, nm in enumerate(names)}
        return dss, ploader.MetaLoader(
            {nm: (ploader.BatchLoader(dss[nm], bs, shuffle=True,
                                      num_workers=2, seed=9), r)
             for nm, r in zip(names, ratios)}, accum_steps=accum, seed=4)

    _, whole = meta()
    want = [(nm, list(b["x"])) for (nm, b), _ in zip(whole, range(n + 8))]
    dss, ml = meta()
    ml.skip(n)
    got = [(nm, list(b["x"])) for (nm, b), _ in zip(ml, range(8))]
    assert got == want[n:]
    for nm, ds in dss.items():
        first = next(x for name, x in got if name == nm)
        assert sorted(ds.reads[:bs]) == sorted(first)
    if n:                   # the skipped batches would be read first
        skipped = [x for name, x in want[:n] if name == names[0]][0]
        assert sorted(dss[names[0]].reads[:bs]) != sorted(skipped)


def test_compute_train_steps_equal():
    from vast_tpu_torch.config import EasyDict

    data = [{"batch_size": 8, "epoch": 3.6}, {"batch_size": 4, "steps": 5},
            {"batch_size": 16}]
    for run in ({}, {"num_train_steps": 30, "valid_freq": 4}):
        p_run, j_run = EasyDict(run), jconfig.EasyDict(run)
        assert ploader.compute_train_steps(data, p_run, [50, 9, 40]) == \
            jloader.compute_train_steps(data, j_run, [50, 9, 40])
        assert dict(p_run) == dict(j_run)


def test_full_batches_equal(synth):
    """Padding of the ragged last batch and the (nv, nvt) row accounting
    on a multi-caption eval loader, as vast_tpu's _full_batches."""
    pds, jds = _datasets(synth, False, txt=synth[3])
    kw = dict(shuffle=False, drop_last=False, num_workers=2)
    got = list(p_full(ploader.BatchLoader(pds, 4, **kw)))
    want = list(j_full(jloader.BatchLoader(jds, 4, **kw)))
    assert [(nv, nt) for _, nv, nt in got] == \
        [(nv, nt) for _, nv, nt in want] == [(4, 6), (4, 6), (2, 3)]
    for (g, _, _), (w, _, _) in zip(got, want):
        _equal_batches(g, w)


def test_rgb_to_yuv420_packed_equal_and_inverted():
    """The host's packed YUV420 planes equal vast_tpu's bit for bit, and
    the port's device expansion (ops/image.py yuv420_to_rgb) brings a
    smooth image back to within a few of its 0-255 levels."""
    import torch
    from PIL import Image

    from vast_tpu.data.vision import rgb_to_yuv420_packed as j_pack
    from vast_tpu_torch.data.vision import rgb_to_yuv420_packed
    from vast_tpu_torch.ops.image import yuv420_to_rgb

    small = (np.random.RandomState(1).rand(2, 2, 3) * 255).astype(np.uint8)
    img = np.asarray(Image.fromarray(small).resize((32, 32),
                                                   Image.BILINEAR))
    packed = rgb_to_yuv420_packed(img)
    np.testing.assert_array_equal(packed, j_pack(img))
    assert packed.shape == (32 * 32 * 3 // 2,) and packed.dtype == np.uint8
    back = yuv420_to_rgb(torch.from_numpy(packed)[None]).numpy()[0]
    assert back.shape == (32, 32, 3)
    # limited-range 8-bit planes step by 255/219 and 255/224 levels, and the
    # chroma is the mean of 2 x 2 pixels of a smooth gradient: a few levels
    # on average (1.5 measured)
    assert np.abs(back - img).mean() < 4
