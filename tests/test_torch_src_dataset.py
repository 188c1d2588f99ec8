"""The tar-shard streams (``srcindexed``): the port against vast_tpu.

Case for case as ``tests/test_src_dataset.py`` holds vast_tpu's
``SrcIndexedDataset``, the port's runs beside it on the same synthetic
shards: the same sample ids in the same order (the shard shuffle and the
shuffle buffer from the same seed), the same frames (exactly equal uint8
or packed YUV420) and the same captions; ``txt_format`` json, dir and the
tar member's fallback; a JSON list of shards; host sharding;
warn-and-continue past a corrupt member; the yuv420 wire and its
fallback to rgb without the native runtime; video members through
``decode_video_bytes`` (skipped where the native media runtime is
absent, as the JAX tests are); the collated batch. Then
``StreamBatchLoader``: its batches equal vast_tpu's, an exception in the
producer reaches the consumer, and ``iter_from(k)`` gives the batches
after the first k.
"""

import itertools
import json
import random
import tarfile
import threading

import numpy as np
import pytest

from tests.test_src_dataset import (_media_available, make_args,
                                    make_image_shard_no_txt, make_shard,
                                    make_video_shard)
from vast_tpu.data import loader as j_loader
from vast_tpu.data import src_dataset as j_src
from vast_tpu.data import vision as j_vision
from vast_tpu.data.tokenizer import tiny_tokenizer as j_tiny_tokenizer
from vast_tpu_torch.config import EasyDict
from vast_tpu_torch.data import data_registry
from vast_tpu_torch.data import loader as p_loader
from vast_tpu_torch.data import src_dataset as p_src
from vast_tpu_torch.data import vision as p_vision
from vast_tpu_torch.data.tokenizer import tiny_tokenizer

needs_media = pytest.mark.skipif(not _media_available(),
                                 reason="native media runtime unavailable")


def port_args(seed=0):
    a = make_args()
    return EasyDict({"model_cfg": EasyDict(a.model_cfg),
                     "run_cfg": EasyDict(seed=seed)})


def both(d_cfg, **kw):
    """(vast_tpu's dataset, the port's) over ``d_cfg``."""
    return (j_src.SrcIndexedDataset(d_cfg, make_args(), j_tiny_tokenizer(),
                                    **kw),
            p_src.SrcIndexedDataset(d_cfg, port_args(), tiny_tokenizer(),
                                    **kw))


def assert_same_samples(got, want):
    assert [s["id"] for s in got] == [s["id"] for s in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), g["id"]
        assert g["raw_captions"] == w["raw_captions"]
        assert g["ids_txt"] == w["ids_txt"]
        for k in ("vision_frames", "vision_frames_yuv"):
            if k in w:
                assert g[k].dtype == w[k].dtype == np.uint8
                np.testing.assert_array_equal(g[k], w[k], err_msg=g["id"])


def image_cfg(src, **kw):
    return {"type": "srcindexed", "training": False, "name": "laion",
            "txt": str(src), "vision_format": "image_rawimage",
            "task": "ret%tv", "batch_size": 2} | kw


def test_registry_gives_the_stream():
    assert data_registry["srcindexed"] is p_src.SrcIndexedDataset


def test_streams_samples_across_shards(tmp_path):
    make_shard(str(tmp_path / "s0.tar"), 3, 0)
    make_shard(str(tmp_path / "s1.tar"), 3, 3)
    j, p = both(image_cfg(tmp_path))
    got = list(p)
    assert_same_samples(got, list(j))
    assert len(got) == 6 and got[0]["vision_frames"].shape == (
        1, p.host_size, p.host_size, 3)
    assert p.host_size == j.host_size == 32          # eval: 1x, 32 px


def test_warn_and_continue_on_corrupt(tmp_path, caplog):
    make_shard(str(tmp_path / "s0.tar"), 3, 0, corrupt_one=True)
    with open(tmp_path / "s1.tar", "wb") as f:
        f.write(b"not a tar")                            # a bad shard
    j, p = both(image_cfg(tmp_path))
    got = list(p)
    assert_same_samples(got, list(j))
    assert [s["id"] for s in got] == ["img00001", "img00002"]
    text = caplog.text
    assert "bad sample img00000" in text and "bad shard" in text


def test_host_sharding(tmp_path):
    for i in range(4):
        make_shard(str(tmp_path / f"s{i}.tar"), 1, i)
    seen = []
    for host in (0, 1):
        j, p = both(image_cfg(tmp_path, batch_size=1), host_id=host,
                    num_hosts=2)
        got = list(p)
        assert_same_samples(got, list(j))
        seen.append({s["id"] for s in got})
    assert not seen[0] & seen[1] and len(seen[0] | seen[1]) == 4


def test_txt_format_dir_sidecars(tmp_path):
    shard_dir, cap_dir = tmp_path / "shards", tmp_path / "caps"
    shard_dir.mkdir()
    cap_dir.mkdir()
    make_image_shard_no_txt(str(shard_dir / "s0.tar"),
                            ["abcde001", "abcde002", "zzzzz001", "nocap001"])
    with open(cap_dir / "abcde.json", "w") as f:
        json.dump({"abcde/abcde001": ["cap one a", "cap one b"],
                   "abcde002": ["cap two"]}, f)
    with open(cap_dir / "zzzzz.json", "w") as f:
        json.dump({"zzzzz001": ["cap three"]}, f)
    j, p = both(image_cfg(shard_dir, name="laion400m", vision=str(shard_dir),
                          txt=str(cap_dir), txt_format="dir"))
    got = list(p)
    assert_same_samples(got, list(j))
    assert {s["id"] for s in got} == {"abcde001", "abcde002", "zzzzz001"}


def test_txt_format_json_dict(tmp_path):
    shard_dir = tmp_path / "shards"
    shard_dir.mkdir()
    make_image_shard_no_txt(str(shard_dir / "s0.tar"),
                            ["img00001", "img00002"])
    cap_path = tmp_path / "caps.json"
    with open(cap_path, "w") as f:
        json.dump({"img00001": "first caption", "img00002": "second one"}, f)
    j, p = both(image_cfg(shard_dir, name="cc12m", vision=str(shard_dir),
                          txt=str(cap_path), txt_format="json"))
    got = list(p)
    assert_same_samples(got, list(j))
    assert {s["id"]: s["raw_captions"] for s in got} == {
        "img00001": "first caption", "img00002": "second one"}


def test_txt_format_json_overrides_tar_member(tmp_path):
    """The lookup wins over an in-tar .txt; the member is the fallback
    where the lookup misses; a laion .json member serves too."""
    shard_dir = tmp_path / "shards"
    shard_dir.mkdir()
    make_shard(str(shard_dir / "s0.tar"), 2, 0)
    with tarfile.open(shard_dir / "s1.tar", "w") as tf:
        from io import BytesIO

        for name, data in (("meta01.jpg", b""), ("meta01.json",
                           json.dumps({"caption": "from json"}).encode())):
            if name.endswith(".jpg"):
                from tests.test_src_dataset import _image_member
                data = _image_member(np.random.RandomState(4))
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, BytesIO(data))
    cap_path = tmp_path / "caps.json"
    with open(cap_path, "w") as f:
        json.dump({"img00000": "json wins"}, f)
    j, p = both(image_cfg(shard_dir, name="cc12m", vision=str(shard_dir),
                          txt=str(cap_path), txt_format="json"))
    got = list(p)
    assert_same_samples(got, list(j))
    caps = {s["id"]: s["raw_captions"] for s in got}
    assert caps == {"img00000": "json wins",
                    "img00001": "a man in the park 1",
                    "meta01": "from json"}


def test_shard_list_from_json(tmp_path):
    make_shard(str(tmp_path / "s0.tar"), 2, 0)
    make_shard(str(tmp_path / "s1.tar"), 2, 2)
    lst = tmp_path / "tars.json"
    with open(lst, "w") as f:
        json.dump([str(tmp_path / "s1.tar"), str(tmp_path / "s0.tar")], f)
    j, p = both(image_cfg(tmp_path, vision=str(lst)))
    got = list(p)
    assert_same_samples(got, list(j))
    assert [s["id"] for s in got][:2] == ["img00002", "img00003"]


def test_shuffle_buffer_and_shard_shuffle_match(tmp_path):
    """Training: the shards reshuffled every pass and a replacement buffer
    of 8 slots, from random.Random(seed + host_id): three passes over two
    shards come out in vast_tpu's order, not in tar order; the host size
    is 1.15 x the resolution."""
    make_shard(str(tmp_path / "s0.tar"), 8, 0)
    make_shard(str(tmp_path / "s1.tar"), 8, 8)
    j, p = both(image_cfg(tmp_path, training=True, shuffle_buffer=8))
    got = list(itertools.islice(iter(p), 48))
    assert_same_samples(got, list(itertools.islice(iter(j), 48)))
    ids = [s["id"] for s in got]
    assert ids[:16] != sorted(ids[:16])
    assert p.host_size == j.host_size == int(32 * 1.15)


def test_yuv420_falls_back_to_rgb_without_the_runtime(tmp_path, monkeypatch,
                                                      caplog):
    make_shard(str(tmp_path / "s0.tar"), 2, 0)
    monkeypatch.setattr(j_vision, "_native_runtime", lambda: None)
    monkeypatch.setattr(p_src, "_native_runtime", lambda: None)
    j, p = both(image_cfg(tmp_path, pixel_format="yuv420"))
    assert p.pixel_format == j.pixel_format == "rgb"
    assert p.out_key == "vision_frames"
    assert_same_samples(list(p), list(j))
    assert "falling back to rgb" in caplog.text


def test_collate_matches(tmp_path):
    make_shard(str(tmp_path / "s0.tar"), 3, 0)
    j, p = both(image_cfg(tmp_path))
    got, want = p.collate(list(p)), j.collate(list(j))
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@needs_media
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_video_tar_members_match(tmp_path, training):
    """mp4 members through decode_video_bytes: segment centres in
    evaluation, a random frame of each segment in training (the same
    draws from the same seed), equal frames."""
    make_video_shard(str(tmp_path / "v0.tar"), 2, 0, n_frames=40)
    j, p = both({"type": "srcindexed", "training": training,
                 "name": "webvid", "vision": str(tmp_path),
                 "vision_format": "video_rawvideo", "vision_sample_num": 4,
                 "task": "ret%tv", "batch_size": 2, "shuffle_buffer": 0})
    got = list(itertools.islice(iter(p), 2))
    assert_same_samples(got, list(itertools.islice(iter(j), 2)))
    assert got[0]["vision_frames"].shape == (4, p.host_size, p.host_size, 3)
    means = got[0]["vision_frames"].reshape(4, -1).mean(axis=1)
    assert (np.diff(means) > 0).all(), means


@needs_media
def test_decode_video_bytes_matches(tmp_path):
    make_video_shard(str(tmp_path / "v0.tar"), 1, 0, n_frames=30)
    with tarfile.open(tmp_path / "v0.tar") as tf:
        blob = next(tf.extractfile(m).read() for m in tf
                    if m.name.endswith(".mp4"))
    for training in (False, True):
        for yuv in (False, True):
            got = p_vision.decode_video_bytes(blob, 5, training, 36,
                                              random.Random(3), yuv=yuv)
            want = j_vision.decode_video_bytes(blob, 5, training, 36,
                                               random.Random(3), yuv=yuv)
            np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError):
        p_vision.decode_video_bytes(b"garbage", 2, False, 36)


def test_decode_video_bytes_refuses_without_a_decoder(monkeypatch):
    """No runtime, no decord, no ffmpeg: raises, as vast_tpu does; yuv
    needs the runtime."""
    monkeypatch.setattr(p_vision, "_native_runtime", lambda: None)
    monkeypatch.setattr(p_vision.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="native media runtime"):
        p_vision.decode_video_bytes(b"x", 2, False, 32, yuv=True)
    with pytest.raises(RuntimeError, match="decord, or ffmpeg"):
        p_vision.decode_video_bytes(b"x", 2, False, 32)


@needs_media
def test_video_tar_yuv420_wire(tmp_path):
    make_video_shard(str(tmp_path / "v0.tar"), 2, 0, n_frames=40)
    j, p = both({"type": "srcindexed", "training": False, "name": "webvid",
                 "vision": str(tmp_path), "vision_format": "video_rawvideo",
                 "vision_sample_num": 4, "task": "ret%tv", "batch_size": 2,
                 "pixel_format": "yuv420"})
    assert p.out_key == "vision_frames_yuv" and p.host_size % 2 == 0
    got = list(p)
    assert_same_samples(got, list(j))
    t = p.host_size
    assert got[0]["vision_frames_yuv"].shape == (4, t * t * 3 // 2)


@needs_media
def test_image_tar_yuv420_host_pack(tmp_path):
    make_shard(str(tmp_path / "i0.tar"), 2, 0)
    j, p = both(image_cfg(tmp_path, name="cc", vision=str(tmp_path),
                          pixel_format="yuv420"))
    got = list(p)
    assert_same_samples(got, list(j))
    t = p.host_size
    assert got[0]["vision_frames_yuv"].shape == (1, t * t * 3 // 2)


def _stream_pair(tmp_path, n=10, batch=3, **kw):
    make_shard(str(tmp_path / "s0.tar"), n, 0)
    j, p = both(image_cfg(tmp_path, **kw))
    return (j_loader.StreamBatchLoader(j, batch),
            p_loader.StreamBatchLoader(p, batch))


def test_stream_batch_loader_matches(tmp_path):
    """Evaluation: batches of 3 and a last one of 1, as vast_tpu's."""
    jl, pl = _stream_pair(tmp_path)
    got, want = list(pl), list(jl)
    assert [len(b["ids"]) for b in got] == [3, 3, 3, 1]
    assert [b["ids"] for b in got] == [b["ids"] for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["vision_frames"], w["vision_frames"])
        np.testing.assert_array_equal(g["caption_tokens"],
                                      w["caption_tokens"])


def test_stream_batch_loader_resumes_by_reading_and_dropping(tmp_path):
    """Training (an endless stream with its shuffle buffer): iter_from(k)
    on a fresh loader gives the batches an unbroken run reads after its
    first k, bit for bit."""
    make_shard(str(tmp_path / "s0.tar"), 7, 0)
    cfg = image_cfg(tmp_path, training=True, shuffle_buffer=4)

    def loader():
        return p_loader.StreamBatchLoader(
            p_src.SrcIndexedDataset(cfg, port_args(), tiny_tokenizer()), 3)

    whole = list(itertools.islice(iter(loader()), 6))
    resumed = list(itertools.islice(loader().iter_from(4), 2))
    assert [b["ids"] for b in resumed] == [b["ids"] for b in whole[4:]]
    for g, w in zip(resumed, whole[4:]):
        np.testing.assert_array_equal(g["vision_frames"], w["vision_frames"])


def test_stream_batch_loader_raises_the_producers_error():
    class Broken:
        def __iter__(self):
            yield {"id": 1}
            raise OSError("shard vanished")

        def collate(self, samples):
            return samples

    with pytest.raises(OSError, match="shard vanished"):
        list(p_loader.StreamBatchLoader(Broken(), 4))


def test_stream_batch_loader_stops_when_the_consumer_leaves():
    """A consumer that takes one batch and leaves: the producer, blocked on
    the full queue, sees the stop and ends."""
    done = threading.Event()

    class Endless:
        def __iter__(self):
            try:
                for i in itertools.count():
                    yield {"id": i}
            finally:
                done.set()

        def collate(self, samples):
            return samples

    it = iter(p_loader.StreamBatchLoader(Endless(), 2, prefetch=1))
    assert [s["id"] for s in next(it)] == [0, 1]
    it.close()
    assert done.wait(5.0)
