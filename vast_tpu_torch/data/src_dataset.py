"""Tar-shard streaming dataset (the reference's data/IndexSrc.py).

The port's own copy of ``vast_tpu.data.src_dataset``. It streams (id,
image or video bytes, caption) records from ``.tar`` shards with
``tarfile``, warning and continuing past a bad shard, member or sample
(IndexSrc.py:140-144):

* the shards: a directory of tars, one ``.tar``, or a JSON list of tar
  paths (IndexSrc.py:150-156), split across hosts by index;
* the members: jpg/jpeg/png images or mp4/webm/mkv/avi/mov videos; a
  video gets split-segment frame sampling (``vision.decode_video_bytes``);
* the caption: an in-tar ``.txt`` or laion-style ``.json`` member, or by
  id from one JSON dict (``txt_format: json``) or from per-prefix sidecar
  files (``txt_format: dir``); an explicit lookup wins over the tar
  member, which is the fallback (IndexSrc.py:119-131);
* training order: the shards reshuffled every pass, then a replacement
  buffer of ``shuffle_buffer`` slots (webdataset's ``.shuffle(1000)``,
  IndexSrc.py:170), all drawn from one ``random.Random(seed + host_id)``.

The stream has no length; a training stream never ends.
"""

from __future__ import annotations

import io
import json
import os
import random
import tarfile

import numpy as np

from vast_tpu_torch.data.anno_dataset import AnnoIndexedDataset
from vast_tpu_torch.data.vision import (_native_runtime, _resize_short_side,
                                        decode_video_bytes,
                                        rgb_to_yuv420_packed)
from vast_tpu_torch.logger import LOGGER

_VIDEO_EXTS = ("mp4", "webm", "mkv", "avi", "mov")
_IMAGE_EXTS = ("jpg", "jpeg", "png")


def _resolve_shards(src: str) -> list[str]:
    """A directory of tars, one .tar, or a JSON list of tar paths
    (IndexSrc.py:150-156)."""
    if os.path.isdir(src):
        return sorted(os.path.join(src, f) for f in os.listdir(src)
                      if f.endswith(".tar"))
    if src.endswith(".json"):
        with open(src) as f:
            return list(json.load(f))
    return [src]


class SrcIndexedDataset:
    """An iterable over the samples of tar shards (image or video
    members), this host's share of them."""

    def __init__(self, d_cfg, args, tokenizer, host_id: int = 0,
                 num_hosts: int = 1):
        # with captions elsewhere (txt_format json/dir) "vision" holds
        # the shards; with captions in the tar either key may
        self.txt_format = d_cfg.get("txt_format", "tar")
        if self.txt_format in ("json", "dir"):
            shard_src = d_cfg["vision"]
        else:
            shard_src = d_cfg.get("vision") or d_cfg["txt"]
        self.shards = _resolve_shards(shard_src)[host_id::num_hosts]
        self.captions = None
        self.caption_dir = None
        if self.txt_format == "json":       # one dict: id -> caption(s)
            with open(d_cfg["txt"]) as f:
                self.captions = json.load(f)
        elif self.txt_format == "dir":      # per-prefix sidecar files
            self.caption_dir = d_cfg["txt"]
        self.d_cfg = d_cfg
        self.tokenizer = tokenizer
        self.cfg = args.model_cfg
        self.training = d_cfg.get("training", True)
        self.vision_format = d_cfg.get("vision_format", "image_rawimage")
        self.sample_num = d_cfg.get("vision_sample_num", 1)
        self.shuffle_buffer = d_cfg.get(
            "shuffle_buffer", 1000 if self.training else 0)
        self._rng = random.Random(args.run_cfg.get("seed", 50) + host_id)
        # VisionMapper's rule: 1.15x the model resolution when training
        # (the device's random crop needs the margin), 1x in evaluation
        res = args.model_cfg.vision_resolution
        self.host_size = int(res * 1.15) if self.training else int(res)
        # packed YUV420 needs the native runtime; image members are then
        # packed on the host, so that the stream keeps one format
        self.pixel_format = d_cfg.get("pixel_format", "rgb")
        if self.pixel_format == "yuv420":
            nat = _native_runtime()
            if nat is None or not nat.media_available():
                LOGGER.warning("%s: pixel_format yuv420 needs the native "
                               "runtime; falling back to rgb",
                               d_cfg.get("name", "src"))
                self.pixel_format = "rgb"
            elif self.host_size % 2:
                self.host_size += 1         # YUV420 planes need even sides

    @property
    def out_key(self) -> str:
        return ("vision_frames_yuv" if self.pixel_format == "yuv420"
                else "vision_frames")

    def __iter__(self):
        it = self._iter_ordered()
        if not (self.training and self.shuffle_buffer > 1):
            yield from it
            return
        # fill the buffer, then emit a random occupant for each incoming
        # sample, which takes its slot (webdataset's .shuffle(N))
        buf: list = []
        for s in it:
            if len(buf) < self.shuffle_buffer:
                buf.append(s)
                continue
            j = self._rng.randrange(len(buf))
            buf[j], s = s, buf[j]
            yield s
        self._rng.shuffle(buf)
        yield from buf

    def _iter_ordered(self):
        shards = list(self.shards)
        while True:
            if self.training:
                self._rng.shuffle(shards)
            for shard in shards:
                yield from self._iter_shard(shard)
            if not self.training:
                return

    def _iter_shard(self, shard):
        try:
            tf = tarfile.open(shard)
        except Exception as e:
            LOGGER.warning("bad shard %s: %s", shard, e)
            return
        with tf:
            current: dict = {}
            cur_key = None
            for member in tf:
                if not member.isfile():
                    continue
                key, ext = os.path.splitext(os.path.basename(member.name))
                if cur_key is not None and key != cur_key and current:
                    s = self._build(cur_key, current)
                    if s is not None:
                        yield s
                    current = {}
                cur_key = key
                try:
                    current[ext.lstrip(".").lower()] = \
                        tf.extractfile(member).read()
                except Exception as e:
                    LOGGER.warning("bad member %s: %s", member.name, e)
            if current and cur_key is not None:
                s = self._build(cur_key, current)
                if s is not None:
                    yield s

    def _lookup_caption(self, key: str):
        """The caption of ``key`` from the external txt source
        (IndexSrc.py:119-131), or None."""
        if self.captions is not None:                   # txt_format json
            cap = self.captions.get(key)
        elif self.caption_dir is not None:              # txt_format dir
            # <txt>/<id[:5]>.json holding {'<id[:5]>/<id>': caps} or
            # {'<id>': caps}
            p = os.path.join(self.caption_dir, key[:5] + ".json")
            if not os.path.exists(p):
                return None
            with open(p) as f:
                files = json.load(f)
            cap = files.get(key[:5] + "/" + key, files.get(key))
        else:
            return None
        if isinstance(cap, list):
            cap = self._rng.choice(cap) if cap else None
        return cap

    def _build(self, key, parts):
        try:
            sample = {"id": key}
            video_raw = next((parts[e] for e in _VIDEO_EXTS if e in parts),
                             None)
            image_raw = next((parts[e] for e in _IMAGE_EXTS if e in parts),
                             None)
            # vision_format picks the member of a mixed tar
            # (IndexSrc.py:163-166)
            if video_raw is not None and (
                    self.vision_format.startswith("video")
                    or image_raw is None):
                sample[self.out_key] = decode_video_bytes(
                    video_raw, self.sample_num, self.training,
                    self.host_size, self._rng,
                    yuv=self.pixel_format == "yuv420")
            elif image_raw is not None:
                from PIL import Image
                img = np.asarray(
                    Image.open(io.BytesIO(image_raw)).convert("RGB"),
                    np.uint8)
                # a host_size square: the packed planes' geometry too
                img = _resize_short_side(img, self.host_size)
                if self.pixel_format == "yuv420":
                    sample[self.out_key] = rgb_to_yuv420_packed(img)[None]
                else:
                    sample["vision_frames"] = img[None]
            cap = None
            if self.txt_format in ("json", "dir"):
                cap = self._lookup_caption(key)
            if cap is None and "txt" in parts:
                cap = parts["txt"].decode("utf-8", "replace").strip()
            if cap is None and "json" in parts:
                cap = json.loads(parts["json"]).get("caption", "")
            if cap is None:
                return None
            sample["raw_captions"] = cap
            sample["ids_txt"] = [key]
            return sample if self.out_key in sample else None
        except Exception as e:                          # IndexSrc.py:140
            LOGGER.warning("bad sample %s: %s", key, e)
            return None

    def collate(self, samples):
        """``AnnoIndexedDataset``'s batch layout."""
        return AnnoIndexedDataset.collate(self, samples)
