"""Annotation-JSON indexed dataset and its collate (the reference's
data/IndexAnno.py).

The port's own copy of ``vast_tpu.data.anno_dataset``. Each annotation
has an id (video_id / image_id / image / id), a caption (``desc`` or
``caption``, a list for multi-caption eval), an optional ``subtitle``
and optional ``question`` / ``answer``. A sample whose vision fails to
decode is replaced by a random one (IndexAnno.py:98-117). ``collate``
tokenizes on the host and returns numpy arrays of static shapes:
captions to ``max_caption_len`` (multi-caption rows flattened, with
``ids_txt`` one id per caption), subtitles to ``max_subtitle_len``.
"""

from __future__ import annotations

import json
import random

import numpy as np

from vast_tpu_torch.data.audio import AudioMapper
from vast_tpu_torch.data.tokenizer import BertTokenizer
from vast_tpu_torch.data.vision import VisionMapper
from vast_tpu_torch.logger import LOGGER


class AnnoIndexedDataset:
    def __init__(self, d_cfg, args, tokenizer: BertTokenizer):
        self.vision_mapper = VisionMapper(d_cfg, args) if "vision" in d_cfg else None
        self.audio_mapper = AudioMapper(d_cfg, args) if "audio" in d_cfg else None
        with open(d_cfg["txt"]) as f:
            self.annos = json.load(f)
        self.idx = list(range(len(self.annos)))
        self.dataset_name = d_cfg["name"]
        self.training = d_cfg["training"]
        self.tokenizer = tokenizer
        self.cfg = args.model_cfg
        self.annfile = d_cfg.get("annfile")
        self.d_cfg = d_cfg
        self._rng = random.Random(args.run_cfg.get("seed", 50))

    def __len__(self):
        return len(self.annos)

    def __getitem__(self, i):
        anno = self.annos[i]
        id_ = next(anno[k] for k in ("video_id", "image_id", "image", "id")
                   if k in anno)
        sample = {"id": id_}

        caption = anno.get("desc", anno.get("caption"))
        if caption is not None:
            sample["raw_captions"] = caption
            num = len(caption) if isinstance(caption, list) else 1
            sample["ids_txt"] = [id_] * num

        if "subtitle" in anno:
            sample["raw_subtitles"] = anno["subtitle"]

        if "question" in anno:
            sample["raw_questions"] = anno["question"]
            answer = anno["answer"]
            if self.training and isinstance(answer, list):  # vqav2
                answer = self._rng.choice(answer)
            sample["raw_answers"] = answer
            if "question_id" in anno:
                sample["question_id"] = anno["question_id"]

        if self.vision_mapper:
            pixels = self.vision_mapper.read(id_)
            if pixels is None:
                # resample in BOTH modes, like the reference
                # (IndexAnno.py:96-105: the testing-mode raise is
                # commented out there — it only logs louder). At eval
                # this distorts the metric sample set, so warn.
                resample = self._rng.choice(self.idx)
                log = LOGGER.info if self.training else LOGGER.warning
                log("%s: corrupt vision for %s, resampling %s%s",
                    self.dataset_name, id_, resample,
                    "" if self.training else " DURING EVAL — metrics "
                    "will cover a distorted sample set")
                return self[resample]
            # key is vision_frames (uint8 RGB) or vision_frames_yuv
            # (packed planes) depending on the mapper's pixel_format
            sample[self.vision_mapper.out_key] = pixels

        if self.audio_mapper:
            wav, valid = self.audio_mapper.read(id_)
            sample["audio_waveforms"] = wav
            sample["audio_valid"] = valid

        return sample

    # -- collate -------------------------------------------------------

    def collate(self, samples: list[dict]) -> dict:
        tok = self.tokenizer
        c = self.cfg
        batch: dict = {"ids": [s["id"] for s in samples]}

        if "raw_captions" in samples[0]:
            raws = [s["raw_captions"] for s in samples]
            batch["raw_captions"] = raws
            flat = [x for r in raws for x in (r if isinstance(r, list) else [r])]
            enc = tok(flat, max_length=c.max_caption_len)
            batch["caption_tokens"] = enc["input_ids"]
            batch["caption_attention_mask"] = enc["attention_mask"]
            batch["ids_txt"] = [i for s in samples for i in s["ids_txt"]]

        if "raw_subtitles" in samples[0]:
            subs = [s["raw_subtitles"] for s in samples]
            batch["raw_subtitles"] = subs
            enc = tok(subs, max_length=c.max_subtitle_len)
            batch["subtitle_tokens"] = enc["input_ids"]
            batch["subtitle_attention_mask"] = enc["attention_mask"]

        if "raw_questions" in samples[0]:
            qs = [s["raw_questions"] for s in samples]
            ans = [s["raw_answers"] for s in samples]
            batch["raw_questions"] = qs
            batch["raw_answers"] = ans
            qflat = [x for q in qs for x in (q if isinstance(q, list) else [q])]
            enc = tok(qflat, max_length=c.max_caption_len)
            batch["question_tokens"] = enc["input_ids"]
            batch["question_attention_mask"] = enc["attention_mask"]
            if self.training:
                aenc = tok(ans, max_length=10)  # model/vast.py:585 max 10
                batch["answer_tokens"] = aenc["input_ids"]
                batch["answer_attention_mask"] = aenc["attention_mask"]
            if "question_id" in samples[0]:
                batch["question_ids"] = [s["question_id"] for s in samples]

        for vk in ("vision_frames", "vision_frames_yuv"):
            if vk in samples[0]:
                batch[vk] = np.stack([s[vk] for s in samples])
                batch["vision_transforms"] = self.d_cfg.get(
                    "vision_transforms", "none")

        if "audio_waveforms" in samples[0]:
            batch["audio_waveforms"] = np.stack(
                [s["audio_waveforms"] for s in samples])
            batch["audio_valid"] = np.asarray(
                [s["audio_valid"] for s in samples], np.int32)

        return batch
