"""VAST for ``ret%tva`` retrieval inference.

Counterpart of ``vast_tpu.models.vast`` for the retrieval-inference
slice: on-device preprocessing (uint8 frames -> normalized pixels,
waveform -> kaldi fbank clips), EVA01 over the frames, BEATs over the
fbank, the BERT text encoder, the poolers and projection heads, the
feature DAG (``get_feature``) for the keys ``ret%tva`` needs, and the
ITM scores of the rerank (``compute_slice_scores(_grouped)``). Training
losses and the captioning / QA heads come in later slices and raise
``NotImplementedError``.

The module tree carries the reference torch state-dict names
(``vision_encoder.visual.*``, ``audio_encoder.*``,
``multimodal_encoder.bert.*``, ``itm_head.linear1``,
``contra_head_t.linear``, ``hidden_trans_vision_multimodal.0`` ...), so a
released VAST ``.pt`` loads with no converter.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from vast_tpu_torch.config import parse_task_string
from vast_tpu_torch.device import resolve_device
from vast_tpu_torch.models.beats import BeatsConfig, BeatsModel
from vast_tpu_torch.models.bert import BertConfig, BertForMaskedLM
from vast_tpu_torch.models.eva_vit import (EVA_PRESETS, EvaVisionTransformer,
                                           EvaVitConfig)
from vast_tpu_torch.ops.activations import gelu
from vast_tpu_torch.ops.fbank import kaldi_fbank
from vast_tpu_torch.ops.image import (CLIP_MEAN, CLIP_STD, preprocess_frames,
                                      yuv420_to_rgb)

# audio normalization stats per encoder (data/audio_mapper.py:19-24)
AUDIO_STATS = {"ast": (-4.2677393, 4.5689974), "beats": (15.41663, 6.55582)}


@dataclasses.dataclass(frozen=True)
class VASTConfig:
    vision_encoder_type: str = "evaclip01_giant"
    audio_encoder_type: str = "beats"
    contra_dim: int = 512
    max_vision_sample_num: int = 8
    max_audio_sample_num: int = 1
    vision_resolution: int = 224
    audio_melbins: int = 64
    audio_target_length: int = 1024
    dtype: torch.dtype = torch.float32
    # explicit sub-configs override the *_encoder_type presets (tiny tests)
    vision_cfg: Optional[Any] = None
    audio_cfg: Optional[Any] = None
    bert_cfg: Optional[BertConfig] = None

    def resolved_vision_cfg(self) -> EvaVitConfig:
        if self.vision_cfg is not None:
            return self.vision_cfg
        if self.vision_encoder_type not in EVA_PRESETS:
            raise NotImplementedError(
                f"vision encoder {self.vision_encoder_type} is not ported")
        return dataclasses.replace(EVA_PRESETS[self.vision_encoder_type],
                                   image_size=self.vision_resolution,
                                   dtype=self.dtype)

    def resolved_audio_cfg(self) -> BeatsConfig:
        if self.audio_cfg is not None:
            return self.audio_cfg
        if not self.audio_encoder_type.startswith("beats"):
            raise NotImplementedError(
                f"audio encoder {self.audio_encoder_type} is not ported")
        return BeatsConfig(dtype=self.dtype)

    def resolved_bert_cfg(self) -> BertConfig:
        return self.bert_cfg or BertConfig(dtype=self.dtype)


def _l2norm(x):
    return x / torch.linalg.vector_norm(x.float(), dim=-1,
                                        keepdim=True).to(x.dtype)


def _interp_nearest(embed, n: int):
    """(1, N, D) -> (1, n, D), F.interpolate(mode='nearest') semantics
    (general_module.py:484-493)."""
    src = embed.shape[1]
    if src == n:
        return embed
    return embed[:, (np.arange(n) * src // n).tolist()]


class ContraHead(nn.Module):
    """Bias-free projection stored as ``contra_head_*.linear``."""

    def __init__(self, d_in, d_out, **fk):
        super().__init__()
        self.linear = nn.Linear(d_in, d_out, bias=False, **fk)

    def forward(self, x):
        return self.linear(x)


class MatchHead(nn.Module):
    """Linear+GELU+LN+Linear->2 (general_module.py:34-42)."""

    def __init__(self, hidden, **fk):
        super().__init__()
        self.linear1 = nn.Linear(hidden, hidden, **fk)
        self.layernorm = nn.LayerNorm(hidden, eps=1e-12, **fk)
        self.linear2 = nn.Linear(hidden, 2, **fk)

    def forward(self, x):
        return self.linear2(self.layernorm(
            gelu(self.linear1(x), approximate=False)))


def _proj_ln(d_in, d_out, **fk):
    """Dense + LayerNorm(eps 1e-12): hidden_trans_*_multimodal.{0,1}."""
    return nn.Sequential(nn.Linear(d_in, d_out, **fk),
                         nn.LayerNorm(d_out, eps=1e-12, **fk))


class VASTModel(nn.Module):
    """VAST on ``device`` (None: the GPU; raises when there is none)."""

    def __init__(self, cfg: VASTConfig, device=None):
        super().__init__()
        self.device = resolve_device(device)
        dev = self.device
        self.cfg = c = cfg
        vc = c.resolved_vision_cfg()
        ac = c.resolved_audio_cfg()
        bc = c.resolved_bert_cfg()
        fk = dict(device=dev, dtype=c.dtype)

        self.vision_encoder = nn.ModuleDict(
            {"visual": EvaVisionTransformer(vc, dev)})
        self.audio_encoder = BeatsModel(ac, dev)
        self.multimodal_encoder = BertForMaskedLM(bc, dev)
        vd, ad, md = vc.width, ac.encoder_embed_dim, bc.hidden_size
        self.multimodal_dim = md

        d = c.contra_dim
        self.contra_head_t = ContraHead(md, d, **fk)
        self.contra_head_s = ContraHead(md, d, **fk)
        self.contra_head_v = ContraHead(vd, d, **fk)
        self.contra_head_a = ContraHead(ad, d, **fk)
        self.contra_head_va = nn.Linear(vd + ad, d, **fk)
        self.contra_head_vs = nn.Linear(vd + md, d, **fk)
        self.contra_head_vas = nn.Linear(vd + ad + md, d, **fk)
        self.contra_temp = nn.Parameter(torch.tensor(0.07, **fk))
        self.itm_head = MatchHead(md, **fk)
        self.vision_frame_embedding = nn.Parameter(
            torch.zeros(1, c.max_vision_sample_num, md, **fk))
        self.audio_frame_embedding = nn.Parameter(
            torch.zeros(1, c.max_audio_sample_num, md, **fk))
        self.hidden_trans_vision_multimodal = _proj_ln(vd, md, **fk)
        self.hidden_trans_audio_multimodal = _proj_ln(ad, md, **fk)
        self.hidden_trans_subtitle_multimodal = _proj_ln(md, md, **fk)
        self.vision_type_embeddings = nn.Parameter(torch.zeros(1, 1, md, **fk))
        self.audio_type_embeddings = nn.Parameter(torch.zeros(1, 1, md, **fk))
        self.subtitle_type_embeddings = nn.Parameter(
            torch.zeros(1, 1, md, **fk))

    # ---------------- encoders ----------------

    def forward_vision_encoder(self, pixels):
        """(B, n, H, W, 3) normalized -> (B, n, tokens, vision_dim)."""
        b, n = pixels.shape[:2]
        out = self.vision_encoder["visual"](pixels.flatten(0, 1))
        return out.view(b, n, *out.shape[1:])

    def forward_audio_encoder(self, spectrograms):
        """(B, n, T, M) -> (B, n, tokens, audio_dim)."""
        b, n = spectrograms.shape[:2]
        out = self.audio_encoder(spectrograms.flatten(0, 1))
        return out.view(b, n, *out.shape[1:])

    # ---------------- fusion-space inputs (gm.py:476-525) ----------------

    def _multimodal_input(self, output, proj, frame_embedding, type_embedding):
        b, n = output.shape[:2]
        x = proj(output) + _interp_nearest(frame_embedding, n)[:, :, None]
        return x.reshape(b, -1, self.multimodal_dim) + type_embedding

    # ---------------- on-device preprocessing (eval) ----------------

    def _preprocess_vision(self, batch):
        if "vision_frames" in batch:
            frames = batch["vision_frames"]            # uint8 (B, n, H, W, 3)
        else:
            frames = yuv420_to_rgb(batch["vision_frames_yuv"])
        return preprocess_frames(
            frames, self.cfg.vision_resolution, mean=CLIP_MEAN, std=CLIP_STD,
            transforms=str(batch.get("vision_transforms", "none")))

    def _preprocess_audio(self, batch):
        """waveform (B, S) at int16 scale -> (B, n, T, M) fbank clips:
        fbank, pad to a clip multiple, the centre clip of each of n even
        segments, normalize (data/audio_mapper.py:55-88, eval branch)."""
        c = self.cfg
        wav = batch["audio_waveforms"]
        n, t = c.max_audio_sample_num, c.audio_target_length
        fb = kaldi_fbank(wav, num_mel_bins=c.audio_melbins)
        mean, std = AUDIO_STATS["beats"]
        fb = (fb - mean) / (2.0 * std)
        frames = fb.shape[-2]
        total = max(1, -(-frames // t))
        fb = torch.nn.functional.pad(fb, (0, 0, 0, total * t - frames))
        bounds = np.linspace(0, total, n + 1)
        starts = bounds[:-1].astype(np.int64)
        sizes = np.maximum((bounds[1:] - bounds[:-1]).astype(np.int64), 1)
        idx = (starts + (sizes + 1) // 2 - 1).tolist()
        clips = fb.view(fb.shape[0], total, t, c.audio_melbins)[:, idx]
        if "audio_valid" in batch:
            valid = batch["audio_valid"].to(clips.dtype)
            clips = clips * valid[:, None, None, None]
        return clips

    # ---------------- feature DAG (model/vast.py:81-314) ----------------

    def get_feature(self, batch, key, cache):
        if key in cache:
            return cache[key]
        if key == "vision_pixels":
            val = batch.get("vision_pixels")
            if val is None:
                val = self._preprocess_vision(batch)
        elif key == "audio_spectrograms":
            val = batch.get("audio_spectrograms")
            if val is None:
                val = self._preprocess_audio(batch)
        elif key == "vision_output":
            val = self.forward_vision_encoder(
                self.get_feature(batch, "vision_pixels", cache))
        elif key == "audio_output":
            val = self.forward_audio_encoder(
                self.get_feature(batch, "audio_spectrograms", cache))
        elif key == "caption_output":
            val = self.multimodal_encoder.encode(
                batch["caption_tokens"], batch["caption_attention_mask"])
        elif key == "condition_feats_v":
            val = self._multimodal_input(
                self.get_feature(batch, "vision_output", cache),
                self.hidden_trans_vision_multimodal,
                self.vision_frame_embedding, self.vision_type_embeddings)
        elif key == "condition_feats_a":
            val = self._multimodal_input(
                self.get_feature(batch, "audio_output", cache),
                self.hidden_trans_audio_multimodal,
                self.audio_frame_embedding, self.audio_type_embeddings)
        elif key == "condition_feats_va":
            val = torch.cat([self.get_feature(batch, "condition_feats_v",
                                              cache),
                             self.get_feature(batch, "condition_feats_a",
                                              cache)], dim=1)
        elif key == "feat_t":
            co = self.get_feature(batch, "caption_output", cache)
            val = _l2norm(self.contra_head_t(co[:, 0]))
        elif key == "feat_va":
            vo = self.get_feature(batch, "vision_output", cache)
            ao = self.get_feature(batch, "audio_output", cache)
            pooled = torch.cat([vo[:, :, 0].mean(dim=1),       # CLS per frame
                                ao.mean(dim=2).mean(dim=1)], dim=1)
            val = _l2norm(self.contra_head_va(pooled))
        else:
            raise NotImplementedError(
                f"feature {key!r} is outside the ret%tva slice")
        cache[key] = val
        return val

    # ---------------- task forwards ----------------

    def forward_ret(self, batch, subtasks, compute_loss=False):
        if compute_loss:
            raise NotImplementedError("retrieval losses come with training")
        cache = {}
        out = {"feat_t": self.get_feature(batch, "feat_t", cache),
               "input_ids": batch["caption_tokens"],
               "attention_mask": batch["caption_attention_mask"]}
        for st in subtasks:
            out[f"feat_cond_{st}"] = self.get_feature(
                batch, f"feat_{st[1:]}", cache)
            out[f"condition_feats_{st}"] = self.get_feature(
                batch, f"condition_feats_{st[1:]}", cache)
        return out

    def text_features(self, caption_tokens, caption_attention_mask):
        """feat_t for a text-only chunk (the evaluation path)."""
        batch = {"caption_tokens": caption_tokens,
                 "caption_attention_mask": caption_attention_mask}
        return self.get_feature(batch, "feat_t", {})

    def condition_features(self, batch, subtasks):
        """{feat_cond_st, condition_feats_st} for the video/audio side."""
        cache, out = {}, {}
        for st in subtasks:
            out[f"feat_cond_{st}"] = self.get_feature(batch, f"feat_{st[1:]}",
                                                      cache)
            out[f"condition_feats_{st}"] = self.get_feature(
                batch, f"condition_feats_{st[1:]}", cache)
        return out

    def _itm_prob(self, fused):
        logits = self.itm_head(fused[:, 0]).float()
        return torch.softmax(logits, dim=1)[:, 1]

    def compute_slice_scores(self, condition_feats, input_ids,
                             attention_mask):
        """ITM softmax[:, 1] of each (text, condition) row pair."""
        return self._itm_prob(self.multimodal_encoder.encode(
            input_ids, attention_mask,
            encoder_hidden_states=condition_feats))

    def compute_slice_scores_grouped(self, condition_feats, input_ids,
                                     attention_mask):
        """ITM scores with per-candidate K/V reuse: ``input_ids`` (G*T, L)
        against ``condition_feats`` (G, Lc, D), text row g*T+j paired with
        candidate g; each candidate's cross K/V is projected once."""
        kv = self.multimodal_encoder.precompute_cross_kv(condition_feats)
        return self._itm_prob(self.multimodal_encoder.encode(
            input_ids, attention_mask, cross_kv=kv))

    def forward(self, batch, task: str, compute_loss: bool = False):
        out = {}
        for head, subtasks in parse_task_string(task):
            if not head.startswith("ret"):
                raise NotImplementedError(f"task head {head!r} is not ported")
            out.update(self.forward_ret(batch, subtasks, compute_loss))
        return out
