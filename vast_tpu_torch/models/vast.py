"""VAST for retrieval (``ret%tv``, ``ta``, ``tva``, ``tvs``, ``tvas``),
captioning (``cap%…``) and QA (``qa%…``): inference and the training
losses.

Counterpart of ``vast_tpu.models.vast``:
on-device preprocessing (uint8 frames -> normalized pixels, with the
random crop and flip when training; waveform -> kaldi fbank clips, a
random clip per segment when training), a vision tower over the frames
(EVA01, or a CLIP ViT: ``vision_encoder_type``), an audio tower over the
fbank (BEATs, or AST: ``audio_encoder_type``), the BERT text encoder
(captions, the vast27m per-modality caption streams and subtitles), the
poolers and projection heads, the feature DAG (``get_feature``,
vast.py:436-539 of ``vast_tpu``), the ITM
scores of the rerank (``compute_slice_scores(_grouped)``), and the ITC +
ITM losses of ``forward_ret(compute_loss=True)`` (vast.py:564-623), and
the masked-LM losses of ``forward_cap`` and ``forward_qa`` (vast.py:
625-711; their generation is ``models/generation.py``). The vision
towers are every one ``vast_tpu`` picks by ``vision_encoder_type``
(vast.py:139-157): EVA01-g, EVA02 B and L, EVA02-bigE
(``models/eva_vit.py``), the CLIP ViTs (``clip_vit.py``), Swin B and L
(``swin.py``; ImageNet statistics, mean pooling) and VideoSwin
(``videoswin.py``: the whole clip at once, ImageNet statistics, mean
pooling).

Randomness: a training forward takes the step's CPU ``torch.Generator``
(``generator``); None is the deterministic (eval) forward. The order of
draws differs from ``vast_tpu``'s key split, so the two agree on random
draws in distribution only; the tests inject what they compare
(``itm_neg_cond_idx`` / ``itm_neg_text_idx``, the masked captions and
answers ``{caption,answer}_masked_{tokens,labels}``, or configurations
with no draw).

The module tree carries the reference torch state-dict names
(``vision_encoder.visual.*``, Swin's and VideoSwin's
``vision_encoder.*``, ``audio_encoder.*``,
``multimodal_encoder.bert.*``, ``itm_head.linear1``,
``contra_head_t.linear``, ``hidden_trans_vision_multimodal.0`` ...; AST
as ``audio_embeddings.*`` + ``audio_encoder.*``), so a released VAST
``.pt`` loads with no converter.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from vast_tpu_torch import parallel
from vast_tpu_torch.config import parse_task_string
from vast_tpu_torch.device import resolve_device
from vast_tpu_torch.models import layers
from vast_tpu_torch.models.ast import AstConfig, AstModel
from vast_tpu_torch.models.beats import BeatsConfig, BeatsModel
from vast_tpu_torch.models.bert import BertConfig, BertForMaskedLM, mlm_loss
from vast_tpu_torch.models.clip_vit import (CLIP_PRESETS,
                                            ClipVisionTransformer,
                                            ClipVitConfig)
from vast_tpu_torch.models.eva_vit import (EVA_PRESETS, EvaVisionTransformer,
                                           EvaVitConfig)
from vast_tpu_torch.models.swin import (SWIN_PRESETS, SwinConfig,
                                        SwinTransformer)
from vast_tpu_torch.models.videoswin import (VideoSwinConfig,
                                             VideoSwinTransformer)
from vast_tpu_torch.ops.activations import gelu
from vast_tpu_torch.ops.fbank import ast_fbank, kaldi_fbank
from vast_tpu_torch.ops.image import (CLIP_MEAN, CLIP_STD, IMAGENET_MEAN,
                                      IMAGENET_STD, preprocess_frames,
                                      yuv420_to_rgb)
from vast_tpu_torch.ops.masking import IGNORE_LABEL, mask_tokens
from vast_tpu_torch.parallel import collectives

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
    max_caption_len: int = 40
    max_omni_caption_len: int = 70
    max_subtitle_len: int = 70
    # "adaptive": the vision frame embedding is added (vast.py:350)
    frame_embedding_type: str = "adaptive"
    itm_ratio: float = 0.1
    label_smoothing: float = 0.1
    # generation (evaluation/evaluation_mm.py): beams of a caption or an
    # answer; captioner_mode samples generate_nums captions a clip
    beam_size: int = 3
    captioner_mode: bool = False
    generate_nums: int = 1
    # the tokenizer's [MASK] id, set from it by pipeline.build_model; 103
    # in the released bert-base-uncased vocabulary
    mask_token_id: int = 103
    # activation checkpointing of every encoder block (models/remat.py);
    # 'attn' is the flagship training policy (bench.py:473-477)
    checkpointing: bool = False
    remat_policy: str = "attn"
    frozen_vision: bool = False
    frozen_audio: bool = False
    dtype: torch.dtype = torch.float32        # compute
    param_dtype: Optional[torch.dtype] = None  # None: dtype (inference)
    # explicit sub-configs override the *_encoder_type presets (tiny tests)
    vision_cfg: Optional[Any] = None
    audio_cfg: Optional[Any] = None
    bert_cfg: Optional[BertConfig] = None

    @property
    def pdtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype

    @classmethod
    def from_model_cfg(cls, m, dtype=torch.float32, param_dtype=None):
        """From a merged model_cfg (``config.get_args``), as
        ``vast_tpu``'s ``VASTConfig.from_model_cfg`` (vast.py:108-137):
        the keys that name a field. Dicts under
        ``vision_cfg`` / ``audio_cfg`` / ``bert_cfg`` (scaled-down
        configs) become the tower's config with ``dtype`` and
        ``param_dtype``; ``checkpointing`` and ``remat_policy`` reach the
        preset towers only, as in ``vast_tpu``."""
        keys = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in dict(m).items() if k in keys}
        kw.update(dtype=dtype, param_dtype=param_dtype)
        sub = dict(dtype=dtype, param_dtype=param_dtype)
        vtype = kw.get("vision_encoder_type", cls.vision_encoder_type)
        atype = kw.get("audio_encoder_type", cls.audio_encoder_type)
        if isinstance(kw.get("vision_cfg"), dict):
            kw["vision_cfg"] = _tower_config(_vision_config_class(vtype),
                                             kw["vision_cfg"], sub)
        if isinstance(kw.get("audio_cfg"), dict):
            ac_cls = AstConfig if atype.startswith("ast") else BeatsConfig
            kw["audio_cfg"] = _tower_config(ac_cls, kw["audio_cfg"], sub)
        if isinstance(kw.get("bert_cfg"), dict):
            kw["bert_cfg"] = _tower_config(BertConfig, kw["bert_cfg"], sub)
        return cls(**kw)

    def _sub(self):
        return dict(dtype=self.dtype, param_dtype=self.param_dtype,
                    remat=self.checkpointing, remat_policy=self.remat_policy)

    def resolved_vision_cfg(self):
        """The tower's config (vast.py:139-157): a preset by
        ``vision_encoder_type`` at ``vision_resolution``; VideoSwin's has
        no resolution."""
        if self.vision_cfg is not None:
            return self.vision_cfg
        t = self.vision_encoder_type
        if t.startswith("videoswin"):
            return VideoSwinConfig(**self._sub())
        if t.startswith("evaclip"):
            presets = EVA_PRESETS
        elif t.startswith("clip"):
            presets = CLIP_PRESETS
        elif t.startswith("swin"):
            presets = SWIN_PRESETS
        else:
            raise NotImplementedError(f"vision encoder {t}")
        return dataclasses.replace(presets[t],
                                   image_size=self.vision_resolution,
                                   **self._sub())

    @property
    def vision_is_clip(self) -> bool:
        """A CLIP-family tower (CLIP's statistics, its CLS token pooled);
        Swin and VideoSwin take ImageNet's and mean-pool."""
        return self.vision_encoder_type.startswith(("clip", "evaclip"))

    def resolved_audio_cfg(self):
        if self.audio_cfg is not None:
            return self.audio_cfg
        t = self.audio_encoder_type
        if t.startswith("beats"):
            return BeatsConfig(**self._sub())
        if t.startswith("ast"):
            return AstConfig(audio_melbins=self.audio_melbins,
                             audio_target_length=self.audio_target_length,
                             **self._sub())
        raise NotImplementedError(f"audio encoder {t} is not ported")

    @property
    def audio_is_ast(self) -> bool:
        return self.audio_encoder_type.startswith("ast")

    def resolved_bert_cfg(self) -> BertConfig:
        return self.bert_cfg or BertConfig(**self._sub())


def _vision_config_class(vtype: str):
    """The config class of a ``vision_cfg`` dict (vast.py:124-133)."""
    if vtype.startswith("clip"):
        return ClipVitConfig
    if vtype.startswith("videoswin"):
        return VideoSwinConfig
    if vtype.startswith("swin"):
        return SwinConfig
    return EvaVitConfig


# keys of vast_tpu's tower configs that its towers read nowhere
_UNREAD_KEYS = {"BertConfig": ("attention_probs_dropout_prob",),
                "BeatsConfig": ("dropout",)}


def _tower_config(cls, d: dict, sub: dict):
    """``cls`` from a model_cfg dict; a key the port's tower does not
    have raises, unless ``vast_tpu`` reads it nowhere either."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unread = _UNREAD_KEYS.get(cls.__name__, ())
    unknown = sorted(k for k in d if k not in fields and k not in unread)
    if unknown:
        raise NotImplementedError(f"{cls.__name__}: {unknown} are not "
                                  f"ported")
    return cls(**{k: v for k, v in d.items() if k in fields}, **sub)


def _entry(fn):
    """An entry point of ``VASTModel``: under parameter sharding
    (``parallel/fsdp.py``) it runs with the model's own split parameters
    gathered (``gather_own``, set by ``shard_state``)."""

    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        gather = self.__dict__.get("gather_own")
        if gather is None:
            return fn(self, *args, **kwargs)
        with gather():
            return fn(self, *args, **kwargs)
    return run


def label_smoothed_ce(logits, targets, smoothing: float):
    """Cross entropy with label smoothing, in fp32 (vast.py:180-187,
    torch ``F.cross_entropy`` semantics)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


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
        self.linear = layers.Linear(d_in, d_out, bias=False, **fk)

    def forward(self, x):
        return self.linear(x)


class MatchHead(nn.Module):
    """Linear+GELU+LN+Linear->2 (general_module.py:34-42)."""

    def __init__(self, hidden, **fk):
        super().__init__()
        self.linear1 = layers.Linear(hidden, hidden, **fk)
        self.layernorm = layers.LayerNorm(hidden, eps=1e-12, **fk)
        self.linear2 = layers.Linear(hidden, 2, **fk)

    def forward(self, x):
        return self.linear2(self.layernorm(
            gelu(self.linear1(x), approximate=False)))


def _proj_ln(d_in, d_out, **fk):
    """Dense + LayerNorm(eps 1e-12): hidden_trans_*_multimodal.{0,1}."""
    return nn.Sequential(layers.Linear(d_in, d_out, **fk),
                         layers.LayerNorm(d_out, eps=1e-12, **fk))


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
        fk = dict(device=dev, dtype=c.pdtype)

        if isinstance(vc, (SwinConfig, VideoSwinConfig)):
            # the reference's top-level vision_encoder.* (vast_ckpt.py:
            # 276-347)
            self.vision_encoder = (
                SwinTransformer(vc, dev) if isinstance(vc, SwinConfig)
                else VideoSwinTransformer(vc, dev, c.max_vision_sample_num,
                                          c.vision_resolution))
            vd = vc.num_features
        else:
            vision = (ClipVisionTransformer if isinstance(vc, ClipVitConfig)
                      else EvaVisionTransformer)
            self.vision_encoder = nn.ModuleDict({"visual": vision(vc, dev)})
            vd = vc.width
        if isinstance(ac, AstConfig):
            # the reference's two top-level AST modules (vast_ckpt.py:184)
            ast = AstModel(ac, dev)
            self.audio_embeddings = ast.audio_embeddings
            self.audio_encoder = ast.audio_encoder
            ad = ac.hidden_size
        else:
            self.audio_encoder = BeatsModel(ac, dev)
            ad = ac.encoder_embed_dim
        self.multimodal_encoder = BertForMaskedLM(bc, dev)
        md = bc.hidden_size
        self.multimodal_dim = md

        d = c.contra_dim
        self.contra_head_t = ContraHead(md, d, **fk)
        self.contra_head_s = ContraHead(md, d, **fk)
        self.contra_head_v = ContraHead(vd, d, **fk)
        self.contra_head_a = ContraHead(ad, d, **fk)
        self.contra_head_va = layers.Linear(vd + ad, d, **fk)
        self.contra_head_vs = layers.Linear(vd + md, d, **fk)
        self.contra_head_vas = layers.Linear(vd + ad + md, d, **fk)
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
        # the ranks that split the batch (training/step.py shard_state
        # sets the mesh's data group; None: the default group)
        self.data_group = None

    # ---------------- encoders ----------------

    @property
    def vision_tower(self) -> nn.Module:
        enc = self.vision_encoder
        return enc["visual"] if isinstance(enc, nn.ModuleDict) else enc

    def forward_vision_encoder(self, pixels, generator=None):
        """(B, n, H, W, 3) normalized -> (B, n, tokens, vision_dim): the
        frames fold into the batch; VideoSwin takes the whole clip and
        gives (B, T', tokens, dim) (vast.py:301-307). Frozen
        (``frozen_vision``): no gradient and no drop-path."""
        b, n = pixels.shape[:2]
        frozen = self.cfg.frozen_vision
        g = None if frozen else generator
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            if isinstance(self.vision_tower, VideoSwinTransformer):
                return self.vision_tower(pixels, g)
            out = self.vision_tower(pixels.flatten(0, 1), g)
        return out.view(b, n, *out.shape[1:])

    def forward_audio_encoder(self, spectrograms):
        """(B, n, T, M) -> (B, n, tokens, audio_dim). Frozen
        (``frozen_audio``): no gradient."""
        b, n = spectrograms.shape[:2]
        frozen = self.cfg.frozen_audio
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            x = spectrograms.flatten(0, 1)
            if self.cfg.audio_is_ast:
                x = self.audio_embeddings(x)
            out = self.audio_encoder(x)
        return out.view(b, n, *out.shape[1:])

    # ---------------- pooling (general_module.py:426-449) --------------

    def pool_vision_for_contra(self, feature):
        """The CLS token per frame, averaged over the frames; Swin and
        VideoSwin have none: the mean over tokens, then frames
        (vast.py:331-335)."""
        if not self.cfg.vision_is_clip:
            return feature.mean(dim=2).mean(dim=1)
        return feature[:, :, 0].mean(dim=1)

    def pool_audio_for_contra(self, feature):
        """AST's CLS token, BEATs' token mean; averaged over the clips."""
        if self.cfg.audio_is_ast:
            return feature[:, :, 0].mean(dim=1)
        return feature.mean(dim=2).mean(dim=1)

    def pool_text_for_contra(self, feature):
        return feature[:, 0]

    # ---------------- fusion-space inputs (gm.py:476-525) ----------------

    def _multimodal_input(self, output, proj, frame_embedding,
                          type_embedding):
        b, n = output.shape[:2]
        x = proj(output)
        if frame_embedding is not None:
            x = x + _interp_nearest(frame_embedding, n)[:, :, None].to(
                x.dtype)
        return (x.reshape(b, -1, self.multimodal_dim)
                + type_embedding.to(x.dtype))

    def get_multimodal_forward_input_vision(self, vision_output):
        adaptive = self.cfg.frame_embedding_type == "adaptive"
        return self._multimodal_input(
            vision_output, self.hidden_trans_vision_multimodal,
            self.vision_frame_embedding if adaptive else None,
            self.vision_type_embeddings)

    def get_multimodal_forward_input_audio(self, audio_output):
        return self._multimodal_input(
            audio_output, self.hidden_trans_audio_multimodal,
            self.audio_frame_embedding, self.audio_type_embeddings)

    def get_multimodal_forward_input_subtitle(self, subtitle_output):
        x = self.hidden_trans_subtitle_multimodal(subtitle_output)
        return x + self.subtitle_type_embeddings.to(x.dtype)

    # ---------------- on-device preprocessing ----------------

    def _preprocess_vision(self, batch, generator=None):
        if "vision_frames" in batch:
            frames = batch["vision_frames"]            # uint8 (B, n, H, W, 3)
        else:
            frames = yuv420_to_rgb(batch["vision_frames_yuv"])
        transforms = str(batch.get("vision_transforms", "none"))
        g = None
        if generator is not None and transforms == "crop_flip":
            g = layers.seeded(layers.next_seed(generator), frames.device)
        mean, std = ((CLIP_MEAN, CLIP_STD) if self.cfg.vision_is_clip
                     else (IMAGENET_MEAN, IMAGENET_STD))   # vast.py:377-379
        return preprocess_frames(
            frames, self.cfg.vision_resolution, mean=mean, std=std,
            transforms=transforms, generator=g)

    def _preprocess_audio(self, batch, generator=None):
        """waveform (B, S) at int16 scale -> (B, n, T, M) fbank clips:
        fbank, pad to a clip multiple, one clip of each of n even segments,
        normalize (data/audio_mapper.py:46-88). BEATs takes the fbank of
        the int16-scale waveform (povey window); AST that of the [-1, 1]
        waveform minus its whole-clip mean (hanning window), each with its
        own stats (vast.py:396-411). The clip is the centre one of its
        segment, or with ``generator`` (training) a uniformly random one
        (vast.py:420-427)."""
        c = self.cfg
        wav = batch["audio_waveforms"]
        n, t = c.max_audio_sample_num, c.audio_target_length
        if c.audio_is_ast:
            w = wav * (1.0 / 32768.0)
            fb = ast_fbank(w - w.mean(dim=-1, keepdim=True),
                           num_mel_bins=c.audio_melbins)
        else:
            fb = kaldi_fbank(wav, num_mel_bins=c.audio_melbins)
        mean, std = AUDIO_STATS["ast" if c.audio_is_ast else "beats"]
        fb = (fb - mean) / (2.0 * std)
        frames = fb.shape[-2]
        total = max(1, -(-frames // t))
        fb = torch.nn.functional.pad(fb, (0, 0, 0, total * t - frames))
        bounds = np.linspace(0, total, n + 1)
        starts = bounds[:-1].astype(np.int64)
        sizes = np.maximum((bounds[1:] - bounds[:-1]).astype(np.int64), 1)
        clips = fb.view(fb.shape[0], total, t, c.audio_melbins)
        if generator is None:
            clips = clips[:, (starts + (sizes + 1) // 2 - 1).tolist()]
        else:
            g = layers.seeded(layers.next_seed(generator), fb.device)
            u = torch.rand((fb.shape[0], n), generator=g, device=fb.device)
            idx = (torch.from_numpy(starts).to(fb.device)
                   + (u * torch.from_numpy(sizes).to(fb.device)).long())
            clips = clips[torch.arange(fb.shape[0], device=fb.device)[:, None],
                          idx]
        if "audio_valid" in batch:
            valid = batch["audio_valid"].to(clips.dtype)
            clips = clips * valid[:, None, None, None]
        return clips

    # ---------------- feature DAG (model/vast.py:81-314) ----------------

    def get_feature(self, batch, key, cache, generator=None):
        """One node of the feature DAG, computed once per forward.
        ``generator``: the step's (training randomness) or None."""
        if key in cache:
            return cache[key]
        if key == "vision_pixels":
            val = batch.get("vision_pixels")
            if val is None:
                val = self._preprocess_vision(batch, generator)
        elif key == "audio_spectrograms":
            val = batch.get("audio_spectrograms")
            if val is None:
                val = self._preprocess_audio(batch, generator)
        elif key == "vision_output":
            val = self.forward_vision_encoder(
                self.get_feature(batch, "vision_pixels", cache, generator),
                generator)
        elif key == "audio_output":
            val = self.forward_audio_encoder(
                self.get_feature(batch, "audio_spectrograms", cache,
                                 generator))
        elif key == "caption_output" or key.startswith("text_output@"):
            # the caption, or a vast27m stream: vision_caption,
            # audio_caption, omni_caption (vast.py:463-470)
            stream = key.split("@", 1)[1] if "@" in key else "caption"
            val = self.multimodal_encoder.encode(
                batch[f"{stream}_tokens"], batch[f"{stream}_attention_mask"],
                generator=generator)
        elif key == "subtitle_output":
            val = self.multimodal_encoder.encode(
                batch["subtitle_tokens"], batch["subtitle_attention_mask"],
                generator=generator)
        elif key == "condition_feats_v":
            val = self.get_multimodal_forward_input_vision(
                self.get_feature(batch, "vision_output", cache, generator))
        elif key == "condition_feats_a":
            val = self.get_multimodal_forward_input_audio(
                self.get_feature(batch, "audio_output", cache, generator))
        elif key == "condition_feats_s":
            val = self.get_multimodal_forward_input_subtitle(
                self.get_feature(batch, "subtitle_output", cache, generator))
        elif key in ("condition_feats_va", "condition_feats_vs",
                     "condition_feats_vas"):
            val = torch.cat([self.get_feature(batch, f"condition_feats_{m}",
                                              cache, generator)
                             for m in key.split("_")[-1]], dim=1)
        elif key == "feat_t" or key.startswith("feat_t@"):
            stream = key.split("@", 1)[1] if "@" in key else "caption"
            co = self.get_feature(
                batch, "caption_output" if stream == "caption"
                else f"text_output@{stream}", cache, generator)
            val = _l2norm(self.contra_head_t(self.pool_text_for_contra(co)))
        elif key in ("feat_s", "feat_v", "feat_a", "feat_va", "feat_vs",
                     "feat_vas"):
            mods = key.split("_")[-1]
            pooled = torch.cat([self._pooled(batch, m, cache, generator)
                                for m in mods], dim=1)
            val = _l2norm(getattr(self, f"contra_head_{mods}")(pooled))
        else:
            raise KeyError(key)
        cache[key] = val
        return val

    _POOL = {"v": ("vision_output", "pool_vision_for_contra"),
             "a": ("audio_output", "pool_audio_for_contra"),
             "s": ("subtitle_output", "pool_text_for_contra")}

    def _pooled(self, batch, modality, cache, generator):
        key, pool = self._POOL[modality]
        return getattr(self, pool)(self.get_feature(batch, key, cache,
                                                    generator))

    # ---------------- task forwards ----------------

    def forward_ret(self, batch, subtasks, compute_loss=False,
                    generator=None, cache=None, text_stream="caption"):
        """Features (``compute_loss=False``) or the ITC + ITM losses of
        ``subtasks`` against the text stream ``text_stream`` (the caption,
        or a vast27m stream such as ``vision_caption``)."""
        cache = {} if cache is None else cache
        feat_t = self.get_feature(
            batch, "feat_t" if text_stream == "caption"
            else f"feat_t@{text_stream}", cache, generator)
        if not compute_loss:
            out = {"feat_t": feat_t, "input_ids": batch["caption_tokens"],
                   "attention_mask": batch["caption_attention_mask"]}
            for st in subtasks:
                out[f"feat_cond_{st}"] = self.get_feature(
                    batch, f"feat_{st[1:]}", cache, generator)
                out[f"condition_feats_{st}"] = self.get_feature(
                    batch, f"condition_feats_{st[1:]}", cache, generator)
            return out
        return self._ret_losses(batch, subtasks, cache, feat_t, generator,
                                text_stream)

    def _ret_losses(self, batch, subtasks, cache, feat_t, generator,
                    text_stream):
        """ITC and ITM over the global batch (vast.py:564-623): this
        rank's rows against every rank's (``parallel.collectives``; one
        process is a world of one). Each ITC direction scores its queries
        against the other side gathered and detached, as the reference's
        ``concat_all_gather``; the targets are this rank's global rows.
        ITM pairs every caption with its clip, a hard-negative clip and a
        hard-negative caption of the global batch, drawn from
        softmax(sim) + 1e-4 with the caption's own column zeroed, or
        injected (``itm_neg_cond_idx`` / ``itm_neg_text_idx``: this rank's
        rows of the global (n_subtasks, B), indices into the global
        batch); the condition sequences are gathered with their gradient
        (``GatherLayer``), the captions without. Under DDP's averaging
        over ranks, the mean of the ranks' losses and its gradient are
        those of the global batch. The ranks are those of
        ``data_group`` (the mesh's dp x fsdp ranks; None: the world)."""
        c = self.cfg
        input_ids = batch[f"{text_stream}_tokens"]
        attention_mask = batch[f"{text_stream}_attention_mask"]
        bs = feat_t.shape[0]
        dev = feat_t.device
        group = self.data_group
        rows = (parallel.group_rank(group) * bs
                + torch.arange(bs, device=dev))
        temp = self.contra_temp.float()
        feat_t_all = collectives.all_gather_detached(feat_t, group)
        ids_all = collectives.all_gather_detached(input_ids, group)
        mask_all = collectives.all_gather_detached(attention_mask, group)
        loss_itc, loss_itm = [], []
        for si, st in enumerate(subtasks):
            feat_cond = self.get_feature(batch, f"feat_{st[1:]}", cache,
                                         generator)
            feat_cond_all = collectives.all_gather_detached(feat_cond, group)
            sim_c2t = (feat_cond @ feat_t_all.T).float() / temp
            sim_t2c = (feat_t @ feat_cond_all.T).float() / temp
            loss_itc.append(
                (label_smoothed_ce(sim_c2t, rows, c.label_smoothing)
                 + label_smoothed_ce(sim_t2c, rows, c.label_smoothing))
                / 2)

            cond = self.get_feature(batch, f"condition_feats_{st[1:]}",
                                    cache, generator)
            cond_all = collectives.all_gather_with_grad(cond, group)
            if "itm_neg_cond_idx" in batch:
                neg_cond_idx = batch["itm_neg_cond_idx"][si]
                neg_text_idx = batch["itm_neg_text_idx"][si]
            else:
                if generator is None:
                    raise ValueError("the ITM negatives are drawn at random: "
                                     "pass a generator or inject "
                                     "itm_neg_cond_idx / itm_neg_text_idx")
                own = torch.zeros_like(sim_t2c, dtype=torch.bool)
                own[torch.arange(bs, device=dev), rows] = True
                with torch.no_grad():
                    w_t2c = (torch.softmax(sim_t2c, dim=1) + 1e-4
                             ).masked_fill(own, 0.0)
                    w_c2t = (torch.softmax(sim_c2t, dim=1) + 1e-4
                             ).masked_fill(own, 0.0)
                g = layers.seeded(layers.next_seed(generator), dev)
                neg_cond_idx = torch.multinomial(w_t2c, 1, generator=g)[:, 0]
                neg_text_idx = torch.multinomial(w_c2t, 1, generator=g)[:, 0]
            ids3 = torch.cat([input_ids, input_ids, ids_all[neg_text_idx]])
            mask3 = torch.cat([attention_mask, attention_mask,
                               mask_all[neg_text_idx]])
            cond3 = torch.cat([cond, cond_all[neg_cond_idx], cond])
            fused = self.multimodal_encoder.encode(
                ids3, mask3, encoder_hidden_states=cond3,
                generator=generator)
            logits = self.itm_head(fused[:, 0])
            labels = torch.cat([torch.ones(bs, dtype=torch.long, device=dev),
                                torch.zeros(2 * bs, dtype=torch.long,
                                            device=dev)])
            loss_itm.append(c.itm_ratio
                            * label_smoothed_ce(logits, labels, 0.0))
        return {"loss_itc": sum(loss_itc) / len(loss_itc),
                "loss_itm": sum(loss_itm) / len(loss_itm)}

    def _masked(self, batch, key, prob, generator):
        """``{key}_tokens`` corrupted for the MLM loss, and its labels:
        injected (``{key}_masked_tokens`` / ``_labels``, the parity
        tests) or drawn from the step's generator."""
        if f"{key}_masked_tokens" in batch:
            return (batch[f"{key}_masked_tokens"],
                    batch[f"{key}_masked_labels"])
        if generator is None:
            raise ValueError(f"the {key}'s [MASK] positions are drawn at "
                             f"random: pass a generator or inject "
                             f"{key}_masked_tokens / {key}_masked_labels")
        tokens = batch[f"{key}_tokens"]
        g = layers.seeded(layers.next_seed(generator), tokens.device)
        return mask_tokens(g, tokens, prob, mask_token=self.cfg.mask_token_id,
                           range_end=self.multimodal_encoder.cfg.vocab_size)

    def _mlm_losses(self, batch, subtasks, ids, att3, labels, generator,
                    cache):
        """The MLM loss of ``ids`` under ``att3`` (B, L, L) against each
        subtask's condition sequence, averaged over the subtasks. The
        sum over this rank's labelled tokens is divided by the global
        count over the world's size, so that the mean of the ranks'
        losses, and its gradient, are the global batch's sum over its
        count, as ``vast_tpu`` divides (ranks' counts may differ)."""
        count = (labels != IGNORE_LABEL).sum().float()
        group = self.data_group
        per_rank = (collectives.all_reduce_sum(count, group).clamp(min=1)
                    / parallel.group_size(group))
        losses = []
        for st in subtasks:
            cond = self.get_feature(batch, f"condition_feats_{st[1:]}",
                                    cache, generator)
            logits = self.multimodal_encoder(
                ids, att3, encoder_hidden_states=cond, generator=generator)
            losses.append(mlm_loss(logits, labels, denom=per_rank))
        return sum(losses) / len(losses)

    def _condition_feats(self, batch, subtasks, generator, cache):
        return {f"condition_feats_{st}": self.get_feature(
                    batch, f"condition_feats_{st[1:]}", cache, generator)
                for st in subtasks}

    def forward_cap(self, batch, subtasks, compute_loss=False,
                    generator=None, cache=None, caption_key: str = "caption"):
        """The condition sequences (``compute_loss=False``; generation
        runs apart), or the captioning loss of the text stream
        ``caption_key``: 60% of its tokens masked, the caption causal over
        its valid tokens (the ``tril`` of the broadcast padding mask,
        vast.py:497-499 of the reference)."""
        cache = {} if cache is None else cache
        if not compute_loss:
            return self._condition_feats(batch, subtasks, generator, cache)
        corrupted, labels = self._masked(batch, caption_key, 0.6, generator)
        mask = batch[f"{caption_key}_attention_mask"]
        att3 = torch.tril(mask[:, None, :].expand(-1, mask.shape[1], -1))
        return {"loss_cap": self._mlm_losses(batch, subtasks, corrupted,
                                             att3, labels, generator, cache)}

    def forward_qa(self, batch, subtasks, compute_loss=False,
                   generator=None, cache=None):
        """The condition sequences (``compute_loss=False``), or the QA
        loss: 99% of the answer's tokens masked after the question; the
        mask bidirectional over the question, causal over the answer, and
        question rows blind to the answer (vast.py:594-599 of the
        reference); the question's labels ignored."""
        cache = {} if cache is None else cache
        if not compute_loss:
            return self._condition_feats(batch, subtasks, generator, cache)
        q_ids = batch["question_tokens"]
        a_corrupted, a_labels = self._masked(batch, "answer", 0.99,
                                             generator)
        ids = torch.cat([q_ids, a_corrupted.to(q_ids.dtype)], dim=1)
        mask = torch.cat([batch["question_attention_mask"],
                          batch["answer_attention_mask"]], dim=1)
        labels = torch.cat([torch.full_like(q_ids, IGNORE_LABEL),
                            a_labels.to(q_ids.dtype)], dim=1)
        ql, l = q_ids.shape[1], ids.shape[1]
        att3 = mask[:, None, :].expand(-1, l, -1)
        r = torch.arange(l, device=ids.device)
        answer_rows = r[:, None] >= ql
        answer_cols = r[None, :] >= ql
        causal = r[None, :] <= r[:, None]
        keep = ~(answer_cols & ~(answer_rows & causal))
        att3 = att3 * keep.to(att3.dtype)
        return {"loss_qa": self._mlm_losses(batch, subtasks, ids, att3,
                                            labels, generator, cache)}

    @_entry
    def text_features(self, caption_tokens, caption_attention_mask):
        """feat_t for a text-only chunk (the evaluation path)."""
        batch = {"caption_tokens": caption_tokens,
                 "caption_attention_mask": caption_attention_mask}
        return self.get_feature(batch, "feat_t", {})

    @_entry
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

    @_entry
    def compute_slice_scores(self, condition_feats, input_ids,
                             attention_mask):
        """ITM softmax[:, 1] of each (text, condition) row pair."""
        return self._itm_prob(self.multimodal_encoder.encode(
            input_ids, attention_mask,
            encoder_hidden_states=condition_feats))

    @_entry
    def compute_slice_scores_grouped(self, condition_feats, input_ids,
                                     attention_mask):
        """ITM scores with per-candidate K/V reuse: ``input_ids`` (G*T, L)
        against ``condition_feats`` (G, Lc, D), text row g*T+j paired with
        candidate g; each candidate's cross K/V is projected once."""
        kv = self.multimodal_encoder.precompute_cross_kv(condition_feats)
        return self._itm_prob(self.multimodal_encoder.encode(
            input_ids, attention_mask, cross_kv=kv))

    @_entry
    def forward(self, batch, task: str, compute_loss: bool = False,
                generator: Optional[torch.Generator] = None):
        """The task heads of ``task`` (vast.py:762-810). ``generator``:
        the step's CPU generator for a training forward (dropout,
        drop-path, random crop and clip, ITM negatives, [MASK] positions);
        None for a deterministic forward. A vast27m batch (one with
        ``vision_caption_tokens``) pairs each ``ret`` and ``cap`` subtask
        with its own caption stream (tv: vision_caption, ta:
        audio_caption, else omni_caption), the losses averaged. Every head
        reads one feature cache, so each encoder runs once a forward on
        one draw of the frames' crop and the audio clip, as the
        reference's memo dict (model/vast.py:81-314) and as vast_tpu's
        heads, which draw from the same step keys."""
        out, cache = {}, {}
        for head, subtasks in parse_task_string(task):
            if head.startswith("qa"):
                out.update(self.forward_qa(batch, subtasks, compute_loss,
                                           generator, cache=cache))
                continue
            if head.startswith("ret"):
                run, stream_arg = self.forward_ret, "text_stream"
            elif head.startswith("cap"):
                run, stream_arg = self.forward_cap, "caption_key"
            else:
                raise NotImplementedError(f"task head {head!r} is not ported")
            if "vision_caption_tokens" not in batch:
                out.update(run(batch, subtasks, compute_loss, generator,
                               cache=cache))
                continue
            for st in subtasks:
                stream = {"tv": "vision_caption",
                          "ta": "audio_caption"}.get(st, "omni_caption")
                r = run(batch, [st], compute_loss, generator, cache=cache,
                        **{stream_arg: stream})
                for k, v in r.items():
                    out[k] = (out.get(k, 0) + v / len(subtasks)
                              if compute_loss else v)
        return out
