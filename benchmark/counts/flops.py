"""Model FLOPs from shapes: the products of every linear layer,
convolution and attention (2 per multiply-add), as
``torch.utils.flop_counter.FlopCounterMode`` counts them on the
benchmark's reference. Element-wise work is not counted. A training
step is three forwards (the backward's two products per forward
product), with nothing recomputed.

``cfg`` is a configuration file's dict (``configs/<name>.json``).
"""

from __future__ import annotations


def _vit(v: dict, images: int, mlp_hidden: int) -> float:
    w, p = v["width"], v["patch_size"]
    grid = v["image_size"] // p
    tokens = grid * grid + 1
    patch = 2.0 * grid * grid * 3 * p * p * w
    lin = 2.0 * tokens * (4 * w * w + 2 * w * mlp_hidden)
    attn = 4.0 * tokens * tokens * w
    return images * (patch + v["layers"] * (lin + attn))


def vision_tokens(cfg: dict) -> int:
    v = cfg["vision"]
    return (v["image_size"] // v["patch_size"]) ** 2 + 1


def vision_forward(cfg: dict, images: int) -> float:
    v = cfg["vision"]
    if cfg["vision_encoder_type"].startswith("evaclip"):
        return _vit(v, images, int(v["width"] * v["mlp_ratio"]))
    return _vit(v, images, 4 * v["width"])


def audio_tokens(cfg: dict) -> int:
    a = cfg["audio"]
    if cfg["audio_encoder_type"] == "ast":
        p = a["patch_size"]
        return (a["audio_melbins"] // p) * (a["audio_target_length"] // p) + 1
    p = a["input_patch_size"]
    return (cfg["audio_melbins"] // p) * (cfg["audio_target_length"] // p)


def audio_forward(cfg: dict, clips: int) -> float:
    a = cfg["audio"]
    n = audio_tokens(cfg)
    if cfg["audio_encoder_type"] == "ast":
        h, p = a["hidden_size"], a["patch_size"]
        conv = 2.0 * (n - 1) * p * p * h
        layer = (2.0 * n * (4 * h * h + 2 * h * a["intermediate_size"])
                 + 4.0 * n * n * h)
        return clips * (conv + a["num_hidden_layers"] * layer)
    e, p, c = a["encoder_embed_dim"], a["input_patch_size"], a["embed_dim"]
    heads = a["encoder_attention_heads"]
    conv = 2.0 * n * p * p * c + 2.0 * n * c * e
    # the grouped positional convolution over n + 1 outputs (k even)
    pos = 2.0 * (n + 1) * e * (e // a["conv_pos_groups"]) * a["conv_pos"]
    layer = (2.0 * n * (4 * e * e + 2 * e * a["encoder_ffn_embed_dim"])
             + 2.0 * n * heads * (e // heads) * 8 + 4.0 * n * n * e)
    return clips * (conv + pos + a["encoder_layers"] * layer)


def bert_encode(cfg: dict, rows: int, length: int, cond_tokens: int = 0,
                cond_sets: int = 0) -> float:
    """``rows`` texts of ``length`` tokens; with a cross-attention over
    ``cond_tokens`` keys whose K/V are projected for ``cond_sets``
    condition sequences (one a row, or one a candidate when texts share
    it)."""
    b = cfg["bert"]
    h, i = b["hidden_size"], b["intermediate_size"]
    t = rows * length
    layer = 2.0 * t * (4 * h * h + 2 * h * i) + 4.0 * rows * length ** 2 * h
    if cond_tokens:
        layer += (2.0 * t * 2 * h * h
                  + 2.0 * cond_sets * cond_tokens * 2 * h * h
                  + 4.0 * t * cond_tokens * h)
    return b["num_hidden_layers"] * layer


def cond_tokens(cfg: dict, frames: int, subtitle_len: int) -> int:
    return frames * vision_tokens(cfg) + audio_tokens(cfg) + subtitle_len


def preprocess(cfg: dict, clips: int, frames: int, in_res: int,
               audio_samples: int, crop: bool) -> float:
    """The random crop's two resize products and the fbank's mel
    product."""
    out = 0.0
    r = cfg["vision_resolution"]
    if crop:
        out += 2.0 * clips * frames * 3 * in_res * r * (in_res + r)
    flen, shift = 400, 160
    n_frames = 1 + (audio_samples - flen) // shift
    out += 2.0 * clips * n_frames * 256 * cfg["audio_melbins"]
    return out


def _dims(cfg):
    v = cfg["vision"]["width"]
    a = cfg["audio"].get("hidden_size", cfg["audio"].get("encoder_embed_dim"))
    return v, a, cfg["bert"]["hidden_size"]


def condition_forward(cfg: dict, clips: int, frames: int,
                      subtitle_len: int) -> float:
    """Towers, the subtitle's encoding, the fusion-space projections and
    the pooled condition feature of ``clips`` clips."""
    vd, ad, md = _dims(cfg)
    vt, at = vision_tokens(cfg), audio_tokens(cfg)
    proj = 2.0 * clips * (frames * vt * vd * md + at * ad * md
                          + subtitle_len * md * md)
    head = 2.0 * clips * (vd + ad + md) * cfg["contra_dim"]
    return (vision_forward(cfg, clips * frames) + audio_forward(cfg, clips)
            + bert_encode(cfg, clips, subtitle_len) + proj + head)


def text_forward(cfg: dict, texts: int, length: int) -> float:
    md = cfg["bert"]["hidden_size"]
    return bert_encode(cfg, texts, length) + 2.0 * texts * md * cfg[
        "contra_dim"]


def itm_head(cfg: dict, rows: int) -> float:
    md = cfg["bert"]["hidden_size"]
    return 2.0 * rows * (md * md + md * 2)


def train_forward(cfg: dict, batch: int, frames: int, caption_len: int,
                  subtitle_len: int, audio_samples: int) -> float:
    """The ``ret%tvas`` training forward with its ITC and ITM losses."""
    lc = cond_tokens(cfg, frames, subtitle_len)
    itc = 2.0 * 2 * batch * batch * cfg["contra_dim"]
    itm = (bert_encode(cfg, 3 * batch, caption_len, lc, 3 * batch)
           + itm_head(cfg, 3 * batch))
    return (preprocess(cfg, batch, frames, cfg["vision_resolution"],
                       audio_samples, True)
            + condition_forward(cfg, batch, frames, subtitle_len)
            + text_forward(cfg, batch, caption_len) + itc + itm)


def train_step(cfg: dict, traffic: dict) -> float:
    """FLOPs of one training step: three forwards."""
    return 3.0 * train_forward(cfg, traffic["batch_size"], traffic["frames"],
                               traffic["caption"]["max_len"],
                               traffic["subtitle"]["max_len"],
                               traffic["audio_samples"])


def rerank_call(cfg: dict, cands: int, cond_len: int, rows: int,
                length: int) -> float:
    """One grouped ITM call: ``rows`` texts over ``cands`` candidates
    whose K/V are projected once each."""
    return (bert_encode(cfg, rows, length, cond_len, cands)
            + itm_head(cfg, rows))


def eval_pass(cfg: dict, traffic: dict, rerank_shapes) -> float:
    """One ``evaluate_ret`` over the mix's clips, with the ITM calls of
    ``rerank_shapes`` ((cands, cond_len, rows, length) each); its ITC
    product runs on the host and is not counted."""
    n = traffic["clips"]
    sub, cap = traffic["subtitle"]["max_len"], traffic["caption"]["max_len"]
    out = (preprocess(cfg, n, traffic["frames"], cfg["vision_resolution"],
                      traffic["audio_samples"], False)
           + condition_forward(cfg, n, traffic["frames"], sub)
           + text_forward(cfg, n, cap))
    return out + sum(rerank_call(cfg, *s) for s in rerank_shapes)
