"""``vast_tpu`` parameter trees -> the port's state dict, and random init.

:func:`from_jax` is the inverse of
``vast_tpu.convert.vast_ckpt.convert_vast_checkpoint``: it takes a
``VASTModel`` params tree (nested dicts of numpy arrays: an EVA tower
(EVA01, EVA02's q/k/v, inner LayerNorms and SwiGLU, layer scale), CLIP,
Swin or VideoSwin; BEATs or AST; and BERT) and returns flat reference
torch names -> numpy arrays. Dense kernels are transposed back to (out,
in), conv kernels go from HWIO to OIHW (VideoSwin's THWIO to OITHW),
BEATs' weight-norm ``v``/``g`` back to (out, in/groups, k) / (1, 1, k),
CLIP's ``in_proj`` kernel to the packed ``in_proj_weight``, AST's tree to
the reference's two modules ``audio_embeddings`` and ``audio_encoder``.
Load the result with ``load_state_dict``. Every mapping is a
transpose, so a tree of the same structure with other contents (a
gradient, an Adam moment, labels coded as arrays) maps the same way, to
the same names and shapes as the port's parameters.
"""

from __future__ import annotations

import numpy as np
import torch


def _put(out, name, value):
    value = np.asarray(value)       # a 0-d leaf (contra_temp) stays 0-d
    out[name] = value.copy() if value.ndim == 0 else \
        np.ascontiguousarray(value)


def _dense(out, name, p):
    _put(out, f"{name}.weight", np.asarray(p["kernel"]).T)
    if "bias" in p:
        _put(out, f"{name}.bias", p["bias"])


def _ln(out, name, p):
    _put(out, f"{name}.weight", p["scale"])
    _put(out, f"{name}.bias", p["bias"])


def _conv2d(out, name, p):
    _put(out, f"{name}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        _put(out, f"{name}.bias", p["bias"])


def _eva(out, pre, p):
    _conv2d(out, f"{pre}patch_embed.proj", p["patch_embed"])
    _put(out, f"{pre}cls_token", p["cls_token"])
    _put(out, f"{pre}pos_embed", p["pos_embed"])
    _ln(out, f"{pre}norm", p["norm"])
    i = 0
    while f"block_{i}" in p:
        blk, bp = p[f"block_{i}"], f"{pre}blocks.{i}."
        _ln(out, f"{bp}norm1", blk["norm1"])
        _ln(out, f"{bp}norm2", blk["norm2"])
        attn, mlp = blk["attn"], blk["mlp"]
        if "qkv" in attn:                                   # EVA01, bigE
            _put(out, f"{bp}attn.qkv.weight",
                 np.asarray(attn["qkv"]["kernel"]).T)
        for proj in ("q_proj", "k_proj", "v_proj"):         # EVA02
            if proj in attn:
                _dense(out, f"{bp}attn.{proj}", attn[proj])
        if "q_bias" in attn:
            _put(out, f"{bp}attn.q_bias", attn["q_bias"])
            _put(out, f"{bp}attn.v_bias", attn["v_bias"])
        if "inner_ln" in attn:
            _ln(out, f"{bp}attn.inner_attn_ln", attn["inner_ln"])
        _dense(out, f"{bp}attn.proj", attn["proj"])
        for fc in ("fc1", "fc2", "w1", "w2", "w3"):         # GELU or SwiGLU
            if fc in mlp:
                _dense(out, f"{bp}mlp.{fc}", mlp[fc])
        if "ffn_ln" in mlp:
            _ln(out, f"{bp}mlp.ffn_ln", mlp["ffn_ln"])
        for gamma in ("gamma_1", "gamma_2"):                # layer scale
            if gamma in blk:
                _put(out, f"{bp}{gamma}", blk[gamma])
        i += 1


def _clip(out, pre, p):
    _conv2d(out, f"{pre}conv1", p["conv1"])
    _put(out, f"{pre}class_embedding", p["class_embedding"])
    _put(out, f"{pre}positional_embedding", p["positional_embedding"])
    _ln(out, f"{pre}ln_pre", p["ln_pre"])
    _ln(out, f"{pre}ln_post", p["ln_post"])
    i = 0
    while f"block_{i}" in p:
        blk, bp = p[f"block_{i}"], f"{pre}transformer.resblocks.{i}."
        _ln(out, f"{bp}ln_1", blk["ln_1"])
        _put(out, f"{bp}attn.in_proj_weight",
             np.asarray(blk["in_proj"]["kernel"]).T)
        _put(out, f"{bp}attn.in_proj_bias", blk["in_proj"]["bias"])
        _dense(out, f"{bp}attn.out_proj", blk["out_proj"])
        _ln(out, f"{bp}ln_2", blk["ln_2"])
        _dense(out, f"{bp}mlp.c_fc", blk["c_fc"])
        _dense(out, f"{bp}mlp.c_proj", blk["c_proj"])
        i += 1


def _swin(out, pre, p):
    """Swin (2-D conv kernel) and VideoSwin (3-D, (t, h, w, in, out) ->
    (out, in, t, h, w)), vast_ckpt.py:276-347."""
    kernel = np.asarray(p["patch_embed"]["kernel"])
    _put(out, f"{pre}patch_embed.proj.weight",
         kernel.transpose(kernel.ndim - 1, kernel.ndim - 2,
                          *range(kernel.ndim - 2)))
    _put(out, f"{pre}patch_embed.proj.bias", p["patch_embed"]["bias"])
    _ln(out, f"{pre}patch_embed.norm", p["patch_norm"])
    _ln(out, f"{pre}norm", p["norm"])
    si = 0
    while f"stage_{si}_block_0" in p:
        bi = 0
        while f"stage_{si}_block_{bi}" in p:
            blk = p[f"stage_{si}_block_{bi}"]
            bp = f"{pre}layers.{si}.blocks.{bi}."
            _ln(out, f"{bp}norm1", blk["norm1"])
            _dense(out, f"{bp}attn.qkv", blk["attn"]["qkv"])
            _dense(out, f"{bp}attn.proj", blk["attn"]["proj"])
            _put(out, f"{bp}attn.relative_position_bias_table",
                 blk["attn"]["relative_position_bias_table"])
            _ln(out, f"{bp}norm2", blk["norm2"])
            _dense(out, f"{bp}mlp.fc1", blk["fc1"])
            _dense(out, f"{bp}mlp.fc2", blk["fc2"])
            bi += 1
        if f"merge_norm_{si}" in p:
            dp = f"{pre}layers.{si}.downsample."
            _ln(out, f"{dp}norm", p[f"merge_norm_{si}"])
            _dense(out, f"{dp}reduction", p[f"merge_reduction_{si}"])
        si += 1


def _ast(out, p):
    ep, np_ = "audio_embeddings.", "audio_encoder."
    _conv2d(out, f"{ep}first_conv", p["first_conv"])
    _put(out, f"{ep}cls_token", p["cls_token"])
    _put(out, f"{ep}position_embeddings.weight",
         p["position_embeddings"]["embedding"])
    _ln(out, f"{np_}last_layernorm", p["last_layernorm"])
    i = 0
    while f"layer_{i}" in p:
        lay, lp = p[f"layer_{i}"], f"{np_}layer.{i}."
        _ln(out, f"{lp}layernorm1", lay["ln1"])
        for j, proj in enumerate(("q", "k", "v", "proj")):
            _dense(out, f"{lp}attention.linears.{j}", lay[proj])
        _ln(out, f"{lp}layernorm2", lay["ln2"])
        _dense(out, f"{lp}ff_layer.linear1", lay["fc1"])
        _dense(out, f"{lp}ff_layer.linear2", lay["fc2"])
        i += 1


def _beats(out, pre, p):
    _conv2d(out, f"{pre}patch_embedding", p["patch_embedding"])
    _ln(out, f"{pre}layer_norm", p["layer_norm"])
    if "post_extract_proj" in p:
        _dense(out, f"{pre}post_extract_proj", p["post_extract_proj"])
    enc, ep = p["encoder"], f"{pre}encoder."
    _put(out, f"{ep}pos_conv.0.weight_v",
         np.asarray(enc["pos_conv_v"]).transpose(2, 1, 0))
    _put(out, f"{ep}pos_conv.0.weight_g",
         np.asarray(enc["pos_conv_g"]).transpose(2, 1, 0))
    _put(out, f"{ep}pos_conv.0.bias", enc["pos_conv_bias"])
    _ln(out, f"{ep}layer_norm", enc["layer_norm"])
    i = 0
    while f"layer_{i}" in enc:
        lay, lp = enc[f"layer_{i}"], f"{ep}layers.{i}."
        attn = lay["self_attn"]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(out, f"{lp}self_attn.{proj}", attn[proj])
        if "relative_attention_bias" in attn:
            _put(out, f"{lp}self_attn.relative_attention_bias.weight",
                 attn["relative_attention_bias"]["embedding"])
        _dense(out, f"{lp}self_attn.grep_linear", attn["grep_linear"])
        _put(out, f"{lp}self_attn.grep_a", attn["grep_a"])
        _ln(out, f"{lp}self_attn_layer_norm", lay["self_attn_layer_norm"])
        _dense(out, f"{lp}fc1", lay["fc1"])
        _dense(out, f"{lp}fc2", lay["fc2"])
        _ln(out, f"{lp}final_layer_norm", lay["final_layer_norm"])
        i += 1


def _bert_attention(out, name, p):
    for proj in ("query", "key", "value"):
        _dense(out, f"{name}.self.{proj}", p[proj])
    _dense(out, f"{name}.output.dense", p["out"])
    _ln(out, f"{name}.output.LayerNorm", p["out_ln"])


def _bert_mlm(out, pre, p):
    bert, bp = p["bert"], f"{pre}bert."
    emb = bert["embeddings"]
    for table in ("word_embeddings", "position_embeddings",
                  "token_type_embeddings"):
        _put(out, f"{bp}embeddings.{table}.weight", emb[table]["embedding"])
    _ln(out, f"{bp}embeddings.LayerNorm", emb["ln"])
    i = 0
    while f"layer_{i}" in bert:
        lay, lp = bert[f"layer_{i}"], f"{bp}encoder.layer.{i}."
        _bert_attention(out, f"{lp}attention", lay["attention"])
        _bert_attention(out, f"{lp}crossattention", lay["crossattention"])
        _dense(out, f"{lp}intermediate.dense", lay["mlp"]["intermediate"])
        _dense(out, f"{lp}output.dense", lay["mlp"]["output"])
        _ln(out, f"{lp}output.LayerNorm", lay["mlp"]["output_ln"])
        i += 1
    cp = f"{pre}cls.predictions."
    _dense(out, f"{cp}transform.dense", p["cls"]["transform"])
    _ln(out, f"{cp}transform.LayerNorm", p["cls"]["transform_ln"])
    _put(out, f"{cp}bias", p["decoder_bias"])


def from_jax(params) -> dict[str, np.ndarray]:
    """``vast_tpu`` VASTModel params -> reference torch state dict (numpy)."""
    out: dict[str, np.ndarray] = {}
    vision, audio = params["vision_encoder"], params["audio_encoder"]
    if "conv1" in vision:
        _clip(out, "vision_encoder.visual.", vision)
    elif "patch_norm" in vision:                        # Swin, VideoSwin
        _swin(out, "vision_encoder.", vision)
    else:
        _eva(out, "vision_encoder.visual.", vision)
    if "first_conv" in audio:
        _ast(out, audio)
    else:
        _beats(out, "audio_encoder.", audio)
    _bert_mlm(out, "multimodal_encoder.", params["multimodal_encoder"])
    _put(out, "contra_temp", params["contra_temp"])
    _dense(out, "itm_head.linear1", params["itm_head"]["linear1"])
    _ln(out, "itm_head.layernorm", params["itm_head"]["ln"])
    _dense(out, "itm_head.linear2", params["itm_head"]["linear2"])
    for head in ("t", "s", "v", "a"):
        _dense(out, f"contra_head_{head}.linear",
               params[f"contra_head_{head}"])
    for head in ("va", "vs", "vas"):
        _dense(out, f"contra_head_{head}", params[f"contra_head_{head}"])
    for mod in ("vision", "audio", "subtitle"):
        p = params[f"hidden_trans_{mod}_multimodal"]
        _dense(out, f"hidden_trans_{mod}_multimodal.0", p["dense"])
        _ln(out, f"hidden_trans_{mod}_multimodal.1", p["ln"])
    for name in ("vision_frame_embedding", "audio_frame_embedding",
                 "vision_type_embeddings", "audio_type_embeddings",
                 "subtitle_type_embeddings"):
        _put(out, name, params[name])
    return out


def load_numpy_state_dict(module: torch.nn.Module, sd: dict) -> None:
    """Strictly load a numpy state dict (copied into each parameter's
    dtype and device)."""
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})


@torch.no_grad()
def init_random_(model: torch.nn.Module, generator: torch.Generator):
    """Fill every floating parameter with N(0, 0.02) and every other one
    with zeros, in the manner of bench.py's ``fast_params``. Each
    parameter is drawn in its own dtype, so a model with fp32 parameters
    and bf16 compute (``param_dtype``) starts from fp32 values."""
    for p in model.parameters():
        if p.is_floating_point():
            p.normal_(0.0, 0.02, generator=generator)
        else:
            p.zero_()
    return model
