"""The least time an attention launch needs, from its shape alone.

A frozen copy of the roofline arithmetic that ``chip_smoke.py``'s kernel
table uses (``bound``, ``PEAKS`` and the bytes and operations of each
launch): the larger of the operations over the bf16 peak and the bytes
over the memory rate, each input byte read once and each output byte
written once. It reads the same whatever kernel serves the shape.

A launch is ``(kind, b, h, lq, lk, d, bias, lse)``; ``kind`` is 'fwd' or
'bwd', ``bias`` whether a bf16 (B, H, Lq, Lk) bias is read (and, in the
backward, its gradient written), ``lse`` whether the forward writes its
fp32 log-sum-exp for the backward.
"""

from __future__ import annotations

# published dense peaks (NVIDIA's data sheet, H100 SXM at 700 W): bf16
# tensor and fp32 CUDA-core FLOP/s, HBM bytes/s
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 67e12, 3.35e12)}
BF16, FP32 = 2, 4
# the program's launch counters (vast_tpu_torch.ops.flash_attention.
# LAUNCHES) of one forward or backward each; the others count subsets
LAUNCH_KEYS = ("tmajor_attention_fwd", "tmajor_attention_fwd_bias",
               "flash_attention_fwd", "flash_attention_fwd_lse",
               "tmajor_attention_bwd", "tmajor_attention_bwd_bias",
               "flash_attention_bwd", "flash_attention_bwd_dbias")


def peaks_for(name: str):
    if name not in PEAKS:
        raise KeyError(f"no published peaks for {name!r}: the bounds are "
                       f"defined for {sorted(PEAKS)}")
    return PEAKS[name]


def bound_s(device_name: str, nbytes: float, flops: float) -> float:
    """The least time of a bf16 launch, seconds."""
    bf16_peak, _, hbm = peaks_for(device_name)
    return max(nbytes / hbm, flops / bf16_peak)


def launch_work(kind, b, h, lq, lk, d, bias, lse):
    """(bytes, flops) of one launch."""
    q = b * h * lq * d * BF16
    kv = 2 * b * h * lk * d * BF16
    bias_b = b * h * lq * lk * BF16 if bias else 0
    lse_b = b * h * lq * FP32
    if kind == "fwd":
        return (q + kv + bias_b + q + (lse_b if lse else 0),
                4.0 * b * h * lq * lk * d)
    # q, k, v, o, do, lse (and the bias) read once; dq, dk, dv (and the
    # bias's gradient) written once
    return (2 * (q + kv) + 2 * q + lse_b + 2 * bias_b,
            10.0 * b * h * lq * lk * d)


def launches_bound_s(device_name: str, launches) -> float:
    return sum(bound_s(device_name, *launch_work(*x)) for x in launches)


def tower_launches(cfg: dict, clips: int, frames: int, train: bool):
    """The hand-kernel attention launches of the vision and audio towers
    over ``clips`` clips of ``frames`` frames: one a layer a tower, and
    in training a backward beside each forward that writes its lse."""
    from benchmark.counts.flops import audio_tokens, vision_tokens

    v, a = cfg["vision"], cfg["audio"]
    out = []
    lv = vision_tokens(cfg)
    if cfg["vision_encoder_type"].startswith("evaclip"):
        hv, dv = v["width"] // v["head_width"], v["head_width"]
    else:
        hv, dv = v["heads"], v["width"] // v["heads"]
    out += [("fwd", clips * frames, hv, lv, lv, dv, False, train)] \
        * v["layers"]
    la = audio_tokens(cfg)
    if cfg["audio_encoder_type"] == "ast":
        ha, layers, bias = a["num_attention_heads"], a["num_hidden_layers"], \
            False
        da = a["hidden_size"] // ha
    else:
        ha, layers, bias = a["encoder_attention_heads"], \
            a["encoder_layers"], True
        da = a["encoder_embed_dim"] // ha
    out += [("fwd", clips, ha, la, la, da, bias, train)] * layers
    if train:
        out += [("bwd",) + x[1:] for x in out]
    return out
