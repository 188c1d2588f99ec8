"""FLOPs of a training step with a Video Swin vision tower, and the least
time of each of its attention launches, from the shapes alone.

FLOPs as ``counts/flops.py`` counts them (2 per multiply-add of every
linear layer, convolution and attention; a step is three forwards): the
3-D patch embedding; per block the qkv, proj and MLP products and 4 n d
per token and head for the attention over the n tokens of its window;
the patch merging; then the fusion-space projections and the pooled
head at the tower's width, and BEATs, BERT, the other heads and the
preprocessing from ``counts/flops.py``.

A window launch is ``("window_fwd" | "window_bwd", windows, heads, n, d,
masks, lse)``: ``windows`` clips times windows a clip, ``masks`` the
windows a clip of the region mask the launch reads (0 for an unshifted
block), ``lse`` whether the forward writes its log-sum-exp. Its least
time counts the work the mechanism needs, whatever implements it: q, k
and v read and o written once; the (heads, n, n) fp32 bias table read
once and the (masks, n, n) bool mask read once; in the backward also o,
do and the lse read, dq, dk and dv written, and the table's gradient
written as (heads, n, n) fp32. Any other launch is
``counts/attention.py``'s and counted there.
"""

from __future__ import annotations

import math

from benchmark.counts import flops
from benchmark.counts.attention import BF16, FP32, bound_s, launch_work

MASK = 1                    # bytes of an element of the bool region mask


def stages(cfg: dict, frames: int) -> list:
    """Per stage of the tower over clips of ``frames`` frames: its token
    ``grid`` (T', H', W'), ``dim``, ``heads``, ``depth``, ``window``
    (clamped to the grid) and whether its odd blocks shift."""
    v = cfg["vision"]
    pt, ph, pw = v["patch_size"]
    res = cfg["vision_resolution"]
    grid = ((frames + 1 - pt) // v["time_stride"] + 1, res // ph, res // pw)
    dim, out = v["embed_dim"], []
    for depth, heads in zip(v["depths"], v["num_heads"]):
        window = tuple(min(g, w) for g, w in zip(grid, v["window_size"]))
        shifts = any(g > w and w // 2 for g, w in zip(grid,
                                                      v["window_size"]))
        out.append({"grid": grid, "dim": dim, "heads": heads,
                    "depth": depth, "window": window, "shifts": shifts})
        grid, dim = (grid[0], grid[1] // 2, grid[2] // 2), 2 * dim
    return out


def vision_tokens(cfg: dict, frames: int) -> int:
    """Tokens a clip of the last stage's grid: the condition sequence's."""
    return math.prod(stages(cfg, frames)[-1]["grid"])


def vision_width(cfg: dict) -> int:
    v = cfg["vision"]
    return v["embed_dim"] * 2 ** (len(v["depths"]) - 1)


def vision_forward(cfg: dict, clips: int, frames: int) -> float:
    v = cfg["vision"]
    st = stages(cfg, frames)
    out = 2.0 * math.prod(st[0]["grid"]) * 3 * math.prod(v["patch_size"]) \
        * v["embed_dim"]
    for i, s in enumerate(st):
        tokens, c = math.prod(s["grid"]), s["dim"]
        hidden = int(c * v["mlp_ratio"])
        lin = 2.0 * tokens * (4 * c * c + 2 * c * hidden)
        attn = 4.0 * tokens * math.prod(s["window"]) * c
        out += s["depth"] * (lin + attn)
        if i < len(st) - 1:
            out += 2.0 * (tokens // 4) * 4 * c * 2 * c
    return clips * out


def condition_forward(cfg: dict, clips: int, frames: int,
                      subtitle_len: int) -> float:
    """Towers, the subtitle's encoding, the fusion-space projections and
    the pooled condition feature of ``clips`` clips."""
    a = cfg["audio"]
    vd, md = vision_width(cfg), cfg["bert"]["hidden_size"]
    ad = a.get("hidden_size", a.get("encoder_embed_dim"))
    vt, at = vision_tokens(cfg, frames), flops.audio_tokens(cfg)
    proj = 2.0 * clips * (vt * vd * md + at * ad * md
                          + subtitle_len * md * md)
    head = 2.0 * clips * (vd + ad + md) * cfg["contra_dim"]
    return (vision_forward(cfg, clips, frames)
            + flops.audio_forward(cfg, clips)
            + flops.bert_encode(cfg, clips, subtitle_len) + proj + head)


def train_forward(cfg: dict, batch: int, frames: int, caption_len: int,
                  subtitle_len: int, audio_samples: int) -> float:
    """The ``ret%tvas`` training forward with its ITC and ITM losses."""
    lc = (vision_tokens(cfg, frames) + flops.audio_tokens(cfg)
          + subtitle_len)
    itc = 2.0 * 2 * batch * batch * cfg["contra_dim"]
    itm = (flops.bert_encode(cfg, 3 * batch, caption_len, lc, 3 * batch)
           + flops.itm_head(cfg, 3 * batch))
    return (flops.preprocess(cfg, batch, frames, cfg["vision_resolution"],
                             audio_samples, True)
            + condition_forward(cfg, batch, frames, subtitle_len)
            + flops.text_forward(cfg, batch, caption_len) + itc + itm)


def train_step(cfg: dict, traffic: dict) -> float:
    """FLOPs of one training step: three forwards."""
    return 3.0 * train_forward(cfg, traffic["batch_size"], traffic["frames"],
                               traffic["caption"]["max_len"],
                               traffic["subtitle"]["max_len"],
                               traffic["audio_samples"])


def window_work(kind, windows, heads, n, d, masks, lse):
    """(bytes, flops) of one window launch."""
    q = windows * heads * n * d * BF16
    table = heads * n * n * FP32
    mask = masks * n * n * MASK
    lse_b = windows * heads * n * FP32
    if kind == "window_fwd":
        return (4 * q + table + mask + (lse_b if lse else 0),
                4.0 * windows * heads * n * n * d)
    # q, k, v, o, do, lse, table and mask read; dq, dk, dv and the
    # table's gradient written
    return (8 * q + lse_b + 2 * table + mask,
            10.0 * windows * heads * n * n * d)


def step_launches(cfg: dict, clips: int, frames: int) -> list:
    """The hand-kernel attention launches of one training step: a forward
    writing its lse and a backward for every Video Swin block (window
    launches) and every BEATs layer (``counts/attention.py``'s)."""
    out = []
    for s in stages(cfg, frames):
        n, nw = math.prod(s["window"]), math.prod(
            g // w for g, w in zip(s["grid"], s["window"]))
        d = s["dim"] // s["heads"]
        for b in range(s["depth"]):
            masks = nw if s["shifts"] and b % 2 else 0
            out.append(("window_fwd", clips * nw, s["heads"], n, d, masks,
                        True))
    a = cfg["audio"]
    heads, la = a["encoder_attention_heads"], flops.audio_tokens(cfg)
    out += [("fwd", clips, heads, la, la, a["encoder_embed_dim"] // heads,
             True, True)] * a["encoder_layers"]
    return out + [(x[0].replace("fwd", "bwd"),) + x[1:] for x in out]


def launches_bound_s(device_name: str, launches) -> float:
    return sum(bound_s(device_name, *(window_work(*x)
                                      if x[0].startswith("window")
                                      else launch_work(*x)))
               for x in launches)
