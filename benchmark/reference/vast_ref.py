"""Plain fp32 reference of VAST's retrieval model and its training losses.

Written from the published architectures in plain ``torch`` operations:
no kernel, no cache, no activation checkpointing of the program, and no
import of the program or of JAX. It holds the towers the benchmark's
configurations use: EVA01-CLIP-g/14 or OpenAI CLIP ViT-L/14 for vision,
BEATs or AST for audio, BERT-base with cross-attention as the text and
fusion encoder, and VAST's heads (contrastive projections, the ITM head,
the fusion-space projections). Module and parameter names are those of
the released VAST checkpoint, so one state dict loads into the
reference and into the program alike.

Precision: everything runs in fp32 with TF32 off (the caller sets the
backends). ``VastRef(cfg, fp8=True)`` is the control: every product
rounds its operands to float8 e4m3 with one scale per tensor (forward
values; the gradient passes straight through): each linear layer's and
convolution's input and weight, and in every attention the queries and
keys before their scores and the probabilities and values before their
sum, the step a later change could be tempted to take. Under autograd
every block is recomputed in its backward (activation checkpointing),
so that the fp32 reference of a training step fits beside nothing else
on one card.

Randomness follows the step's CPU generator as VAST's port draws it, so
that one generator state given to both sides gives the same dropout
masks, crop and audio clip: each module that draws takes one seed from
the step's generator (``next_seed``) and draws from a generator on the
tensor's device seeded with it. Dropout masks are drawn in the dtype the
configurations compute in (bf16, ``DRAW_DTYPE``) and applied in fp32.

Departures from the published models, each also the program's: GELU is
the exact erf form everywhere; BEATs' relative-position gate is applied
as an additive bias after the 1/sqrt(d) scale (neutral alpha).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
AUDIO_STATS = {"ast": (-4.2677393, 4.5689974), "beats": (15.41663, 6.55582)}
FP8_MAX = 448.0
# the configurations' compute dtype, in which the program draws its
# dropout masks
DRAW_DTYPE = torch.bfloat16


def _q8(t):
    """Round ``t`` to float8 e4m3 with one scale per tensor; the gradient
    passes straight through."""
    if t.numel() == 0:
        return t
    amax = t.detach().abs().amax().clamp(min=1e-30)
    s = FP8_MAX / amax
    q = (t.detach() * s).to(torch.float8_e4m3fn).to(t.dtype) / s
    return t + (q - t.detach())


class Linear(nn.Linear):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return F.linear(_q8(x), _q8(self.weight), self.bias)
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return self._conv_forward(_q8(x), _q8(self.weight), self.bias)
        return self._conv_forward(x, self.weight, self.bias)


def next_seed(generator):
    return int(torch.randint(0, 2 ** 62, (), generator=generator))


def seeded(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x, rate, generator):
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, dtype=DRAW_DTYPE,
                       device=x.device).bernoulli_(keep, generator=generator)
    return x * mask.float() / keep


def attention(q, k, v, bias=None, fp8=False):
    """(B, H, Lq, D) x (B, H, Lk, D): softmax(q k^T + bias) v, q scaled;
    ``fp8``: each product's operands rounded to float8 e4m3."""
    q8 = _q8 if fp8 else (lambda t: t)
    s = q8(q) @ q8(k).transpose(-1, -2)
    if bias is not None:
        s = s + bias
    return q8(torch.softmax(s, dim=-1)) @ q8(v)


def gelu(x):
    return F.gelu(x)


def _blocks(blocks, x, *args):
    for blk in blocks:
        if torch.is_grad_enabled():
            x = checkpoint(blk, x, *args, use_reentrant=False)
        else:
            x = blk(x, *args)
    return x


# ---------------------------------------------------------------- vision

class EvaAttention(nn.Module):
    fp8 = False

    def __init__(self, width, head_width):
        super().__init__()
        self.h, self.d = width // head_width, head_width
        self.qkv = Linear(width, 3 * width, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(width))
        self.v_bias = nn.Parameter(torch.zeros(width))
        self.proj = Linear(width, width)

    def forward(self, x):
        b, l, w = x.shape
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = self.qkv(x) + bias
        q, k, v = qkv.view(b, l, 3, self.h, self.d).permute(2, 0, 3, 1, 4)
        o = attention(q * self.d ** -0.5, k, v, fp8=self.fp8)
        return self.proj(o.transpose(1, 2).reshape(b, l, w))


class EvaMlp(nn.Module):
    def __init__(self, width, hidden):
        super().__init__()
        self.fc1 = Linear(width, hidden)
        self.fc2 = Linear(hidden, width)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class EvaBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm1 = nn.LayerNorm(c["width"], eps=c["ln_eps"])
        self.attn = EvaAttention(c["width"], c["head_width"])
        self.norm2 = nn.LayerNorm(c["width"], eps=c["ln_eps"])
        self.mlp = EvaMlp(c["width"], int(c["width"] * c["mlp_ratio"]))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, width, patch):
        super().__init__()
        self.proj = Conv2d(3, width, patch, patch)


class EvaVit(nn.Module):
    """EVA01-CLIP-g/14: pre-norm blocks, fused qkv with q and v biases."""

    def __init__(self, c):
        super().__init__()
        grid = c["image_size"] // c["patch_size"]
        self.patch_embed = PatchEmbed(c["width"], c["patch_size"])
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c["width"]))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1,
                                                  c["width"]))
        self.blocks = nn.ModuleList(EvaBlock(c) for _ in range(c["layers"]))
        self.norm = nn.LayerNorm(c["width"], eps=c["ln_eps"])

    def forward(self, pixels):
        x = self.patch_embed.proj(pixels.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], 1)
        x = _blocks(self.blocks, x + self.pos_embed)
        return self.norm(x)


class ClipAttention(nn.Module):
    fp8 = False

    def __init__(self, width, heads):
        super().__init__()
        self.h = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x):
        b, l, w = x.shape
        d = w // self.h
        wt, bt = self.in_proj_weight, self.in_proj_bias
        if self.fp8:
            y = F.linear(_q8(x), _q8(wt), bt)
        else:
            y = F.linear(x, wt, bt)
        q, k, v = y.view(b, l, 3, self.h, d).permute(2, 0, 3, 1, 4)
        o = attention(q * d ** -0.5, k, v, fp8=self.fp8)
        return self.out_proj(o.transpose(1, 2).reshape(b, l, w))


class ClipMlp(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)

    def forward(self, x):
        y = self.c_fc(x)
        return self.c_proj(y * torch.sigmoid(1.702 * y))     # QuickGELU


class ClipBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.ln_1 = nn.LayerNorm(c["width"], eps=c["ln_eps"])
        self.attn = ClipAttention(c["width"], c["heads"])
        self.ln_2 = nn.LayerNorm(c["width"], eps=c["ln_eps"])
        self.mlp = ClipMlp(c["width"])

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class ClipTransformer(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.resblocks = nn.ModuleList(ClipBlock(c)
                                       for _ in range(c["layers"]))


class ClipVit(nn.Module):
    """OpenAI CLIP ViT (arXiv:2103.00020): ln_pre, pre-norm blocks with
    QuickGELU, ln_post over every token."""

    def __init__(self, c):
        super().__init__()
        grid = c["image_size"] // c["patch_size"]
        self.conv1 = Conv2d(3, c["width"], c["patch_size"], c["patch_size"],
                            bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(c["width"]))
        self.positional_embedding = nn.Parameter(
            torch.zeros(grid * grid + 1, c["width"]))
        self.ln_pre = nn.LayerNorm(c["width"], eps=c["ln_eps"])
        self.transformer = ClipTransformer(c)
        self.ln_post = nn.LayerNorm(c["width"], eps=c["ln_eps"])

    def forward(self, pixels):
        x = self.conv1(pixels.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], 1) + self.positional_embedding)
        return self.ln_post(_blocks(self.transformer.resblocks, x))


# ----------------------------------------------------------------- audio

def relative_position_bucket(rel, num_buckets, max_distance):
    """BEATs' bidirectional T5-style buckets."""
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rp = np.abs(rel)
    exact = nb // 2
    large = exact + (np.log(np.maximum(rp, 1).astype(np.float64) / exact)
                     / math.log(max_distance / exact)
                     * (nb - exact)).astype(np.int64)
    return buckets + np.where(rp < exact, rp, np.minimum(large, nb - 1))


class BeatsAttention(nn.Module):
    fp8 = False

    def __init__(self, c, first):
        super().__init__()
        e, self.h = c["encoder_embed_dim"], c["encoder_attention_heads"]
        self.c = c
        self.q_proj, self.k_proj = Linear(e, e), Linear(e, e)
        self.v_proj, self.out_proj = Linear(e, e), Linear(e, e)
        if first:
            self.relative_attention_bias = nn.Embedding(c["num_buckets"],
                                                        self.h)
        self.grep_linear = Linear(e // self.h, 8)
        self.grep_a = nn.Parameter(torch.ones(1, self.h, 1, 1))

    def position_bias(self, length, device):
        rel = np.arange(length)[None, :] - np.arange(length)[:, None]
        idx = relative_position_bucket(rel, self.c["num_buckets"],
                                       self.c["max_distance"])
        table = self.relative_attention_bias.weight
        return table[torch.from_numpy(idx).to(device)].permute(2, 0, 1)

    def forward(self, x, pos_bias):
        b, l, e = x.shape
        d = e // self.h
        q = self.q_proj(x).view(b, l, self.h, d)
        k = self.k_proj(x).view(b, l, self.h, d).transpose(1, 2)
        v = self.v_proj(x).view(b, l, self.h, d).transpose(1, 2)
        # the gated relative position (BEATs, gru_rel_pos): from the
        # unscaled query, one gate per sample, head and query
        g = torch.sigmoid(self.grep_linear(q).view(b, l, self.h, 2, 4)
                          .sum(-1))
        gate_a, gate_b = g.chunk(2, dim=-1)
        gate = gate_a * (gate_b * self.grep_a.view(1, 1, -1, 1) - 1.0) + 2.0
        bias = gate.transpose(1, 2) * pos_bias[None]
        o = attention(q.transpose(1, 2) * d ** -0.5, k, v, bias, self.fp8)
        return self.out_proj(o.transpose(1, 2).reshape(b, l, e))


class BeatsLayer(nn.Module):
    def __init__(self, c, first):
        super().__init__()
        e = c["encoder_embed_dim"]
        self.self_attn = BeatsAttention(c, first)
        self.self_attn_layer_norm = nn.LayerNorm(e, eps=c["ln_eps"])
        self.fc1 = Linear(e, c["encoder_ffn_embed_dim"])
        self.fc2 = Linear(c["encoder_ffn_embed_dim"], e)
        self.final_layer_norm = nn.LayerNorm(e, eps=c["ln_eps"])
        self.alpha = (2 * c["encoder_layers"]) ** 0.25         # deep norm

    def forward(self, x, pos_bias):
        x = self.self_attn_layer_norm(x * self.alpha
                                      + self.self_attn(x, pos_bias))
        return self.final_layer_norm(x * self.alpha
                                     + self.fc2(gelu(self.fc1(x))))


class WeightNormConv1d(nn.Module):
    def __init__(self, channels, kernel, groups):
        super().__init__()
        self.groups = groups
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(torch.zeros(channels, channels // groups,
                                                 kernel))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        v = self.weight_v
        w = self.weight_g * v / torch.sqrt((v * v).sum((0, 1), keepdim=True)
                                           + 1e-12)
        return F.conv1d(x, w, self.bias, padding=v.shape[-1] // 2,
                        groups=self.groups)


class BeatsEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        self.pos_conv = nn.ModuleList([WeightNormConv1d(
            c["encoder_embed_dim"], c["conv_pos"], c["conv_pos_groups"])])
        self.layers = nn.ModuleList(BeatsLayer(c, i == 0)
                                    for i in range(c["encoder_layers"]))
        self.layer_norm = nn.LayerNorm(c["encoder_embed_dim"],
                                       eps=c["ln_eps"])


class Beats(nn.Module):
    """BEATs (iter3+, AS2M): 16x16 patches of the fbank, post-LN deep-norm
    layers with a gated relative-position bias shared from layer 0."""

    def __init__(self, c):
        super().__init__()
        p = c["input_patch_size"]
        self.patch_embedding = Conv2d(1, c["embed_dim"], p, p, bias=False)
        self.layer_norm = nn.LayerNorm(c["embed_dim"], eps=c["ln_eps"])
        self.post_extract_proj = Linear(c["embed_dim"],
                                        c["encoder_embed_dim"])
        self.encoder = BeatsEncoder(c)

    def forward(self, fbank):
        x = self.patch_embedding(fbank[:, None]).flatten(2).transpose(1, 2)
        x = self.post_extract_proj(self.layer_norm(x))
        enc = self.encoder
        y = enc.pos_conv[0](x.transpose(1, 2))
        if enc.c["conv_pos"] % 2 == 0:
            y = y[:, :, :-1]
        x = enc.layer_norm(x + gelu(y.transpose(1, 2)))
        pos_bias = enc.layers[0].self_attn.position_bias(x.shape[1],
                                                         x.device)
        return _blocks(enc.layers, x, pos_bias)


class AstEmbeddings(nn.Module):
    def __init__(self, c):
        super().__init__()
        h, p = c["hidden_size"], c["patch_size"]
        n = (c["audio_melbins"] // p) * (c["audio_target_length"] // p)
        self.first_conv = Conv2d(1, h, p, p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, h))
        self.position_embeddings = nn.Embedding(n + 1, h)

    def forward(self, fbank):
        x = self.first_conv(fbank.transpose(-1, -2)[:, None])
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], 1)
        return x + self.position_embeddings.weight[:x.shape[1]]


class AstAttention(nn.Module):
    fp8 = False

    def __init__(self, c):
        super().__init__()
        self.h = c["num_attention_heads"]
        self.linears = nn.ModuleList(Linear(c["hidden_size"],
                                            c["hidden_size"])
                                     for _ in range(4))

    def forward(self, x):
        b, l, e = x.shape
        d = e // self.h
        q, k, v = (lin(x).view(b, l, self.h, d).transpose(1, 2)
                   for lin in self.linears[:3])
        o = attention(q * d ** -0.5, k, v, fp8=self.fp8)
        return self.linears[3](o.transpose(1, 2).reshape(b, l, e))


class AstFeedForward(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.linear1 = Linear(c["hidden_size"], c["intermediate_size"])
        self.linear2 = Linear(c["intermediate_size"], c["hidden_size"])

    def forward(self, x):
        return self.linear2(gelu(self.linear1(x)))


class AstLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layernorm1 = nn.LayerNorm(c["hidden_size"], eps=c["ln_eps"])
        self.attention = AstAttention(c)
        self.layernorm2 = nn.LayerNorm(c["hidden_size"], eps=c["ln_eps"])
        self.ff_layer = AstFeedForward(c)

    def forward(self, x):
        x = x + self.attention(self.layernorm1(x))
        return x + self.ff_layer(self.layernorm2(x))


class AstEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layer = nn.ModuleList(AstLayer(c)
                                   for _ in range(c["num_hidden_layers"]))
        self.last_layernorm = nn.LayerNorm(c["hidden_size"], eps=c["ln_eps"])

    def forward(self, x):
        return self.last_layernorm(_blocks(self.layer, x))


# ------------------------------------------------------------------ BERT

class BertEmbeddings(nn.Module):
    def __init__(self, c):
        super().__init__()
        h = c["hidden_size"]
        self.word_embeddings = nn.Embedding(c["vocab_size"], h)
        self.position_embeddings = nn.Embedding(
            c["max_position_embeddings"], h)
        self.token_type_embeddings = nn.Embedding(c["type_vocab_size"], h)
        self.LayerNorm = nn.LayerNorm(h, eps=c["layer_norm_eps"])


class _Proj(nn.Module):
    def __init__(self, h):
        super().__init__()
        self.query, self.key, self.value = Linear(h, h), Linear(h, h), \
            Linear(h, h)


class _Out(nn.Module):
    def __init__(self, d_in, h, eps):
        super().__init__()
        self.dense = Linear(d_in, h)
        self.LayerNorm = nn.LayerNorm(h, eps=eps)


class BertAttention(nn.Module):
    fp8 = False

    def __init__(self, c):
        super().__init__()
        self.h = c["num_attention_heads"]
        self.self = _Proj(c["hidden_size"])
        self.output = _Out(c["hidden_size"], c["hidden_size"],
                           c["layer_norm_eps"])

    def forward(self, x, src, add_mask, rate, g):
        b, lq, e = x.shape
        d = e // self.h

        def heads(t):
            return t.view(t.shape[0], t.shape[1], self.h, d).transpose(1, 2)

        q = heads(self.self.query(x))
        k, v = heads(self.self.key(src)), heads(self.self.value(src))
        o = attention(q * d ** -0.5, k, v, add_mask, self.fp8)
        o = o.transpose(1, 2).reshape(b, lq, e)
        y = dropout(self.output.dense(o), rate, g)
        return self.output.LayerNorm(x + y)


class _Inter(nn.Module):
    def __init__(self, h, i):
        super().__init__()
        self.dense = Linear(h, i)


class BertLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        self.attention = BertAttention(c)
        self.crossattention = BertAttention(c)
        self.intermediate = _Inter(c["hidden_size"], c["intermediate_size"])
        self.output = _Out(c["intermediate_size"], c["hidden_size"],
                           c["layer_norm_eps"])

    def forward(self, x, self_mask, cond, seed):
        g = None if seed is None else seeded(seed, x.device)
        rate = self.c["hidden_dropout_prob"]
        x = self.attention(x, x, self_mask, rate, g)
        if cond is not None:
            x = self.crossattention(x, cond, None, rate, g)
        y = dropout(self.output.dense(gelu(self.intermediate.dense(x))),
                    rate, g)
        return self.output.LayerNorm(x + y)


class _Encoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c)
                                   for _ in range(c["num_hidden_layers"]))


class BertModel(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        self.embeddings = BertEmbeddings(c)
        self.encoder = _Encoder(c)


class _Transform(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.dense = Linear(c["hidden_size"], c["hidden_size"])
        self.LayerNorm = nn.LayerNorm(c["hidden_size"],
                                      eps=c["layer_norm_eps"])


class _Predictions(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.transform = _Transform(c)
        self.bias = nn.Parameter(torch.zeros(c["vocab_size"]))


class _Cls(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.predictions = _Predictions(c)


class BertForMaskedLM(nn.Module):
    """BERT-base with a cross-attention in every layer, post-LN; the MLM
    head's parameters are held so that the state dict is the released
    one (retrieval does not read them)."""

    def __init__(self, c):
        super().__init__()
        self.bert = BertModel(c)
        self.cls = _Cls(c)

    def encode(self, ids, mask, cond=None, generator=None):
        """Hidden states (B, L, H). ``mask``: (B, L) or (B, L, L) of 0/1.
        ``generator`` (training): dropout on."""
        c = self.bert.c
        drop = generator is not None and c["hidden_dropout_prob"] > 0
        emb = self.bert.embeddings
        g = seeded(next_seed(generator), ids.device) if drop else None
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = (emb.word_embeddings(ids) + emb.position_embeddings(pos)
             + emb.token_type_embeddings.weight[0])
        x = dropout(emb.LayerNorm(x), c["hidden_dropout_prob"], g)
        m = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
        add_mask = torch.where(m.bool(), 0.0, NEG_INF)
        for layer in self.bert.encoder.layer:
            seed = next_seed(generator) if drop else None
            if torch.is_grad_enabled():
                x = checkpoint(layer, x, add_mask, cond, seed,
                               use_reentrant=False)
            else:
                x = layer(x, add_mask, cond, seed)
        return x


# ------------------------------------------------------- preprocessing

def _triangle_weights(in_size, sample, kernel_scale):
    pos = torch.arange(in_size, dtype=sample.dtype, device=sample.device)
    x = (sample[..., None, :] - pos[:, None]).abs() / kernel_scale
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(dim=-2, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None, :], w, torch.zeros_like(w))


def _center_crop(x, res):
    """The evaluation's short-side resize and centre crop, for frames that
    arrive at the configuration's resolution: the identity."""
    if x.shape[-3:-1] != (res, res):
        raise ValueError(f"the reference takes frames at {res} x {res}, "
                         f"not {tuple(x.shape[-3:-1])}")
    return x


def _random_crop_flip(x, res, g, scale=(0.8, 1.0)):
    """One square window of 80-100% of the area and one horizontal flip per
    clip, resized bilinearly with antialiasing (scale_and_translate)."""
    b, h, w = x.shape[0], x.shape[-3], x.shape[-2]
    area = torch.empty(b, device=x.device).uniform_(scale[0], scale[1],
                                                    generator=g)
    side = torch.sqrt(area * h * w).clamp_max(float(min(h, w)))
    pos = torch.rand((b, 2), generator=g, device=x.device)
    top = (pos[:, 0] * (h - side)).long()
    left = (pos[:, 1] * (w - side)).long()
    flip = torch.rand(b, generator=g, device=x.device) < 0.5
    s = res / side.float()
    out = torch.arange(res, dtype=torch.float32, device=x.device)

    def weights(size, offset):
        inv = 1.0 / s
        sample = ((out[None] + 0.5) * inv[:, None]
                  - (-offset.float() * s)[:, None] * inv[:, None] - 0.5)
        return _triangle_weights(size, sample,
                                 torch.clamp_min(inv, 1.0)[:, None, None])

    x = torch.einsum("bnhwc,bhH->bnHwc", x, weights(h, top))
    x = torch.einsum("bnhwc,bwW->bnhWc", x, weights(w, left))
    return torch.where(flip[:, None, None, None, None], x.flip(-2), x)


def preprocess_frames(frames, res, generator):
    """uint8 (B, N, R, R, 3) -> CLIP-normalized fp32 (B, N, R, R, 3): a
    random resized crop and flip with ``generator`` (training), else the
    centre crop."""
    x = frames.float() / 255.0
    if generator is None:
        x = _center_crop(x, res)
    else:
        x = _random_crop_flip(x, res, seeded(next_seed(generator), x.device))
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def kaldi_fbank(wav, num_bins, window, sample_rate=16000):
    """Kaldi log-mel filterbank (dither 0, snip edges, 25/10 ms, DC
    removal, pre-emphasis 0.97, power spectrum, 20 Hz to Nyquist)."""
    flen, shift = sample_rate * 25 // 1000, sample_rate * 10 // 1000
    nfft = 1 << (flen - 1).bit_length()
    fr = wav.float().unfold(-1, flen, shift)
    fr = fr - fr.mean(-1, keepdim=True)
    fr = fr - 0.97 * torch.cat([fr[..., :1], fr[..., :-1]], -1)
    i = np.arange(flen)
    han = 0.5 - 0.5 * np.cos(2 * math.pi * i / (flen - 1))
    win = han ** 0.85 if window == "povey" else han
    fr = fr * torch.from_numpy(win.astype(np.float32)).to(fr.device)
    spec = torch.fft.rfft(fr, n=nfft, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[..., :nfft // 2]
    lo, hi = _mel(20.0), _mel(0.5 * sample_rate)
    delta = (hi - lo) / (num_bins + 1)
    b = np.arange(num_bins)[:, None]
    mel_f = _mel(sample_rate / nfft * np.arange(nfft // 2)[None, :])
    up = (mel_f - (lo + b * delta)) / delta
    down = ((lo + (b + 2) * delta) - mel_f) / delta
    banks = np.maximum(0.0, np.minimum(up, down)).astype(np.float32).T
    return torch.log(torch.clamp(power @ torch.from_numpy(banks).to(
        fr.device), min=1.1920928955078125e-07))


def preprocess_audio(wav, cfg, generator):
    """waveform (B, S) at int16 scale -> one normalized fbank clip of
    ``audio_target_length`` frames per sample (B, 1, T, M): the centre
    clip, or with ``generator`` a uniformly random one."""
    ast = cfg["audio_encoder_type"] == "ast"
    t, m = cfg["audio_target_length"], cfg["audio_melbins"]
    if ast:
        w = wav / 32768.0
        fb = kaldi_fbank(w - w.mean(-1, keepdim=True), m, "hanning")
    else:
        fb = kaldi_fbank(wav, m, "povey")
    mean, std = AUDIO_STATS["ast" if ast else "beats"]
    fb = (fb - mean) / (2.0 * std)
    frames = fb.shape[-2]
    total = max(1, -(-frames // t))
    fb = F.pad(fb, (0, 0, 0, total * t - frames))
    clips = fb.view(fb.shape[0], total, t, m)
    if generator is None:
        return clips[:, [(total + 1) // 2 - 1]]
    g = seeded(next_seed(generator), fb.device)
    u = torch.rand((fb.shape[0], 1), generator=g, device=fb.device)
    idx = (u * total).long()
    return clips[torch.arange(fb.shape[0], device=fb.device)[:, None], idx]


# ------------------------------------------------------------------ VAST

class _Head(nn.Module):
    def __init__(self, d_in, d_out):
        super().__init__()
        self.linear = Linear(d_in, d_out, bias=False)


class MatchHead(nn.Module):
    def __init__(self, h):
        super().__init__()
        self.linear1 = Linear(h, h)
        self.layernorm = nn.LayerNorm(h, eps=1e-12)
        self.linear2 = Linear(h, 2)

    def forward(self, x):
        return self.linear2(self.layernorm(gelu(self.linear1(x))))


def _proj_ln(d_in, d_out):
    return nn.Sequential(Linear(d_in, d_out), nn.LayerNorm(d_out, eps=1e-12))


def smoothed_ce(logits, targets, eps):
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, targets[:, None])[:, 0]
    return ((1 - eps) * nll - eps * logp.mean(-1)).mean()


def l2norm(x):
    return x / x.norm(dim=-1, keepdim=True)


class VastRef(nn.Module):
    """VAST (arXiv:2305.18500) for ``ret%tvas``: vision, audio and
    subtitle conditions, the caption as text."""

    def __init__(self, cfg, fp8: bool = False):
        super().__init__()
        self.cfg = cfg
        v, a, b = cfg["vision"], cfg["audio"], cfg["bert"]
        if cfg["vision_encoder_type"].startswith("evaclip"):
            self.vision_encoder = nn.ModuleDict({"visual": EvaVit(v)})
        else:
            self.vision_encoder = nn.ModuleDict({"visual": ClipVit(v)})
        vd = v["width"]
        if cfg["audio_encoder_type"] == "ast":
            self.audio_embeddings = AstEmbeddings(a)
            self.audio_encoder = AstEncoder(a)
            ad = a["hidden_size"]
        else:
            self.audio_encoder = Beats(a)
            ad = a["encoder_embed_dim"]
        self.multimodal_encoder = BertForMaskedLM(b)
        md, d = b["hidden_size"], cfg["contra_dim"]
        self.contra_head_t = _Head(md, d)
        self.contra_head_s = _Head(md, d)
        self.contra_head_v = _Head(vd, d)
        self.contra_head_a = _Head(ad, d)
        self.contra_head_va = Linear(vd + ad, d)
        self.contra_head_vs = Linear(vd + md, d)
        self.contra_head_vas = Linear(vd + ad + md, d)
        self.contra_temp = nn.Parameter(torch.tensor(0.07))
        self.itm_head = MatchHead(md)
        self.vision_frame_embedding = nn.Parameter(
            torch.zeros(1, cfg["max_vision_sample_num"], md))
        self.audio_frame_embedding = nn.Parameter(torch.zeros(1, 1, md))
        self.hidden_trans_vision_multimodal = _proj_ln(vd, md)
        self.hidden_trans_audio_multimodal = _proj_ln(ad, md)
        self.hidden_trans_subtitle_multimodal = _proj_ln(md, md)
        self.vision_type_embeddings = nn.Parameter(torch.zeros(1, 1, md))
        self.audio_type_embeddings = nn.Parameter(torch.zeros(1, 1, md))
        self.subtitle_type_embeddings = nn.Parameter(torch.zeros(1, 1, md))
        for m in self.modules():
            if hasattr(type(m), "fp8"):
                m.fp8 = fp8

    # ------------------------------------------------------------ parts

    def vision(self, frames, generator=None):
        """uint8 frames -> (B, n, tokens, width)."""
        pix = preprocess_frames(frames, self.cfg["vision_resolution"],
                                generator)
        b, n = pix.shape[:2]
        out = self.vision_encoder["visual"](pix.flatten(0, 1))
        return out.view(b, n, *out.shape[1:])

    def audio(self, wav, generator=None):
        clips = preprocess_audio(wav, self.cfg, generator)
        b, n = clips.shape[:2]
        x = clips.flatten(0, 1)
        if self.cfg["audio_encoder_type"] == "ast":
            x = self.audio_encoder(self.audio_embeddings(x))
        else:
            x = self.audio_encoder(x)
        return x.view(b, n, *x.shape[1:])

    def _cond_seq(self, out, proj, frame_emb, type_emb):
        b, n = out.shape[:2]
        x = proj(out)
        if frame_emb is not None:
            src = frame_emb.shape[1]
            idx = (np.arange(n) * src // n).tolist()
            x = x + frame_emb[:, idx][:, :, None]
        return x.reshape(b, -1, x.shape[-1]) + type_emb

    def features(self, batch, generator=None):
        """The features of a ``ret%tvas`` forward, in the order the program
        draws its randomness: the caption, then vision, audio and the
        subtitle. Returns a dict of the text and condition features and
        the condition sequence."""
        mm = self.multimodal_encoder
        cap = mm.encode(batch["caption_tokens"],
                        batch["caption_attention_mask"], generator=generator)
        vis = self.vision(batch["vision_frames"], generator)
        aud = self.audio(batch["audio_waveforms"], generator)
        sub = mm.encode(batch["subtitle_tokens"],
                        batch["subtitle_attention_mask"], generator=generator)
        ast = self.cfg["audio_encoder_type"] == "ast"
        pooled = torch.cat([
            vis[:, :, 0].mean(1),
            aud[:, :, 0].mean(1) if ast else aud.mean(2).mean(1),
            sub[:, 0]], 1)
        cond = torch.cat([
            self._cond_seq(vis, self.hidden_trans_vision_multimodal,
                           self.vision_frame_embedding,
                           self.vision_type_embeddings),
            self._cond_seq(aud, self.hidden_trans_audio_multimodal,
                           self.audio_frame_embedding,
                           self.audio_type_embeddings),
            self.hidden_trans_subtitle_multimodal(sub)
            + self.subtitle_type_embeddings], 1)
        return {"feat_t": l2norm(self.contra_head_t.linear(cap[:, 0])),
                "feat_cond": l2norm(self.contra_head_vas(pooled)),
                "cond": cond}

    def itm_prob(self, cond, ids, mask):
        """ITM softmax[:, 1] of each (text, condition) row pair."""
        fused = self.multimodal_encoder.encode(ids, mask, cond)
        return torch.softmax(self.itm_head(fused[:, 0]), -1)[:, 1]

    def text_features(self, ids, mask):
        return l2norm(self.contra_head_t.linear(
            self.multimodal_encoder.encode(ids, mask)[:, 0]))

    def ret_losses(self, batch, generator=None):
        """ITC (label smoothing 0.1, both directions) and ITM (0.1 x CE of
        each caption with its clip, a negative clip and a negative
        caption, the negatives given as ``itm_neg_*_idx``)."""
        f = self.features(batch, generator)
        self.last_cond = f["cond"].detach()
        ft, fc, cond = f["feat_t"], f["feat_cond"], f["cond"]
        bs = ft.shape[0]
        rows = torch.arange(bs, device=ft.device)
        temp = self.contra_temp
        sim_c2t = fc @ ft.detach().T / temp
        sim_t2c = ft @ fc.detach().T / temp
        itc = (smoothed_ce(sim_c2t, rows, 0.1)
               + smoothed_ce(sim_t2c, rows, 0.1)) / 2
        neg_c = batch["itm_neg_cond_idx"][0]
        neg_t = batch["itm_neg_text_idx"][0]
        ids, mask = batch["caption_tokens"], batch["caption_attention_mask"]
        ids3 = torch.cat([ids, ids, ids[neg_t]])
        mask3 = torch.cat([mask, mask, mask[neg_t]])
        cond3 = torch.cat([cond, cond[neg_c], cond])
        fused = self.multimodal_encoder.encode(ids3, mask3, cond3, generator)
        logits = self.itm_head(fused[:, 0])
        labels = torch.cat([torch.ones(bs, dtype=torch.long),
                            torch.zeros(2 * bs, dtype=torch.long)]
                           ).to(ft.device)
        itm = self.cfg["itm_ratio"] * smoothed_ce(logits, labels, 0.0)
        return {"loss_itc": itc, "loss_itm": itm}
