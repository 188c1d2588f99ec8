"""BERT with cross-attention in every layer (VAST's fusion encoder).

Counterpart of ``vast_tpu.models.bert`` for the retrieval path: the
embeddings, self- and cross-attention with their output LN, the MLP, the
full-sequence encode with a 2-D or 3-D mask, cross K/V computed once per
condition sequence (``precompute_cross_kv``), and the ``kv_groups`` fold
that scores T texts against one candidate's K/V (bert.py:116-135). The
MLM head's weights are here so the state dict is complete; the MLM loss
and the decode KV cache come with the captioning slice. Training adds
the hidden dropout of ``vast_tpu`` (after the embeddings' LN, each
attention's output projection and the MLP's output: bert.py:71, :101,
:173) and activation checkpointing per layer (models/remat.py). Like
``vast_tpu``, it drops no attention probabilities (its
``attention_probs_dropout_prob`` field is read nowhere).

Module names follow HF's BertForMaskedLM, so the reference state dict
(``multimodal_encoder.bert.encoder.layer.{i}.attention.self.query...``)
loads as it is. Attention routes by shape (ops/attention.py): the
caption's self-attention and one caption's cross-attention take the plain
route, and the grouped rerank's folded query, from 8 texts per candidate
on, the head-major CUDA kernel.

Tensor parallel (``parallel/tp.py``): an attention whose heads divide by
the tp size runs this rank's heads (``query``/``key``/``value`` rows,
the output ``dense`` columns), in self- and cross-attention alike, so the
cross K/V that ``precompute_cross_kv`` projects once and the decode's KV
cache (``init_cache``) hold this rank's heads; the MLP splits
``intermediate.dense`` rows and ``output.dense`` columns where
``intermediate_size`` divides. Embeddings and the MLM head stay whole.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vast_tpu_torch.models import layers
from vast_tpu_torch.models.layers import dropout
from vast_tpu_torch.models.remat import check_policy, remat_call
from vast_tpu_torch.ops.activations import gelu
from vast_tpu_torch.ops.attention import multi_head_attention
from vast_tpu_torch.parallel import tp as tpl


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    dtype: torch.dtype = torch.float32
    param_dtype: Optional[torch.dtype] = None     # None: dtype
    remat: bool = False
    remat_policy: str = "dots"

    @property
    def pdtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype, compute_dtype=c.dtype)
        self.cfg = c
        self.word_embeddings = layers.Embedding(c.vocab_size, c.hidden_size,
                                                **fk)
        self.position_embeddings = layers.Embedding(
            c.max_position_embeddings, c.hidden_size, **fk)
        self.token_type_embeddings = layers.Embedding(c.type_vocab_size,
                                                      c.hidden_size, **fk)
        self.LayerNorm = layers.LayerNorm(c.hidden_size,
                                          eps=c.layer_norm_eps, device=device,
                                          dtype=c.pdtype)

    def forward(self, input_ids, generator=None, position_ids=None):
        """``position_ids`` (None: ``arange(L)``) broadcast against
        ``input_ids``."""
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)[None]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings.weight[0].to(self.cfg.dtype))
        return dropout(self.LayerNorm(x), self.cfg.hidden_dropout_prob,
                       generator)


class BertSelfAttention(nn.Module):
    """The q/k/v projections (HF ``attention.self``)."""

    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.query = layers.Linear(c.hidden_size, c.hidden_size, **fk)
        self.key = layers.Linear(c.hidden_size, c.hidden_size, **fk)
        self.value = layers.Linear(c.hidden_size, c.hidden_size, **fk)


class BertOutput(nn.Module):
    """Dense + residual LN (HF ``attention.output`` / ``output``)."""

    def __init__(self, c: BertConfig, in_features: int, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.cfg = c
        self.dense = layers.Linear(in_features, c.hidden_size, **fk)
        self.LayerNorm = layers.LayerNorm(c.hidden_size,
                                          eps=c.layer_norm_eps, **fk)

    def forward(self, x, residual, generator=None):
        y = dropout(self.dense(x), self.cfg.hidden_dropout_prob, generator)
        return self.LayerNorm(residual + y)


class BertAttention(nn.Module):
    """Self- or cross-attention + output projection + residual LN."""

    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.cfg = c
        self.self = BertSelfAttention(c, device)
        self.output = BertOutput(c, c.hidden_size, device)
        self.heads = c.num_attention_heads    # this rank's (tp: H / tp)
        self.tp = None

    def tp_linears(self) -> dict:
        return {"self.query": ("query", 1), "self.key": ("key", 1),
                "self.value": ("value", 1), "output.dense": ("out", 1)}

    def tp_splits(self, tp: int) -> bool:
        return self.cfg.num_attention_heads % tp == 0

    def tp_partial_params(self) -> list:
        return []

    def enable_tp(self, tp) -> None:
        tpl.split_module(self, tp)
        self.heads = self.cfg.num_attention_heads // tp.size

    def _heads(self, y):
        return y.view(*y.shape[:-1], self.heads, self.cfg.head_dim)

    def project_kv(self, x):
        """Cross K/V of a condition sequence, (B, Lc, H, D) each."""
        return self._heads(self.self.key(x)), self._heads(self.self.value(x))

    def forward(self, hidden, kv_source=None, mask=None, precomputed_kv=None,
                generator=None, cache=None, cache_index=None):
        """``cache`` (decode, self-attention): this window's K/V are
        written into its slots ``[cache_index, cache_index + lq)`` in
        place and the query attends over the whole cache."""
        c = self.cfg
        b, lq, _ = hidden.shape
        q = self._heads(self.self.query(hidden))
        if precomputed_kv is not None:
            k, v = precomputed_kv
            if k.shape[0] != b:
                # T texts per candidate share one K/V: fold them into the
                # query length of that candidate's row
                if b % k.shape[0]:
                    raise ValueError(
                        f"query batch {b} is not a multiple of the "
                        f"precomputed K/V batch {k.shape[0]}")
                if mask is not None:
                    raise NotImplementedError(
                        "grouped cross-attention assumes unmasked "
                        "condition features")
                q = q.reshape(k.shape[0], b // k.shape[0] * lq,
                              self.heads, c.head_dim)
        else:
            src = hidden if kv_source is None else kv_source
            k, v = self.project_kv(src)
            if cache is not None:
                end = cache_index + lq
                cache["k"][:, cache_index:end] = k.to(cache["k"].dtype)
                cache["v"][:, cache_index:end] = v.to(cache["v"].dtype)
                k, v = cache["k"], cache["v"]
        out = multi_head_attention(q, k, v, mask=mask)
        out = out.reshape(b, lq, self.heads * c.head_dim)
        return self.output(out, hidden, generator)


class BertIntermediate(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.dense = layers.Linear(c.hidden_size, c.intermediate_size,
                                   device=device, dtype=c.pdtype)

    def forward(self, x):
        return gelu(self.dense(x))


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.attention = BertAttention(c, device)
        self.crossattention = BertAttention(c, device)
        self.intermediate = BertIntermediate(c, device)
        self.output = BertOutput(c, c.intermediate_size, device)
        self.ffn = c.intermediate_size

    def tp_linears(self) -> dict:
        return {"intermediate.dense": ("intermediate", 1),
                "output.dense": ("output", 1)}

    def tp_splits(self, tp: int) -> bool:
        return self.ffn % tp == 0

    def tp_partial_params(self) -> list:
        return []

    def enable_tp(self, tp) -> None:
        tpl.split_module(self, tp)

    def forward(self, hidden, self_mask=None, encoder_hidden_states=None,
                cross_mask=None, cross_kv=None, seed: Optional[int] = None,
                cache=None, cache_index=None):
        """``seed`` (training): the layer's dropout draws; None: off.
        ``cache``: the layer's decode cache ({"k", "v"})."""
        g = None if seed is None else layers.seeded(seed, hidden.device)
        hidden = self.attention(hidden, mask=self_mask, generator=g,
                                cache=cache, cache_index=cache_index)
        if encoder_hidden_states is not None or cross_kv is not None:
            hidden = self.crossattention(
                hidden, kv_source=encoder_hidden_states, mask=cross_mask,
                precomputed_kv=cross_kv, generator=g)
        return self.output(self.intermediate(hidden), hidden, g)


def _extend_mask(attention_mask, lq: int):
    """2-D (B, Lk) or 3-D (B, Lq, Lk) mask -> bool (B, 1, Lq, Lk)
    (bert.py get_extended_attention_mask)."""
    if attention_mask is None:
        return None
    if attention_mask.dim() == 2:
        m = attention_mask[:, None, None, :].expand(
            -1, 1, lq, attention_mask.shape[-1])
    elif attention_mask.dim() == 3:
        m = attention_mask[:, None]
    else:
        m = attention_mask
    return m.bool()


class BertEncoder(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c, device)
                                   for _ in range(c.num_hidden_layers))


class BertModel(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.cfg = c
        check_policy(c.remat_policy)
        self.embeddings = BertEmbeddings(c, device)
        self.encoder = BertEncoder(c, device)

    def forward(self, input_ids, attention_mask=None,
                encoder_hidden_states=None, encoder_attention_mask=None,
                cross_kv=None, generator=None, cache=None, cache_index=None,
                cache_mask=None, decode_self_mask=None):
        """Full-sequence forward -> last hidden state (B, L, hidden).
        ``generator`` (the step's, training): dropout on; None: off.

        Decode (``cache`` from :func:`init_cache`): ``input_ids`` is the
        window at positions ``[cache_index, cache_index + lq)``; its
        tokens attend over the cache slots that ``cache_mask`` (B, Lc)
        marks and that lie at or before their own position, or, where
        given, as ``decode_self_mask`` (B, lq, Lc) says (the prompt's
        prefill). Returns ``(hidden, cache)``; the cache is written in
        place. No checkpointing while decoding.
        """
        c = self.cfg
        drop = generator is not None and c.hidden_dropout_prob > 0.0
        emb_g = None
        if drop:
            emb_g = layers.seeded(layers.next_seed(generator),
                                  input_ids.device)
        lq = input_ids.shape[1]
        positions = None
        if cache is not None:
            positions = cache_index + torch.arange(
                lq, device=input_ids.device)[None]
        x = self.embeddings(input_ids, emb_g, positions)
        if cache is None:
            self_mask = _extend_mask(attention_mask, lq)
        elif decode_self_mask is not None:
            self_mask = decode_self_mask[:, None].bool()
        else:
            l_cache = cache[0]["k"].shape[1]
            pos = torch.arange(l_cache, device=x.device)
            self_mask = (cache_mask[:, None, None, :].bool()
                         & (pos[None, None, None, :]
                            <= positions[:, None, :, None]))
        cross_mask = _extend_mask(encoder_attention_mask, lq)
        policy = c.remat_policy if c.remat and cache is None else "none"
        for i, layer in enumerate(self.encoder.layer):
            seed = layers.next_seed(generator) if drop else None
            lkv = None if cross_kv is None else cross_kv[i]
            if cache is not None:
                x = layer(x, self_mask, encoder_hidden_states, cross_mask,
                          lkv, seed, cache[i], cache_index)
            else:
                x = remat_call(policy, layer, x, self_mask,
                               encoder_hidden_states, cross_mask, lkv, seed)
        return x if cache is None else (x, cache)

    def precompute_cross_kv(self, encoder_hidden_states):
        return [layer.crossattention.project_kv(encoder_hidden_states)
                for layer in self.encoder.layer]


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.pdtype)
        self.dense = layers.Linear(c.hidden_size, c.hidden_size, **fk)
        self.LayerNorm = layers.LayerNorm(c.hidden_size,
                                          eps=c.layer_norm_eps, **fk)

    def forward(self, x):
        return self.LayerNorm(gelu(self.dense(x)))


class BertLMPredictionHead(nn.Module):
    """transform + the decoder, whose matrix is tied to the word
    embeddings (``decoder_weight``), plus its bias."""

    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.transform = BertPredictionHeadTransform(c, device)
        self.bias = nn.Parameter(torch.zeros(c.vocab_size, device=device,
                                             dtype=c.pdtype))

    def forward(self, hidden, decoder_weight):
        """fp32 logits: the product in the compute dtype, the bias added
        in fp32 (``vast_tpu``'s bf16 ``attend`` plus its fp32 bias)."""
        x = self.transform(hidden)
        return (F.linear(x, decoder_weight.to(x.dtype)).float()
                + self.bias.float())


class BertOnlyMLMHead(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.predictions = BertLMPredictionHead(c, device)


class BertForMaskedLM(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.cfg = c
        self.bert = BertModel(c, device)
        self.cls = BertOnlyMLMHead(c, device)

    def logits_from_hidden(self, hidden):
        return self.cls.predictions(
            hidden, self.bert.embeddings.word_embeddings.weight)

    def forward(self, input_ids, attention_mask=None, **kwargs):
        """MLM logits (fp32) of :meth:`BertModel.forward`'s hidden states;
        with a ``cache``, ``(logits, cache)``."""
        out = self.bert(input_ids, attention_mask, **kwargs)
        if isinstance(out, tuple):
            return self.logits_from_hidden(out[0]), out[1]
        return self.logits_from_hidden(out)

    def encode(self, *args, **kwargs):
        """Text encoding without the MLM head (multimodal_encoder.bert)."""
        return self.bert(*args, **kwargs)

    def precompute_cross_kv(self, encoder_hidden_states):
        return self.bert.precompute_cross_kv(encoder_hidden_states)


def init_cache(cfg: BertConfig, batch: int, length: int, device=None,
               heads: int | None = None):
    """The decode cache: per layer {"k", "v"} of (B, L, H, D) zeros in the
    compute dtype (``vast_tpu``'s generate follows the model's); ``heads``
    (None: the config's) the model's own heads, H / tp under tp."""
    h, d = heads or cfg.num_attention_heads, cfg.head_dim
    kw = dict(dtype=cfg.dtype, device=device)
    return [{"k": torch.zeros(batch, length, h, d, **kw),
             "v": torch.zeros(batch, length, h, d, **kw)}
            for _ in range(cfg.num_hidden_layers)]


def mlm_loss(logits, labels, ignore_index: int = -100, denom=None):
    """Cross entropy in fp32, summed over the positions whose label is
    not ``ignore_index`` and divided by ``denom`` (None: their count, 1
    where there is none)."""
    valid = labels != ignore_index
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0).long()[..., None])
    nll = torch.where(valid, nll[..., 0], 0.0)
    if denom is None:
        denom = valid.sum().clamp(min=1)
    return nll.sum() / denom
