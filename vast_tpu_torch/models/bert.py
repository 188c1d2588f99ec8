"""BERT with cross-attention in every layer (VAST's fusion encoder).

Counterpart of ``vast_tpu.models.bert`` for the retrieval path: the
embeddings, self- and cross-attention with their output LN, the MLP, the
full-sequence encode with a 2-D or 3-D mask, cross K/V computed once per
condition sequence (``precompute_cross_kv``), and the ``kv_groups`` fold
that scores T texts against one candidate's K/V (bert.py:116-135). The
MLM head's weights are here so the state dict is complete; the MLM loss
and the decode KV cache come with the captioning slice.

Module names follow HF's BertForMaskedLM, so the reference state dict
(``multimodal_encoder.bert.encoder.layer.{i}.attention.self.query...``)
loads as it is. Attention routes by shape (ops/attention.py): the
caption's self-attention and one caption's cross-attention take the plain
route, and the grouped rerank's folded query, from 8 texts per candidate
on, the head-major CUDA kernel.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vast_tpu_torch.ops.activations import gelu
from vast_tpu_torch.ops.attention import multi_head_attention


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
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.dtype)
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size, **fk)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size, **fk)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size, **fk)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      **fk)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)[None]
             + self.token_type_embeddings.weight[0])
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    """The q/k/v projections (HF ``attention.self``)."""

    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.dtype)
        self.query = nn.Linear(c.hidden_size, c.hidden_size, **fk)
        self.key = nn.Linear(c.hidden_size, c.hidden_size, **fk)
        self.value = nn.Linear(c.hidden_size, c.hidden_size, **fk)


class BertOutput(nn.Module):
    """Dense + residual LN (HF ``attention.output`` / ``output``)."""

    def __init__(self, c: BertConfig, in_features: int, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.dtype)
        self.dense = nn.Linear(in_features, c.hidden_size, **fk)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      **fk)

    def forward(self, x, residual):
        return self.LayerNorm(residual + self.dense(x))


class BertAttention(nn.Module):
    """Self- or cross-attention + output projection + residual LN."""

    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.cfg = c
        self.self = BertSelfAttention(c, device)
        self.output = BertOutput(c, c.hidden_size, device)

    def _heads(self, y):
        c = self.cfg
        return y.view(*y.shape[:-1], c.num_attention_heads, c.head_dim)

    def project_kv(self, x):
        """Cross K/V of a condition sequence, (B, Lc, H, D) each."""
        return self._heads(self.self.key(x)), self._heads(self.self.value(x))

    def forward(self, hidden, kv_source=None, mask=None, precomputed_kv=None):
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
                              c.num_attention_heads, c.head_dim)
        else:
            src = hidden if kv_source is None else kv_source
            k, v = self.project_kv(src)
        out = multi_head_attention(q, k, v, mask=mask)
        out = out.reshape(b, lq, c.hidden_size)
        return self.output(out, hidden)


class BertIntermediate(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.intermediate_size,
                               device=device, dtype=c.dtype)

    def forward(self, x):
        return gelu(self.dense(x))


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.attention = BertAttention(c, device)
        self.crossattention = BertAttention(c, device)
        self.intermediate = BertIntermediate(c, device)
        self.output = BertOutput(c, c.intermediate_size, device)

    def forward(self, hidden, self_mask=None, encoder_hidden_states=None,
                cross_mask=None, cross_kv=None):
        hidden = self.attention(hidden, mask=self_mask)
        if encoder_hidden_states is not None or cross_kv is not None:
            hidden = self.crossattention(
                hidden, kv_source=encoder_hidden_states, mask=cross_mask,
                precomputed_kv=cross_kv)
        return self.output(self.intermediate(hidden), hidden)


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
        self.embeddings = BertEmbeddings(c, device)
        self.encoder = BertEncoder(c, device)

    def forward(self, input_ids, attention_mask=None,
                encoder_hidden_states=None, encoder_attention_mask=None,
                cross_kv=None):
        """Full-sequence forward -> last hidden state (B, L, hidden)."""
        x = self.embeddings(input_ids)
        lq = x.shape[1]
        self_mask = _extend_mask(attention_mask, lq)
        cross_mask = _extend_mask(encoder_attention_mask, lq)
        for i, layer in enumerate(self.encoder.layer):
            x = layer(x, self_mask, encoder_hidden_states, cross_mask,
                      None if cross_kv is None else cross_kv[i])
        return x

    def precompute_cross_kv(self, encoder_hidden_states):
        return [layer.crossattention.project_kv(encoder_hidden_states)
                for layer in self.encoder.layer]


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        fk = dict(device=device, dtype=c.dtype)
        self.dense = nn.Linear(c.hidden_size, c.hidden_size, **fk)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      **fk)


class BertLMPredictionHead(nn.Module):
    """MLM head weights: transform + decoder bias (the decoder matrix is
    tied to the word embeddings). Its forward comes with captioning."""

    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.transform = BertPredictionHeadTransform(c, device)
        self.bias = nn.Parameter(torch.zeros(c.vocab_size, device=device,
                                             dtype=c.dtype))


class BertOnlyMLMHead(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.predictions = BertLMPredictionHead(c, device)


class BertForMaskedLM(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.bert = BertModel(c, device)
        self.cls = BertOnlyMLMHead(c, device)

    def encode(self, *args, **kwargs):
        """Text encoding without the MLM head (multimodal_encoder.bert)."""
        return self.bert(*args, **kwargs)

    def precompute_cross_kv(self, encoder_hidden_states):
        return self.bert.precompute_cross_kv(encoder_hidden_states)
