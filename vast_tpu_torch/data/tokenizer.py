"""BERT-compatible WordPiece tokenizer (pure Python, offline).

The port's own copy of ``vast_tpu.data.tokenizer``. The reference loads
HF's ``bert-base-uncased`` tokenizer (model/vast.py:72-75) and sets
CLS/SEP as BOS/EOS; here the standard BasicTokenizer + WordPiece
algorithm reads a ``vocab.txt``. Special-token ids of the released vocab:
[PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103. ``tiny_tokenizer``
is a small built-in vocabulary with the same special ids, for tests and
synthetic data.
"""

from __future__ import annotations

import os
import unicodedata

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BertTokenizer:
    """Uncased WordPiece tokenizer with numpy batch encoding."""

    def __init__(self, vocab: dict[str, int] | list[str], lowercase: bool = True):
        if isinstance(vocab, list):
            vocab = {tok: i for i, tok in enumerate(vocab)}
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.lowercase = lowercase
        self.unk_token = "[UNK]"
        self.pad_token_id = vocab.get("[PAD]", 0)
        self.unk_token_id = vocab.get("[UNK]", 100)
        self.cls_token_id = vocab.get("[CLS]", 101)
        self.sep_token_id = vocab.get("[SEP]", 102)
        self.mask_token_id = vocab.get("[MASK]", 103)
        # reference aliases (model/vast.py:72-75)
        self.bos_token_id = self.cls_token_id
        self.eos_token_id = self.sep_token_id
        self.special_ids = {
            self.pad_token_id,
            self.cls_token_id,
            self.sep_token_id,
            self.mask_token_id,
        }
        self.max_input_chars_per_word = 100

    # -- construction -------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str) -> "BertTokenizer":
        with open(path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        return cls(tokens)

    @classmethod
    def from_pretrained(cls, path: str) -> "BertTokenizer":
        if os.path.isdir(path):
            path = os.path.join(path, "vocab.txt")
        return cls.from_vocab_file(path)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- basic tokenization -------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _split_basic(self, text: str) -> list[str]:
        text = self._clean(text)
        # pad CJK chars with spaces
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        text = "".join(out)
        tokens = []
        for tok in text.strip().split():
            if self.lowercase:
                tok = tok.lower()
                tok = "".join(
                    c for c in unicodedata.normalize("NFD", tok)
                    if unicodedata.category(c) != "Mn"
                )
            # split on punctuation
            cur: list[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    def _wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        sub_tokens: list[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            sub_tokens.append(cur)
            start = end
        return sub_tokens

    def tokenize(self, text: str) -> list[str]:
        out = []
        for tok in self._split_basic(text):
            out.extend(self._wordpiece(tok))
        return out

    def convert_tokens_to_ids(self, tokens: list[str]) -> list[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    # -- encode / decode ----------------------------------------------
    def encode(self, text: str, max_length: int) -> tuple[list[int], list[int]]:
        """[CLS] tokens [SEP], truncated + padded to ``max_length``."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        ids = ids[: max_length - 2]
        ids = [self.cls_token_id] + ids + [self.sep_token_id]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        ids = ids + [self.pad_token_id] * pad
        mask = mask + [0] * pad
        return ids, mask

    def __call__(self, texts: list[str] | str, max_length: int = 40):
        """HF-ish batch API: returns dict of int32 numpy arrays."""
        if isinstance(texts, str):
            texts = [texts]
        ids, masks = zip(*(self.encode(t, max_length) for t in texts))
        return {
            "input_ids": np.asarray(ids, dtype=np.int32),
            "attention_mask": np.asarray(masks, dtype=np.int32),
        }

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_ids:
                if i == self.sep_token_id:
                    break
                continue
            toks.append(self.inv_vocab.get(i, self.unk_token))
        text = " ".join(toks).replace(" ##", "")
        return text.strip()

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch_ids]


_WORDS = [
    "a", "the", "of", "and", "in", "on", "man", "woman", "dog", "cat", "is",
    "run", "##ning", "walk", "play", "##ing", "ball", "park", "red", "blue",
    "green", "car", "bike", "street", "water", "beach", "sing", "music",
    "guitar", "drum", "bird", "talk", "##s", "jump", "ride", "eat", "food",
    "table", "chair", "room", "house", "tree", "sky", "sun", "rain", "snow",
    "boy", "girl", "child", "people", "crowd", "two", "three", "with", "at",
    "near", "over", "under", "small", "big", "fast", "slow", "video", "audio",
]


def tiny_tokenizer(extra_words: list[str] | None = None) -> BertTokenizer:
    """Small self-contained tokenizer for tests and synthetic data.

    Keeps the released vocab's special-token ids ([PAD]=0 ... [MASK]=103,
    words from 106) so masking/label logic is exercised realistically.
    """
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]  # 0..99
    vocab += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]  # 100..103
    vocab += ["[unused99]", "[unused100]"]  # 104, 105
    words = list(_WORDS)
    if extra_words:
        words += [w for w in extra_words if w not in words]
    vocab += words
    return BertTokenizer(vocab)
