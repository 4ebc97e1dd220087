"""Static-shape WordPiece tokenization.

The port's own copy of ``WordPieceTokenizer`` from
``egovlp_tpu/data/text.py`` (:25-137): BERT-uncased conventions ([CLS] ...
[SEP], pad id 0), always padded or truncated to ``max_length``.  The
HuggingFace ``tokenizers`` WordPiece is used when that package is
installed; otherwise the pure-Python WordPiece below gives the same ids.
"""

from __future__ import annotations

import unicodedata
from typing import List, Sequence, Tuple

import numpy as np


class WordPieceTokenizer:
    """BERT-uncased WordPiece with fixed-length output."""

    def __init__(self, vocab_path: str, max_length: int = 30,
                 lowercase: bool = True, backend: str = "auto"):
        self.vocab_path = vocab_path
        self.max_length = int(max_length)
        self.lowercase = lowercase
        self._rust = None
        if backend in ("auto", "rust"):
            try:
                from tokenizers import BertWordPieceTokenizer

                tok = BertWordPieceTokenizer(vocab_path, lowercase=lowercase)
                tok.enable_padding(length=self.max_length, pad_id=0,
                                   pad_token="[PAD]")
                tok.enable_truncation(max_length=self.max_length)
                self._rust = tok
            except Exception:
                if backend == "rust":
                    raise
        if self._rust is None:
            self._vocab = self._load_vocab(vocab_path)

    def __call__(self, texts) -> Tuple[np.ndarray, np.ndarray]:
        """texts: str or sequence of str -> (input_ids, attention_mask),
        both int32 [B, max_length]."""
        if isinstance(texts, str):
            texts = [texts]
        texts = [str(t) for t in texts]
        if self._rust is not None:
            encs = self._rust.encode_batch(texts)
            ids = np.asarray([e.ids for e in encs], np.int32)
            mask = np.asarray([e.attention_mask for e in encs], np.int32)
            return ids, mask
        return self._encode_python(texts)

    @staticmethod
    def _load_vocab(path):
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return vocab

    def _basic_tokens(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
            text = unicodedata.normalize("NFD", text)
            text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out, cur = [], []
        for ch in text:
            if ch.isspace():
                if cur:
                    out.append("".join(cur))
                    cur = []
            elif unicodedata.category(ch).startswith("P") or ch in "$+<=>^`|~":
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    def _wordpiece(self, word: str) -> List[str]:
        unk = "[UNK]"
        if len(word) > 100:
            return [unk]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self._vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [unk]
            pieces.append(piece)
            start = end
        return pieces

    def _encode_python(self, texts: Sequence[str]):
        L = self.max_length
        ids = np.zeros((len(texts), L), np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        cls_id = self._vocab.get("[CLS]", 101)
        sep_id = self._vocab.get("[SEP]", 102)
        unk_id = self._vocab.get("[UNK]", 100)
        for b, text in enumerate(texts):
            toks: List[int] = [cls_id]
            for w in self._basic_tokens(text):
                for p in self._wordpiece(w):
                    toks.append(self._vocab.get(p, unk_id))
            toks = toks[: L - 1]
            toks.append(sep_id)
            ids[b, : len(toks)] = toks
            mask[b, : len(toks)] = 1
        return ids, mask
