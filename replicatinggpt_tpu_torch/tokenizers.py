"""Tokenizers for the port: the character-level tokenizer.

A copy of ``CharTokenizer`` and the ``'char'`` branch of
``get_tokenizer`` from ``replicatinggpt_tpu/tokenizers.py``. The
byte-level BPE and tiktoken branches come with GPT-2-scale training
(ROADMAP.md queue A item 3); asking for them raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class CharTokenizer:
    """Character-level tokenizer: the vocabulary is the sorted set of the
    corpus's characters (65 for Tiny Shakespeare)."""

    def __init__(self, chars: Sequence[str]):
        self.chars = list(chars)
        self.stoi = {c: i for i, c in enumerate(self.chars)}
        self.itos = {i: c for i, c in enumerate(self.chars)}

    @classmethod
    def from_text(cls, text: str) -> "CharTokenizer":
        return cls(sorted(set(text)))

    @property
    def vocab_size(self) -> int:
        return len(self.chars)

    def encode(self, s: str) -> List[int]:
        return [self.stoi[c] for c in s]

    def encode_np(self, s: str) -> np.ndarray:
        """Corpus-scale encode (the same ids as ``encode``): one lookup per
        distinct character instead of one per position."""
        codes = np.frombuffer(s.encode("utf-32-le"), np.uint32)
        uniq, inv = np.unique(codes, return_inverse=True)
        lut = np.array([self.stoi[chr(int(u))] for u in uniq], np.int32)
        return lut[inv].reshape(-1)

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.itos[int(i)] for i in ids)


def get_tokenizer(spec: str, corpus_text: Optional[str] = None
                  ) -> CharTokenizer:
    """``'char'``: the char vocabulary of ``corpus_text``. Every other
    spec of the JAX package (``'bpe'``, ``'bpe:<path>'``,
    ``'tiktoken:<name>'``) raises."""
    if spec == "char":
        if corpus_text is None:
            raise ValueError("the char tokenizer needs the corpus text")
        return CharTokenizer.from_text(corpus_text)
    raise NotImplementedError(
        f"tokenizer {spec!r} is not in replicatinggpt_tpu_torch yet: "
        f"ROADMAP.md queue A item 3 (BPE and tiktoken tokenizers)")
