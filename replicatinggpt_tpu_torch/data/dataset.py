"""Corpus loading and the tokenized train/val split (a copy of
``replicatinggpt_tpu/data/dataset.py``). Tokens stay on the host as a
NumPy array; the batchers and ``prefetch`` move them to the device."""

from __future__ import annotations

import dataclasses

import numpy as np


def load_corpus(path: str) -> str:
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


@dataclasses.dataclass
class TokenDataset:
    """Tokenized corpus with a train/val split (first 90% / last 10%)."""

    train: np.ndarray  # int32 [n_train]
    val: np.ndarray    # int32 [n_val]
    vocab_size: int

    @classmethod
    def from_text(cls, text: str, tokenizer, val_fraction: float = 0.1
                  ) -> "TokenDataset":
        ids = np.asarray(tokenizer.encode_np(text), dtype=np.int32)
        n = int(len(ids) * (1.0 - val_fraction))
        return cls(train=ids[:n], val=ids[n:], vocab_size=tokenizer.vocab_size)
