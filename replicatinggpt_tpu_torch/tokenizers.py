"""Tokenizers for the port: character-level and byte-level BPE.

Copies of ``CharTokenizer``, ``ByteBPETokenizer`` and the ``'char'``,
``'bpe'`` and ``'bpe:<path>'`` branches of ``get_tokenizer`` from
``replicatinggpt_tpu/tokenizers.py``: the same vocabularies, merges,
ids and JSON files. The JAX package's pre-tokenizer is GPT-2's pattern
run by the third-party ``regex`` package. Here the same pattern runs on
the standard library's ``re``, with ``\\s``, ``\\p{L}`` and ``\\p{N}``
spelled out as the code-point classes ``regex`` gives them
(``pretoken_tables.py``, generated from ``regex`` by
``tools/gen_pretoken_tables.py``), so ``regex`` is not needed. Both
engines take the first alternative that matches, leftmost, with greedy
runs that backtrack, so the splits are the same. The tiktoken branch is
not ported: its BPE ranks come over the network (ROADMAP.md does not
queue it). Nor is the JAX package's C++ encoder; ``encode_np`` is the
pure-Python ``encode``.
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .pretoken_tables import LETTER, NUMBER, SPACE


def _class_body(*tables) -> str:
    """The inside of a ``re`` character class holding these ranges."""
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                   for table in tables for a, b in table)


_S, _L, _N = (_class_body(t) for t in (SPACE, LETTER, NUMBER))
#: GPT-2's pre-tokenizer pattern (the JAX package's ``_PRETOKEN_PAT``),
#: ``'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+``
#: ``|\s+(?!\S)|\s+`` for ``re``: contractions, then letter, digit and
#: symbol runs after an optional U+0020, then whitespace runs that leave
#: their last character to a following non-space. ``(?!\S)`` becomes "no
#: character outside the space class follows", true at the end too.
PRETOKEN_RE = re.compile(
    f"'s|'t|'re|'ve|'m|'ll|'d| ?[{_L}]+| ?[{_N}]+| ?[^{_S}{_L}{_N}]+"
    f"|[{_S}]+(?![^{_S}])|[{_S}]+")


def pretokenize(s: str) -> List[str]:
    """What ``regex.findall`` gives for the JAX package's pattern: the
    pieces, in order, cover ``s``."""
    return PRETOKEN_RE.findall(s)


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-character map: every byte
    becomes a printable, non-space character, so merges are strings."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_BYTE_ENCODER = _bytes_to_unicode()
_BYTE_DECODER = {v: k for k, v in _BYTE_ENCODER.items()}


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


class ByteBPETokenizer:
    """Byte-level BPE, trainable and saveable: GPT-2's pre-tokenizer,
    the 256-symbol byte alphabet, then merges ranked by training order."""

    kind = "bpe"

    def __init__(self, merges: List[Tuple[str, str]],
                 vocab: Optional[List[str]] = None):
        self.merges = [tuple(m) for m in merges]
        self.ranks = {m: i for i, m in enumerate(self.merges)}
        if vocab is None:
            base = [_BYTE_ENCODER[b] for b in range(256)]
            vocab = base + ["".join(m) for m in self.merges]
        self.vocab = vocab
        self.token_to_id = {t: i for i, t in enumerate(vocab)}
        self.id_to_token = {i: t for i, t in enumerate(vocab)}
        self._cache: Dict[str, List[int]] = {}

    @classmethod
    def train(cls, text: str, vocab_size: int = 1024) -> "ByteBPETokenizer":
        """Learn merges on ``text`` until the vocabulary holds
        ``vocab_size`` tokens: each round merges the most frequent
        adjacent pair, ties going to the larger pair. Pairs are counted
        over the distinct pre-tokens weighted by their frequency."""
        if vocab_size <= 256:
            raise ValueError("the byte alphabet alone is 256 symbols")
        words = Counter()
        for w in pretokenize(text):
            words[tuple(_BYTE_ENCODER[b] for b in w.encode("utf-8"))] += 1

        merges: List[Tuple[str, str]] = []
        words = dict(words)
        while 256 + len(merges) < vocab_size:
            pairs: Counter = Counter()
            for units, freq in words.items():
                for a, b in zip(units, units[1:]):
                    pairs[(a, b)] += freq
            if not pairs:
                break
            best = max(pairs, key=lambda p: (pairs[p], p))
            merges.append(best)
            merged = best[0] + best[1]
            new_words = {}
            for units, freq in words.items():
                out = []
                i = 0
                while i < len(units):
                    if (i + 1 < len(units) and units[i] == best[0]
                            and units[i + 1] == best[1]):
                        out.append(merged)
                        i += 2
                    else:
                        out.append(units[i])
                        i += 1
                new_words[tuple(out)] = new_words.get(tuple(out), 0) + freq
            words = new_words
        return cls(merges)

    def _bpe_word(self, word: str) -> List[int]:
        if word in self._cache:
            return self._cache[word]
        units = [_BYTE_ENCODER[b] for b in word.encode("utf-8")]
        while len(units) > 1:
            ranked = [(self.ranks.get(p, 1 << 30), i)
                      for i, p in enumerate(zip(units, units[1:]))]
            rank, i = min(ranked)
            if rank >= (1 << 30):
                break
            units = units[:i] + [units[i] + units[i + 1]] + units[i + 2:]
        ids = [self.token_to_id[u] for u in units]
        self._cache[word] = ids
        return ids

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, s: str) -> List[int]:
        out: List[int] = []
        for w in pretokenize(s):
            out.extend(self._bpe_word(w))
        return out

    def encode_np(self, s: str) -> np.ndarray:
        """``encode`` as an int32 array."""
        return np.asarray(self.encode(s), np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.id_to_token[int(i)] for i in ids)
        data = bytes(_BYTE_DECODER[ch] for ch in text)
        return data.decode("utf-8", errors="replace")

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"kind": self.kind, "merges": self.merges,
                       "vocab": self.vocab}, f)

    @classmethod
    def load(cls, path: str) -> "ByteBPETokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls([tuple(m) for m in d["merges"]], d["vocab"])


def get_tokenizer(spec: str, corpus_text: Optional[str] = None,
                  cache_dir: str = "datasets"):
    """Resolve a tokenizer spec:

    - ``'char'``: the char vocabulary of ``corpus_text``;
    - ``'bpe'``: the byte-level BPE of 1024 tokens trained on
      ``corpus_text`` at first use and cached to
      ``cache_dir/bpe_1024.json`` (the JAX package's file and format);
    - ``'bpe:<path>'``: a saved ``ByteBPETokenizer``.

    ``'tiktoken:<name>'`` raises: not in this port yet."""
    if spec == "char":
        if corpus_text is None:
            raise ValueError("the char tokenizer needs the corpus text")
        return CharTokenizer.from_text(corpus_text)
    if spec == "bpe" or spec.startswith("bpe:"):
        if ":" in spec:
            return ByteBPETokenizer.load(spec.split(":", 1)[1])
        if corpus_text is None:
            raise ValueError("training the BPE needs the corpus text")
        cache = os.path.join(cache_dir, "bpe_1024.json")
        if os.path.exists(cache):
            return ByteBPETokenizer.load(cache)
        tok = ByteBPETokenizer.train(corpus_text, vocab_size=1024)
        try:
            os.makedirs(cache_dir, exist_ok=True)
            tok.save(cache)
        except OSError:
            pass
        return tok
    if spec.startswith("tiktoken"):
        raise NotImplementedError(
            f"tokenizer {spec!r} is not ported to replicatinggpt_tpu_torch: "
            f"its BPE ranks come over the network, which the port does not "
            f"fetch (ROADMAP.md does not queue it)")
    raise ValueError(f"unknown tokenizer spec {spec!r}")
