"""Batched per-row sampling for the serving engine.

Ports of ``replicatinggpt_tpu/sample/generate.py``'s batched sampler:
every row is a pool slot with its own temperature, top-k, top-p and
greedy switch, and its own random stream — here one ``torch.Generator``
per row (torch and JAX give different numbers from the same seed, so
only the kept sets and greedy picks are comparable across the two).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch


@dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 500
    temperature: float = 1.0
    top_k: int = 0          # 0 = full multinomial
    top_p: float = 0.0      # 0 = off; (0, 1) = nucleus (after top-k)
    greedy: bool = False


def batched_top_k_filter(logits: torch.Tensor, k: torch.Tensor
                         ) -> torch.Tensor:
    """Per-row top-k: logits strictly below the row's k-th largest value
    (counting repeats) go to -inf, so ties at the k-th value are kept.
    Rows with k <= 0 or k >= V pass through unchanged. (JAX finds the
    k-th value by a radix select, a TPU sort workaround; a sort gives
    the same value.)"""
    V = logits.shape[-1]
    k = torch.as_tensor(k, device=logits.device).long()
    off = (k <= 0) | (k >= V)
    k_eff = torch.where(off, torch.ones_like(k), k)
    desc = torch.sort(logits.float(), dim=-1, descending=True).values
    kth = desc.gather(1, (k_eff - 1)[:, None])
    filtered = torch.where(logits < kth, torch.full_like(logits, -torch.inf),
                           logits)
    return torch.where(off[:, None], logits, filtered)


def batched_top_p_filter(logits: torch.Tensor, p: torch.Tensor
                         ) -> torch.Tensor:
    """Per-row nucleus filter: keep the smallest prefix of the
    descending-probability order whose mass reaches p (the top token
    always); rows with p <= 0 or p >= 1 pass through. The order is JAX's
    (a stable ascending argsort, reversed), so tied logits rank by
    DESCENDING index and the kept set at a tie matches."""
    p = torch.as_tensor(p, device=logits.device, dtype=torch.float32)
    off = (p <= 0.0) | (p >= 1.0)
    idx = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    sorted_logits = logits.gather(1, idx)
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < torch.where(off, torch.ones_like(p), p)[:, None]
    mask = torch.zeros_like(keep).scatter(1, idx, keep)
    filtered = torch.where(mask, logits, torch.full_like(logits, -torch.inf))
    return torch.where(off[:, None], logits, filtered)


def filter_logits_batched(logits: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor
                          ) -> torch.Tensor:
    """temperature -> top-k -> top-p, each per row."""
    t = torch.as_tensor(temperature, device=logits.device,
                        dtype=torch.float32)
    scaled = logits / torch.clamp(t, min=1e-6)[:, None]
    return batched_top_p_filter(batched_top_k_filter(scaled, top_k), top_p)


def sample_tokens_batched(generators: Sequence[Optional[torch.Generator]],
                          logits: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor,
                          greedy: torch.Tensor) -> torch.Tensor:
    """(B, V) f32 logits -> (B,) int32 tokens. Greedy rows take the
    argmax of the RAW logits; a row with a generator draws from its
    filtered distribution with that generator; a row with neither (an
    idle slot) gives 0."""
    greedy = torch.as_tensor(greedy, device=logits.device, dtype=torch.bool)
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    draw = [b for b, g in enumerate(generators) if g is not None]
    if not draw:
        return torch.where(greedy, out, torch.zeros_like(out))
    probs = torch.softmax(
        filter_logits_batched(logits, temperature, top_k, top_p), dim=-1)
    sampled = torch.zeros_like(out)
    for b in draw:
        sampled[b] = torch.multinomial(probs[b], 1,
                                       generator=generators[b])[0]
    return torch.where(greedy, out, sampled)
