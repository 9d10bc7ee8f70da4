"""Autoregressive generation and the serving engine's sampler.

Ports of ``replicatinggpt_tpu/sample/generate.py``:

- the batched per-row sampler of the serving engine: every row is a
  pool slot with its own temperature, top-k, top-p and greedy switch,
  and its own random stream — here one ``torch.Generator`` per row;
- ``generate()``: a prefill, then one sampled token per
  ``models.gpt.decode_step`` against the KV cache, with the JAX
  package's prompt bucketing and window refresh (when the cache fills,
  the last ``block_size // 2`` tokens are prefilled again and decoding
  goes on). The sampled token stays on the device between steps and the
  position is a host int, so a step waits on nothing. The TPU dispatch
  scaffolding is not ported: there is no power-of-two grouping of
  refresh segments (each segment is one host loop) and no cache growth
  by chunks (the kernels read only rows < pos, so a whole-``block_size``
  buffer costs nothing extra). Greedy tokens are the JAX package's.

torch and JAX give different numbers from the same seed, so only the
kept sets and greedy picks are comparable across the two.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models.gpt import (GPT, Params, compute_params, decode_step,
                          init_kv_cache, prefill)
from ..ops.decode import fused_weights


@dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 500
    temperature: float = 1.0
    top_k: int = 0          # 0 = full multinomial
    top_p: float = 0.0      # 0 = off; (0, 1) = nucleus (after top-k)
    greedy: bool = False
    vocab_limit: int = 0    # 0 = off; else only ids below it are drawn


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
    idle slot) gives 0. Nothing is read back to the host: a draw is
    ``torch.multinomial``'s one-sample path (the argmax of p / q, q
    exponential from the generator: the same draws, the same token)
    without its host-side checks of the probabilities."""
    greedy = torch.as_tensor(greedy, device=logits.device, dtype=torch.bool)
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    draw = [b for b, g in enumerate(generators) if g is not None]
    if not draw:
        return torch.where(greedy, out, torch.zeros_like(out))
    probs = torch.softmax(
        filter_logits_batched(logits, temperature, top_k, top_p), dim=-1)
    sampled = torch.zeros_like(out)
    for b in draw:
        q = torch.empty_like(probs[b]).exponential_(
            1, generator=generators[b])
        sampled[b] = torch.argmax(probs[b] / q)
    return torch.where(greedy, out, sampled)


def _sample_token(generator: Optional[torch.Generator], logits: torch.Tensor,
                  gcfg: GenerateConfig) -> torch.Tensor:
    """(B, V) f32 logits -> (B,) int32: greedy argmax, or temperature ->
    top-k -> top-p -> one draw per row from ``generator``, over the
    first ``gcfg.vocab_limit`` ids when that is set (a tokenizer with
    fewer ids than the model's vocabulary)."""
    if 0 < gcfg.vocab_limit < logits.shape[-1]:
        logits = logits[:, :gcfg.vocab_limit]
    if gcfg.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    B, V = logits.shape
    logits = logits / max(gcfg.temperature, 1e-6)
    if gcfg.top_k and gcfg.top_k > 0:
        k = torch.full((B,), min(gcfg.top_k, V), dtype=torch.long,
                       device=logits.device)
        logits = batched_top_k_filter(logits, k)
    if gcfg.top_p and gcfg.top_p > 0.0:
        p = torch.full((B,), gcfg.top_p, dtype=torch.float32,
                       device=logits.device)
        logits = batched_top_p_filter(logits, p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _segment_core(params: Params, prompt: torch.Tensor, prompt_len: int,
                  n_new: int, cfg: ModelConfig, gcfg: GenerateConfig,
                  generator: Optional[torch.Generator],
                  allow_kernels: bool,
                  blocks: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """One prefill of the (B, P_pad) prompt, then exactly ``n_new``
    decode steps from position ``prompt_len - 1``. Requires P_pad +
    n_new <= block_size + 1. Returns (B, n_new) int32."""
    B = prompt.shape[0]
    cache = init_kv_cache(cfg, B, device=prompt.device)
    prefill(params, prompt, cache, cfg)
    start = prompt_len - 1
    tok = prompt[:, start]
    out = torch.empty((B, n_new), dtype=torch.int32, device=prompt.device)
    for i in range(n_new):
        logits, cache = decode_step(params, tok, start + i, cache, cfg,
                                    allow_kernels=allow_kernels,
                                    fused_blocks=blocks)
        tok = _sample_token(generator, logits, gcfg)
        out[:, i] = tok
    return out


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def generate(model: GPT, prompt, cfg: ModelConfig,
             gcfg: GenerateConfig = GenerateConfig(),
             generator: Optional[torch.Generator] = None, *, device=None,
             allow_kernels: bool = True) -> torch.Tensor:
    """Generate ``gcfg.max_new_tokens`` continuations of ``prompt``.

    model: the master weights (cast once per call with
    ``compute_params``). prompt: (B, P) token ids, 1 <= P <= block_size
    (the reference's zero-context start is one 0 token). device: None means the card (raises without one).
    generator: the sampling stream, on the device (default: seed 0).
    allow_kernels False forces ``decode_step``'s plain route. Returns
    (B, max_new_tokens) int32 on the device.

    Segments as in JAX: the prompt is padded to a power of two (true
    length kept); the first segment runs min(pow2(n), S - P_pad + 1)
    steps; every refresh segment prefills the last S // 2 tokens and
    runs S // 2 + 1 steps; surplus tokens of the last are dropped."""
    dev = resolve_device(device)
    params = compute_params(model, dev)
    prompt = (prompt if isinstance(prompt, torch.Tensor)
              else torch.as_tensor(np.asarray(prompt))).to(dev, torch.int32)
    if prompt.dim() != 2 or prompt.shape[1] < 1:
        raise ValueError(f"prompt must be (B, P) with P >= 1; got "
                         f"{tuple(prompt.shape)}")
    S = cfg.block_size
    B, P0 = prompt.shape
    if P0 > S:
        raise ValueError(f"prompt of {P0} tokens is longer than "
                         f"block_size={S}")
    remaining = gcfg.max_new_tokens
    if remaining <= 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    # the fused route's weights, cast once (a no-op for all but the
    # layernorm parameters); decode_step decides whether it runs
    blocks = (fused_weights(params["blocks"], cfg.compute_dtype)
              if allow_kernels and B == 1 else None)

    def segment(p, plen, n):
        return _segment_core(params, p, plen, n, cfg, gcfg, generator,
                             allow_kernels, blocks)

    P_pad = min(_pow2_at_least(P0), S)
    padded = torch.nn.functional.pad(prompt, (0, P_pad - P0))
    n1 = min(_pow2_at_least(remaining), S - P_pad + 1)
    toks = segment(padded, P0, n1)
    take = min(n1, remaining)
    chunks = [toks[:, :take]]
    remaining -= take
    Pw, n_mid = S // 2, S // 2 + 1
    window = torch.cat([prompt, toks[:, :take]], dim=1)[:, -Pw:]
    while remaining > 0:
        toks = segment(window, Pw, n_mid)
        take = min(n_mid, remaining)
        chunks.append(toks[:, :take])
        remaining -= take
        window = torch.cat([window, toks], dim=1)[:, -Pw:]
    return torch.cat(chunks, dim=1)
