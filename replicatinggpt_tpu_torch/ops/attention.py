"""Attention cores and dropout, as plain tensor code.

Ports of ``replicatinggpt_tpu/ops/attention.py``: ``cached_attention``
and ``windowed_cached_attention`` (the paged engine's gather route and
its prefill attention), ``full_causal_attention`` (the training block's
split-heads route: ``impl="flash"`` takes the (B, H, T, D) flash kernel
of ``ops/flash_attention.flash_attention``, ``"einsum"`` the plain core)
and the dropout helpers every dropout site shares, ``DropoutRNG`` among
them. Conventions: q, k, v are (B, H, T, D); scores and softmax in f32
whatever the compute dtype; the weights are cast to v's dtype before the
value product, as the JAX cores do. Random bits come from an explicit
``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30   # large-negative instead of -inf: NaN-free masked rows


def quantize_dropout_rate(rate: float) -> float:
    """A dropout rate quantized to 1/256 (clamped to [1/256, 255/256]):
    every dropout site, the flash kernel's in-kernel mask included, uses
    this effective rate."""
    return min(max(int(round(rate * 256)), 1), 255) / 256.0


def uint8_inverted_dropout(x: torch.Tensor, rate: float,
                           generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout from 8-bit random draws: drop iff bits < 256*q;
    kept entries scale by 1/(1-q), so E[out] == x."""
    q = quantize_dropout_rate(rate)
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                         generator=generator, device=x.device)
    return torch.where(bits >= int(q * 256), x / (1.0 - q),
                       torch.zeros_like(x))


def _softmax_dropout(weights: torch.Tensor, rate: float,
                     generator: Optional[torch.Generator],
                     train: bool) -> torch.Tensor:
    if not train or rate <= 0.0 or generator is None:
        return weights
    return uint8_inverted_dropout(weights, rate, generator)


def _masked_softmax_pv(q, k, v, keep, scale, *, rate: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       train: bool = False):
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    w = _softmax_dropout(torch.softmax(s, dim=-1), rate, generator, train)
    return w.to(v.dtype) @ v


class DropoutRNG:
    """The random streams of one training run's dropout: ``bits``, a
    generator on the device, draws the residual masks (and the plain
    core's attention masks); ``seeds``, a CPU generator, draws the flash
    kernels' int32 seeds and the blocks' own seeds, so no draw waits on
    the card. ``stream`` (a sequence shard's rank) decorrelates ``bits``
    between the processes of a seq group, whose residual masks cover other
    positions, and leaves ``seeds`` alone: every rank draws the same
    kernel seeds, so a (q, k) pair's hashed attention mask is the same on
    whichever rank computes it. Stream 0 is the single-process stream."""

    def __init__(self, seed: int, device=None, stream: int = 0):
        dev = torch.device("cpu" if device is None else device)
        self.stream = stream
        bits_seed = seed if stream == 0 else \
            (seed + stream * 0x9E3779B97F4A7C15) % 2 ** 63
        self.bits = torch.Generator(device=dev).manual_seed(bits_seed)
        self.seeds = torch.Generator().manual_seed(seed)

    def kernel_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.seeds))


def full_causal_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, scale: Optional[float] = None,
                          dropout_rate: float = 0.0,
                          rng: Optional[DropoutRNG] = None,
                          train: bool = False,
                          impl: str = "einsum") -> torch.Tensor:
    """Causal self-attention over a full sequence, q/k/v (B, H, T, D),
    with dropout on the attention weights when training.
    ``impl="flash"`` runs ``flash_attention`` (the kernel inside its
    envelope, with its hashed mask when training with dropout); with
    dropout outside the kernel's envelope it takes the plain core and
    its generator mask, as the JAX fallback does."""
    if impl == "flash":
        from .flash_attention import flash_attention, supports_dropout
        training_dropout = train and dropout_rate > 0.0 and rng is not None
        if not training_dropout:
            return flash_attention(q, k, v, scale=scale, causal=True)
        if supports_dropout(q):
            return flash_attention(q, k, v, scale=scale, causal=True,
                                   dropout_rate=dropout_rate, rng=rng)
    T, D = q.shape[-2:]
    pos = torch.arange(T, device=q.device)
    return _masked_softmax_pv(q, k, v, pos[None, :] <= pos[:, None],
                              D ** -0.5 if scale is None else scale,
                              rate=dropout_rate,
                              generator=None if rng is None else rng.bits,
                              train=train)


def cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_index: torch.Tensor) -> torch.Tensor:
    """Single-position decode attention: q (B, H, 1, D) against caches
    (B, H, S, D), attending positions <= ``cache_index`` (a scalar or a
    (B,) vector of per-row positions)."""
    S, D = k_cache.shape[-2:]
    kpos = torch.arange(S, device=q.device)
    ci = torch.as_tensor(cache_index, device=q.device)
    if ci.dim() == 1:
        ci = ci[:, None, None, None]
    return _masked_softmax_pv(q, k_cache, v_cache, kpos <= ci, D ** -0.5)


def windowed_cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor,
                              base_index: torch.Tensor) -> torch.Tensor:
    """Multi-position attention: q (B, H, W, D), query j of row b at
    absolute position ``base_index[b] + j``, attending cache positions
    <= its own."""
    S, D = k_cache.shape[-2:]
    W = q.shape[2]
    kpos = torch.arange(S, device=q.device)[None, :]
    qj = torch.arange(W, device=q.device)[:, None]
    base = torch.as_tensor(base_index, device=q.device)
    limit = base[:, None, None, None] + qj                     # (B,1,W,1)
    return _masked_softmax_pv(q, k_cache, v_cache, kpos <= limit,
                              D ** -0.5)
