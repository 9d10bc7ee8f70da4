"""Attention cores over a gathered KV view, as plain tensor code.

Ports of ``replicatinggpt_tpu/ops/attention.py`` ``cached_attention``
and ``windowed_cached_attention``: the paged engine's gather route and
its prefill attention. Conventions: q, k, v are (B, H, T, D); scores
and softmax in f32 whatever the compute dtype; the weights are cast to
v's dtype before the value product, as the JAX cores do.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30   # large-negative instead of -inf: NaN-free masked rows


def _masked_softmax_pv(q, k, v, keep, scale):
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return w.to(v.dtype) @ v


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
