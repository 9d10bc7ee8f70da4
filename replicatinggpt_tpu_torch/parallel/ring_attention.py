"""Ring attention: causal self-attention with the sequence split into
``--sp`` shards, each hop one chunk-attention kernel launch.

The port of ``replicatinggpt_tpu/parallel/ring_attention.py``'s ring with
Pallas chunk hops (``_ring_local_flash``), the body the JAX package runs
on a TPU. Shard i holds the queries, keys and values of positions
[i Tl, (i + 1) Tl). Its first hop is the diagonal (its own K/V); at hop s
it holds the K/V chunk of shard (i - s) mod n, and the hops of later
chunks (src > i, fully masked) are skipped, as the JAX ring's
``lax.cond`` skips them. Each hop is ``ops.flash_chunk.flash_chunk`` at
the global offsets (q at i Tl, k at src Tl): the ``csrc/flash_packed.cu``
chunk kernel on CUDA tensors, its plain version on CPU tensors. Hops
merge (o, lse) by the logsumexp recurrence in plain PyTorch in f32, as the
JAX merge is plain JAX, so the whole ring is differentiable through the
hops' lse. One kernel seed serves every hop of a call (JAX passes one rng
to every hop): the mask hashes global positions, so each (q, k) pair
draws once wherever it is computed.

The shards live in a ``parallel.mesh`` group: all of them in one process
(``LocalSeqGroup``) or one per process (``ProcessSeqGroup``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_chunk import flash_chunk


def _merge(o_acc, lse_acc, o_s, lse_s):
    """Logsumexp merge of two partial attentions over disjoint keys. Both
    lse's are finite on every hop the ring runs: the diagonal's rows see
    themselves and earlier chunks are fully visible."""
    m = torch.maximum(lse_acc, lse_s)
    w1 = torch.exp(lse_acc - m)
    w2 = torch.exp(lse_s - m)
    denom = w1 + w2
    o = (o_acc * w1[..., None] + o_s.float() * w2[..., None]) \
        / denom[..., None]
    return o, m + torch.log(denom)


def _ring_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                group, scale: Optional[float] = None, seed: int = 0,
                rate: float = 0.0) -> torch.Tensor:
    """The hop loop. q, k, v: (S, B, H, Tl, D), the S shards this process
    holds (``group.shards``). Returns (S, B, H, Tl, D) in q's dtype, each
    shard's output accumulated in f32."""
    n = group.size
    Tl = q.shape[3]
    ring = group.ring_kv(k, v)
    outs = []
    for j, (idx, qj) in enumerate(zip(group.shards, q.unbind(0))):
        o_acc = lse_acc = None
        for s in range(n):
            src = (idx - s) % n
            if src > idx:
                continue      # a later chunk: every key is in the future
            kc, vc = ring[j][s]
            o_s, lse_s = flash_chunk(qj, kc, vc, scale=scale, causal=True,
                                     q_offset=idx * Tl, k_offset=src * Tl,
                                     seed=seed, rate=rate)
            if o_acc is None:
                o_acc, lse_acc = o_s.float(), lse_s
            else:
                o_acc, lse_acc = _merge(o_acc, lse_acc, o_s, lse_s)
        outs.append(o_acc.to(q.dtype))
    return torch.stack(outs)


def hop_launches(group) -> int:
    """Chunk-kernel launches of one ring call in this process: shard i
    runs i + 1 hops, so 1 + 2 + ... + n with all n shards here, and rank
    r's r + 1 in a process group."""
    return sum(i + 1 for i in group.shards)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, scale: Optional[float] = None,
                   dropout_rate: float = 0.0, seed: int = 0,
                   train: bool = False) -> torch.Tensor:
    """Causal ring attention. q, k, v: (B, H, T, D), T this process's
    positions (the whole sequence for a ``LocalSeqGroup``, one shard for a
    ``ProcessSeqGroup``), split into its shards of T / S. Dropout applies
    while ``train`` with ``seed``. Returns (B, H, T, D)."""
    S = len(group.shards)
    B, H, T, D = q.shape
    if T % S:
        raise ValueError(f"sequence length {T} does not split into {S} "
                         f"shards")

    def shards(t):
        return t.reshape(B, H, S, T // S, D).permute(2, 0, 1, 3, 4) \
            .contiguous()

    rate = dropout_rate if train else 0.0
    o = _ring_local(shards(q), shards(k), shards(v), group=group,
                    scale=scale, seed=seed, rate=rate)
    return o.permute(1, 2, 0, 3, 4).reshape(B, H, T, D)


def make_ring_attention_fn(group, scale: Optional[float] = None,
                           dropout_rate: float = 0.0):
    """The block's ``attention_fn(qkv, cfg, rng, train)`` through the ring:
    qkv (B, T, 3C) in, the merged (B, T, C) out. The packed rows are cut
    into the group's shards and heads with one copy; while training with
    a rate, each call draws one kernel seed from ``rng`` (the same on
    every rank: ``DropoutRNG.seeds`` does not depend on the rank)."""

    def attention_fn(qkv, cfg, rng, train):
        B, T, C3 = qkv.shape
        S, H = len(group.shards), cfg.n_head
        if T % S:
            raise ValueError(f"sequence length {T} does not split into "
                             f"{S} shards")
        Tl, D = T // S, C3 // 3 // H
        parts = qkv.reshape(B, S, Tl, 3, H, D).permute(3, 1, 0, 4, 2, 5) \
            .contiguous()
        rate = dropout_rate if (train and rng is not None) else 0.0
        seed = rng.kernel_seed() if rate > 0.0 else 0
        o = _ring_local(*parts.unbind(0), group=group, scale=scale,
                        seed=seed, rate=rate)
        return o.permute(1, 0, 3, 2, 4).reshape(B, T, H * D)

    attention_fn.impl_name = "ring"
    return attention_fn


def describe_ring_route(seq_len: int, group) -> str:
    """The ring's route line for the training log."""
    n = group.size
    return (f"ring attention over {n} sequence shards of {seq_len // n} "
            f"tokens ({group.describe()}): each hop one chunk kernel launch "
            f"(csrc/flash_packed.cu) on CUDA tensors, its plain version on "
            f"CPU tensors, merged by logsumexp in PyTorch; hop launches a "
            f"layer in this process: {hop_launches(group)}")
