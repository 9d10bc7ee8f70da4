"""Speculative decoding for the serving engine: drafters and acceptance
(the port of ``replicatinggpt_tpu/serve/speculative.py``).

A drafter proposes up to k tokens a slot; the target model scores the
whole ``[last_committed, draft_1..draft_k]`` window in one pass over the
paged pool (``models.gpt.verify_step_paged``: on the kernel route,
``paged_window_attention`` at W = k+1 per layer), and per-position
acceptance commits between 1 and k+1 tokens a slot a step.

Acceptance (``spec_accept_and_sample``): the drafters propose
deterministic tokens, a point-mass proposal q. Speculative rejection
sampling then reduces to: accept d with probability p(d) under the
target's filtered per-slot distribution (temperature -> top-k -> top-p,
``sample.generate.filter_logits_batched``); at the first rejection,
draw from p with d masked out. That keeps the target distribution
exactly for any drafter, and for greedy slots is argmax equality: a
greedy slot's speculative stream is its non-speculative stream. The
draws come from the engine's per-slot ``torch.Generator``s
(``spec_noise``), where JAX splits per-slot keys: the same distribution,
another random stream.

Two drafters behind one host-side interface:

- :class:`NGramDrafter`: prompt lookup. Match the slot's trailing n-gram
  against its own prompt+generated history and propose the continuation
  of the most recent earlier occurrence. No parameters, no device work;
- :class:`ModelDrafter`: a second, smaller model with its own contiguous
  pool (``serve.cache_pool.CachePool``, slot for slot with the engine's
  pages), drafting k tokens greedily with k+1 ``decode_step_multi``
  steps a step (plain PyTorch, as JAX runs them without a kernel). Its
  cache needs no repair after a verify: accepted tokens are the drafted
  ones, and the draft steps write the whole window's K/V.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..faults.inject import fire as fault_fire
from ..models.gpt import (GPT, compute_params, decode_step_multi,
                          prefill_chunk_into_slot)
from ..ops.attention import NEG_INF
from ..sample.generate import filter_logits_batched
from .cache_pool import CachePool, prefill_chunk_size


# ---------------------------------------------------------------------------
# acceptance (on the device, no host read)
# ---------------------------------------------------------------------------

def spec_noise(generators: Sequence[Optional[torch.Generator]], B: int,
               W: int, V: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random draws of one verify step: ``u`` (B, W) uniforms for the
    acceptance tests and ``q`` (2, B, V) exponentials for the correction
    and the bonus draw (the argmax of p / q is a draw from p, as in
    ``sample_tokens_batched``). Row b draws from ``generators[b]``; a row
    with None (a greedy or idle slot) draws nothing and gets u = 0, q =
    1, which no greedy row reads."""
    u = torch.zeros((B, W), device=device)
    q = torch.ones((2, B, V), device=device)
    for b, g in enumerate(generators):
        if g is not None:
            u[b] = torch.rand((W,), generator=g, device=device)
            q[:, b] = torch.empty((2, V), device=device).exponential_(
                1, generator=g)
    return u, q


def spec_accept_and_sample(logits: torch.Tensor, window: torch.Tensor,
                           n_valid: torch.Tensor, temperature, top_k, top_p,
                           greedy, noise: Tuple[torch.Tensor, torch.Tensor]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot speculative acceptance and the committed tokens.

    logits: (B, W, V) f32 from the verify step (position j scores the
    token after window token j); window: (B, W) int; n_valid: (B,) the
    real drafts a slot (the rest are padding); per-slot sampling params
    as in ``sample_tokens_batched``; ``noise``: ``spec_noise``'s draws.

    Returns ``(n_acc, out)``, int32: ``n_acc[b]`` accepted drafts
    (0..n_valid[b]); ``out[b, :n_acc[b]+1]`` the committed tokens, the
    accepted drafts and then the correction token (drawn from the target
    with the rejected draft masked out) or, after a full acceptance, the
    bonus token (drawn from the target); 0 past them. Greedy rows accept
    by raw-logit argmax equality and take the raw argmax as their last
    token, ``sample_tokens_batched``'s greedy mode."""
    B, W, V = logits.shape
    dev = logits.device
    u, q = noise
    offs = torch.arange(W, device=dev)[None, :]
    # the candidate at logits position j is window token j+1
    cand = torch.cat([window[:, 1:].long(),
                      torch.zeros((B, 1), dtype=torch.long, device=dev)], 1)
    next_raw = torch.argmax(logits, dim=-1)                   # (B, W)

    def rep(a):
        return torch.as_tensor(a, device=dev).repeat_interleave(W)

    f = filter_logits_batched(logits.reshape(B * W, V), rep(temperature),
                              rep(top_k), rep(top_p)).reshape(B, W, V)
    p_acc = torch.softmax(f, dim=-1).gather(-1, cand[..., None])[..., 0]
    greedy = torch.as_tensor(greedy, device=dev).bool()
    accept = torch.where(greedy[:, None], next_raw == cand, u < p_acc)
    valid = offs < n_valid.long()[:, None]
    chain = torch.cumprod((accept & valid).long(), dim=1)
    n_acc = chain.sum(1)                                      # (B,)

    # only position n_acc emits a drawn token: one correction and one
    # bonus draw a row, from that position's distribution
    at = n_acc[:, None]
    f_r = f.gather(1, at[:, :, None].expand(B, 1, V))[:, 0]   # (B, V)
    cand_r = cand.gather(1, at)[:, 0]
    raw_r = next_raw.gather(1, at)[:, 0]
    # NEG_INF, not -inf: a row whose only candidate was the draft stays
    # NaN-free (its acceptance was certain, so it is never used)
    masked_r = torch.where(
        torch.arange(V, device=dev)[None, :] == cand_r[:, None],
        torch.full_like(f_r, NEG_INF), f_r)
    corr = torch.argmax(torch.softmax(masked_r, dim=-1) / q[0], dim=-1)
    bonus = torch.argmax(torch.softmax(f_r, dim=-1) / q[1], dim=-1)
    final = torch.where(greedy, raw_r,
                        torch.where(n_acc < n_valid.long(), corr, bonus))
    out = torch.where(offs < at, cand,
                      torch.where(offs == at, final[:, None],
                                  torch.zeros_like(cand)))
    return n_acc.to(torch.int32), out.to(torch.int32)


# ---------------------------------------------------------------------------
# host-side drafter interface
# ---------------------------------------------------------------------------

@dataclass
class DraftContext:
    """Per-step host snapshot handed to ``Drafter.draft``, built once a
    step from the engine's host state (no device read)."""

    tok: np.ndarray                    # (P,) int32 last committed token
    pos: np.ndarray                    # (P,) int32 per-slot positions
    active: np.ndarray                 # (P,) bool
    histories: Optional[List[Optional[np.ndarray]]] = None
    # per-slot prompt+generated history; only made when the drafter sets
    # ``needs_history`` (the n-gram drafter)


class Drafter:
    """Host-side proposal source for speculative decoding.

    ``draft`` returns ``(tokens (P, k) int32, lens (P,) int32)``,
    deterministic proposals a slot; the engine further bounds lens by
    the slot's room and token budget. The lifecycle hooks follow slot
    admission, so that a stateful drafter (the model drafter's cache)
    stays in step with the engine's pool."""

    name = "base"
    needs_history = False

    def __init__(self, k: int):
        assert k >= 1, k
        self.k = k

    def on_admit(self, slot: int, prompt: np.ndarray) -> None:
        pass

    def on_release(self, slot: int) -> None:
        pass

    def resync(self, slot: int, history: np.ndarray) -> None:
        """Rebuild the slot's drafter state from its whole committed
        history (prompt + generated): the engine calls it when it turns a
        drafter back on, since tokens committed by the plain decode path
        meanwhile never went through the drafter. A fresh admission of
        the history: a chunked re-prefill for the model drafter, nothing
        for the n-gram drafter."""
        self.on_admit(slot, history)

    def draft(self, ctx: DraftContext) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: propose the continuation of the most
    recent earlier occurrence of the slot's trailing n-gram, falling
    back to shorter n-grams down to 1; no match (or a history under 2
    tokens) proposes nothing. Host numpy over histories <= block_size."""

    name = "ngram"
    needs_history = True

    def __init__(self, k: int, ngram: int = 3):
        super().__init__(k)
        assert ngram >= 1, ngram
        self.ngram = ngram

    def _lookup(self, history: np.ndarray) -> np.ndarray:
        L = int(history.size)
        for n in range(min(self.ngram, L - 1), 0, -1):
            pat = history[L - n:]
            win = np.lib.stride_tricks.sliding_window_view(history, n)
            hits = np.nonzero((win == pat).all(axis=1))[0]
            hits = hits[hits < L - n]          # not the suffix itself
            if hits.size:
                i = int(hits[-1])
                cont = history[i + n:i + n + self.k]
                if cont.size:
                    return cont.astype(np.int32)
        return np.empty((0,), np.int32)

    def draft(self, ctx: DraftContext) -> Tuple[np.ndarray, np.ndarray]:
        P = ctx.tok.shape[0]
        toks = np.zeros((P, self.k), np.int32)
        lens = np.zeros((P,), np.int32)
        for slot in range(P):
            if not ctx.active[slot] or ctx.histories[slot] is None:
                continue
            cont = self._lookup(ctx.histories[slot])
            toks[slot, :cont.size] = cont
            lens[slot] = cont.size
        return toks, lens


class ModelDrafter(Drafter):
    """Small-model drafter: a second model (``model``, a ``models.gpt.GPT``
    of ``cfg``) with its own contiguous pool, slot for slot with the
    engine's. A step drafts k tokens a slot greedily (greedy on purpose:
    point-mass proposals keep the acceptance exact for every target
    sampling mode); an admission chunk-prefills the prompt into the
    slot's buffer.

    The draft runs k+1 ``decode_step_multi`` steps, not k: step j writes
    the K/V of window token j at pos+j, so stopping at k would leave
    d_k's K/V unwritten, and after a full acceptance the engine's
    frontier passes that position, which the draft cache would then hold
    stale for every later proposal of the request. The extra step writes
    it; its proposal is discarded. A slot whose positions run off the
    buffer writes nothing there, and the engine bounds its surplus
    proposals away. With the target's own weights, greedy acceptance is
    therefore exact (accept rate 1)."""

    name = "model"

    def __init__(self, model: GPT, cfg: ModelConfig, k: int, pool_size: int,
                 prefill_chunk: int = 0, device=None):
        super().__init__(k)
        cfg.validate()
        self.device = dev = resolve_device(device)
        self.params = compute_params(model, dev)
        self.cfg = cfg
        self.pool_size = pool_size
        self._chunk = prefill_chunk_size(prefill_chunk, cfg.block_size)
        self.pool = CachePool(cfg, pool_size, device=dev)

    def on_admit(self, slot: int, prompt: np.ndarray) -> None:
        P = int(prompt.size)
        S = self.pool.seq_len
        chunk = self._chunk
        n_chunks = -(-P // chunk)
        if n_chunks * chunk > S:
            raise IndexError(f"draft prefill of a {P}-token prompt in "
                             f"{chunk}-token chunks past {S}")
        padded = np.zeros((n_chunks * chunk,), np.int64)
        padded[:P] = prompt
        toks = torch.from_numpy(padded).to(self.device)
        for c in range(n_chunks):
            prefill_chunk_into_slot(self.params,
                                    toks[None, c * chunk:(c + 1) * chunk],
                                    c * chunk, slot, self.pool.cache,
                                    self.cfg)

    def draft(self, ctx: DraftContext) -> Tuple[np.ndarray, np.ndarray]:
        state = torch.from_numpy(np.stack([
            ctx.tok, np.where(ctx.active, ctx.pos, 0),
            ctx.active.astype(np.int32)]).astype(np.int64)).to(self.device)
        tok, pos, active = state[0], state[1], state[2].bool()
        out = []
        for _ in range(self.k + 1):
            logits, _ = decode_step_multi(self.params, tok, pos,
                                          self.pool.cache, self.cfg)
            tok = torch.where(active, torch.argmax(logits, dim=-1),
                              torch.zeros_like(tok))
            out.append(tok)
            pos = pos + 1
        toks = torch.stack(out[:self.k], 1).to(torch.int32).cpu().numpy()
        lens = np.where(ctx.active, self.k, 0).astype(np.int32)
        return toks, lens


# ---------------------------------------------------------------------------
# construction helpers (CLI / replay)
# ---------------------------------------------------------------------------

def draft_config_from_preset(target: ModelConfig,
                             preset: str) -> ModelConfig:
    """A drafter config from a named preset, made compatible with the
    target: the same vocabulary (proposals must be target ids), block
    size (slot buffers line up), compute dtype and cache layout."""
    from ..config import get_config
    base = get_config(preset).model
    return dataclasses.replace(
        base, vocab_size=target.vocab_size, block_size=target.block_size,
        dtype=target.dtype, decode_cache_layout=target.decode_cache_layout)


def make_drafter(mode: str, k: int, ngram: int, pool_size: int,
                 draft_model: Optional[GPT] = None,
                 draft_cfg: Optional[ModelConfig] = None,
                 prefill_chunk: int = 0, device=None) -> Optional[Drafter]:
    """Drafter factory: ``mode`` is 'off' | 'ngram' | 'model'; 'model'
    needs ``draft_model`` and ``draft_cfg``. One drafter an engine:
    drafters hold per-slot state."""
    if mode in ("off", "", None):
        return None
    if mode == "ngram":
        return NGramDrafter(k, ngram=ngram)
    if mode == "model":
        if draft_model is None or draft_cfg is None:
            raise ValueError("mode='model' needs draft_model and draft_cfg")
        return ModelDrafter(draft_model, draft_cfg, k, pool_size,
                            prefill_chunk=prefill_chunk, device=device)
    raise ValueError(f"unknown drafter mode {mode!r}")


def timed_draft(drafter: Drafter, ctx: DraftContext, vocab_size: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, float]:
    """``drafter.draft`` and its wall time (seconds), which the engine
    records a step beside the verify step it amortizes.

    Fault seam ``spec/draft`` (kind ``collapse``): shifts every proposed
    token by one (mod the vocabulary), so that the accept rate collapses
    while every token stays a valid id: the failure the engine's
    speculative auto-disable must catch. No-op without an installed
    FaultPlan."""
    t0 = time.perf_counter()
    toks, lens = drafter.draft(ctx)
    f = fault_fire("spec/draft")
    if f is not None and f.kind == "collapse" and vocab_size > 1:
        toks = (toks + 1) % vocab_size
    return toks, lens, time.perf_counter() - t0
