"""Continuous-batching inference engine over the paged KV pool.

The port of ``replicatinggpt_tpu/serve/engine.py`` at
``decode_window=1``: a host-side scheduler drives one multi-slot decode
step per engine step. Per step the engine

1. expires deadlines (queued and active),
2. admits queued prompts into free slots, gated on free PAGES as well
   as free slots (serve/pages.py): admission claims the longest
   radix-cached prefix, applies copy-on-write page splits, and chunked
   prefill (``models.gpt.prefill_chunk_paged``) writes only the
   uncached tail's K/V through the slot's page table,
3. runs ONE decode step over all slots
   (``models.gpt.decode_step_paged``) and samples per slot
   (``sample.generate.sample_tokens_batched``), then fetches the tokens
   and does the host bookkeeping: commit, eos / budget finishes, radix
   registration of pages the decode frontier passed.

The decode step runs all layers in one ``fused_paged_decode_layers``
launch, or attends per layer through ``paged_window_attention`` (the
CUDA kernels on the card), when the route allows it
(``decide_kernel_route``), else through the gather route. The pool may
hold int8/fp8 pages with f32 scales (``kv_quant``, ``quant_granularity``).

Sharded serving (``mesh_data`` x ``mesh_model``, the ``--mesh-shape``
knob): the pool's pages split over 'data', the heads, the pool's
channels and the weights (Megatron TP) over 'model'
(``parallel.mesh``), the shards living in one process or one a process
under ``torchrun`` (``parallel.serve_group``). Each layer's decode
attention is the partials mode of ``paged_window_attention`` per data
shard, merged exactly over 'data' and folded once
(``ops.paged_attention.sharded_paged_window_attention``), or the gather
route where the geometry does not divide; the fused route stays 1x1.
Under ``torchrun`` every rank takes rank 0's host decisions: the clock
is rank 0's (``synced_clock``), and each step's tokens, positions,
active mask, tables and sampled tokens are rank 0's, broadcast.

Decode windows > 1, mixed prefill+decode steps, speculative verify,
weight quantization and telemetry are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models.gpt import (GPT, Params, compute_params, decode_step_paged,
                          prefill_chunk_paged)
from ..ops.decode import fused_paged_decode_supported, fused_weights
from ..ops.paged_attention import (paged_attention_envelope,
                                   paged_kernel_mesh_ok)
from ..parallel.mesh import (model_shards, page_shards, shard_serve_params,
                             vocab_shards)
from ..parallel.serve_group import serve_group
from ..quant import QuantConfig
from ..sample.generate import sample_tokens_batched
from ..utils.logging import Metrics
from ..utils.profiling import StepTimer
from .cache_pool import prefill_chunk_size
from .pages import PagedCachePool, pool_geometry
from .requests import (FINISH_CANCELLED, FINISH_DEADLINE, FINISH_EOS,
                       FINISH_LENGTH_CAP, FINISH_MAX_TOKENS,
                       REJECT_BAD_REQUEST, Request, RequestResult)
from .scheduler import Scheduler

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class EngineConfig:
    """Engine sizing (the JAX ``EngineConfig`` fields this port
    honours). ``prefill_chunk=0`` auto-sizes to min(64, block_size)."""

    pool_size: int = 8
    max_queue: int = 64
    prefill_chunk: int = 0
    page_size: int = 0        # tokens per KV page; 0 = min(16, block_size)
    max_pages: int = 0        # logical pages per slot; 0 = ceil(block/page)
    n_pages: int = 0          # physical pool pages; 0 = pool_size*max_pages
    prefix_cache: bool = True  # radix prefix reuse (False: pages only)
    paged_kernel: bool = False  # decode through the paged kernels
                                # (packed layout only): the fused
                                # all-layers kernel where its envelope
                                # holds, else the per-layer attention
    kv_quant: str = "none"      # paged KV page storage: none|int8|fp8
                                # (f32 scales beside the pages)
    quant_granularity: str = "page"   # one scale per row ('page') or per
                                      # row and head ('head')
    mesh_data: int = 1          # 'data' axis: the pool's physical pages
    mesh_model: int = 1         # 'model' axis: heads, pool channels, TP

    @property
    def mesh_shape(self) -> tuple:
        return (self.mesh_data, self.mesh_model)

    def quant(self) -> QuantConfig:
        """The validated KV quantization this engine runs under."""
        return QuantConfig(kv_dtype=self.kv_quant,
                           granularity=self.quant_granularity).validate()

    def chunk(self, block_size: int) -> int:
        return prefill_chunk_size(self.prefill_chunk, block_size)


@dataclass(frozen=True)
class KernelRoute:
    """The engine's kernel-route decision, made once at construction and
    exported by ``metrics_summary()['kernel_route']`` with the JAX
    engine's schema. ``decode`` is "fused" (every layer of a step in one
    ``fused_paged_decode_layers`` call), "kernel" (attention per layer
    through ``paged_window_attention``) or "gather" (scatter, gather the
    logical view, attend); on the card the first two are the CUDA
    kernels, on the CPU their plain versions. ``window`` is "none"
    because this engine runs no windowed step; ``reasons`` names every
    failed gate."""

    decode: str
    window: str
    reasons: tuple
    kv_quant: str = "none"
    granularity: str = "page"
    sharded: bool = False         # the kernel runs per data shard
    mesh: tuple = (1, 1)          # (data, model)

    def summary(self) -> dict:
        return {"route": self.decode, "decode": self.decode,
                "window": self.window, "sharded": self.sharded,
                "mesh": list(self.mesh),
                "kv_quant": self.kv_quant, "weight_quant": "none",
                "granularity": self.granularity, "act_quant": "none",
                "reasons": list(self.reasons)}


def decide_kernel_route(cfg: ModelConfig, ecfg: EngineConfig,
                        page_size: int, max_pages: int, itemsize: int,
                        n_slots: int, n_pages: int = 0) -> KernelRoute:
    """The JAX engine's rule: the fused all-layers kernel whenever
    ``fused_paged_decode_supported`` holds on a 1x1 mesh, else the
    per-layer kernel inside its envelope (on a mesh, per data shard,
    where ``paged_kernel_mesh_ok`` holds for the pool's ``n_pages``),
    else the gather route. ``itemsize`` is the POOL's element size (1
    for int8/fp8), as the JAX engine passes it, so an int8 pool can
    admit the f32 fused route that an f32 pool misses."""
    q = ecfg.quant()
    d, m = ecfg.mesh_shape
    reasons = []
    if not ecfg.paged_kernel:
        reasons.append("paged_kernel_off")
    if cfg.decode_cache_layout != "packed":
        reasons.append("cache_layout")
    h_loc = cfg.n_head // m if cfg.n_head % m == 0 else cfg.n_head
    _, env = paged_attention_envelope(
        h_loc, cfg.head_dim, page_size, itemsize=itemsize, window=1,
        max_pages=max_pages, kv_quant=q.kv_dtype, granularity=q.granularity)
    reasons.extend(env)
    if not paged_kernel_mesh_ok(d, m, n_pages, cfg.n_embd, cfg.n_head):
        reasons.append("mesh_indivisible")
    fused = not reasons and d * m == 1 and fused_paged_decode_supported(
        cfg, n_slots, page_size, itemsize, kv_quant=q.kv_dtype,
        granularity=q.granularity, max_pages=max_pages)
    decode = "fused" if fused else "gather" if reasons else "kernel"
    return KernelRoute(decode=decode, window="none", reasons=tuple(reasons),
                       kv_quant=q.kv_dtype, granularity=q.granularity,
                       sharded=d * m > 1 and decode == "kernel",
                       mesh=(d, m))


@dataclass
class _Active:
    """Host-side record of a request occupying a slot."""

    req: Request
    t_submit: float
    t_admit: float
    cap: int                      # max new tokens this slot can produce
    capped: bool                  # cap < req.max_new_tokens (context limit)
    tokens: List[int] = field(default_factory=list)
    t_first_token: float = 0.0
    t_last_token: float = 0.0


class Engine:
    """Continuous-batching engine over a paged KV pool.

    Host API (single-threaded — drive it from one loop): ``submit(req)``
    -> None or a rejected ``RequestResult``; ``cancel(request_id)`` ->
    bool; ``step()`` -> requests finishing this step; ``drain()``;
    ``metrics_summary()``.

    ``model`` is a ``models.gpt.GPT`` (f32 master weights); the engine
    casts it once to the compute dtype on ``device`` (default: the
    card) and, on a mesh, splits it for the shards this process holds:
    all of them in one process, this rank's under ``torchrun`` (the
    launch's process group, joined before the engine is made)."""

    def __init__(self, model: GPT, cfg: ModelConfig,
                 ecfg: EngineConfig = EngineConfig(),
                 clock: Callable[[], float] = time.monotonic,
                 device: Optional[Union[str, torch.device]] = None):
        cfg.validate()
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.params: Params = compute_params(model, dev)
        # the serving mesh: the shards' group, the weights split for the
        # model shards it holds, rank 0's clock on every rank
        self.group = None
        if ecfg.mesh_data * ecfg.mesh_model > 1:
            _, _, n_pages = pool_geometry(cfg, ecfg.pool_size,
                                          ecfg.page_size, ecfg.max_pages,
                                          ecfg.n_pages)
            tp = model_shards(cfg, ecfg.mesh_model)
            self.group = serve_group(ecfg.mesh_data, ecfg.mesh_model,
                                     page_shards(n_pages, ecfg.mesh_data),
                                     tp)
            self.params = shard_serve_params(
                self.params, cfg, tp, vocab_shards(cfg, tp),
                self.group.model_shards)
            clock = self.group.synced_clock(clock)
        self.clock = clock
        self.pool = PagedCachePool(
            cfg, ecfg.pool_size, page_size=ecfg.page_size,
            max_pages=ecfg.max_pages, n_pages=ecfg.n_pages,
            prefix_cache=ecfg.prefix_cache, device=dev, quant=ecfg.quant(),
            mesh_shape=ecfg.mesh_shape, group=self.group)
        self.scheduler = Scheduler(ecfg.max_queue, cfg.block_size,
                                   clock=clock)
        self.metrics = Metrics()
        self.step_timer = StepTimer(dev)
        P = ecfg.pool_size
        self._chunk = ecfg.chunk(cfg.block_size)
        self.kernel_route = decide_kernel_route(
            cfg, ecfg, self.pool.page_size, self.pool.max_pages,
            self.pool.itemsize, P, self.pool.n_pages)
        self._use_kernel = self.kernel_route.decode == "kernel"
        self._use_fused = self.kernel_route.decode == "fused"
        # the fused kernel's blocks, every one in the compute dtype
        self._fused_blocks = (fused_weights(self.params["blocks"],
                                            cfg.compute_dtype)
                              if self._use_fused else None)
        log.info("kernel route: %s%s", self.kernel_route.decode,
                 (" reasons=" + ",".join(self.kernel_route.reasons)
                  if self.kernel_route.reasons else ""))
        self._tok = np.zeros((P,), np.int32)
        # ALIAS of pool.positions: the engine advances it in place
        self._pos = self.pool.positions
        self._active = np.zeros((P,), bool)
        self._budget = np.zeros((P,), np.int32)
        self._eos = np.full((P,), -1, np.int32)
        self._deadline = np.full((P,), np.inf)
        self._temp = np.ones((P,), np.float32)
        self._top_k = np.zeros((P,), np.int32)
        self._top_p = np.zeros((P,), np.float32)
        self._greedy = np.zeros((P,), bool)
        # per-slot sampling streams, reseeded at admission
        self._gens = [torch.Generator(device=dev) for _ in range(P)]
        # device copies of the page tables and sampling params, rebuilt
        # only after an admission or finish changed them (None = stale)
        self._li = None
        self._slots: Dict[int, _Active] = {}
        self._pending: List[RequestResult] = []
        self.n_steps = 0

    # ---------------------------------------------------------------- API

    def submit(self, req: Request) -> Optional[RequestResult]:
        self.metrics.inc("requests_submitted")
        if (self.pool.slot_of(req.id) is not None
                or self.scheduler.contains(req.id)):
            self.metrics.inc(REJECT_BAD_REQUEST)
            return RequestResult(id=req.id, tokens=[],
                                 finish_reason=REJECT_BAD_REQUEST)
        eos = req.eos_token_id
        if eos is not None and not (0 <= int(eos) < self.cfg.vocab_size):
            self.metrics.inc(REJECT_BAD_REQUEST)
            return RequestResult(id=req.id, tokens=[],
                                 finish_reason=REJECT_BAD_REQUEST)
        reason = self.scheduler.submit(req)
        if reason is not None:
            self.metrics.inc("finished_" + reason
                             if reason == FINISH_DEADLINE else reason)
            return RequestResult(id=req.id, tokens=[], finish_reason=reason)
        return None

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued or running request; its terminal result (with
        any tokens produced) surfaces from the next ``step()``."""
        now = self.clock()
        if self.scheduler.cancel(request_id):
            self.metrics.inc("finished_" + FINISH_CANCELLED)
            self._pending.append(RequestResult(
                id=request_id, tokens=[], finish_reason=FINISH_CANCELLED))
            return True
        slot = self.pool.slot_of(request_id)
        if slot is None:
            return False
        self._pending.append(self._finish_slot(slot, FINISH_CANCELLED, now))
        return True

    @property
    def idle(self) -> bool:
        return (not self._active.any() and len(self.scheduler) == 0
                and not self._pending)

    def step(self) -> List[RequestResult]:
        """One scheduling iteration: expire -> admit -> decode."""
        finished: List[RequestResult] = self._pending
        self._pending = []
        now = self.clock()
        for req, t_submit, reason in self.scheduler.drain_expired(now):
            finished.append(self._finish_unstarted(req, t_submit, reason,
                                                   now))
        for slot in np.flatnonzero(self._active & (self._deadline <= now)):
            finished.append(self._finish_slot(int(slot), FINISH_DEADLINE,
                                              now))
        self._admit_queue(now, finished)
        self.metrics.gauge("queue_depth", self.scheduler.depth)
        self.metrics.gauge("slots_active", int(self._active.sum()))
        self.metrics.gauge("slot_occupancy", self.pool.occupancy)
        self.metrics.gauge("pages_in_use", self.pool.alloc.pages_in_use)
        if self._active.any():
            finished.extend(self._decode_once())
        return finished

    def drain(self, max_steps: int = 1_000_000) -> List[RequestResult]:
        out: List[RequestResult] = []
        for _ in range(max_steps):
            if self.idle:
                return out
            out.extend(self.step())
        raise RuntimeError(f"engine did not drain in {max_steps} steps")

    def metrics_summary(self) -> dict:
        s = self.metrics.summary()
        s["step_latency"] = self.step_timer.summary(skip=1)
        s["n_steps"] = self.n_steps
        s["kernel_route"] = self.kernel_route.summary()
        s["pages"] = self.pool.stats()
        return s

    # ----------------------------------------------------------- internals

    def _cap(self, req: Request) -> int:
        """Decode budget: decode step i runs at position P-1+i (the first
        rewrites the last prompt position), so a slot supports
        S - P + 1 new tokens."""
        return min(req.max_new_tokens,
                   self.pool.seq_len - int(req.prompt.size) + 1)

    def _fits(self, req: Request) -> bool:
        """Enough free (or LRU-reclaimable) pages for the request's WHOLE
        lifetime, reserved at admission."""
        return self.pool.can_admit(req.prompt, self._cap(req))

    def _admit(self, req: Request, t_submit: float, now: float) -> None:
        P = int(req.prompt.size)
        cap = self._cap(req)
        # claims the longest cached prefix, reserves the remaining pages
        # and sets pool.positions[slot] = P - 1 (aliased by self._pos)
        adm = self.pool.acquire(req.id, req.prompt, cap)
        assert adm is not None, "scheduler admitted past pool capacity"
        slot = adm.slot
        for src, dst in adm.cow:
            # copy-on-write split of a fully-cached prompt's frontier page
            self.pool.copy_page(src, dst)
        claimed = adm.claimed
        if claimed < P:
            chunk = self._chunk
            n_chunks = -(-(P - claimed) // chunk)
            if P > self.pool.seq_len:
                raise IndexError(f"prefill of a {P}-token prompt past "
                                 f"{self.pool.seq_len}")
            padded = np.zeros((n_chunks * chunk,), np.int64)
            padded[:P - claimed] = req.prompt[claimed:]
            dev = self.device
            toks = torch.tensor(padded, device=dev)
            table_row = torch.tensor(self.pool.tables[slot], device=dev)
            for c in range(n_chunks):
                prefill_chunk_paged(
                    self.params, toks[None, c * chunk:(c + 1) * chunk],
                    claimed + c * chunk, P, table_row, self.pool.cache,
                    self.cfg, group=self.group,
                    host_row=self.pool.tables[slot])
        # registration AFTER the prefill wrote the pages: a same-step
        # neighbor may claim them the moment they hit the radix
        self.pool.commit_admission(slot)
        self._tok[slot] = req.prompt[-1]
        self._active[slot] = True
        self._budget[slot] = cap
        self._eos[slot] = (-1 if req.eos_token_id is None
                           else int(req.eos_token_id))
        self._deadline[slot] = (np.inf if req.deadline is None
                                else req.deadline)
        sp = req.sampling
        self._temp[slot] = sp.temperature
        self._top_k[slot] = sp.top_k
        self._top_p[slot] = sp.top_p
        self._greedy[slot] = sp.greedy
        self._gens[slot].manual_seed(req.rng_seed)
        self._li = None
        self._slots[slot] = _Active(req=req, t_submit=t_submit, t_admit=now,
                                    cap=cap,
                                    capped=cap < req.max_new_tokens)
        self.metrics.inc("requests_admitted")
        self.metrics.inc("prefill_tokens", P - claimed)
        self.metrics.inc("prefix_hit_tokens", claimed)
        self.metrics.observe("queue_wait_s", now - t_submit)

    def _admit_queue(self, now: float, finished: List[RequestResult]
                     ) -> None:
        """One-at-a-time FIFO admission: each admission changes page
        availability, so the fits check sees fresh allocator state, and
        a head that does not fit BLOCKS the queue (no starvation)."""
        while self.pool.n_free > 0:
            admitted, dropped = self.scheduler.admit(1, now,
                                                     fits=self._fits)
            for req, t_submit, reason in dropped:
                finished.append(self._finish_unstarted(req, t_submit,
                                                       reason, now))
            if not admitted:
                break
            req, t_submit = admitted[0]
            self._admit(req, t_submit, now)

    def _launch_inputs(self) -> tuple:
        if self._li is None:
            dev = self.device
            self._li = tuple(torch.tensor(a, device=dev) for a in (
                self.pool.tables, self._temp, self._top_k, self._top_p,
                self._greedy))
            if self.group is not None:
                self.group.broadcast_(self._li[:1])   # rank 0's tables
        return self._li

    def _decode_once(self) -> List[RequestResult]:
        """One decode step over every slot, fetched at once (the write
        positions are bounds-checked inside ``decode_step_paged``)."""
        self.step_timer.start()
        n_active = int(self._active.sum())
        dev = self.device
        tables, temp, top_k, top_p, greedy = self._launch_inputs()
        state = torch.from_numpy(np.stack(
            [self._tok, self._pos, self._active.astype(np.int32)])).to(dev)
        if self.group is not None:
            self.group.broadcast_([state])   # rank 0's tokens and positions
        tok, pos, active = state[0], state[1], state[2].bool()
        logits, _ = decode_step_paged(self.params, tok, pos, active, tables,
                                      self.pool.cache, self.cfg,
                                      use_kernel=self._use_kernel,
                                      use_fused=self._use_fused,
                                      fused_blocks=self._fused_blocks,
                                      group=self.group,
                                      host_tables=self.pool.tables)
        gens = [g if a and not gr else None
                for g, a, gr in zip(self._gens, self._active, self._greedy)]
        nxt = sample_tokens_batched(gens, logits, temp, top_k, top_p, greedy)
        if self.group is not None:
            self.group.broadcast_([nxt])     # rank 0's samples
        toks = nxt.cpu().numpy()
        self.step_timer.lap()
        now = self.clock()
        self.n_steps += 1
        emitted = self._active.copy()
        n_tok = int(emitted.sum())
        self.metrics.observe("batch_fill_ratio",
                             n_active / self.ecfg.pool_size)
        self.metrics.inc("decode_steps")
        self.metrics.inc("decode_tokens", n_tok)
        finished: List[RequestResult] = []
        for slot in list(self._slots):
            if not emitted[slot]:
                continue
            st = self._slots[slot]
            first = not st.tokens
            st.tokens.append(int(toks[slot]))
            if first:
                st.t_first_token = now
                self.metrics.observe("ttft_s", now - st.t_submit)
            st.t_last_token = now
            self._tok[slot] = st.tokens[-1]
            self._pos[slot] += 1
            self._budget[slot] = st.cap - len(st.tokens)
            eos = int(self._eos[slot])
            if eos >= 0 and st.tokens[-1] == eos:
                finished.append(self._finish_slot(slot, FINISH_EOS, now))
            elif self._budget[slot] <= 0:
                reason = (FINISH_LENGTH_CAP if st.capped
                          else FINISH_MAX_TOKENS)
                finished.append(self._finish_slot(slot, reason, now))
        # the full prompt page holding position P-1 becomes shareable
        # once the decode frontier passed it
        self.pool.flush_pending()
        return finished

    def _finish_slot(self, slot: int, reason: str,
                     now: float) -> RequestResult:
        st = self._slots.pop(slot)
        self._active[slot] = False
        self._deadline[slot] = np.inf
        self._li = None           # release zeroes the slot's table row
        self.pool.release(slot)
        n = len(st.tokens)
        decode_tps = 0.0
        if n > 1 and st.t_last_token > st.t_first_token:
            decode_tps = (n - 1) / (st.t_last_token - st.t_first_token)
        res = RequestResult(
            id=st.req.id, tokens=st.tokens, finish_reason=reason,
            queue_wait_s=st.t_admit - st.t_submit,
            ttft_s=(st.t_first_token - st.t_submit) if n else 0.0,
            decode_tokens_per_s=decode_tps, total_s=now - st.t_submit)
        self.metrics.inc(f"finished_{reason}")
        if decode_tps:
            self.metrics.observe("decode_tokens_per_s", decode_tps)
        return res

    def _finish_unstarted(self, req: Request, t_submit: float, reason: str,
                          now: float) -> RequestResult:
        self.metrics.inc(f"finished_{reason}")
        return RequestResult(id=req.id, tokens=[], finish_reason=reason,
                             queue_wait_s=now - t_submit,
                             total_s=now - t_submit)

