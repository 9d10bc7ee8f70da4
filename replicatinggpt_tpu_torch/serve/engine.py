"""Continuous-batching inference engine over the paged KV pool.

The port of ``replicatinggpt_tpu/serve/engine.py``: a host-side
scheduler drives multi-slot decode over the paged pool. Per step the
engine

1. expires deadlines (queued and active),
2. admits queued prompts into free slots, gated on free PAGES as well
   as free slots (serve/pages.py): admission claims the longest
   radix-cached prefix, applies copy-on-write page splits, and chunked
   prefill writes only the uncached tail's K/V through the slot's page
   table,
3. decodes every slot and does the host bookkeeping: commit, eos /
   budget finishes, radix registration of pages the decode frontier
   passed.

With ``decode_window=1`` (the blocked loop) step 2's prefill runs
``models.gpt.prefill_chunk_paged`` at once and step 3 is ONE decode step
(``models.gpt.decode_step_paged``) and sampler call, whose tokens are
read back before the step returns.

With ``decode_window=k > 1`` step 3 is a WINDOW of k steps enqueued at
once (``models.gpt.decode_window_paged``), the per-slot state (token,
position, active flag, budget) staying on the card from window to
window, and the host runs one window ahead: window N+1 is enqueued
before window N's (k, B) token block is read, which is one copy into
pinned host memory started at launch and waited on at the drain. The
cadence is continuous: an admission is host bookkeeping at a window
boundary while the window before it flies, and the prompt's uncached
tail prefills INSIDE the next window (``models.gpt.mixed_window_paged``:
new slots write prompt chunks while resident slots decode, one per-slot
phase mask); deadlines and cancels ride the next window as lifecycle
masks (``_merge_lifecycle``: the slot goes inactive on the card, its
pages free at the boundary); radix registration of an in-window prefill
waits for the drain of the window that wrote it. With
``decode_window_auto`` the window size climbs its buckets
(``EngineConfig.window_buckets``) while the host's launch time is still
a share of the window's wall. Each slot draws from its own
``torch.Generator``, on a schedule the host knows (prefill steps draw
nothing, the budget is known), so a window gives the tokens of k
blocked steps.

Decoding runs all layers in one ``fused_paged_decode_layers`` launch, or
attends per layer through ``paged_window_attention`` (the CUDA kernels
on the card), when the route allows it (``decide_kernel_route``), else
through the gather route; the mixed windows attend through
``paged_window_attention`` at W = the prefill chunk (``window`` route).
The pool may hold int8/fp8 pages with f32 scales (``kv_quant``,
``quant_granularity``).

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
active mask, tables and sampled tokens are rank 0's, broadcast. A mesh
runs the blocked loop only: its step plans on the host every step
(ROADMAP.md queue A item 14).

Speculative decoding (``drafter=``, serve/speculative.py): each step a
drafter proposes up to k tokens a slot, bounded on the host by the slot's
room and budget, and ONE ``models.gpt.verify_step_paged`` pass scores the
(k+1)-token windows (``paged_window_attention`` at W = k+1 on the kernel
route, the ``verify`` route of ``decide_kernel_route``); the acceptance
commits 1..k+1 tokens a slot, exact for every sampling mode. While a
drafter is active no decode window runs: a speculative step first reads
the window in flight and completes any in-window prefill on the host,
as JAX does. Self-healing (``rcfg=``, ``faults.watchdog``): a stall
watchdog over step wall times, speculative auto-disable with backed-off
re-probes (an operator's ``set_spec_active(False)`` pins it), and load
shedding at the queue; ``journal=`` (serve/journal.py) records every
accepted and finished request for restart recovery. A drafter on a
serving mesh is ROADMAP.md queue A item 16.

Weight quantization and telemetry are not ported yet (see ROADMAP.md).
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
from ..faults.inject import fire as fault_fire
from ..faults.watchdog import (LoadShedder, ResilienceConfig, SpecHealth,
                               StepWatchdog)
from ..models.gpt import (GPT, Params, compute_params, decode_step_paged,
                          decode_window_paged, mixed_window_paged,
                          prefill_chunk_paged, verify_step_paged)
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
                       FINISH_LENGTH_CAP, FINISH_MAX_TOKENS, FINISH_SHED,
                       REJECT_BAD_REQUEST, Request, RequestResult,
                       SamplingParams)
from .scheduler import Scheduler
from .speculative import (DraftContext, Drafter, spec_accept_and_sample,
                          spec_noise, timed_draft)

#: the window-size autotuner (``EngineConfig.decode_window_auto``):
#: every this many windows, climb one bucket while the host's launch time
#: is still more than this share of the windows' wall
WINDOW_AUTOTUNE_INTERVAL = 8
WINDOW_AUTOTUNE_HOST_FRAC = 0.05

#: the ROADMAP.md item a windowed engine on a serving mesh waits for
MESH_WINDOW_ITEM = "queue A item 14 (decode windows on a serving mesh)"
#: and the one a drafter on a serving mesh waits for
MESH_SPEC_ITEM = "queue A item 16 (speculative decoding on a serving mesh)"

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
    decode_window: int = 1      # decode steps enqueued as one window (the
                                # --decode-window knob): 1 = the blocked
                                # step-per-read loop; > 1 the continuous
                                # double-buffered windows (1x1 mesh)
    decode_window_auto: bool = False  # climb window_buckets() from the
                                      # live host-vs-wall split, capped
                                      # at decode_window

    @property
    def mesh_shape(self) -> tuple:
        return (self.mesh_data, self.mesh_model)

    def quant(self) -> QuantConfig:
        """The validated KV quantization this engine runs under."""
        return QuantConfig(kv_dtype=self.kv_quant,
                           granularity=self.quant_granularity).validate()

    def chunk(self, block_size: int) -> int:
        return prefill_chunk_size(self.prefill_chunk, block_size)

    def window_buckets(self) -> tuple:
        """The window sizes this engine may launch, smallest first: the
        powers of two below ``decode_window`` and ``decode_window``
        itself when auto-tuned, else ``decode_window`` alone."""
        W = max(int(self.decode_window), 1)
        if W <= 1:
            return (1,)
        if not self.decode_window_auto:
            return (W,)
        out, b = [], 2
        while b < W:
            out.append(b)
            b *= 2
        return tuple(out) + (W,)

    def warmup_tokens(self) -> int:
        """Tokens a warmup request generates so that it drives the steady
        window path past its admission's mixed window (one definition for
        every warmup)."""
        return 1 if self.decode_window <= 1 else 2 * self.decode_window + 2


@dataclass(frozen=True)
class KernelRoute:
    """The engine's kernel-route decision, made once at construction and
    exported by ``metrics_summary()['kernel_route']`` with the JAX
    engine's schema. ``decode`` is "fused" (every layer of a step in one
    ``fused_paged_decode_layers`` call), "kernel" (attention per layer
    through ``paged_window_attention``) or "gather" (scatter, gather the
    logical view, attend); on the card the first two are the CUDA
    kernels, on the CPU their plain versions. ``window`` is the mixed
    prefill+decode windows' route: "kernel" (``paged_window_attention``
    at W = the prefill chunk) or "gather", and "none" on an engine that
    runs no window (``decode_window`` 1). ``verify`` is the speculative
    verify step's: "kernel" (``paged_window_attention`` at W = k+1),
    "gather", or "none" without a drafter. ``reasons`` names every
    failed gate."""

    decode: str
    window: str
    reasons: tuple
    verify: str = "none"
    kv_quant: str = "none"
    granularity: str = "page"
    sharded: bool = False         # the kernel runs per data shard
    mesh: tuple = (1, 1)          # (data, model)

    def summary(self) -> dict:
        return {"route": self.decode, "decode": self.decode,
                "window": self.window, "verify": self.verify,
                "sharded": self.sharded,
                "mesh": list(self.mesh),
                "kv_quant": self.kv_quant, "weight_quant": "none",
                "granularity": self.granularity, "act_quant": "none",
                "reasons": list(self.reasons)}


def decide_kernel_route(cfg: ModelConfig, ecfg: EngineConfig,
                        page_size: int, max_pages: int, itemsize: int,
                        n_slots: int, n_pages: int = 0,
                        spec_k: int = 0) -> KernelRoute:
    """The JAX engine's rule: the fused all-layers kernel whenever
    ``fused_paged_decode_supported`` holds on a 1x1 mesh, else the
    per-layer kernel inside its envelope (on a mesh, per data shard,
    where ``paged_kernel_mesh_ok`` holds for the pool's ``n_pages``),
    else the gather route. ``itemsize`` is the POOL's element size (1
    for int8/fp8), as the JAX engine passes it, so an int8 pool can
    admit the f32 fused route that an f32 pool misses. A windowed
    engine's mixed windows take the per-layer kernel wherever the same
    gates hold and its envelope takes W = the prefill chunk
    (``window_*`` reasons otherwise), as JAX's
    ``mixed_step_kernel_ok``; so does the speculative verify step of an
    engine with a drafter of ``spec_k`` drafts, at W = spec_k + 1
    (``verify_*`` reasons otherwise), as JAX routes it with its windows."""
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
    window = "none"
    if ecfg.decode_window > 1:
        _, wenv = paged_attention_envelope(
            h_loc, cfg.head_dim, page_size, itemsize=itemsize,
            window=ecfg.chunk(cfg.block_size), max_pages=max_pages,
            kv_quant=q.kv_dtype, granularity=q.granularity)
        wreasons = [f"window_{r}" for r in wenv if r not in env]
        reasons.extend(wreasons)
        window = "gather" if decode == "gather" or wreasons else "kernel"
    verify = "none"
    if spec_k > 0:
        _, venv = paged_attention_envelope(
            h_loc, cfg.head_dim, page_size, itemsize=itemsize,
            window=spec_k + 1, max_pages=max_pages, kv_quant=q.kv_dtype,
            granularity=q.granularity)
        vreasons = [f"verify_{r}" for r in venv if r not in env]
        reasons.extend(vreasons)
        verify = "gather" if decode == "gather" or vreasons else "kernel"
    return KernelRoute(decode=decode, window=window, verify=verify,
                       reasons=tuple(reasons),
                       kv_quant=q.kv_dtype, granularity=q.granularity,
                       sharded=d * m > 1 and decode == "kernel",
                       mesh=(d, m))


def route_kernels(cfg: ModelConfig, ecfg: EngineConfig) -> tuple:
    """The CUDA kernel sources (``csrc/<name>.cu``) an engine of ``cfg``
    and ``ecfg`` loads on the card, from its route decision alone, so that
    a launcher builds them before its workers start (a build needs
    ``nvcc``, not a card)."""
    from ..quant.kv import kv_itemsize
    psz, mp, n_pages = pool_geometry(cfg, ecfg.pool_size, ecfg.page_size,
                                     ecfg.max_pages, ecfg.n_pages)
    route = decide_kernel_route(cfg, ecfg, psz, mp,
                                kv_itemsize(ecfg.kv_quant, cfg),
                                ecfg.pool_size, n_pages)
    names = []
    if route.decode == "fused":
        names.append("fused_paged_decode_layers")
    if "kernel" in (route.decode, route.window):
        names.append("paged_window_attention")
    return tuple(names)


def engine_summary_block(engine: "Engine") -> dict:
    """One replica's block of the fleet summary
    (``serve.router.Router.fleet_summary``)."""
    s = engine.metrics_summary()
    return {
        "occupancy_mean": round(
            s["histograms"].get("batch_fill_ratio", {}).get("mean", 0.0), 4),
        "n_steps": engine.n_steps,
        "step_latency": s["step_latency"],
        "kernel_route": s["kernel_route"],
        "pages": s["pages"],
        "finished": {k: int(v) for k, v in engine.metrics.counters.items()
                     if k.startswith("finished_")},
    }


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


@dataclass
class _InFlight:
    """One enqueued window whose token block has not been read yet.
    ``block``: its (2, k, B) int32 tokens and emitted mask, in pinned
    host memory on the card (the copy enqueued at launch, ``event``
    recorded after it), else the tensor itself."""

    block: torch.Tensor
    event: Optional[torch.cuda.Event]
    k: int                        # the window's steps
    t_wall: float                 # launch time (perf_counter)
    n_active: int                 # live slots at launch
    host_s: float = 0.0           # the host's launch time (the
                                  # autotuner's numerator)
    #: (slot, request id) of the slots whose in-window prefill completes
    #: in this window: their radix registration waits for its drain; the
    #: id guards against a slot recycled since the launch
    pf_done: List = field(default_factory=list)


def _merge_lifecycle(tok, pos, active, budget, life):
    """Fold a boundary's host-side lifecycle changes into the card's step
    state at the top of a window (JAX ``_merge_lifecycle``). ``life`` is
    ONE (5, B) int32 tensor: row 0 the kill flags (cancelled or expired
    slots go inactive from the window's first step: their writes drop
    and they emit nothing), row 1 the admission flags, rows 2-4 an
    admitted slot's token, position and budget (it goes active)."""
    kill, adm = life[0].bool(), life[1].bool()
    tok = torch.where(adm, life[2], tok)
    pos = torch.where(adm, life[3], pos)
    budget = torch.where(adm, life[4], budget)
    return tok, pos, (active | adm) & ~kill, budget


def _engine_decode_window(params, state, eos, life, tables, cache,
                          cfg: ModelConfig, *, k: int, sample_fn,
                          max_pos, use_kernel: bool = False,
                          use_fused: bool = False, fused_blocks=None):
    """The steady window: the lifecycle merge, then ``k`` decode steps
    (``models.gpt.decode_window_paged``). ``state``: (tok, pos, active,
    budget) on the card. Returns ``(toks, emitted, tok, pos, active,
    budget)``."""
    tok, pos, active, budget = _merge_lifecycle(*state, life)
    return decode_window_paged(params, tok, pos, active, budget, eos,
                               tables, cache, cfg, sample_fn=sample_fn,
                               length=k, use_kernel=use_kernel,
                               use_fused=use_fused,
                               fused_blocks=fused_blocks, max_pos=max_pos)


def _engine_mixed_window(params, state, eos, life, pfc, pf_toks, tables,
                         cache, cfg: ModelConfig, *, k: int, sample_fn,
                         max_pos, use_kernel: bool = False):
    """The window launched while a slot still has prompt chunks to
    write: the lifecycle merge, then ``models.gpt.mixed_window_paged``.
    ``pfc``: the (3, B) prefill cursors in one tensor (chunks this
    window, next write position, prompt length); ``pf_toks`` (k, B,
    chunk) the chunks."""
    tok, pos, active, budget = _merge_lifecycle(*state, life)
    return mixed_window_paged(params, tok, pos, active, budget, eos,
                              pfc[0], pfc[1], pfc[2], pf_toks, tables,
                              cache, cfg, sample_fn=sample_fn, length=k,
                              use_kernel=use_kernel, max_pos=max_pos)


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
    launch's process group, joined before the engine is made).

    ``drafter`` (serve/speculative.py) turns on speculative decoding;
    ``rcfg`` (``faults.watchdog.ResilienceConfig``) opts into the
    self-healing policies, None or all-zero changing nothing;
    ``journal`` (``serve.journal.RequestJournal``) records accepted and
    finished requests. ``params`` (``models.gpt.compute_params`` of
    ``model`` on ``device``) shares one cast copy of the weights between
    engines, as the fleet's replicas do (1x1 only)."""

    def __init__(self, model: GPT, cfg: ModelConfig,
                 ecfg: EngineConfig = EngineConfig(),
                 clock: Callable[[], float] = time.monotonic,
                 device: Optional[Union[str, torch.device]] = None,
                 drafter: Optional[Drafter] = None,
                 rcfg: Optional[ResilienceConfig] = None, journal=None,
                 params: Optional[Params] = None):
        cfg.validate()
        if ecfg.decode_window > 1 and ecfg.mesh_data * ecfg.mesh_model > 1:
            raise ValueError(
                f"decode_window={ecfg.decode_window} on a "
                f"{ecfg.mesh_data}x{ecfg.mesh_model} serving mesh is not "
                f"implemented in replicatinggpt_tpu_torch yet: ROADMAP.md "
                f"{MESH_WINDOW_ITEM}")
        if drafter is not None and ecfg.mesh_data * ecfg.mesh_model > 1:
            raise ValueError(
                f"a drafter on a {ecfg.mesh_data}x{ecfg.mesh_model} serving "
                f"mesh is not implemented in replicatinggpt_tpu_torch yet: "
                f"ROADMAP.md {MESH_SPEC_ITEM}")
        dcfg = getattr(drafter, "cfg", None)
        if dcfg is not None:           # model drafter: pools must line up
            assert dcfg.vocab_size == cfg.vocab_size, \
                "draft model must share the target vocab"
            assert dcfg.block_size == cfg.block_size, \
                "draft model must share the target block_size"
            assert drafter.pool_size == ecfg.pool_size, \
                "draft pool must match the engine pool"
        self.drafter = drafter
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        if params is not None and ecfg.mesh_data * ecfg.mesh_model > 1:
            raise ValueError("shared params= are the 1x1 engine's; a "
                             "serving mesh splits its own from model")
        self.params: Params = (compute_params(model, dev) if params is None
                               else params)
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
        # the window sizes and the autotuner's cursor and accumulators
        # (host launch time vs window wall since its last decision)
        self._window = max(int(ecfg.decode_window), 1)
        self._buckets = ecfg.window_buckets()
        self._wk = 0
        self._window_cur = self._buckets[0]
        self._at_host = self._at_wall = 0.0
        self._at_n = 0
        self.kernel_route = decide_kernel_route(
            cfg, ecfg, self.pool.page_size, self.pool.max_pages,
            self.pool.itemsize, P, self.pool.n_pages,
            spec_k=drafter.k if drafter is not None else 0)
        self._use_kernel = self.kernel_route.decode == "kernel"
        self._use_fused = self.kernel_route.decode == "fused"
        self._use_window_kernel = self.kernel_route.window == "kernel"
        self._use_verify_kernel = self.kernel_route.verify == "kernel"
        # the fused kernel's blocks, every one in the compute dtype
        self._fused_blocks = (fused_weights(self.params["blocks"],
                                            cfg.compute_dtype)
                              if self._use_fused else None)
        log.info("kernel route: %s, window %s%s", self.kernel_route.decode,
                 self.kernel_route.window,
                 (f", verify {self.kernel_route.verify}"
                  if drafter is not None else "")
                 + (" reasons=" + ",".join(self.kernel_route.reasons)
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
        # device copies of the eos ids, page tables and sampling params,
        # rebuilt only after an admission or finish changed them
        self._li = None
        # lifecycle masks of the windows: request id -> kill reason, and
        # the slots admitted since the last launch (_merge_lifecycle)
        self._kill: Dict[str, str] = {}
        self._adm_mask = np.zeros((P,), bool)
        # in-window prefill cursors: chunks left to launch, next write
        # position, prompt length, and the padded prompt tails; a window
        # consumes min(k, chunks left), so the host advances them at
        # launch without reading the card
        self._pf_left = np.zeros((P,), np.int32)
        self._pf_off = np.zeros((P,), np.int32)
        self._pf_limit = np.zeros((P,), np.int32)
        self._pf_tail: Dict[int, np.ndarray] = {}
        # the launched windows' schedule: each slot's budget left and
        # position after them (the card's, unless an eos ended it sooner)
        self._sched_budget = np.zeros((P,), np.int32)
        self._sched_pos = np.zeros((P,), np.int32)
        # the card's (tok, pos, active, budget) between windows (None:
        # upload the host mirrors at the next launch), the window whose
        # token block is unread, and the quiet boundaries' lifecycle pack
        self._dev_state = None
        self._inflight: Optional[_InFlight] = None
        self._z_life = torch.zeros((5, P), dtype=torch.int32, device=dev)
        self._slots: Dict[int, _Active] = {}
        self._pending: List[RequestResult] = []
        self.n_steps = 0
        if self._window > 1:
            self._warm_windows()
        # self-healing (faults.watchdog), every policy opt-in through rcfg
        self.rcfg = rcfg or ResilienceConfig()
        self.journal = journal
        self._spec_active = drafter is not None
        self._watchdog = (StepWatchdog(self.rcfg)
                          if self.rcfg.watchdog_on else None)
        self._spec_health = (SpecHealth(self.rcfg)
                             if self.rcfg.spec_guard_on
                             and drafter is not None else None)
        self._shedder = (LoadShedder(self.rcfg)
                         if self.rcfg.shed_on else None)
        self._probe_pending = False
        self._spec_pinned = False     # operator pin (set_spec_active)
        #: host-side log of resilience events, the newest 256
        self.events: List[str] = []

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
        if self.journal is not None:
            self.journal.record_submit(req)
        return None

    def cancel(self, request_id: str, migrated: bool = False) -> bool:
        """Cancel a queued or running request; its terminal result (with
        any tokens produced) surfaces from the next ``step()``.

        On a windowed engine a cancel is a lifecycle mask: the kill flag
        rides the next window, which deactivates the slot on the card
        from its first step (the slot emits nothing after it lands), and
        the slot and its pages free at that boundary, after the window
        in flight is read (its tokens ride the result). A cancel racing
        a window that already finished the request surfaces the natural
        finish. ``migrated=True`` is the fleet router's re-route: the
        router resubmits the id elsewhere in the same step, so the slot
        must be free NOW, not at the next boundary. The window in flight
        is read (a ``cancel`` window break) and the slot finishes and
        frees at once, on every engine. Either way the finish is
        journaled, so that this engine's journal never replays the
        id."""
        now = self.clock()
        if self.scheduler.cancel(request_id):
            self.metrics.inc("finished_" + FINISH_CANCELLED)
            self._journal_finish(request_id, FINISH_CANCELLED)
            self._pending.append(RequestResult(
                id=request_id, tokens=[], finish_reason=FINISH_CANCELLED))
            return True
        slot = self.pool.slot_of(request_id)
        if slot is None:
            return False
        if self._window > 1 and not migrated:
            self._kill[request_id] = FINISH_CANCELLED
            return True
        self._kill.pop(request_id, None)
        self._pending.extend(self._drain_pending("cancel"))
        slot = self.pool.slot_of(request_id)
        if slot is None:
            # the window just read finished it; its result is pending
            return True
        self._pending.append(self._finish_slot(slot, FINISH_CANCELLED, now))
        return True

    def partial_tokens(self, request_id: str) -> Optional[List[int]]:
        """The tokens committed so far for an active request (a copy);
        None while it is queued or after it finished. The fleet router's
        delivery ledger reads this between steps."""
        slot = self.pool.slot_of(request_id)
        if slot is None or slot not in self._slots:
            return None
        return list(self._slots[slot].tokens)

    def in_flight_ids(self) -> List[str]:
        """Every accepted-but-unfinished request id: the queued ones in
        arrival order, then the active slots'."""
        return self.scheduler.ids() + [self._slots[s].req.id
                                       for s in sorted(self._slots)]

    def warmup(self) -> None:
        """Run one throwaway greedy request of ``ecfg.warmup_tokens()``
        tokens through this engine, its journal detached, so that the
        first real request builds and loads nothing (on the card: the
        kernels of every path the engine takes, and their first
        launches); then reset the counters, timings and page statistics,
        as if no request had run. The engine must be idle."""
        if not self.idle:
            raise RuntimeError("warmup() needs an idle engine")
        journal, self.journal = self.journal, None
        try:
            rej = self.submit(Request(
                id="__warmup__", prompt=np.zeros((1,), np.int32),
                max_new_tokens=self.ecfg.warmup_tokens(),
                sampling=SamplingParams(greedy=True)))
            if rej is not None:
                raise RuntimeError(f"warm-up request refused: {rej}")
            self.drain()
        finally:
            self.journal = journal
        self.metrics = Metrics()
        self.step_timer = StepTimer(self.device)
        self.n_steps = 0
        a = self.pool.alloc
        a.prefix_lookups = a.prefix_hits = a.prefix_hit_tokens = 0
        a.prompt_tokens = a.evictions = a.cow_copies = 0
        self.events.clear()

    @property
    def idle(self) -> bool:
        return (not self._active.any() and len(self.scheduler) == 0
                and not self._pending and self._inflight is None)

    def step(self) -> List[RequestResult]:
        """One scheduling iteration: expire -> shed -> admit -> decode, with
        the self-healing policies around the decode phase when configured.
        On a windowed engine the decode phase is one window boundary
        (``_window_step``): admissions are host bookkeeping whose prompt
        chunks ride the next window, expired and cancelled slots ride it
        as kill flags, and the next window is enqueued before the one in
        flight is read. A speculative step (a drafter active, or its
        re-probe due) leaves the window path: it reads the window in
        flight, completes any in-window prefill, admits and verifies."""
        finished: List[RequestResult] = self._pending
        self._pending = []
        now = self.clock()
        t_wall = time.perf_counter()
        for req, t_submit, reason in self.scheduler.drain_expired(now):
            finished.append(self._finish_unstarted(req, t_submit, reason,
                                                   now))
        if self._shedder is not None:
            n_shed = self._shedder.observe(self.scheduler.depth,
                                           self.ecfg.max_queue)
            if n_shed:
                for req, t_submit in self.scheduler.shed(n_shed):
                    finished.append(self._finish_unstarted(
                        req, t_submit, FINISH_SHED, now))
                self.metrics.inc("shed_requests", n_shed)
                self._event(f"step {self.n_steps}: shed {n_shed} queued "
                            f"request(s) under sustained overload")
        expired = [int(s) for s in
                   np.flatnonzero(self._active & (self._deadline <= now))
                   if int(s) in self._slots]
        # the re-probe countdown while auto-disabled (an operator's pin
        # through set_spec_active(False) sticks)
        reprobe = False
        if (self.drafter is not None and not self._spec_active
                and not self._spec_pinned and self._spec_health is not None
                and self._active.any()):
            reprobe = self._spec_health.tick_disabled()
        use_spec = self.drafter is not None and (self._spec_active
                                                 or reprobe)
        windowed = self._window > 1 and not use_spec
        busy = windowed and bool(self._active.any() or self._kill or expired
                                 or self._head_admissible())
        if busy:
            for slot in expired:
                self._kill.setdefault(self._slots[slot].req.id,
                                      FINISH_DEADLINE)
        elif not windowed:
            # a speculative step on a windowed engine reads the window in
            # flight first (its tokens commit, its finished slots free)
            # and writes any prompt chunks the abandoned windows still
            # owed: the verify step attends every admitted prompt whole
            finished.extend(self._drain_pending(
                "reprobe" if reprobe else "spec"))
            self._flush_prefill()
            for rid, reason in list(self._kill.items()):
                slot = self.pool.slot_of(rid)
                if slot is not None and slot in self._slots:
                    finished.append(self._finish_slot(slot, reason, now))
            self._kill.clear()
            for slot in expired:
                if slot in self._slots:   # it may have ended in the drain
                    finished.append(self._finish_slot(slot, FINISH_DEADLINE,
                                                      now))
            if reprobe:
                self.set_spec_active(True)
                self._probe_pending = True
                self.metrics.inc("spec_reprobes")
                self._event(f"step {self.n_steps}: re-probing speculative "
                            f"decoding")
            self._admit_queue(now, finished, self._admit)
        self._gauges()
        # fault seam: an artificially slow step (no-op without a plan),
        # what the watchdog must catch
        flt = fault_fire("serve/step", index=self.n_steps)
        if flt is not None and flt.kind == "delay":
            time.sleep(flt.arg)
        ran = False
        if busy:
            self._window_step(now, finished)
            ran = True
        elif windowed:
            if self._inflight is not None:
                # every slot finished while a window flew: read it (it
                # emits nothing) so that drain() reaches idle
                finished.extend(self._drain_pending())
        elif self._active.any():
            finished.extend(self._verify_once()
                            if self.drafter is not None and self._spec_active
                            else self._decode_once())
            ran = True
        if ran and self._watchdog is not None:
            dur = time.perf_counter() - t_wall
            if self._watchdog.observe(dur):
                self.metrics.inc("watchdog_stalls")
                self.metrics.gauge("last_stall_s", dur)
                self._event(f"step {self.n_steps}: stall, {dur * 1e3:.1f} ms "
                            f"step against a p99-derived budget")
        return finished

    def set_spec_active(self, active: bool) -> None:
        """Switch speculative decoding between its verify step and the
        plain decode path. Turning it on resyncs a stateful drafter from
        the host's histories (tokens committed meanwhile never went
        through its cache), after reading the window in flight and
        completing any in-window prefill. Turning it off here PINS the
        plain path: the auto re-probe leaves it alone until
        ``set_spec_active(True)`` (the auto-disable flips ``_spec_active``
        itself and stays re-probeable)."""
        active = active and self.drafter is not None
        if active and not self._spec_active:
            self._pending.extend(self._drain_pending("spec"))
            self._flush_prefill()
            hists = self._histories()
            for slot in self._slots:
                if self._active[slot] and hists[slot] is not None:
                    self.drafter.resync(slot, hists[slot])
        self._spec_pinned = not active and self.drafter is not None
        self._spec_active = active

    @property
    def spec_active(self) -> bool:
        return self._spec_active

    def _journal_finish(self, request_id: str, reason: str) -> None:
        if self.journal is not None:
            self.journal.record_finish(request_id, reason)

    def _event(self, msg: str) -> None:
        self.events.append(msg)
        if len(self.events) > 256:
            del self.events[:len(self.events) - 256]

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
        # the host's launch time per launch and per token (a window's
        # launch is its enqueue, before any wait on the card; a blocked
        # step's the same up to its token read)
        c = self.metrics.counters
        disp = self.metrics.hist_summary("decode_dispatch_s")
        n_disp = int(c.get("decode_dispatches", 0))
        tokens = int(c.get("dispatch_tokens", 0))
        mean_ms = disp["mean"] * 1e3
        s["dispatch"] = {
            "window_k": self._window_cur,
            "window_k_max": self._window,
            "autotune": bool(self.ecfg.decode_window_auto),
            "autotune_increases": int(c.get("autotune_window_increases",
                                            0)),
            "dispatches": n_disp,
            "mean_dispatch_ms": round(mean_ms, 4),
            "host_dispatch_ms_per_token": (round(mean_ms * n_disp / tokens,
                                                 4) if tokens else 0.0),
            "decode_windows": int(c.get("decode_windows", 0)),
            "mixed_windows": int(c.get("mixed_windows", 0)),
            "decode_window_steps": int(c.get("decode_window_steps", 0)),
            "mixed_window_steps": int(c.get("mixed_window_steps", 0)),
        }
        # the host mutations that make a windowed engine read the window
        # in flight early and leave the window path, the JAX engine's
        # keys: admissions, deadlines and cancels ride the windows here,
        # so only a speculative step ('spec') or re-probe moves them
        s["window_breaks"] = {
            r: int(c.get("window_breaks_" + r, 0))
            for r in ("admit", "deadline", "cancel", "spec", "reprobe")}
        s["recovery"] = {
            "watchdog_stalls": int(c.get("watchdog_stalls", 0)),
            "spec_disables": int(c.get("spec_disables", 0)),
            "spec_reprobes": int(c.get("spec_reprobes", 0)),
            "shed_requests": int(c.get("shed_requests", 0)),
            "spec_active": self._spec_active,
            "events": list(self.events[-32:]),
        }
        if self.drafter is not None:
            drafted = c.get("spec_draft_tokens", 0)
            slot_steps = c.get("slot_steps", 0)
            s["speculative"] = {
                "drafter": self.drafter.name,
                "k": self.drafter.k,
                "accept_rate": (round(c.get("spec_accepted_tokens", 0)
                                      / drafted, 4) if drafted else 0.0),
                "mean_tokens_per_step": (round(c.get("spec_tokens", 0)
                                               / slot_steps, 3)
                                         if slot_steps else 0.0),
                "verify_steps": int(c.get("verify_steps", 0)),
                "draft_overhead_s":
                    self.metrics.hist_summary("draft_overhead_s"),
            }
        return s

    # ----------------------------------------------------------- internals

    def _gauges(self) -> None:
        self.metrics.gauge("queue_depth", self.scheduler.depth)
        self.metrics.gauge("slots_active", int(self._active.sum()))
        self.metrics.gauge("slot_occupancy", self.pool.occupancy)
        self.metrics.gauge("pages_in_use", self.pool.alloc.pages_in_use)

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

    def _padded_tail(self, req: Request, claimed: int) -> np.ndarray:
        """The prompt's uncached tail, zero-padded to whole chunks."""
        P = int(req.prompt.size)
        if P > self.pool.seq_len:
            raise IndexError(f"prefill of a {P}-token prompt past "
                             f"{self.pool.seq_len}")
        chunk = self._chunk
        padded = np.zeros((-(-(P - claimed) // chunk) * chunk,), np.int32)
        padded[:P - claimed] = req.prompt[claimed:]
        return padded

    def _admit(self, req: Request, t_submit: float, now: float) -> None:
        """Blocked admission: claim, copy-on-write, prefill now."""
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
            padded = self._padded_tail(req, claimed)
            dev = self.device
            toks = torch.tensor(padded.astype(np.int64), device=dev)
            table_row = torch.tensor(self.pool.tables[slot], device=dev)
            for c in range(padded.size // chunk):
                prefill_chunk_paged(
                    self.params, toks[None, c * chunk:(c + 1) * chunk],
                    claimed + c * chunk, P, table_row, self.pool.cache,
                    self.cfg, group=self.group,
                    host_row=self.pool.tables[slot])
        # registration AFTER the prefill wrote the pages: a same-step
        # neighbor may claim them the moment they hit the radix
        self.pool.commit_admission(slot)
        self._admit_finalize(req, t_submit, now, slot, cap, claimed)

    def _admit_windowed(self, req: Request, t_submit: float, now: float
                        ) -> None:
        """Admission at a window boundary: ``_admit``'s claim and
        copy-on-write (enqueued behind the window in flight), but the
        prompt's uncached tail goes onto the prefill cursors and rides
        the next (mixed) window, and the slot enters the card's state
        through the admission mask. Its radix registration waits for the
        drain of the window that finishes its prefill
        (``_InFlight.pf_done``): pages a window in flight is writing must
        not be claimable."""
        P = int(req.prompt.size)
        cap = self._cap(req)
        adm = self.pool.acquire(req.id, req.prompt, cap, defer_commit=True)
        assert adm is not None, "scheduler admitted past pool capacity"
        slot = adm.slot
        for src, dst in adm.cow:
            self.pool.copy_page(src, dst)
        claimed = adm.claimed
        if claimed < P:
            padded = self._padded_tail(req, claimed)
            self._pf_tail[slot] = padded
            self._pf_left[slot] = padded.size // self._chunk
            self._pf_off[slot] = claimed
            self._pf_limit[slot] = P
        else:
            # a fully cached prompt (copy-on-write aside) writes nothing:
            # its pages were written and registered by earlier owners
            self.pool.commit_admission(slot)
        self._adm_mask[slot] = True
        self._admit_finalize(req, t_submit, now, slot, cap, claimed)

    def _admit_finalize(self, req: Request, t_submit: float, now: float,
                        slot: int, cap: int, claimed: int) -> None:
        """The slot mirrors and records both admissions share."""
        P = int(req.prompt.size)
        if self.drafter is not None:
            # a drafter keeps its own cache and sees the whole prompt:
            # prefix reuse is the target pool's
            self.drafter.on_admit(slot, req.prompt)
        self._tok[slot] = req.prompt[-1]
        self._active[slot] = True
        self._budget[slot] = self._sched_budget[slot] = cap
        self._sched_pos[slot] = P - 1
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

    def _admit_queue(self, now: float, finished: List[RequestResult],
                     admit_fn) -> None:
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
            admit_fn(req, t_submit, now)

    def _head_admissible(self) -> bool:
        """Whether this step could admit: a free slot and a queued head
        that fits. While it cannot, a backlog waits for a window
        boundary that frees room."""
        if self.pool.n_free <= 0:
            return False
        head = self.scheduler.peek()
        return head is not None and self._fits(head[0])

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card: through
        pinned memory, enqueued without waiting, so that a window
        boundary never blocks the host on the card."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _launch_inputs(self) -> tuple:
        """The eos ids, page tables and sampling params on the device,
        uploaded again only after an admission or finish changed them."""
        if self._li is None:
            self._li = tuple(self._upload(a) for a in (
                self._eos, self.pool.tables, self._temp, self._top_k,
                self._top_p, self._greedy))
            if self.group is not None:
                self.group.broadcast_(self._li[1:2])  # rank 0's tables
        return self._li

    def _decode_once(self) -> List[RequestResult]:
        """One blocked decode step over every slot, its tokens read at
        once. The host mirror bounds the write positions and sizes the
        kernels' split."""
        self.step_timer.start()
        t_wall = time.perf_counter()
        n_active = int(self._active.sum())
        dev = self.device
        _, tables, temp, top_k, top_p, greedy = self._launch_inputs()
        pe = np.where(self._active, self._pos, 0)
        cap = self.pool.max_pages * self.pool.page_size
        if pe.min() < 0 or pe.max() >= cap:
            raise IndexError(f"paged decode write: [{pe.min()}, "
                             f"{pe.max() + 1}) outside [0, {cap})")
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
                                      host_tables=self.pool.tables,
                                      max_pos=int(pe.max()))
        gens = [g if a and not gr else None
                for g, a, gr in zip(self._gens, self._active, self._greedy)]
        nxt = sample_tokens_batched(gens, logits, temp, top_k, top_p, greedy)
        if self.group is not None:
            self.group.broadcast_([nxt])     # rank 0's samples
        host_s = time.perf_counter() - t_wall
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
        self.metrics.inc("decode_dispatches")
        self.metrics.observe("decode_dispatch_s", host_s)
        self.metrics.inc("dispatch_tokens", n_tok)
        finished: List[RequestResult] = []
        for slot in list(self._slots):
            if not emitted[slot]:
                continue
            st = self._slots[slot]
            self._commit_tokens(slot, st, [int(toks[slot])], now)
            finished.extend(self._finish_if_done(slot, st, now))
        # the full prompt page holding position P-1 becomes shareable
        # once the decode frontier passed it
        self.pool.flush_pending()
        return finished

    # -------------------------------------------------------- speculative

    def _histories(self) -> List[Optional[np.ndarray]]:
        """Per-slot prompt+generated history: host data (the engine
        appends every committed token), so a drafter never reads the
        device for it."""
        out: List[Optional[np.ndarray]] = [None] * self.ecfg.pool_size
        for slot, st in self._slots.items():
            out[slot] = np.concatenate(
                [st.req.prompt,
                 np.fromiter(st.tokens, np.int32, len(st.tokens))])
        return out

    def _verify_once(self) -> List[RequestResult]:
        """One speculative step: the host's draft, ONE verify pass over
        every slot's (k+1)-token window, and the commit of 1..k+1 tokens a
        slot. Each slot's drafts are bounded on the host by its room (the
        window's last real position stays inside the slot) and its
        remaining budget; the window's real writes are checked against the
        slot's positions before the launch, and the accepted counts and
        tokens are read back in one copy."""
        k = self.drafter.k
        S = self.pool.seq_len
        P = self.ecfg.pool_size
        # verify works off the host mirrors and advances them: the card's
        # window state, if any, is stale after this step
        self._dev_state = None
        ctx = DraftContext(
            tok=self._tok, pos=self._pos, active=self._active,
            histories=(self._histories() if self.drafter.needs_history
                       else None))
        draft_toks, draft_len, dt = timed_draft(self.drafter, ctx,
                                                self.cfg.vocab_size)
        self.metrics.observe("draft_overhead_s", dt)
        m = np.zeros((P,), np.int32)
        for slot, st in self._slots.items():
            if not self._active[slot]:
                continue
            room = S - 1 - int(self._pos[slot])
            budget = st.cap - len(st.tokens) - 1
            m[slot] = max(0, min(int(draft_len[slot]), k, room, budget))
        pe = np.where(self._active, self._pos + m, 0)
        if pe.min() < 0 or pe.max() >= S:
            raise IndexError(f"speculative verify window: [{pe.min()}, "
                             f"{pe.max() + 1}) outside [0, {S})")
        window = np.zeros((P, k + 1), np.int32)
        window[:, 0] = self._tok
        window[:, 1:] = draft_toks
        self.step_timer.start()
        up = self._upload(np.concatenate(
            [window, np.stack([self._pos, m, self._active.astype(np.int32)],
                              1)], 1))
        window_d, pos, n_valid = up[:, :k + 1], up[:, k + 1], up[:, k + 2]
        active = up[:, k + 3].bool()
        _, tables, temp, top_k, top_p, greedy = self._launch_inputs()
        logits, _ = verify_step_paged(
            self.params, window_d, pos, n_valid, active, tables,
            self.pool.cache, self.cfg, use_kernel=self._use_verify_kernel,
            max_pos=int(np.where(self._active, self._pos, 0).max()))
        gens = [g if a and not gr else None
                for g, a, gr in zip(self._gens, self._active, self._greedy)]
        noise = spec_noise(gens, P, k + 1, self.cfg.vocab_size, self.device)
        n_acc, out = spec_accept_and_sample(logits, window_d, n_valid, temp,
                                            top_k, top_p, greedy, noise)
        res = torch.cat([n_acc[:, None], out], 1).cpu().numpy()
        self.step_timer.lap()
        n_acc_h, out_h = res[:, 0], res[:, 1:]
        now = self.clock()
        self.n_steps += 1
        n_active = int(self._active.sum())
        drafted = int(m[self._active].sum())
        accepted = int(n_acc_h[self._active].sum())
        emitted = accepted + n_active         # + the correction or bonus
        self.metrics.observe("batch_fill_ratio", n_active / P)
        self.metrics.inc("decode_steps")
        self.metrics.inc("verify_steps")
        self.metrics.inc("slot_steps", n_active)
        self.metrics.inc("spec_draft_tokens", drafted)
        self.metrics.inc("spec_accepted_tokens", accepted)
        self.metrics.inc("spec_tokens", emitted)
        if drafted:
            self.metrics.observe("accept_rate", accepted / drafted)
        self.metrics.observe("tokens_per_slot_step", emitted / n_active)
        if self._spec_health is not None:
            if self._spec_health.observe(drafted, accepted):
                # at this accept rate the drafter is a pure tax: back to
                # plain decode, and a re-probe later with backoff
                self._spec_active = False
                self._probe_pending = False
                self._spec_health.on_disable()
                self.metrics.inc("spec_disables")
                self._event(f"step {self.n_steps}: speculative decoding "
                            f"disabled (windowed accept rate below "
                            f"{self.rcfg.spec_disable_threshold})")
            elif (self._probe_pending and len(self._spec_health.window)
                  >= self.rcfg.spec_window):
                self._probe_pending = False
                self._spec_health.on_reenable()
                self._event(f"step {self.n_steps}: speculative re-probe "
                            f"healthy; backoff reset")
        finished: List[RequestResult] = []
        n_tok = 0
        for slot in list(self._slots):
            if not self._active[slot]:
                continue
            st = self._slots[slot]
            committed = [int(t) for t in out_h[slot, :int(n_acc_h[slot]) + 1]]
            eos = int(self._eos[slot])
            if eos >= 0 and eos in committed:
                # an accepted eos ends the stream there: drop what the
                # window committed past it
                committed = committed[:committed.index(eos) + 1]
            n_tok += len(committed)
            self._commit_tokens(slot, st, committed, now)
            finished.extend(self._finish_if_done(slot, st, now))
        # decode_tokens counts the verify commits too; dispatch_tokens, the
        # denominator of the host's launch time a token, does not
        self.metrics.inc("decode_tokens", n_tok)
        # a windowed engine's launch schedule restarts from the mirrors
        self._sched_budget[:] = self._budget
        self._sched_pos[:] = self._pos
        self.pool.flush_pending()
        return finished

    def _flush_prefill(self) -> None:
        """Write, through the blocked prefill, the prompt chunks that
        in-window prefills still owe, and register their pages: called
        when the engine leaves the window path with chunks outstanding
        (a speculative step), since the verify and decode paths attend
        each admitted slot's whole prompt."""
        for slot in np.flatnonzero(self._pf_left > 0):
            slot = int(slot)
            chunk = self._chunk
            tail = self._pf_tail.pop(slot)
            n = int(self._pf_left[slot])
            off = int(self._pf_off[slot])
            limit = int(self._pf_limit[slot])
            toks = torch.tensor(tail[:n * chunk].astype(np.int64),
                                device=self.device)
            table_row = torch.tensor(self.pool.tables[slot],
                                     device=self.device)
            for c in range(n):
                prefill_chunk_paged(
                    self.params, toks[None, c * chunk:(c + 1) * chunk],
                    off + c * chunk, limit, table_row, self.pool.cache,
                    self.cfg, group=self.group,
                    host_row=self.pool.tables[slot])
            self._pf_left[slot] = self._pf_off[slot] = 0
            self._pf_limit[slot] = 0
            if slot in self._slots:
                self.pool.commit_admission(slot)

    # ------------------------------------------------------------ windows

    def _window_step(self, now: float, finished: List[RequestResult]
                     ) -> None:
        """One window boundary: resolve pending kills into this launch's
        flags, admit the queue head(s) as host bookkeeping (their chunks
        ride the launch), launch window N, read window N-1, then finish
        the killed slots, whose pages may free while window N flies: the
        kill flag deactivated them on the card before it started (writes
        dropped, nothing emitted)."""
        k = self._window_cur
        kill = np.zeros((self.ecfg.pool_size,), bool)
        kills = []
        for rid, reason in self._kill.items():
            slot = self.pool.slot_of(rid)
            if slot is not None and slot in self._slots:
                kill[slot] = True
                kills.append((slot, reason))
        # slots this boundary's kills free are admissible at the next one
        self._admit_queue(now, finished, self._admit_windowed)
        live = self._active & ~kill
        if kills or self._adm_mask.any():
            if live.any():
                nxt = self._launch(k, kill)
                finished.extend(self._drain_pending())
                for slot, reason in kills:
                    if slot in self._slots:   # it may have ended in N-1
                        finished.append(self._finish_slot(
                            slot, reason, now, masked=True))
                self._inflight = nxt
            else:
                # the kills empty the engine: no window would carry the
                # mask, so they finish on the host (the card's state is
                # then rebuilt from the mirrors at the next launch)
                finished.extend(self._drain_pending())
                for slot, reason in kills:
                    if slot in self._slots:
                        finished.append(self._finish_slot(slot, reason,
                                                          now))
            self._kill.clear()
        elif live.any():
            # each slot's work left in window steps: prefill chunks and
            # its budget; when all of it fits one window, that window is
            # the last (an eos only ends sooner)
            rem = np.where(live, self._pf_left + self._budget, 0)
            last = int(rem.max()) <= k
            if self._inflight is not None and last:
                finished.extend(self._drain_pending())
            elif last:
                finished.extend(self._drain_window(self._launch(k)))
            else:
                # double buffering: launch window N before reading N-1
                nxt = self._launch(k)
                finished.extend(self._drain_pending())
                self._inflight = nxt
        else:
            finished.extend(self._drain_pending())
            self._kill.clear()   # ids whose requests already ended

    def _window_plan(self, k: int, live: np.ndarray) -> tuple:
        """The host's schedule of a k-step window over the ``live``
        slots: (prefill chunks of each slot, its decode steps after
        them, per step the bound on every live slot's row base that
        sizes the kernels' split, per step the slots that draw). A slot
        decodes within the budget the launched windows left it; the
        bound is a prefilling slot's chunk start, a decoding slot's
        position after its decode steps so far."""
        n_pf = np.where(live, np.minimum(self._pf_left, k), 0)
        n_dec = np.where(live, np.clip(k - n_pf, 0, self._sched_budget), 0)
        over = (n_dec > 0) & (self._sched_pos + n_dec > self.pool.seq_len)
        if over.any():
            raise IndexError(f"decode window writes past position "
                             f"{self.pool.seq_len - 1} in slots "
                             f"{np.flatnonzero(over).tolist()}")
        t = np.arange(k)[:, None]
        base = np.where(t < n_pf, self._pf_off + t * self._chunk,
                        self._sched_pos + np.clip(t - n_pf, 0, n_dec))
        bounds = [int(b) for b in np.where(live, base, 0).max(1)]
        draws = ((t >= n_pf) & (t < n_pf + n_dec)
                 & (live & ~self._greedy))
        return n_pf, n_dec, bounds, draws

    def _launch(self, k: int, kill: Optional[np.ndarray] = None
                ) -> _InFlight:
        """Enqueue one k-step window without reading it: the decode
        window, or the mixed window while a slot has prompt chunks left.
        The card's state from the window before feeds it; kills and
        admissions ride it as one (5, B) upload (a quiet boundary uploads
        nothing); its token block's copy to pinned host memory is
        enqueued behind it, with an event that ``_drain_window`` waits
        on. No host read happens here."""
        t_wall = time.perf_counter()
        P = self.ecfg.pool_size
        if kill is None:
            kill = np.zeros((P,), bool)
        live = self._active & ~kill
        if self._dev_state is None:
            st = self._upload(np.stack([self._tok, self._pos,
                                        self._active.astype(np.int32),
                                        self._budget]))
            state = (st[0], st[1], st[2].bool(), st[3])
        else:
            state = self._dev_state
        eos_d, tables_d, *sample = self._launch_inputs()
        if kill.any() or self._adm_mask.any():
            life = self._upload(np.stack(
                [kill, self._adm_mask, self._tok, self._pos,
                 self._budget]).astype(np.int32))
        else:
            life = self._z_life
        n_pf, n_dec, bounds, draws = self._window_plan(k, live)
        gens = self._gens

        def sample_fn(t, logits):
            return sample_tokens_batched(
                [g if d else None for g, d in zip(gens, draws[t])], logits,
                *sample)

        pf = np.flatnonzero(n_pf)
        pf_done = []
        if pf.size:
            chunk = self._chunk
            pf_toks = np.zeros((k, P, chunk), np.int32)
            for slot in pf:
                n = int(n_pf[slot])
                pf_toks[:n, slot] = \
                    self._pf_tail[slot][:n * chunk].reshape(n, chunk)
            up = self._upload(np.concatenate([
                np.stack([n_pf, self._pf_off, self._pf_limit]).ravel(),
                pf_toks.ravel()]).astype(np.int32))
            out = _engine_mixed_window(
                self.params, state, eos_d, life, up[:3 * P].view(3, P),
                up[3 * P:].view(k, P, chunk), tables_d, self.pool.cache,
                self.cfg, k=k, sample_fn=sample_fn, max_pos=bounds,
                use_kernel=self._use_window_kernel)
            for slot in pf:
                n = int(n_pf[slot])
                self._pf_left[slot] -= n
                self._pf_off[slot] += n * chunk
                if self._pf_left[slot] == 0:
                    self._pf_tail.pop(slot)
                    pf_done.append((int(slot), self._slots[slot].req.id))
                else:
                    self._pf_tail[slot] = self._pf_tail[slot][n * chunk:]
            self.metrics.inc("mixed_windows")
            self.metrics.inc("mixed_window_steps", k)
        else:
            out = _engine_decode_window(
                self.params, state, eos_d, life, tables_d, self.pool.cache,
                self.cfg, k=k, sample_fn=sample_fn, max_pos=bounds,
                use_kernel=self._use_kernel, use_fused=self._use_fused,
                fused_blocks=self._fused_blocks)
            self.metrics.inc("decode_windows")
            self.metrics.inc("decode_window_steps", k)
        toks, emitted, tok, pos, active, budget = out
        self._dev_state = (tok, pos, active, budget)
        self._adm_mask[:] = False       # the merge rides this launch
        self._sched_budget -= n_dec.astype(np.int32)
        self._sched_pos += n_dec.astype(np.int32)
        block = torch.stack([toks, emitted.to(torch.int32)])
        event = None
        if block.is_cuda:
            host = torch.empty(block.shape, dtype=block.dtype,
                               pin_memory=True)
            host.copy_(block, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            block = host
        host_s = time.perf_counter() - t_wall
        self.metrics.inc("decode_dispatches")
        self.metrics.observe("decode_dispatch_s", host_s)
        return _InFlight(block=block, event=event, k=k, t_wall=t_wall,
                         n_active=int(live.sum()), host_s=host_s,
                         pf_done=pf_done)

    def _drain_pending(self, break_reason: str = "") -> List[RequestResult]:
        """Read the window in flight, if any. A ``break_reason`` marks the
        read as a window break (the engine leaves the window path for a
        speculative step, 'spec', or re-probe, 'reprobe'), counted in
        ``window_breaks_{reason}``."""
        if self._inflight is None:
            return []
        if break_reason:
            self.metrics.inc("window_breaks_" + break_reason)
        w, self._inflight = self._inflight, None
        return self._drain_window(w)

    def _drain_window(self, w: _InFlight) -> List[RequestResult]:
        """Read one window's token block (its one host read) and do the
        host bookkeeping: commit each slot's emitted tokens, finish the
        slots whose eos or budget stopped them on the card (their slot
        and pages free here), register the prompt pages its prefill
        completed and the pages its decode passed."""
        if w.event is not None:
            w.event.synchronize()
        blk = w.block.numpy()
        toks, emitted = blk[0], blk[1].astype(bool)
        now = self.clock()
        self.n_steps += 1
        self.step_timer.laps.append(time.perf_counter() - w.t_wall)
        n_tok = int(emitted.sum())
        self.metrics.observe("batch_fill_ratio",
                             w.n_active / self.ecfg.pool_size)
        self.metrics.inc("decode_steps")
        self.metrics.inc("decode_tokens", n_tok)
        self.metrics.inc("dispatch_tokens", n_tok)
        for slot, rid in w.pf_done:
            st = self._slots.get(slot)
            if st is not None and st.req.id == rid:
                self.pool.commit_admission(slot)
        finished: List[RequestResult] = []
        for slot in list(self._slots):
            # a run: False while the slot prefills, True from its first
            # decode step until it stops; commit by the mask
            mask = emitted[:, slot]
            if not mask.any():
                continue
            st = self._slots[slot]
            self._commit_tokens(slot, st, [int(t) for t in toks[mask, slot]],
                                now)
            finished.extend(self._finish_if_done(slot, st, now,
                                                 device_stopped=True))
        self.pool.flush_pending()
        if w.k > 1:
            self._at_host += w.host_s
            self._at_wall += self.step_timer.laps[-1]
            self._at_n += 1
            self._maybe_autotune()
        return finished

    def _maybe_autotune(self) -> None:
        """Bounded additive increase: every ``WINDOW_AUTOTUNE_INTERVAL``
        windows, while the host's launch time is more than
        ``WINDOW_AUTOTUNE_HOST_FRAC`` of the windows' wall, move one
        bucket up (never down, never past ``decode_window``)."""
        if (not self.ecfg.decode_window_auto
                or self._wk >= len(self._buckets) - 1
                or self._at_n < WINDOW_AUTOTUNE_INTERVAL):
            return
        host_frac = self._at_host / max(self._at_wall, 1e-9)
        if host_frac > WINDOW_AUTOTUNE_HOST_FRAC:
            self._wk += 1
            self._window_cur = self._buckets[self._wk]
            self.metrics.inc("autotune_window_increases")
            self.metrics.gauge("decode_window_k", self._window_cur)
        self._at_host = self._at_wall = 0.0
        self._at_n = 0

    def _warm_windows(self) -> None:
        """One masked no-op window of each kind at construction, every
        slot inactive (writes dropped, nothing emitted, nothing drawn):
        on the card it builds and loads the kernels the windows launch
        before the first request does. A window's shapes do not depend
        on its k, so one step of each kind covers every bucket."""
        P = self.ecfg.pool_size
        zeros = torch.zeros((P,), dtype=torch.int32, device=self.device)
        state = (zeros, zeros, zeros.bool(), zeros)
        eos_d, tables_d, *sample = self._launch_inputs()

        def no_draw(t, logits):
            return sample_tokens_batched([None] * P, logits, *sample)

        _engine_decode_window(
            self.params, state, eos_d, self._z_life, tables_d,
            self.pool.cache, self.cfg, k=1, sample_fn=no_draw, max_pos=[0],
            use_kernel=self._use_kernel, use_fused=self._use_fused,
            fused_blocks=self._fused_blocks)
        _engine_mixed_window(
            self.params, state, eos_d, self._z_life, self._z_life[:3],
            torch.zeros((1, P, self._chunk), dtype=torch.int32,
                        device=self.device), tables_d, self.pool.cache,
            self.cfg, k=1, sample_fn=no_draw, max_pos=[0],
            use_kernel=self._use_window_kernel)

    # --------------------------------------------------------- bookkeeping

    def _commit_tokens(self, slot: int, st: _Active, committed: List[int],
                       now: float) -> None:
        """Append a step's or window's tokens to a slot's record: TTFT on
        the first, and the token, position and budget mirrors."""
        first = not st.tokens
        st.tokens.extend(committed)
        if first:
            st.t_first_token = now
            self.metrics.observe("ttft_s", now - st.t_submit)
        st.t_last_token = now
        self._tok[slot] = st.tokens[-1]
        self._pos[slot] += len(committed)
        self._budget[slot] = st.cap - len(st.tokens)

    def _finish_if_done(self, slot: int, st: _Active, now: float,
                        device_stopped: bool = False) -> List[RequestResult]:
        """Finish the slot if its last token is its eos or its budget is
        spent."""
        eos = int(self._eos[slot])
        if eos >= 0 and st.tokens[-1] == eos:
            return [self._finish_slot(slot, FINISH_EOS, now,
                                      device_stopped=device_stopped)]
        if self._budget[slot] <= 0:
            reason = FINISH_LENGTH_CAP if st.capped else FINISH_MAX_TOKENS
            return [self._finish_slot(slot, reason, now,
                                      device_stopped=device_stopped)]
        return []

    def _finish_slot(self, slot: int, reason: str, now: float,
                     device_stopped: bool = False,
                     masked: bool = False) -> RequestResult:
        """Free the slot and its pages and build its result. A finish the
        card already knows of (its eos or budget stopped the slot there,
        ``device_stopped``, or a kill flag in a launched window,
        ``masked``) keeps the card's window state; any other makes the
        next launch upload the host mirrors."""
        st = self._slots.pop(slot)
        self._active[slot] = False
        self._deadline[slot] = np.inf
        self._adm_mask[slot] = False
        self._pf_left[slot] = self._pf_off[slot] = self._pf_limit[slot] = 0
        self._pf_tail.pop(slot, None)
        if not (device_stopped or masked):
            self._dev_state = None
        self._li = None           # release zeroes the slot's table row
        self.pool.release(slot)
        if self.drafter is not None:
            self.drafter.on_release(slot)
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
        self._journal_finish(st.req.id, reason)
        if decode_tps:
            self.metrics.observe("decode_tokens_per_s", decode_tps)
        return res

    def _finish_unstarted(self, req: Request, t_submit: float, reason: str,
                          now: float) -> RequestResult:
        self.metrics.inc(f"finished_{reason}")
        self._journal_finish(req.id, reason)
        return RequestResult(id=req.id, tokens=[], finish_reason=reason,
                             queue_wait_s=now - t_submit,
                             total_s=now - t_submit)
