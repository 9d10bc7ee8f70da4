"""Multi-replica router: the fleet tier in one process (the port of the
in-process part of ``replicatinggpt_tpu/serve/router.py``).

One engine is one card's worth of slots; a fleet is N engine replicas.
This module balances requests across them and keeps the fleet's
promises when a replica misbehaves:

- **Radix-prefix affinity**: a request goes to the replica whose radix
  index already holds the longest prefix of its prompt
  (``PagedCachePool.cached_prefix_tokens``, a pure peek), else to the
  least-loaded one. The turns of a session therefore stay with the
  replica that holds their pages, and the fleet's prefix-hit rate stays
  near one replica's.
- **Health probes**: the router times every replica's step on the host
  and reads each engine's counters into per-replica gauges. The time
  means something because the engine reads its tokens back every step.
  A replica whose step runs over the wedge budget ``wedge_patience``
  times in a row is *wedged*: no new request goes to it and its
  in-flight work is re-routed.
- **Requeue across death**: a killed replica's accepted-but-unfinished
  requests are rebuilt from its crash journal and resubmitted to the
  survivors, with a bounded retry ladder and exponential backoff. A
  request regenerates deterministically (prompt, sampling, its own
  ``rng_seed``), so its tokens equal an uninterrupted run's, and the
  delivery ledger (:meth:`Router.take_new_tokens`) hands each token to
  the consumer exactly once across the migration.
- **Hedged re-route on wedge**: a wedged replica's in-flight requests are
  cancelled there with ``migrated=True`` (the engine frees the slot and
  pages at once) and resubmitted to a healthy replica in the same step,
  so no id is ever live on two replicas; the fleet-wide dedupe of
  :meth:`Router.submit` keeps a client's duplicate off a second replica.
- **The router's own ledger** (``RouterConfig.ledger_path``): one submit
  record at fleet acceptance, one finish record at each terminal result,
  in the request journal's format. A restarted router requeues the
  accepted-but-unfinished set it finds there.

All replicas live in this process and share one cast copy of the
weights, as the JAX ``Router`` shares ``params``; each has its own
``Engine``, page pool and journal. Single-threaded, like the engine: one
loop drives :meth:`Router.step` (the HTTP front door, serve/http.py, and
the fleet replay, serve/loadgen.py). Worker processes (``backends=``,
the RPC protocol, the process supervisor) are ROADMAP.md queue A item
10; per-replica tiers and page transfers are queue A item 9(e).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..device import resolve_device
from ..faults.fleet import (KIND_PROC_KILL, KIND_REPLICA_KILL,
                            KIND_REPLICA_WEDGE, REFUSED_KINDS,
                            fleet_step_fault)
from ..models.gpt import compute_params
from ..utils.jsonl import load_jsonl_if_exists
from ..utils.logging import Metrics
from .journal import RequestJournal
from .requests import (FINISH_CANCELLED, FINISH_DEADLINE,
                       REJECT_BAD_REQUEST, REJECT_FLEET_CAPACITY,
                       REJECT_PROMPT_TOO_LONG, REJECT_QUEUE_FULL,
                       REJECT_REPLICA_DOWN, REJECT_REPLICA_TIMEOUT, Request,
                       RequestResult)

#: the ROADMAP.md items a fleet's unported parts wait for
REMOTE_ITEM = "queue A item 10 (worker processes behind the router)"
DISAGG_ITEM = "queue A item 9(e) (disaggregation)"

#: rejections every replica would give alike (same config, same clock):
#: trying another replica, or again later, is pointless
TERMINAL_REJECTS = frozenset({REJECT_BAD_REQUEST,
                              REJECT_PROMPT_TOO_LONG, FINISH_DEADLINE})

#: try-later rejections, which the retry ladder maps to
#: REJECT_FLEET_CAPACITY when it runs out
RETRYABLE_REJECTS = frozenset({REJECT_QUEUE_FULL, REJECT_REPLICA_DOWN,
                               REJECT_REPLICA_TIMEOUT})


@dataclass(frozen=True)
class RouterConfig:
    """Fleet sizing and the routing and recovery knobs."""

    n_replicas: int = 2
    #: per-replica crash journals live here (replica{i}.jsonl); None
    #: disables them, and with them the requeue after a kill
    journal_dir: Optional[str] = None
    #: the router's own crash journal (None: in-memory ledger only)
    ledger_path: Optional[str] = None
    #: fsync the ledger's finish records
    ledger_fsync: bool = False
    #: route by the longest cached prefix (False: least-loaded only)
    affinity: bool = True
    #: a rejected resubmission retries up to retry_max times, backing
    #: off retry_backoff_steps * 2^attempt router steps between tries
    retry_max: int = 4
    retry_backoff_steps: int = 1
    #: wedge probe: a replica step slower than wedge_budget_s,
    #: wedge_patience times in a row, wedges the replica (0 = off). The
    #: first wedge_skip_steps steps of a replica are exempt.
    wedge_budget_s: float = 0.0
    wedge_patience: int = 2
    wedge_skip_steps: int = 3
    #: router steps a wedged replica sits out before it rejoins
    quarantine_steps: int = 8
    #: per-replica tier labels of a disaggregated fleet: not in this
    #: port yet (DISAGG_ITEM); None is the colocated fleet
    tiers: Optional[Tuple[str, ...]] = None


@dataclass
class _InFlight:
    """The router's ledger entry for one accepted request."""

    req: Request
    replica: int
    t_submit: float            # fleet submit time (router clock)
    attempts: int = 0


@dataclass
class _Requeue:
    """A request between replicas, waiting to be (re)submitted."""

    req: Request
    t_submit: float
    attempts: int
    due_step: int
    t_requeued: float = 0.0    # when it left its replica


class ReplicaBase:
    """The router's view of one replica: the health state every backend
    shares, and the verbs the router drives. :class:`Replica` is the
    in-process engine; a worker process behind the RPC protocol is
    ROADMAP.md queue A item 10."""

    is_local = True

    def __init__(self, idx: int, journal_path: Optional[str]):
        self.idx = idx
        self.journal_path = journal_path
        self.alive = True
        self.wedged = False
        self.draining = False
        self.suspect_streak = 0
        self.skip_steps = 0
        self.quarantine_until = 0
        self.last_step_s = 0.0

    @property
    def routable(self) -> bool:
        return self.alive and not self.wedged and not self.draining

    @property
    def load(self) -> int:
        return self.queue_depth + self.slots_active

    @property
    def warmed(self) -> bool:
        return True

    def _base_health(self) -> dict:
        return {"replica": self.idx, "alive": self.alive,
                "wedged": self.wedged, "draining": self.draining,
                "last_step_ms": round(self.last_step_s * 1e3, 3)}

    def submit(self, req: Request) -> Optional[RequestResult]:
        raise NotImplementedError

    def cancel(self, request_id: str, migrated: bool = False) -> bool:
        raise NotImplementedError

    def step_engine(self) -> List[RequestResult]:
        raise NotImplementedError

    def partial_tokens(self, request_id: str) -> Optional[List[int]]:
        raise NotImplementedError

    def cached_prefix_tokens(self, prompt) -> int:
        raise NotImplementedError

    @property
    def queue_depth(self) -> int:
        raise NotImplementedError

    @property
    def slots_active(self) -> int:
        raise NotImplementedError

    @property
    def pages_in_use(self) -> int:
        raise NotImplementedError

    @property
    def engine_idle(self) -> bool:
        raise NotImplementedError

    def hit_tokens(self) -> Tuple[int, int]:
        """(prefix_hit_tokens, prompt_tokens) for the fleet aggregate."""
        raise NotImplementedError

    def journal_state(self) -> Tuple[Dict[str, str], List[Request]]:
        """``(finished_reasons, unfinished_requests)`` from this
        replica's crash journal."""
        return {}, []

    def health(self) -> dict:
        raise NotImplementedError

    def summary_block(self) -> dict:
        raise NotImplementedError

    def close(self) -> None:
        pass


class Replica(ReplicaBase):
    """One in-process engine and its crash journal."""

    def __init__(self, idx: int, engine, journal_path: Optional[str],
                 journal: Optional[RequestJournal], skip_steps: int = 0):
        super().__init__(idx, journal_path)
        self.engine = engine
        self.journal = journal
        self.skip_steps = skip_steps
        self._warmed = False

    @property
    def warmed(self) -> bool:
        return self._warmed

    def submit(self, req: Request) -> Optional[RequestResult]:
        return self.engine.submit(req)

    def cancel(self, request_id: str, migrated: bool = False) -> bool:
        return self.engine.cancel(request_id, migrated=migrated)

    def step_engine(self) -> List[RequestResult]:
        return self.engine.step()

    def partial_tokens(self, request_id: str) -> Optional[List[int]]:
        return self.engine.partial_tokens(request_id)

    def cached_prefix_tokens(self, prompt) -> int:
        return self.engine.pool.cached_prefix_tokens(prompt)

    @property
    def queue_depth(self) -> int:
        return self.engine.scheduler.depth

    @property
    def slots_active(self) -> int:
        return int(self.engine._active.sum())

    @property
    def pages_in_use(self) -> int:
        return self.engine.pool.alloc.pages_in_use

    @property
    def engine_idle(self) -> bool:
        return self.engine.idle

    def hit_tokens(self) -> Tuple[int, int]:
        a = self.engine.pool.alloc
        return a.prefix_hit_tokens, a.prompt_tokens

    def journal_state(self) -> Tuple[Dict[str, str], List[Request]]:
        if self.journal_path is None:
            return {}, []
        finished = {r["id"]: r.get("reason", "")
                    for r in load_jsonl_if_exists(self.journal_path)
                    if r.get("ev") == "finish"}
        return finished, RequestJournal.unfinished(self.journal_path)

    def health(self) -> dict:
        """Router-side state and the engine's own counters."""
        c = self.engine.metrics.counters
        return {
            **self._base_health(),
            "queue_depth": self.queue_depth,
            "slots_active": self.slots_active,
            "pages_in_use": self.pages_in_use,
            "watchdog_stalls": int(c.get("watchdog_stalls", 0)),
            "shed_requests": int(c.get("shed_requests", 0)),
            "requests_admitted": int(c.get("requests_admitted", 0)),
            "warmed": self.warmed,
        }

    def summary_block(self) -> dict:
        from .engine import engine_summary_block
        return {"health": self.health(),
                **engine_summary_block(self.engine)}

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()


class Router:
    """N-replica front tier: submit/cancel/step/drain over the fleet.

    The engine's host API shape: ``submit`` returns None (accepted) or a
    terminal rejection, ``step`` advances every live replica one
    scheduling iteration and returns the fleet's newly finished results,
    ``drain`` runs to idle. ``model`` (a ``models.gpt.GPT``) is cast once
    to the compute dtype on ``device`` and shared by every replica."""

    def __init__(self, model=None, cfg=None,
                 rcfg: RouterConfig = RouterConfig(), ecfg=None,
                 clock: Callable[[], float] = time.monotonic,
                 device=None,
                 backends: Optional[List[ReplicaBase]] = None):
        if backends is not None:
            raise NotImplementedError(
                f"replicas behind the RPC protocol (backends=) are not "
                f"implemented in replicatinggpt_tpu_torch yet: ROADMAP.md "
                f"{REMOTE_ITEM}")
        if rcfg.tiers is not None:
            raise NotImplementedError(
                f"replica tiers {rcfg.tiers} are not implemented in "
                f"replicatinggpt_tpu_torch yet: ROADMAP.md {DISAGG_ITEM}")
        assert rcfg.n_replicas >= 1, rcfg.n_replicas
        from .engine import Engine, EngineConfig
        ecfg = ecfg or EngineConfig()
        if ecfg.mesh_data * ecfg.mesh_model > 1:
            raise NotImplementedError(
                f"a {ecfg.mesh_data}x{ecfg.mesh_model} serving mesh a "
                f"replica is not implemented in replicatinggpt_tpu_torch "
                f"yet: ROADMAP.md {REMOTE_ITEM}")
        self.rcfg = rcfg
        self.clock = clock
        self.metrics = Metrics()
        dev = resolve_device(device)
        params = compute_params(model, dev)
        self.replicas: List[ReplicaBase] = []
        for i in range(rcfg.n_replicas):
            jpath = jr = None
            if rcfg.journal_dir is not None:
                jpath = os.path.join(rcfg.journal_dir, f"replica{i}.jsonl")
                jr = RequestJournal(jpath)
            eng = Engine(model, cfg, ecfg, clock=clock, device=dev,
                         journal=jr, params=params)
            self.replicas.append(Replica(
                idx=i, engine=eng, journal_path=jpath, journal=jr,
                skip_steps=rcfg.wedge_skip_steps))
        self.n_steps = 0
        self._inflight: Dict[str, _InFlight] = {}
        self._requeue: List[_Requeue] = []
        #: id -> replica whose engine-surfaced terminal result must be
        #: swallowed (the hedged re-route cancelled that copy there; keyed
        #: by replica so that the live copy's finish elsewhere passes)
        self._superseded: Dict[str, int] = {}
        #: tokens handed to the consumer per id, across migrations: the
        #: exactly-once state of take_new_tokens
        self._delivered: Dict[str, int] = {}
        self._ttft: Dict[str, float] = {}
        #: terminal results the ROUTER produced (a kill without a
        #: journal, a journaled finish on a dead replica, the cancel of a
        #: requeued request, retry exhaustion), surfaced by the next
        #: step() like an engine's finishes
        self._router_finished: List[RequestResult] = []
        self.results: Dict[str, RequestResult] = {}
        self.events: List[str] = []
        # the router's own ledger: recover the previous incarnation's
        # unfinished set first, then open it for append under a lock
        self.ledger: Optional[RequestJournal] = None
        if rcfg.ledger_path is not None:
            recovered = RequestJournal.unfinished(rcfg.ledger_path)
            self.ledger = RequestJournal(rcfg.ledger_path,
                                         fsync_finish=rcfg.ledger_fsync,
                                         lock=True)
            now = self.clock()
            for req in recovered:
                # deadlines died with the previous router's clock
                self._requeue.append(_Requeue(
                    req=req, t_submit=now, attempts=0, due_step=0,
                    t_requeued=now))
            if recovered:
                self.metrics.inc("fleet_ledger_recovered", len(recovered))
                self._event(f"ledger recovery: {len(recovered)} "
                            f"unfinished request(s) requeued from "
                            f"{rcfg.ledger_path}")
        self._gauges()

    # ---------------------------------------------------------------- API

    def warmup(self) -> None:
        """Warm every live replica's engine (``Engine.warmup``: on the
        card its kernels built and loaded), then mark them warm together:
        ``readyz`` says ready only once every replica is."""
        reps = [r for r in self.replicas if r.alive and not r.warmed]
        for rep in reps:
            rep.engine.warmup()
        for rep in reps:
            rep._warmed = True

    def submit(self, req: Request) -> Optional[RequestResult]:
        """Route and submit one request; None = accepted somewhere. An id
        the fleet already knows (in flight, between replicas, or terminal
        but unclaimed) is rejected fleet-wide, before and after a kill:
        an id keys the delivery ledger, the journals and cancellation."""
        self.metrics.inc("fleet_requests_submitted")
        if self.knows(req.id):
            self.metrics.inc("fleet_dedup_rejects")
            return RequestResult(id=req.id, tokens=[],
                                 finish_reason=REJECT_BAD_REQUEST)
        rej = self._submit_routed(req, self.clock(), attempts=0)
        if rej is None and self.ledger is not None:
            # one submit record per id at fleet acceptance
            self.ledger.record_submit(req)
        return rej

    def cancel(self, request_id: str) -> bool:
        fi = self._inflight.get(request_id)
        if fi is not None:
            return self.replicas[fi.replica].cancel(request_id)
        for i, item in enumerate(self._requeue):
            if item.req.id == request_id:
                del self._requeue[i]
                self._record_result(RequestResult(
                    id=request_id, tokens=[],
                    finish_reason=FINISH_CANCELLED), item.t_submit)
                return True
        return False

    @property
    def idle(self) -> bool:
        # undelivered router-side results keep the fleet busy: one more
        # step() must surface them
        return (not self._requeue and not self._router_finished
                and not self._inflight
                and all(r.engine_idle for r in self.replicas if r.alive))

    @property
    def n_alive(self) -> int:
        return sum(r.alive for r in self.replicas)

    def step(self) -> List[RequestResult]:
        """One fleet iteration: fire the fleet fault -> step every live
        replica (timing each for the wedge probe) -> surface finishes ->
        re-route a wedged replica's work -> the requeue ladder -> the
        per-replica gauges."""
        step_idx = self.n_steps
        self.n_steps += 1
        wedge_delay: Dict[int, float] = {}
        flt = fleet_step_fault(step_idx)
        if flt is not None:
            if flt.kind == KIND_REPLICA_KILL:
                self._kill(int(flt.arg), step_idx)
            elif flt.kind == KIND_REPLICA_WEDGE:
                wedge_delay[int(flt.arg2)] = float(flt.arg)
            elif flt.kind == KIND_PROC_KILL:
                self._event(f"step {step_idx}: proc_kill ignored (no "
                            f"supervisor attached)")
            elif flt.kind in REFUSED_KINDS:
                raise NotImplementedError(
                    f"fleet fault {flt.kind!r} is not implemented in "
                    f"replicatinggpt_tpu_torch yet: ROADMAP.md "
                    f"{REFUSED_KINDS[flt.kind]}")
        out: List[RequestResult] = []
        if self._router_finished:
            out.extend(self._router_finished)
            self._router_finished = []
        now = self.clock()
        for rep in self.replicas:
            if not rep.alive:
                continue
            t_wall = time.perf_counter()
            delay = wedge_delay.get(rep.idx, 0.0)
            if delay:
                # the injected wedge stalls the replica's step inside the
                # router's measurement
                time.sleep(delay)
            finished = rep.step_engine()
            rep.last_step_s = time.perf_counter() - t_wall
            # finishes before the wedge probe: a request that finished in
            # the step that trips the probe leaves the ledger first, or
            # _wedge would decode it a second time
            for res in finished:
                done = self._on_finish(res, rep.idx, now)
                if done is not None:
                    out.append(done)
            self._probe(rep, step_idx)
        self._observe_ttft(now)
        self._drain_requeue(step_idx)
        if self._router_finished:      # retry exhaustion in this step
            out.extend(self._router_finished)
            self._router_finished = []
        self._gauges()
        return out

    def drain(self, max_steps: int = 1_000_000) -> List[RequestResult]:
        out: List[RequestResult] = []
        for _ in range(max_steps):
            if self.idle:
                return out
            out.extend(self.step())
        raise RuntimeError(f"fleet did not drain in {max_steps} steps")

    def take_new_tokens(self, request_id: str) -> List[int]:
        """The tokens newly available for ``request_id`` since the last
        call: the one delivery path (SSE streams and the fleet replay
        read through here). A requeued request regenerates from token 0,
        and this ledger suppresses the prefix already delivered, so the
        concatenated stream equals the uninterrupted token list."""
        sent = self._delivered.get(request_id, 0)
        res = self.results.get(request_id)
        if res is not None:
            new = res.tokens[sent:]
        else:
            fi = self._inflight.get(request_id)
            if fi is None:
                return []
            partial = (self.replicas[fi.replica]
                       .partial_tokens(request_id)) or []
            new = partial[sent:]
        if new:
            self._delivered[request_id] = sent + len(new)
        return new

    def result(self, request_id: str) -> Optional[RequestResult]:
        return self.results.get(request_id)

    def knows(self, request_id: str) -> bool:
        """Whether the id is anywhere in the fleet: in flight, between
        replicas, or terminal but unclaimed."""
        return (request_id in self._inflight
                or request_id in self.results
                or any(q.req.id == request_id for q in self._requeue))

    def pop_result(self, request_id: str) -> Optional[RequestResult]:
        """Take a terminal result out of the router's memory (the front
        door does once a stream delivered it all)."""
        self._delivered.pop(request_id, None)
        self._ttft.pop(request_id, None)
        return self.results.pop(request_id, None)

    def close(self) -> None:
        for rep in self.replicas:
            rep.close()
        if self.ledger is not None:
            self.ledger.close()
            self.ledger = None

    # ------------------------------------------------------- supervision

    def mark_down(self, idx: int, reason: str = "") -> None:
        """Stop stepping a replica and keep its ledger entries (a
        supervisor would restart it, or abandon it through
        :meth:`abandon_replica`)."""
        rep = self.replicas[idx]
        if not rep.alive:
            return
        rep.alive = False
        rep.wedged = False
        self.metrics.inc("fleet_replica_downs")
        self._event(f"step {self.n_steps}: replica {idx} DOWN"
                    + (f" ({reason})" if reason else ""))

    def add_replica(self, rep: ReplicaBase) -> int:
        """Grow the fleet at run time: append the backend and return its
        index. An in-process replica is routable at once (its engine is
        built); a worker process would wait for its registration
        (ROADMAP.md queue A item 10)."""
        assert rep.idx == len(self.replicas), (
            f"replica indices are append-only: got {rep.idx}, "
            f"expected {len(self.replicas)}")
        rep.alive = rep.is_local
        rep.skip_steps = self.rcfg.wedge_skip_steps
        self.replicas.append(rep)
        self.metrics.inc("fleet_replicas_added")
        self._event(f"step {self.n_steps}: replica {rep.idx} added "
                    f"(fleet grows to {len(self.replicas)})")
        return rep.idx

    def abandon_replica(self, idx: int) -> None:
        """Give up on a replica for good: the journal-driven requeue of a
        ``replica_kill``."""
        self._kill(idx, self.n_steps)

    def offered_load(self) -> dict:
        """Queued work (the routable replicas' queues and the requeue),
        active slots, and how many replicas take traffic."""
        routable = [r for r in self.replicas if r.routable]
        return {
            "queued": (sum(r.queue_depth for r in routable)
                       + len(self._requeue)),
            "active": sum(r.slots_active for r in routable),
            "n_routable": len(routable),
        }

    def drain_replica(self, idx: int) -> int:
        """Mark a replica draining (unroutable, not ready) and migrate its
        in-flight work onto the rest of the fleet; returns how many
        requests moved. :meth:`undrain_replica` lifts it."""
        rep = self.replicas[idx]
        if not rep.alive or rep.draining:
            return 0
        rep.draining = True
        n = self._migrate(rep, self.n_steps)
        self.metrics.inc("fleet_drains")
        self._event(f"step {self.n_steps}: replica {idx} draining "
                    f"({n} request(s) migrated)")
        return n

    def undrain_replica(self, idx: int) -> None:
        self.replicas[idx].draining = False

    # ------------------------------------------------------------ summary

    def fleet_summary(self) -> dict:
        """Router counters, fleet TTFT, per-replica blocks and the
        aggregate prefix-hit rate."""
        c = self.metrics.counters
        hit_tokens = prompt_tokens = 0
        per_replica = []
        for rep in self.replicas:
            h, p = rep.hit_tokens()
            hit_tokens += h
            prompt_tokens += p
            per_replica.append(rep.summary_block())
        return {
            "n_replicas": len(self.replicas),
            "n_alive": self.n_alive,
            "n_steps": self.n_steps,
            "router": {k: int(v) for k, v in sorted(c.items())},
            "fleet_ttft_s": self.metrics.hist_summary("fleet_ttft_s"),
            "requeue_latency_s": self.metrics.hist_summary(
                "fleet_requeue_latency_s"),
            "aggregate_prefix_hit_rate": (
                round(hit_tokens / prompt_tokens, 4)
                if prompt_tokens else 0.0),
            "replicas": per_replica,
            "events": list(self.events[-32:]),
        }

    def healthz(self) -> dict:
        """Liveness: the router loop answers; per-replica detail rides
        along."""
        return {"ok": True, "live": True, "n_alive": self.n_alive,
                "replicas": [r.health() for r in self.replicas]}

    def readyz(self) -> dict:
        """Readiness: ok iff at least one replica is routable and warm."""
        ready = [r.idx for r in self.replicas if r.routable and r.warmed]
        return {"ok": bool(ready), "ready_replicas": len(ready),
                "n_alive": self.n_alive,
                "draining": [r.idx for r in self.replicas if r.draining]}

    # ----------------------------------------------------------- internals

    def _event(self, msg: str) -> None:
        self.events.append(msg)
        if len(self.events) > 256:
            del self.events[:len(self.events) - 256]

    def _candidates(self, req: Request) -> List[Tuple[ReplicaBase, int]]:
        """(replica, cached-prefix tokens) to try, best first: longest
        cached prefix, then least load, then index."""
        avail = [r for r in self.replicas if r.routable]
        if not avail:
            # a wholly wedged fleet still beats dropping the request:
            # a wedged but live replica (never a draining one)
            avail = [r for r in self.replicas
                     if r.alive and not r.draining]
        scored = [(rep, (rep.cached_prefix_tokens(req.prompt)
                         if self.rcfg.affinity else 0)) for rep in avail]
        scored.sort(key=lambda t: (-t[1], t[0].load, t[0].idx))
        return scored

    def _submit_routed(self, req: Request, t_submit: float,
                       attempts: int) -> Optional[RequestResult]:
        """Try each candidate once, in affinity and load order; None on
        acceptance, else the last rejection."""
        last: Optional[RequestResult] = None
        for rep, _ in self._candidates(req):
            rej = rep.submit(req)
            if rej is None:
                self._inflight[req.id] = _InFlight(
                    req=req, replica=rep.idx, t_submit=t_submit,
                    attempts=attempts)
                self.metrics.inc("fleet_requests_routed")
                return None
            last = rej
            if rej.finish_reason in TERMINAL_REJECTS:
                break
            self.metrics.inc("fleet_route_fallbacks")
        if last is None:       # no replica at all
            last = RequestResult(id=req.id, tokens=[],
                                 finish_reason=REJECT_FLEET_CAPACITY)
        return last

    def _on_finish(self, res: RequestResult, replica: int,
                   now: float) -> Optional[RequestResult]:
        if self._superseded.get(res.id) == replica:
            # the hedged re-route cancelled this copy on this replica;
            # the live copy is elsewhere
            del self._superseded[res.id]
            return None
        fi = self._inflight.get(res.id)
        if fi is not None and fi.replica != replica:
            # a stale copy on a replica the ledger does not route the id
            # to: the live copy's entry stays
            self.metrics.inc("fleet_stale_finishes")
            return None
        fi = self._inflight.pop(res.id, None)
        if fi is None:
            if res.id not in self.results:
                self.metrics.inc("fleet_ghost_finishes")
            return None
        res.total_s = now - fi.t_submit
        if res.id in self._ttft:
            res.ttft_s = self._ttft[res.id]
        elif res.tokens:
            # finished in the step its first token committed, which
            # _observe_ttft (after the replica loop) never sees
            res.ttft_s = now - fi.t_submit
            self._ttft[res.id] = res.ttft_s
            self.metrics.observe("fleet_ttft_s", res.ttft_s)
        self.metrics.inc("fleet_requests_finished")
        if self.ledger is not None:
            self.ledger.record_finish(res.id, res.finish_reason)
        self.results[res.id] = res
        return res

    def _record_result(self, res: RequestResult, t_submit: float) -> None:
        """A terminal result the router produced, surfaced by the next
        step()."""
        res.total_s = self.clock() - t_submit
        self.metrics.inc("fleet_requests_finished")
        if self.ledger is not None:
            self.ledger.record_finish(res.id, res.finish_reason)
        self.results[res.id] = res
        self._router_finished.append(res)

    def _observe_ttft(self, now: float) -> None:
        """Fleet TTFT: the first token observable at the router for each
        in-flight id (tokens delivered before a migration count)."""
        for rid, fi in self._inflight.items():
            if rid in self._ttft or self._delivered.get(rid, 0):
                continue
            if self.replicas[fi.replica].partial_tokens(rid):
                self._ttft[rid] = now - fi.t_submit
                self.metrics.observe("fleet_ttft_s", now - fi.t_submit)

    def _probe(self, rep: ReplicaBase, step_idx: int) -> None:
        """Wedge detection over the step's host time, and the end of a
        quarantine."""
        cfg = self.rcfg
        if rep.wedged and step_idx >= rep.quarantine_until:
            rep.wedged = False
            rep.suspect_streak = 0
            self.metrics.inc("fleet_replica_rejoins")
            self._event(f"step {step_idx}: replica {rep.idx} rejoined")
        if cfg.wedge_budget_s <= 0 or rep.wedged:
            return
        if rep.skip_steps > 0:        # a warm-up step is not a wedge
            rep.skip_steps -= 1
            return
        if rep.last_step_s > cfg.wedge_budget_s:
            rep.suspect_streak += 1
        else:
            rep.suspect_streak = 0
        if rep.suspect_streak >= cfg.wedge_patience:
            self._wedge(rep, step_idx)

    def _migrate(self, rep: ReplicaBase, step_idx: int) -> int:
        """Cancel (``migrated=True``) every request the ledger has on
        ``rep`` and requeue it, due now; returns how many moved."""
        now = self.clock()
        ids = [rid for rid, fi in self._inflight.items()
               if fi.replica == rep.idx]
        for rid in ids:
            fi = self._inflight.pop(rid)
            rep.cancel(rid, migrated=True)
            self._superseded[rid] = rep.idx
            self._requeue.append(_Requeue(
                req=fi.req, t_submit=fi.t_submit, attempts=fi.attempts,
                due_step=step_idx, t_requeued=now))
        if ids:
            self.metrics.inc("fleet_requeued_requests", len(ids))
        return len(ids)

    def _wedge(self, rep: ReplicaBase, step_idx: int) -> None:
        """Quarantine a wedged replica and hedge its in-flight work onto
        the healthy ones: the copy on the suspect is cancelled with
        ``migrated=True`` first, so no id is ever live on two replicas."""
        rep.wedged = True
        rep.suspect_streak = 0
        rep.quarantine_until = step_idx + self.rcfg.quarantine_steps
        self.metrics.inc("fleet_replica_wedges")
        self._event(f"step {step_idx}: replica {rep.idx} wedged "
                    f"({rep.last_step_s * 1e3:.1f} ms step over "
                    f"{self.rcfg.wedge_budget_s * 1e3:.1f} ms budget); "
                    f"re-routing its in-flight work")
        self._migrate(rep, step_idx)

    def _kill(self, idx: int, step_idx: int) -> None:
        """Abandon a replica (the in-process stand-in for a process
        death): close its journal, replay it, requeue the unfinished."""
        if not (0 <= idx < len(self.replicas)):
            return
        rep = self.replicas[idx]
        if not rep.alive:
            return
        rep.alive = False
        rep.wedged = False
        self.metrics.inc("fleet_replica_kills")
        self._event(f"step {step_idx}: replica {idx} KILLED; replaying "
                    f"its journal")
        now = self.clock()
        rep.close()
        finished_reasons, pending = rep.journal_state()
        # the in-memory ledger is authoritative for this run: replay only
        # the ids it has in flight ON THE DEAD REPLICA. Anything else is
        # a ghost (a stale record of an earlier run sharing the journal
        # directory, or an id that migrated away): resurrecting one whose
        # id collides with a live request would decode it twice
        pending = [p for p in pending
                   if self._inflight.get(p.id) is not None
                   and self._inflight[p.id].replica == idx]
        pending_ids = {r.id for r in pending}
        for p in pending:
            fi = self._inflight.pop(p.id)
            self._requeue.append(_Requeue(
                req=p, t_submit=fi.t_submit, attempts=fi.attempts,
                due_step=step_idx, t_requeued=now))
        if pending:
            self.metrics.inc("fleet_requeued_requests", len(pending))
        # in-flight ids the journal says finished, whose result died
        # undelivered with the replica (or every id, without a journal):
        # the journaled reason surfaces, the tokens are lost with it
        for rid in [r for r, fi in list(self._inflight.items())
                    if fi.replica == idx and r not in pending_ids]:
            fi = self._inflight.pop(rid)
            self._record_result(RequestResult(
                id=rid, tokens=[],
                finish_reason=finished_reasons.get(rid, FINISH_CANCELLED)),
                fi.t_submit)

    def _drain_requeue(self, step_idx: int) -> None:
        """The bounded retry ladder, with exponential backoff, for the
        requests between replicas; exhaustion records a terminal result
        (surfaced with this step's batch)."""
        # no routable replica BECAUSE one is draining on purpose: hold the
        # requeue without burning attempts (a fleet with nothing coming
        # back still exhausts honestly)
        if not any(r.routable for r in self.replicas):
            if (any(r.alive and r.draining for r in self.replicas)
                    and self._requeue):
                for item in self._requeue:
                    item.due_step = max(item.due_step, step_idx + 1)
                return
        still: List[_Requeue] = []
        for item in self._requeue:
            if item.due_step > step_idx:
                still.append(item)
                continue
            rej = self._submit_routed(item.req, item.t_submit,
                                      attempts=item.attempts)
            if rej is None:
                self.metrics.inc("fleet_requeue_submits")
                if item.t_requeued:
                    self.metrics.observe(
                        "fleet_requeue_latency_s",
                        max(self.clock() - item.t_requeued, 0.0))
                continue
            item.attempts += 1
            if (item.attempts > self.rcfg.retry_max
                    or rej.finish_reason in TERMINAL_REJECTS):
                reason = (REJECT_FLEET_CAPACITY
                          if rej.finish_reason in RETRYABLE_REJECTS
                          else rej.finish_reason)
                self._record_result(RequestResult(
                    id=item.req.id, tokens=[], finish_reason=reason),
                    item.t_submit)
                self.metrics.inc("fleet_requeue_exhausted")
                continue
            item.due_step = step_idx + (self.rcfg.retry_backoff_steps
                                        * (2 ** (item.attempts - 1)))
            self.metrics.inc("fleet_requeue_retries")
            still.append(item)
        self._requeue = still

    def _gauges(self) -> None:
        for rep in self.replicas:
            i = rep.idx
            self.metrics.gauge(f"replica{i}_alive", int(rep.alive))
            self.metrics.gauge(f"replica{i}_wedged", int(rep.wedged))
            self.metrics.gauge(f"replica{i}_draining", int(rep.draining))
            self.metrics.gauge(f"replica{i}_queue_depth",
                               rep.queue_depth if rep.alive else 0)
            self.metrics.gauge(f"replica{i}_slots_active",
                               rep.slots_active if rep.alive else 0)
            self.metrics.gauge(f"replica{i}_pages_in_use",
                               rep.pages_in_use if rep.alive else 0)
        self.metrics.gauge("fleet_requeue_depth", len(self._requeue))
        self.metrics.gauge("fleet_inflight", len(self._inflight))
        self.metrics.gauge("fleet_replicas", len(self.replicas))
        self.metrics.gauge("fleet_replicas_routable",
                           sum(r.routable for r in self.replicas))
