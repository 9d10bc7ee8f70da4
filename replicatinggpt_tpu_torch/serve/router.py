"""Multi-replica router: the fleet tier, in one process or across worker
processes (the port of ``replicatinggpt_tpu/serve/router.py``).

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

Two replica backends speak one interface (:class:`ReplicaBase`):
:class:`Replica`, an engine in this process (the replicas share one cast
copy of the weights on a 1x1 mesh, as the JAX ``Router`` shares
``params``), and :class:`RemoteReplica`, a worker process
(serve/worker.py) behind the serve/rpc.py protocol (``backends=``, from
``faults.procsup.spawn_fleet``). The router drives a worker with the same
verbs, reads its committed tokens from the step reply, and treats a
transport failure as what it is: an RPC timeout is a slow step for the
wedge probe (SIGSTOP, a wedged card), a refused or reset connection marks
the replica down for the supervisor to restart. A restarted worker
replays its own journal, and :meth:`Router.attach_replica` reconciles the
router's ledger with what it recovered (read through the
``journal_drain`` RPC: the router never opens a worker's path); a worker
whose host vanished, journal and all, is recovered from the router's own
ledger. ``proc_kill``, ``proc_hang`` and ``host_loss`` go to the
supervisor (``Router.supervisor``).

Single-threaded, like the engine: one loop drives :meth:`Router.step`
(the HTTP front door, serve/http.py, and the fleet replay,
serve/loadgen.py). Per-replica tiers and page transfers are ROADMAP.md
queue A item 9(e).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..faults.fleet import (KIND_HOST_LOSS, KIND_PROC_HANG,
                            KIND_PROC_KILL, KIND_REPLICA_KILL,
                            KIND_REPLICA_WEDGE, REFUSED_KINDS,
                            fleet_step_fault)
from ..faults.netchaos import FaultyTransport
from ..utils.jsonl import load_jsonl_if_exists
from ..utils.logging import Metrics
from .journal import RequestJournal
from .requests import (FINISH_CANCELLED, FINISH_DEADLINE,
                       REJECT_BAD_REQUEST, REJECT_FLEET_CAPACITY,
                       REJECT_PROMPT_TOO_LONG, REJECT_QUEUE_FULL,
                       REJECT_REPLICA_DOWN, REJECT_REPLICA_TIMEOUT, Request,
                       RequestResult)
from .rpc import (DISAGG_ITEM, RpcClient, RpcError, RpcProtocolError,
                  RpcTimeout, request_from_wire, request_to_wire,
                  result_from_wire)

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
    #: a worker process's step RPC budget: past it the call is abandoned
    #: and the elapsed time feeds the wedge probe
    step_timeout_s: float = 10.0
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


class ReplicaDownError(RuntimeError):
    """A worker's transport is gone (refused, reset): the process died or
    is restarting. The router marks it down; the supervisor recovers."""


class ReplicaBase:
    """The router's view of one replica: the health state every backend
    shares, and the verbs the router drives. :class:`Replica` is an
    engine in this process, :class:`RemoteReplica` a worker process."""

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
        self.steps = 0

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


class RemoteReplica(ReplicaBase):
    """A worker process behind serve/rpc.py. The router's view of it is
    built from step replies (gauges, committed tokens, finished results)
    cached between calls, so that ``partial_tokens`` and ``health`` never
    block the routing loop on a sick worker.

    The worker redelivers finished results until they are acked (a reply
    lost to a timeout must not lose a finish): ``step_engine`` dedupes
    redeliveries against the previous reply and acks them on the next
    call, so the router sees each finish once. An id leaves the dedupe
    set when the router resubmits it here."""

    is_local = False

    #: verbs whose handlers mutate worker state: each call carries an
    #: idempotency key, so that a duplicate or a blind protocol retry is
    #: answered from the worker's reply cache (serve/worker.py
    #: ``IDEMPOTENT_VERBS``)
    MUTATING_VERBS = ("submit", "page_transfer", "journal_drain")

    #: the budget of the routing path's RPC (the prefix peek): affinity is
    #: an optimization, and a hung worker must not stall every submit for
    #: a whole rpc_timeout_s
    ROUTE_RPC_TIMEOUT_S = 1.0

    def __init__(self, idx: int, journal_path: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 rpc_timeout_s: float = 10.0,
                 step_timeout_s: float = 10.0):
        # journal_path is never read here (the worker's disk may be
        # another machine's): operator metadata only
        super().__init__(idx, journal_path)
        self.host = host
        self.client = None
        self.rpc_timeout_s = rpc_timeout_s
        self.step_timeout_s = step_timeout_s
        self.pid: Optional[int] = None
        self.gen = -1
        self.restarts = 0
        self.rpc_timeouts = 0
        self._warmed = False
        self._idle = True
        self._gauges = {"queue_depth": 0, "slots_active": 0,
                        "pages_in_use": 0, "n_steps": 0,
                        "prefix_hit_tokens": 0, "prompt_tokens": 0}
        self._partials: Dict[str, List[int]] = {}
        self._seen: set = set()        # finish ids delivered, unacked
        self._acks: List[str] = []
        #: the fleet's metrics (set by the Router): the rpc_* counters
        self.metrics: Optional[Metrics] = None
        #: each logical call attempt gets a fresh key (a resubmission must
        #: execute again); wire duplicates and retries of one attempt
        #: reuse it
        self._idem_seq = 0
        #: the last time an RPC round-tripped: Router._probe_heartbeat
        #: closes a silent client past ``heartbeat_deadline_s``
        self.last_ok_t = time.monotonic()
        self.heartbeat_deadline_s: Optional[float] = None
        #: the steps of the worker process ``pid`` as the router timed
        #: them (count, seconds): beside the worker's own step times in
        #: its ``summary``, the same steps, the RPC's share of a step
        self.timed_steps = 0
        self.timed_step_s = 0.0
        if port:
            self.connect(port)

    def _next_idem(self, op: str) -> str:
        self._idem_seq += 1
        return f"r{self.idx}.{op}.{self._idem_seq}"

    # ------------------------------------------------------- connection

    def connect(self, port: int, pid: Optional[int] = None,
                gen: Optional[int] = None,
                host: Optional[str] = None) -> None:
        if self.client is not None:
            self.client.close()
        if host:
            # the registration's peer address: a respawned worker may come
            # back on another machine
            self.host = host
        # a pass-through while no FaultPlan is installed: chaos runs and
        # clean runs take the same path
        self.client = FaultyTransport(
            RpcClient(self.host, port, timeout_s=self.rpc_timeout_s),
            src="router", dst=f"worker{self.idx}", observer=self)
        if pid is not None:
            if pid != self.pid:
                self.timed_steps, self.timed_step_s = 0, 0.0
            self.pid = pid
        if gen is not None:
            self.gen = gen

    def close(self) -> None:
        if self.client is not None:
            self.client.close()

    def _call(self, op: str, timeout_s: Optional[float] = None,
              **kw) -> dict:
        if self.client is None:
            raise ReplicaDownError(f"worker {self.idx}: never attached")
        if op in self.MUTATING_VERBS and "idem" not in kw:
            kw["idem"] = self._next_idem(op)
        if self.gen >= 0 and "gen" not in kw:
            # the incarnation we believe we talk to: a restarted worker
            # at a newer generation fences this call off
            kw["gen"] = self.gen
        try:
            resp = self.client.call(op, timeout_s=timeout_s, **kw)
        except RpcProtocolError as e:
            resp = self._retry_protocol(op, timeout_s, kw, e)
        except RpcTimeout:
            raise
        except RpcError as e:
            # RpcDown, or a worker whose dispatch raises: both are the
            # supervisor's to recover
            raise ReplicaDownError(f"worker {self.idx}: {e}") from e
        self._note_response(resp)
        return resp

    def _retry_protocol(self, op: str, timeout_s: Optional[float],
                        kw: dict, err: RpcProtocolError) -> dict:
        """A broken stream, not a broken call: reconnect and retry once
        with the same kwargs (the same idem key: if the first copy
        executed, the reply cache answers). A generation fence means this
        router is stale: the replica goes down and the attach path
        renegotiates."""
        if "stale generation" in str(err):
            if self.metrics is not None:
                self.metrics.inc("rpc_stale_generation_rejects")
            raise ReplicaDownError(f"worker {self.idx}: {err}") from err
        if self.metrics is not None:
            self.metrics.inc("rpc_corrupt_frames")
        self.client.close()
        try:
            return self.client.call(op, timeout_s=timeout_s, **kw)
        except RpcTimeout:
            raise
        except RpcError as e2:
            raise ReplicaDownError(f"worker {self.idx}: {e2}") from e2

    def _note_response(self, resp) -> None:
        """Every round trip feeds the heartbeat and the duplicate
        suppression count (``idem_hit``: a reply from the worker's
        cache)."""
        self.last_ok_t = time.monotonic()
        if (isinstance(resp, dict) and resp.get("idem_hit")
                and self.metrics is not None):
            self.metrics.inc("rpc_dup_suppressed")

    def net_chaos_response(self, resp) -> None:
        """A reply the chaos layer swallowed (reorder, one-way partition):
        its call took effect on the worker, so it is counted too."""
        self._note_response(resp)

    def net_chaos_partition(self, active: bool) -> None:
        if active and self.metrics is not None:
            self.metrics.inc("rpc_partitions_active")

    # ----------------------------------------------------- backend verbs

    def submit(self, req: Request) -> Optional[RequestResult]:
        try:
            resp = self._call("submit", timeout_s=self.rpc_timeout_s,
                              idem=self._next_idem("submit"),
                              req=request_to_wire(req, time.monotonic()))
        except RpcTimeout:
            # the hung worker may still execute it when it resumes: the
            # router supersedes that copy before it routes the id again
            return RequestResult(id=req.id, tokens=[],
                                 finish_reason=REJECT_REPLICA_TIMEOUT)
        except ReplicaDownError:
            return RequestResult(id=req.id, tokens=[],
                                 finish_reason=REJECT_REPLICA_DOWN)
        if resp.get("accepted"):
            # a legal reuse of a finished id must pass the finish dedupe
            self._seen.discard(req.id)
            return None
        return result_from_wire(resp["rejection"])

    def cancel(self, request_id: str, migrated: bool = False) -> bool:
        try:
            resp = self._call("cancel", timeout_s=self.rpc_timeout_s,
                              id=request_id, migrated=migrated)
        except (ReplicaDownError, RpcTimeout):
            return False
        return bool(resp.get("found"))

    def step_engine(self) -> List[RequestResult]:
        try:
            resp = self._call("step", acks=self._acks,
                              timeout_s=self.step_timeout_s)
        except RpcTimeout:
            # a hung worker: the caller's wall time feeds the wedge probe;
            # the call may still execute on resume, which the ack and
            # redelivery make safe
            self.rpc_timeouts += 1
            return []
        self._acks = []
        self._absorb(resp)
        delivered = [result_from_wire(d) for d in resp.get("finished", [])]
        fresh = [r for r in delivered if r.id not in self._seen]
        # what this reply carried stays buffered worker-side until the
        # next call acks it; what it did not was pruned by an earlier ack
        self._seen = {r.id for r in delivered}
        self._acks = sorted(self._seen)
        return fresh

    def stream_drain(self) -> None:
        """Refresh the committed-token cache without a step."""
        resp = self._call("stream_drain", timeout_s=self.rpc_timeout_s)
        self._partials.update({rid: list(toks) for rid, toks
                               in resp.get("partials", {}).items()})

    def journal_state(self, kinds: Tuple[str, ...] = ("finished",)
                      ) -> Tuple[Dict[str, str], List[Request]]:
        """The worker's journal state, paged through the ``journal_drain``
        RPC; an unreachable worker yields an empty view (the caller falls
        back to the router's ledger: the host-loss path). ``kinds``
        defaults to the finish records (attach gets the unfinished set
        from the worker's ``in_flight``)."""
        finished: Dict[str, str] = {}
        unfinished: List[Request] = []
        cursor = 0
        while True:
            try:
                resp = self._call("journal_drain",
                                  timeout_s=self.rpc_timeout_s,
                                  idem=self._next_idem("journal_drain"),
                                  cursor=cursor, kinds=list(kinds))
            except (ReplicaDownError, RpcTimeout):
                break
            for rec in resp.get("records", []):
                if rec.get("kind") == "finished":
                    finished[rec["id"]] = rec.get("reason", "")
                elif rec.get("kind") == "unfinished":
                    unfinished.append(request_from_wire(rec["req"],
                                                        time.monotonic()))
            nxt = int(resp.get("cursor", cursor))
            if resp.get("eof", True) or nxt <= cursor:
                break
            cursor = nxt
        return finished, unfinished

    def _absorb(self, resp: dict) -> None:
        for k in self._gauges:
            if k in resp:
                self._gauges[k] = int(resp[k])
        if "idle" in resp:
            self._idle = bool(resp["idle"])
        if "warmed" in resp:
            self._warmed = bool(resp["warmed"])
        self._partials = {rid: list(toks) for rid, toks
                          in resp.get("partials", {}).items()}

    def partial_tokens(self, request_id: str) -> Optional[List[int]]:
        return self._partials.get(request_id)

    def cached_prefix_tokens(self, prompt) -> int:
        import numpy as np
        try:
            resp = self._call("prefix", prompt=np.asarray(prompt).tolist(),
                              timeout_s=min(self.ROUTE_RPC_TIMEOUT_S,
                                            self.rpc_timeout_s))
        except (ReplicaDownError, RpcTimeout):
            return 0
        return int(resp.get("tokens", 0))

    @property
    def queue_depth(self) -> int:
        return self._gauges["queue_depth"]

    @property
    def slots_active(self) -> int:
        return self._gauges["slots_active"]

    @property
    def pages_in_use(self) -> int:
        return self._gauges["pages_in_use"]

    @property
    def engine_idle(self) -> bool:
        return self._idle

    @property
    def warmed(self) -> bool:
        return self._warmed

    def refresh_health(self, timeout_s: Optional[float] = None) -> dict:
        """One live ``health`` RPC (attach, the front door's vocabulary
        lookup), its gauges absorbed. On the serving path pass a short
        ``timeout_s``."""
        resp = self._call("health", timeout_s=timeout_s)
        self._absorb(resp)
        return resp

    def hit_tokens(self) -> Tuple[int, int]:
        return (self._gauges["prefix_hit_tokens"],
                self._gauges["prompt_tokens"])

    def health(self) -> dict:
        """Cached state only: /healthz must never block on a sick worker
        (the supervisor's probe and :meth:`refresh_health` call it)."""
        h = dict(self._base_health())
        h.update({
            "queue_depth": self.queue_depth,
            "slots_active": self.slots_active,
            "pages_in_use": self.pages_in_use,
            "pid": self.pid, "gen": self.gen,
            "restarts": self.restarts,
            "rpc_timeouts": self.rpc_timeouts,
            "warmed": self.warmed,
        })
        return h

    def summary_block(self) -> dict:
        try:
            block = self._call("summary",
                               timeout_s=self.rpc_timeout_s).get("block", {})
        except (ReplicaDownError, RpcTimeout):
            block = {"occupancy_mean": 0.0,
                     "n_steps": self._gauges["n_steps"], "pages": {},
                     "finished": {}, "unreachable": True}
        block["health"] = self.health()
        block["router_timed"] = {"pid": self.pid, "steps": self.timed_steps,
                                 "step_s_sum": self.timed_step_s}
        return block


class Router:
    """N-replica front tier: submit/cancel/step/drain over the fleet.

    The engine's host API shape: ``submit`` returns None (accepted) or a
    terminal rejection, ``step`` advances every live replica one
    scheduling iteration and returns the fleet's newly finished results,
    ``drain`` runs to idle. ``model`` (a ``models.gpt.GPT``) is cast once
    to the compute dtype on ``device`` and shared by every replica (a
    replica on a serving mesh splits its own). Pass ``backends`` (a list
    of :class:`ReplicaBase`, e.g. :class:`RemoteReplica` proxies from
    ``faults.procsup.spawn_fleet``) to run the fleet across worker
    processes; ``model``, ``cfg``, ``ecfg`` and ``device`` are unused then
    (each worker owns its model)."""

    def __init__(self, model=None, cfg=None,
                 rcfg: RouterConfig = RouterConfig(), ecfg=None,
                 clock: Callable[[], float] = time.monotonic,
                 device=None,
                 backends: Optional[List[ReplicaBase]] = None):
        if rcfg.tiers is not None:
            raise NotImplementedError(
                f"replica tiers {rcfg.tiers} are not implemented in "
                f"replicatinggpt_tpu_torch yet: ROADMAP.md {DISAGG_ITEM}")
        self.rcfg = rcfg
        self.clock = clock
        self.metrics = Metrics()
        #: the process supervisor (faults/procsup.py, set by its
        #: attach_router): proc_kill, proc_hang and host_loss go to it
        self.supervisor = None
        self.replicas: List[ReplicaBase] = []
        if backends is not None:
            self.replicas = list(backends)
            for rep in self.replicas:
                rep.skip_steps = rcfg.wedge_skip_steps
                if not rep.is_local:
                    # the rpc_* counters land in the fleet's metrics; a
                    # half-open socket is closed after three silent step
                    # budgets
                    rep.metrics = self.metrics
                    rep.heartbeat_deadline_s = rcfg.step_timeout_s * 3.0
        else:
            self._build_replicas(model, cfg, ecfg, device)
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

    def _build_replicas(self, model, cfg, ecfg, device) -> None:
        from ..device import resolve_device
        from ..models.gpt import compute_params
        from .engine import Engine, EngineConfig
        rcfg = self.rcfg
        assert rcfg.n_replicas >= 1, rcfg.n_replicas
        ecfg = ecfg or EngineConfig()
        dev = resolve_device(device)
        params = (compute_params(model, dev)
                  if ecfg.mesh_data * ecfg.mesh_model == 1 else None)
        for i in range(rcfg.n_replicas):
            jpath = jr = None
            if rcfg.journal_dir is not None:
                jpath = os.path.join(rcfg.journal_dir, f"replica{i}.jsonl")
                jr = RequestJournal(jpath)
            eng = Engine(model, cfg, ecfg, clock=self.clock, device=dev,
                         journal=jr, params=params)
            self.replicas.append(Replica(
                idx=i, engine=eng, journal_path=jpath, journal=jr,
                skip_steps=rcfg.wedge_skip_steps))

    # ---------------------------------------------------------------- API

    def warmup(self) -> None:
        """Warm every live in-process replica's engine (``Engine.warmup``:
        on the card its kernels built and loaded), then mark them warm
        together: ``readyz`` says ready only once every replica is. A
        worker process warms itself before it registers."""
        reps = [r for r in self.replicas
                if r.is_local and r.alive and not r.warmed]
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
            elif flt.kind in (KIND_PROC_KILL, KIND_PROC_HANG,
                              KIND_HOST_LOSS):
                self._process_fault(flt, step_idx)
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
            try:
                finished = rep.step_engine()
            except ReplicaDownError as e:
                rep.last_step_s = time.perf_counter() - t_wall
                self.mark_down(rep.idx, str(e))
                continue
            rep.last_step_s = time.perf_counter() - t_wall
            rep.steps += 1
            if not rep.is_local:
                # a worker's step as the router times it, and the size of
                # its reply frame (it carries every active slot's tokens)
                self.metrics.observe(f"replica{rep.idx}_step_s",
                                     rep.last_step_s)
                self.metrics.observe(f"replica{rep.idx}_step_frame_bytes",
                                     rep.client.last_frame_bytes)
                rep.timed_steps += 1
                rep.timed_step_s += rep.last_step_s
            # finishes before the wedge probe: a request that finished in
            # the step that trips the probe leaves the ledger first, or
            # _wedge would decode it a second time
            for res in finished:
                done = self._on_finish(res, rep.idx, now)
                if done is not None:
                    out.append(done)
            self._probe(rep, step_idx)
            self._probe_heartbeat(rep, step_idx)
        self._observe_ttft(now)
        self._drain_requeue(step_idx)
        if self._router_finished:      # retry exhaustion in this step
            out.extend(self._router_finished)
            self._router_finished = []
        self._gauges()
        return out

    def _process_fault(self, flt, step_idx: int) -> None:
        """``proc_kill`` (worker ``arg``), ``proc_hang`` (worker ``arg2``
        for ``arg`` ticks) and ``host_loss`` (worker ``arg``) go to the
        supervisor; without one they are logged and ignored."""
        sup = self.supervisor
        if sup is None:
            self._event(f"step {step_idx}: {flt.kind} ignored (no "
                        f"supervisor attached)")
        elif flt.kind == KIND_PROC_KILL:
            sup.chaos_kill(int(flt.arg))
        elif flt.kind == KIND_PROC_HANG:
            sup.chaos_hang(int(flt.arg2), int(flt.arg))
        else:
            sup.chaos_host_loss(int(flt.arg))

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
        built); a worker process joins down, and :meth:`attach_replica`
        makes it routable once its registration completes."""
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

    def attach_replica(self, idx: int, port: int, pid: Optional[int] = None,
                       gen: Optional[int] = None,
                       host: Optional[str] = None) -> dict:
        """(Re)connect a worker and reconcile the router's ledger with what
        the (restarted) worker recovered from its journal, read through
        the ``journal_drain`` RPC:

        - ids the worker replayed keep their entries (they regenerate from
          token 0; the delivery ledger suppresses the delivered prefix);
        - ids its journal says finished (the result died undelivered with
          the process) surface their journaled reason;
        - ids the worker lost (a torn submit record, a vanished host's
          empty journal) requeue from the router's ledger;
        - ids the worker replayed that the router does not own there
          (stale ghosts, work that migrated away) are cancelled."""
        rep = self.replicas[idx]
        assert isinstance(rep, RemoteReplica), "attach is remote-only"
        rep.connect(port, pid=pid, gen=gen, host=host)
        h = rep.refresh_health()
        rep.stream_drain()
        worker_ids = set(h.get("in_flight", []))
        mine = [rid for rid, fi in self._inflight.items()
                if fi.replica == idx]
        finished_reasons, _ = rep.journal_state()
        kept = lost = 0
        now = self.clock()
        for rid in mine:
            if rid in worker_ids:
                kept += 1
                continue
            fi = self._inflight.pop(rid)
            if rid in finished_reasons:
                self._record_result(RequestResult(
                    id=rid, tokens=[], finish_reason=finished_reasons[rid]),
                    fi.t_submit)
            else:
                self._requeue.append(_Requeue(
                    req=fi.req, t_submit=fi.t_submit, attempts=fi.attempts,
                    due_step=self.n_steps, t_requeued=now))
                self.metrics.inc("fleet_requeued_requests")
                lost += 1
        ghosts = [rid for rid in worker_ids
                  if rid not in self._inflight
                  or self._inflight[rid].replica != idx]
        for rid in ghosts:
            rep.cancel(rid, migrated=True)
            self.metrics.inc("fleet_ghost_cancels")
        # superseded copies this incarnation can never deliver died with
        # the process before it
        self._superseded = {rid: i for rid, i in self._superseded.items()
                            if i != idx or rid in worker_ids}
        rep.alive = True
        rep.wedged = False
        rep.draining = False
        rep.suspect_streak = 0
        rep.skip_steps = self.rcfg.wedge_skip_steps
        self.metrics.inc("fleet_replica_attaches")
        self._event(f"step {self.n_steps}: worker {idx} attached (pid "
                    f"{rep.pid}, gen {rep.gen}, kept {kept}, requeued "
                    f"{lost}, ghosts {len(ghosts)})")
        return {"kept": kept, "requeued": lost, "ghosts": len(ghosts)}

    def abandon_replica(self, idx: int) -> None:
        """Give up on a replica for good (its restart budget ran out, or a
        ``replica_kill``): requeue its in-flight work onto the
        survivors."""
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
            # a worker that wedged (SIGSTOP) may still hold superseded
            # copies the hedge could not cancel while it did not answer
            if not rep.is_local:
                for rid, sidx in list(self._superseded.items()):
                    if sidx == rep.idx:
                        rep.cancel(rid, migrated=True)
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

    def _probe_heartbeat(self, rep: ReplicaBase, step_idx: int) -> None:
        """Half-open socket detection: a worker whose RPCs all time out
        (a one-way partition, dropped packets) never raises, every call
        just spends its budget. Once nothing round-tripped for
        ``heartbeat_deadline_s``, the client is closed, so that the next
        call connects afresh: a dead peer then fails fast as ``RpcDown``
        (down, then the supervisor), a healed one gets a clean socket."""
        deadline = getattr(rep, "heartbeat_deadline_s", None)
        if rep.is_local or deadline is None or rep.client is None:
            return
        silent_s = time.monotonic() - rep.last_ok_t
        if silent_s <= deadline:
            return
        rep.client.close()
        rep.last_ok_t = time.monotonic()   # one reconnect a deadline
        self._event(f"step {step_idx}: replica {rep.idx} heartbeat "
                    f"deadline blown ({silent_s:.1f}s silent) — forcing "
                    f"reconnect")

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
        """Abandon a replica (a worker the supervisor gave up on, or the
        in-process stand-in for a process death) and requeue its
        unfinished requests: an in-process replica's from its journal, a
        worker's from the router's own ledger (its host may be gone,
        journal and all)."""
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
        if rep.is_local:
            finished_reasons, pending = rep.journal_state()
        else:
            # every in-flight id re-decodes; the delivery ledger
            # suppresses the streamed prefix, so a finish that died unacked
            # is delivered in full instead of as a tokenless reason
            finished_reasons = {}
            pending = [fi.req for fi in self._inflight.values()
                       if fi.replica == idx]
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
        # no routable replica BECAUSE recovery is under way (a replica
        # draining on purpose, a worker respawning): hold the requeue
        # without burning attempts, which router steps would spend in
        # milliseconds of a restart's seconds (a fleet with nothing coming
        # back still exhausts honestly)
        if not any(r.routable for r in self.replicas):
            recovering = (any(r.alive and r.draining for r in self.replicas)
                          or (self.supervisor is not None
                              and self.supervisor.reviving))
            if recovering and self._requeue:
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
