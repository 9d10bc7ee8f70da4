"""Worker process: one engine behind the serve/rpc.py socket protocol
(the port of ``replicatinggpt_tpu/serve/worker.py``).

``python -m replicatinggpt_tpu_torch serve-worker`` is the unit a
deployment schedules: it owns one engine (its weights, KV pool and, on
the card, its own CUDA context and loaded kernels: a process whose death
takes nothing else with it), an exclusively locked crash journal on its
own disk, and an RPC socket the router drives. Nothing assumes a
filesystem shared with the router: the worker announces itself over the
network (``register``), and its journal's content crosses the socket
(``journal_drain``). The router (serve/router.py, ``RemoteReplica``)
holds the in-flight ledger, the supervisor (faults/procsup.py) the
restart and autoscale policy.

Start-up order (the crash-recovery contract):

1. build and **warm** the engine (``Engine.warmup``: one throwaway greedy
   request, on the card through the kernels of the engine's route, which
   builds and loads them): ready means the next request builds nothing,
   and a kernel that fails to build or launch fails here, before
   registration;
2. open the journal with ``lock=True`` (a not-quite-dead previous
   incarnation still holding it fails this process loudly) and
   ``fsync_finish`` on (``--no-fsync`` off);
3. **replay** the journal: every accepted-but-unfinished request of the
   previous incarnation is resubmitted and regenerates from token 0 (its
   sampling stream is seeded from the request alone), and the router's
   delivery ledger suppresses the prefix the client already saw, so
   streams stay exactly-once across ``kill -9``. Requests the admission
   queue cannot hold yet wait in a list retried before every step;
4. bind the RPC server (port 0 = ephemeral) and **register** with the
   fleet: one ``register`` frame to ``--router-addr`` with ``{port, pid,
   gen, replayed, worker_idx, proto, shape_hash, ...}``. A protocol or
   engine-shape mismatch is refused here (exit 3), never mid-traffic.

The worker never steps itself: the router's ``step`` RPC is the one
driver, so fleet scheduling stays single-threaded across the process
boundary. Finished results are kept until the router acks them;
committed tokens of active slots ride every step reply.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import signal
import sys
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from ..utils.logging import Metrics
from .journal import RequestJournal
from .requests import (FINISH_CANCELLED, REJECT_REPLICA_DOWN, Request,
                       RequestResult)
from .rpc import (DISAGG_ITEM, HEADER_BYTES, JOURNAL_DRAIN_LIMIT,
                  PROTO_VERSION, RpcProtocolError, crc_ok, decode_header,
                  encode_frame, request_from_wire, request_to_wire,
                  result_to_wire, serve_connection)

#: re-registration pacing: a worker that hears nothing from the router for
#: REREGISTER_IDLE_S seconds assumes the router (or its listener)
#: restarted, and re-announces itself with full-jitter exponential
#: backoff until a listener answers (re-registering an attached worker is
#: an idempotent re-attach)
REREGISTER_IDLE_S = 5.0
REREGISTER_BACKOFF_S = 0.5
REREGISTER_BACKOFF_CAP_S = 10.0

#: mutating verbs whose dispatch consults the reply cache: a duplicated or
#: retried frame with an ``idem`` key already answered gets the cached
#: reply (``idem_hit``) instead of a second execution
IDEMPOTENT_VERBS = ("submit", "page_transfer", "journal_drain")

#: the reply cache's bound
REPLY_CACHE_SIZE = 256


class WorkerServer:
    """Dispatch table around one engine (single-threaded: it runs on the
    asyncio loop, the worker's one thread of control)."""

    def __init__(self, engine, journal: Optional[RequestJournal],
                 clock=time.monotonic):
        self.engine = engine
        self.journal = journal
        self.clock = clock
        self.draining = False
        self.warmed = False
        #: this incarnation's generation (set at spawn; -1 = unfenced):
        #: calls stamped with another generation are refused
        self.gen = -1
        #: when the router last called: the re-registration loop's
        #: silence detector
        self.last_contact = time.monotonic()
        self._replies: "OrderedDict[str, dict]" = OrderedDict()
        self.stop_event = asyncio.Event()
        #: finished results not yet acked, redelivered in every step reply
        self._finished: Dict[str, RequestResult] = {}
        #: replayed requests the admission queue could not hold yet
        self._replay_pending: List[Request] = []
        #: journal_drain's paging snapshot (one read a drain session)
        self._drain_snapshot: Optional[List[dict]] = None
        self.n_replayed = 0
        #: the engine's own step times (``summary``'s ``worker``; their
        #: count and sum exact, the p50 over the newest 8192): the
        #: router's wall time a step less these is the RPC's share
        self.step_calls = 0
        self.step_s_sum = 0.0
        self.timing = Metrics()
        #: row #1's launch count at registration (``summary`` reports
        #: the launches since)
        self.launches0 = 0

    # ------------------------------------------------------------ replay

    def replay_journal(self, path: str) -> int:
        """Resubmit the previous incarnation's unfinished requests."""
        pending = RequestJournal.unfinished(path)
        self.n_replayed = len(pending)
        for req in pending:
            if self.engine.submit(req) is not None:
                self._replay_pending.append(req)
        return self.n_replayed

    def _retry_replays(self) -> None:
        self._replay_pending = [req for req in self._replay_pending
                                if self.engine.submit(req) is not None]

    # ---------------------------------------------------------- dispatch

    def dispatch(self, doc: dict) -> dict:
        op = doc.get("op")
        fn = getattr(self, f"op_{op}", None)
        if fn is None:
            raise ValueError(f"unknown op {op!r}")
        self.last_contact = time.monotonic()
        gen = doc.get("gen")
        if gen is not None and self.gen >= 0 and int(gen) != self.gen:
            raise RpcProtocolError(
                f"stale generation {gen} (worker at gen {self.gen})")
        idem = doc.get("idem")
        if idem is not None and op in IDEMPOTENT_VERBS:
            cached = self._replies.get(idem)
            if cached is not None:
                return {**cached, "idem_hit": True}
            resp = fn(doc) or {}
            self._replies[idem] = resp
            while len(self._replies) > REPLY_CACHE_SIZE:
                self._replies.popitem(last=False)
            return resp
        return fn(doc)

    def _in_flight_ids(self) -> List[str]:
        return (self.engine.in_flight_ids()
                + [r.id for r in self._replay_pending])

    def _gauges(self) -> dict:
        eng = self.engine
        a = eng.pool.alloc
        return {
            "queue_depth": eng.scheduler.depth,
            "slots_active": int(eng._active.sum()),
            "pages_in_use": a.pages_in_use,
            "prefix_hit_tokens": a.prefix_hit_tokens,
            "prompt_tokens": a.prompt_tokens,
            "n_steps": eng.n_steps,
            "idle": (eng.idle and not self._replay_pending
                     and not self._finished),
            "warmed": self.warmed,
        }

    def _partials(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for rid in self.engine.in_flight_ids():
            toks = self.engine.partial_tokens(rid)
            if toks is not None:
                out[rid] = toks
        return out

    def op_submit(self, doc: dict) -> dict:
        if self.draining:
            return {"accepted": False,
                    "rejection": result_to_wire(RequestResult(
                        id=doc["req"]["id"], tokens=[],
                        finish_reason=REJECT_REPLICA_DOWN))}
        rej = self.engine.submit(request_from_wire(doc["req"], self.clock()))
        if rej is None:
            return {"accepted": True}
        return {"accepted": False, "rejection": result_to_wire(rej)}

    def op_step(self, doc: dict) -> dict:
        for rid in doc.get("acks", []):
            self._finished.pop(rid, None)
        self._retry_replays()
        t0 = time.perf_counter()
        for res in self.engine.step():
            self._finished[res.id] = res
        dt = time.perf_counter() - t0
        self.step_calls += 1
        self.step_s_sum += dt
        self.timing.observe("step_s", dt)
        return {
            "finished": [result_to_wire(r)
                         for r in self._finished.values()],
            "partials": self._partials(),
            **self._gauges(),
        }

    def op_stream_drain(self, doc: dict) -> dict:
        return {"partials": self._partials(), **self._gauges()}

    def op_cancel(self, doc: dict) -> dict:
        rid = doc["id"]
        found = self.engine.cancel(rid, migrated=bool(doc.get("migrated")))
        if not found:
            # a replay-pending id is in flight too: its cancel journals a
            # finish, or a later restart would resurrect it
            for i, req in enumerate(self._replay_pending):
                if req.id == rid:
                    del self._replay_pending[i]
                    if self.journal is not None:
                        self.journal.record_finish(rid, FINISH_CANCELLED)
                    found = True
                    break
        return {"found": found}

    def op_prefix(self, doc: dict) -> dict:
        import numpy as np
        return {"tokens": int(self.engine.pool.cached_prefix_tokens(
            np.asarray(doc["prompt"], np.int32)))}

    def op_page_transfer(self, doc: dict) -> dict:
        raise NotImplementedError(
            f"page_transfer is not implemented in replicatinggpt_tpu_torch "
            f"yet: ROADMAP.md {DISAGG_ITEM}")

    def op_health(self, doc: dict) -> dict:
        return {
            "pid": os.getpid(),
            "vocab_size": int(self.engine.cfg.vocab_size),
            "in_flight": self._in_flight_ids(),
            "replayed": self.n_replayed,
            "draining": self.draining,
            "counters": {k: int(v) for k, v in
                         self.engine.metrics.counters.items()},
            **self._gauges(),
        }

    def op_summary(self, doc: dict) -> dict:
        """The engine's fleet-summary block, and ``worker``: this
        process's pid, row #1's launches since registration, its engine
        step times (count, sum, p50) and, on the card, the peak device
        memory allocated."""
        from ..ops import paged_attention
        from .engine import engine_summary_block
        worker = {
            "pid": os.getpid(),
            "row1_launches": (paged_attention.paged_window_attention.launches
                              - self.launches0),
            "step_calls": self.step_calls,
            "step_s_sum": self.step_s_sum,
            "step_s_p50": self.timing.percentile("step_s", 0.5),
        }
        dev = getattr(self.engine, "device", None)
        if dev is not None and dev.type == "cuda":
            import torch
            worker["peak_allocated_bytes"] = int(
                torch.cuda.max_memory_allocated(dev))
        return {"block": {**engine_summary_block(self.engine),
                          "worker": worker}}

    def _journal_view(self) -> List[dict]:
        """The journal's condensed state: the last finish reason an id
        (in journal order), then the unfinished requests as wire docs."""
        if self.journal is None:
            return []
        from ..utils.jsonl import load_jsonl_if_exists
        reasons: Dict[str, str] = {}
        for rec in load_jsonl_if_exists(self.journal.path):
            if rec.get("ev") == "finish":
                reasons[rec["id"]] = rec.get("reason", "")
        now = self.clock()
        return ([{"kind": "finished", "id": rid, "reason": reason}
                 for rid, reason in reasons.items()]
                + [{"kind": "unfinished", "req": request_to_wire(req, now)}
                   for req in RequestJournal.unfinished(self.journal.path)])

    def op_journal_drain(self, doc: dict) -> dict:
        """The local journal's condensed state in bounded frames: the
        router pages with ``cursor`` until ``eof``. The view is taken at
        ``cursor == 0`` and later frames page over it (one disk read a
        drain session; a record appended mid-drain never shifts the
        paging). ``kinds`` filters it."""
        cursor = max(int(doc.get("cursor", 0)), 0)
        limit = max(1, min(int(doc.get("limit", JOURNAL_DRAIN_LIMIT)),
                           JOURNAL_DRAIN_LIMIT))
        kinds = doc.get("kinds")
        if cursor == 0 or self._drain_snapshot is None:
            records = self._journal_view()
            if kinds:
                records = [r for r in records if r["kind"] in kinds]
            self._drain_snapshot = records
        records = self._drain_snapshot
        frame = records[cursor:cursor + limit]
        eof = cursor + len(frame) >= len(records)
        if eof:
            self._drain_snapshot = None
        return {"records": frame, "cursor": cursor + len(frame),
                "eof": eof}

    def op_drain(self, doc: dict) -> dict:
        """Rolling-restart drain: refuse new submits and cancel everything
        in flight as migrated (the journal records the finishes, so the
        next incarnation's replay resurrects none of it)."""
        self.draining = True
        ids = self._in_flight_ids()
        for rid in list(self.engine.in_flight_ids()):
            self.engine.cancel(rid, migrated=True)
        for req in self._replay_pending:
            if self.journal is not None:
                self.journal.record_finish(req.id, FINISH_CANCELLED)
        self._replay_pending = []
        return {"cancelled": ids}

    def op_shutdown(self, doc: dict) -> dict:
        asyncio.get_running_loop().call_soon(self.stop_event.set)
        return {"stopping": True}


async def _register_attempt(router_addr: str, doc: dict) -> dict:
    """One register frame to the fleet's listener. Raises
    :class:`RpcProtocolError` on a typed refusal (a mismatched build must
    exit) and ConnectionError on a transport failure or any other refusal
    (the caller retries)."""
    host, _, port = router_addr.rpartition(":")
    writer = None
    try:
        reader, writer = await asyncio.open_connection(host or "127.0.0.1",
                                                       int(port))
        writer.write(encode_frame({"op": "register", **doc}))
        await writer.drain()
        header = await asyncio.wait_for(reader.readexactly(HEADER_BYTES),
                                        15.0)
        n, crc = decode_header(header)
        body = await asyncio.wait_for(reader.readexactly(n), 15.0)
        if not crc_ok(body, crc):
            raise ConnectionError("registration response checksum mismatch")
        resp = json.loads(body)
    except (OSError, ValueError, asyncio.IncompleteReadError,
            asyncio.TimeoutError) as e:
        raise ConnectionError(f"{type(e).__name__}: {e}") from e
    finally:
        if writer is not None:
            writer.close()
    if resp.get("ok"):
        return resp
    if resp.get("kind") == "protocol":
        raise RpcProtocolError(resp.get("error", "protocol mismatch"))
    raise ConnectionError(resp.get("error", "rejected"))


async def _register_with_router(router_addr: str, doc: dict,
                                budget_s: float = 120.0) -> dict:
    """Start-up registration: ``_register_attempt`` until the listener
    answers (it is polled from the router's loop, so an answer may lag a
    tick); :class:`RpcProtocolError` propagates."""
    deadline = time.monotonic() + budget_s
    last = "no attempt"
    while time.monotonic() < deadline:
        try:
            return await _register_attempt(router_addr, doc)
        except ConnectionError as e:
            last = str(e)
        await asyncio.sleep(0.2)
    raise RuntimeError(f"registration with {router_addr} failed: {last}")


async def _reregister_loop(worker, router_addr: str, doc: dict,
                           idle_s: float = REREGISTER_IDLE_S,
                           backoff_s: float = REREGISTER_BACKOFF_S,
                           backoff_cap_s: float = REREGISTER_BACKOFF_CAP_S,
                           on_reregister=None, rng=None) -> None:
    """Keep the worker attached across router restarts: after
    ``idle_s`` without a call, re-send the register frame until a
    listener answers. The backoff is full-jitter exponential
    (``uniform(0, min(cap, base * 2^n))``), so that a fleet healing from
    one partition does not re-register in one herd; ``rng`` is seeded
    from the pid otherwise. One silence episode is one logical
    registration: its idem key is refreshed when an episode begins and
    reused by the retries within it. A typed protocol refusal stops the
    worker."""
    rng = rng or random.Random(os.getpid())
    attempt = 0
    episode = 0
    in_episode = False
    base_idem = doc.get("idem", f"reg.{doc.get('worker_idx', 0)}"
                                f".{doc.get('gen', 0)}")
    while not worker.stop_event.is_set():
        if time.monotonic() - worker.last_contact < idle_s:
            attempt = 0
            in_episode = False
            await asyncio.sleep(idle_s / 2)
            continue
        if not in_episode:
            in_episode = True
            episode += 1
            doc = {**doc, "idem": f"{base_idem}.re{episode}"}
        try:
            await _register_attempt(router_addr, doc)
            worker.last_contact = time.monotonic()
            attempt = 0
            in_episode = False
            if on_reregister is not None:
                on_reregister()
        except RpcProtocolError as e:
            print(f"re-registration REJECTED (protocol/shape mismatch): "
                  f"{e}; stopping", file=sys.stderr)
            worker.stop_event.set()
            return
        except ConnectionError:
            attempt += 1
        await asyncio.sleep(rng.uniform(
            0.0, min(backoff_cap_s, backoff_s * (2.0 ** attempt))))


async def _run_async(worker: WorkerServer, host: str, port: int,
                     router_addr: Optional[str], gen: int, worker_idx: int,
                     shape_hash: str) -> int:
    worker.gen = gen
    conns = set()

    async def connection(reader, writer):
        conns.add(writer)
        try:
            await serve_connection(reader, writer, worker.dispatch)
        finally:
            conns.discard(writer)

    server = await asyncio.start_server(connection, host, port)
    bound = server.sockets[0].getsockname()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, worker.stop_event.set)
    print(f"worker listening on {bound[0]}:{bound[1]} pid={os.getpid()} "
          f"gen={gen} idx={worker_idx} shape={shape_hash} "
          f"replayed={worker.n_replayed}", file=sys.stderr, flush=True)
    rereg_task = None
    if router_addr:
        # the server is live already: the supervisor's attach RPCs are
        # served by this loop while registration awaits its answer
        reg_doc = {"port": bound[1], "pid": os.getpid(), "gen": gen,
                   "worker_idx": worker_idx,
                   "replayed": worker.n_replayed,
                   "proto": PROTO_VERSION, "shape_hash": shape_hash,
                   "tier": "mixed",
                   "page_size": int(worker.engine.pool.page_size),
                   "idem": f"reg.{worker_idx}.{gen}.{os.getpid()}.0"}
        try:
            await _register_with_router(router_addr, reg_doc)
        except RpcProtocolError as e:
            print(f"registration REJECTED (protocol/shape mismatch): {e}",
                  file=sys.stderr)
            await _close(server, conns)
            return 3
        print(f"registered with {router_addr}", file=sys.stderr,
              flush=True)
        worker.last_contact = time.monotonic()
        rereg_task = asyncio.ensure_future(_reregister_loop(
            worker, router_addr, reg_doc,
            idle_s=getattr(worker, "reregister_idle_s", REREGISTER_IDLE_S),
            on_reregister=lambda: print(
                f"re-registered with {router_addr} (router was silent)",
                file=sys.stderr)))
    await worker.stop_event.wait()
    if rereg_task is not None:
        rereg_task.cancel()
        try:
            await rereg_task
        except asyncio.CancelledError:
            pass
    # let an in-flight shutdown reply flush first
    await asyncio.sleep(0.05)
    await _close(server, conns)
    return 0


async def _close(server, conns) -> None:
    """Stop listening and close the open connections (the router keeps
    one: ``wait_closed`` waits for every connection to end)."""
    server.close()
    for writer in list(conns):
        writer.close()
    await server.wait_closed()


def run_worker(args) -> int:
    """The serve-worker subcommand's body (cli.py has the flags): the
    port's model on ``--device`` (the card unless ``cpu``; no card
    raises), from ``--checkpoint-dir``'s newest verified step or the
    seed's random init, and the engine ``serve`` would build."""
    from ..cli import engine_config_from_args, load_weights
    from ..config import config_from_args
    from ..device import resolve_device
    from ..ops import paged_attention
    from .engine import Engine
    from .rpc import engine_shape_hash
    cfg = config_from_args(args)
    ecfg = engine_config_from_args(args)
    dev = resolve_device(args.device)
    model = load_weights(cfg, args.checkpoint_dir, dev, "serving").model
    engine = Engine(model, cfg.model, ecfg, device=dev)
    # no journal yet: the warm-up request never reaches one; on the card
    # a kernel that fails to build or launch raises here, unregistered
    engine.warmup()
    journal = None
    if args.journal:
        journal = RequestJournal(args.journal,
                                 fsync_finish=not args.no_fsync, lock=True)
        engine.journal = journal
    worker = WorkerServer(engine, journal)
    worker.reregister_idle_s = args.reregister_idle_s
    worker.warmed = True
    worker.launches0 = paged_attention.paged_window_attention.launches
    if args.journal:
        n = worker.replay_journal(args.journal)
        if n:
            print(f"journal replay: {n} unfinished request(s) resubmitted",
                  file=sys.stderr)
    shape = engine_shape_hash(cfg.model, ecfg)
    try:
        return asyncio.run(_run_async(worker, args.host, args.port,
                                      args.router_addr, args.gen,
                                      args.worker_idx, shape))
    finally:
        if journal is not None:
            journal.close()
