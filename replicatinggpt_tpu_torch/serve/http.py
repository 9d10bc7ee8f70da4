"""HTTP/SSE front door of the fleet, standard-library asyncio only (the
port of ``replicatinggpt_tpu/serve/http.py``).

A thin asyncio HTTP server over the router's host API that adds no
scheduling of its own: backpressure is the engines' bounded queues
surfacing as 429s, deadlines are request fields, a cancel (explicit, or a
client that disconnects mid-stream) is ``Router.cancel``, which frees the
request's slot and KV pages at once, and crash recovery is the
per-replica journals behind the router. The server binds loopback.

Endpoints (JSON unless noted):

- ``POST /v1/submit``: body ``{"prompt": [ids], "id"?, "max_new_tokens"?,
  "temperature"?, "top_k"?, "top_p"?, "greedy"?, "rng_seed"?,
  "eos_token_id"?, "deadline_s"?}``; 200 ``{"id", "status": "accepted"}``
  or the status of the rejection (429 backpressure, 400 validation, 413
  prompt too long, 504 a deadline dead on arrival, 503 every replica
  unreachable).
- ``GET /v1/stream/{id}``: ``text/event-stream``, one ``data: {"token":
  t, "i": n}`` event a token as steps commit them, then ``event: done``
  with the terminal summary. Exactly once across a replica kill
  mid-stream (the router's delivery ledger); one consumer a request id.
- ``POST /v1/generate``: submit and stream in one round trip.
- ``POST /v1/cancel/{id}``: ``{"cancelled": bool}``.
- ``GET /v1/result/{id}``: the terminal result without streaming (202
  while it runs; reading it frees the id).
- ``GET /healthz``: liveness, 200 whenever the server answers, with the
  per-replica detail.
- ``GET /readyz``: readiness, 200 iff at least one routable replica is
  warm (``Router.warmup``: the server warms every in-process replica
  before it binds its socket, so that the first step builds no kernel; a
  worker process warms itself before it registers), else 503; it follows
  the fleet through a rolling restart.
- ``GET /metrics``: the router's metrics in the Prometheus text format
  (fleet counters and per-replica gauges; utils/telemetry.py).

Single-threaded on purpose, as the engine and the router are: one
stepping task calls ``router.step()`` between socket reads, and a step
blocks the loop for one engine step a replica (a worker process's step
is one blocking RPC). A multi-process fleet's supervisor
(faults/procsup.py) is ticked by the same task after every step and on
idle turns, so that restarts progress while the fleet waits.

A peer that does not complete its headers (slow-loris), stalls mid-body
or stops reading its SSE stream is dropped after ``idle_timeout_s``. The
submit paths meter a token bucket a client id (the ``x-client-id``
header; without it, one shared anonymous bucket) before parsing the
body: an over-rate client gets 429 with ``Retry-After``
(:class:`RateLimitConfig`).
"""

from __future__ import annotations

import asyncio
import itertools
import json
import math
import sys
import traceback
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.telemetry import prometheus_text
from .requests import (FINISH_DEADLINE, REJECT_BAD_REQUEST,
                       REJECT_FLEET_CAPACITY, REJECT_PROMPT_TOO_LONG,
                       REJECT_QUEUE_FULL, REJECT_REPLICA_DOWN,
                       REJECT_REPLICA_TIMEOUT, Request, SamplingParams)
from .router import Router

#: rejection reason -> HTTP status for the submit path
REASON_STATUS = {
    REJECT_QUEUE_FULL: 429,
    REJECT_FLEET_CAPACITY: 429,
    REJECT_BAD_REQUEST: 400,
    REJECT_PROMPT_TOO_LONG: 413,
    FINISH_DEADLINE: 504,
    # every candidate replica unreachable/hung at submit time: a
    # try-later server condition, not a client error
    REJECT_REPLICA_DOWN: 503,
    REJECT_REPLICA_TIMEOUT: 503,
}

_STATUS_TEXT = {200: "OK", 202: "Accepted", 400: "Bad Request",
                404: "Not Found", 405: "Method Not Allowed",
                408: "Request Timeout", 413: "Payload Too Large",
                429: "Too Many Requests",
                500: "Internal Server Error", 503: "Service Unavailable",
                504: "Gateway Timeout"}


@dataclass(frozen=True)
class RateLimitConfig:
    """Per-client token-bucket sizing for the submit paths. ``rps`` is
    the sustained refill rate (0 disables the limiter entirely);
    ``burst`` the bucket capacity — how many submits a quiet client may
    fire back-to-back. ``header`` names the client-id header; a request
    without it shares one anonymous bucket (anonymous traffic competes
    with itself, never with identified tenants). ``max_clients`` bounds
    the bucket table — the id is an UNTRUSTED string, and without a cap
    a peer minting fresh ids per request would grow the table without
    limit."""

    rps: float = 0.0
    burst: float = 10.0
    header: str = "x-client-id"
    max_clients: int = 4096


class _TokenBuckets:
    """The bucket table: lazily-refilled continuous token buckets keyed
    by client id. ``take`` returns 0.0 on admit (one token consumed) or
    the seconds until a token accrues (the Retry-After value). Stale
    entries (fully refilled = client gone quiet) are reclaimed when the
    table hits ``max_clients``; if every entry is active the OLDEST
    refill is dropped — an attacker minting ids can only evict its own
    churn, an active tenant's bucket refills on its next request at
    worst."""

    def __init__(self, cfg: RateLimitConfig, clock):
        self.cfg = cfg
        self.clock = clock
        self._b: Dict[str, Tuple[float, float]] = {}  # id -> (tokens, t)

    def take(self, client: str) -> float:
        now = self.clock()
        tokens, t = self._b.get(client, (self.cfg.burst, now))
        tokens = min(self.cfg.burst,
                     tokens + (now - t) * self.cfg.rps)
        if tokens >= 1.0:
            if client not in self._b and \
                    len(self._b) >= self.cfg.max_clients:
                self._evict(now)
            self._b[client] = (tokens - 1.0, now)
            return 0.0
        self._b[client] = (tokens, now)
        return (1.0 - tokens) / max(self.cfg.rps, 1e-9)

    def _evict(self, now: float) -> None:
        full = [k for k, (tok, t) in self._b.items()
                if tok + (now - t) * self.cfg.rps >= self.cfg.burst]
        if full:
            for k in full:
                del self._b[k]
            return
        del self._b[min(self._b, key=lambda k: self._b[k][1])]


def request_from_json(body: dict, default_id: str, clock,
                      vocab: int = 0) -> Tuple[Optional[Request],
                                               Optional[str]]:
    """Build a :class:`Request` from a submit body; (None, error) on a
    malformed one. Validation beyond shape (empty prompt, too-long
    prompt) is the Scheduler's job — the front door only refuses what
    it cannot even construct. ``vocab`` bounds the token ids (0 skips
    the check): this is the first untrusted boundary, and an
    out-of-range id would otherwise be silently clamped by the
    embedding gather into a 200 with garbage output."""
    prompt = body.get("prompt")
    if (not isinstance(prompt, list) or
            not all(isinstance(t, int) and not isinstance(t, bool)
                    and 0 <= t and (not vocab or t < vocab)
                    for t in prompt)):
        return None, ("prompt must be a list of token ids in "
                      f"[0, {vocab})" if vocab else
                      "prompt must be a list of non-negative token ids")
    rid = body.get("id", default_id)
    if not isinstance(rid, str) or not rid:
        return None, "id must be a non-empty string"
    try:
        deadline = None
        if body.get("deadline_s"):
            deadline = clock() + float(body["deadline_s"])
        req = Request(
            id=rid, prompt=np.asarray(prompt, np.int32),
            max_new_tokens=int(body.get("max_new_tokens", 16)),
            sampling=SamplingParams(
                temperature=float(body.get("temperature", 1.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 0.0)),
                greedy=bool(body.get("greedy", False))),
            deadline=deadline,
            rng_seed=int(body.get("rng_seed", 0)),
            eos_token_id=(None if body.get("eos_token_id") is None
                          else int(body["eos_token_id"])))
    except (TypeError, ValueError) as e:
        return None, f"bad request field: {e}"
    return req, None


class ServeApp:
    """The front door: one router, one asyncio server, one stepping task.

    ``step_wait_s`` bounds how long an SSE handler waits for the next
    step wakeup before re-checking terminal state (a safety net around
    missed wakeups, not a poll interval); ``idle_sleep_s`` is the
    stepping task's sleep when the fleet is idle. ``idle_timeout_s`` is the
    slow-loris budget: a peer that stalls mid-headers, mid-body, or
    mid-SSE-consumption is dropped after it (0 disables).
    ``supervisor`` (``faults.procsup.ProcSupervisor``, a multi-process
    fleet's) is ticked by the stepping task.
    """

    def __init__(self, router: Router, idle_sleep_s: float = 0.002,
                 step_wait_s: float = 0.5,
                 idle_timeout_s: float = 30.0, supervisor=None,
                 rate_limit: Optional[RateLimitConfig] = None):
        self.router = router
        self.supervisor = supervisor
        self.idle_sleep_s = idle_sleep_s
        self.step_wait_s = step_wait_s
        self.idle_timeout_s = idle_timeout_s
        self.rate_limit = rate_limit
        self._buckets = (_TokenBuckets(rate_limit, router.clock)
                         if rate_limit and rate_limit.rps > 0 else None)
        self._vocab: Optional[int] = None
        self._ids = itertools.count()
        self._running = False
        self._step_fut: Optional[asyncio.Future] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._stepper: Optional[asyncio.Future] = None
        #: ids whose client disconnected mid-stream: nobody will ever
        #: pop their terminal result, so the stepping task pops it the moment
        #: it surfaces (pop_result's no-unbounded-growth invariant)
        self._abandoned: set = set()

    # ------------------------------------------------------- stepping

    async def _step_loop(self) -> None:
        """Step the router whenever it has work; wake SSE streams after
        every step (they read the delivery ledger, not engine state)."""
        loop = asyncio.get_running_loop()
        self._step_fut = loop.create_future()
        while self._running:
            if self.router.idle:
                if self.supervisor is not None:
                    self.supervisor.tick()
                await asyncio.sleep(self.idle_sleep_s)
                continue
            self.router.step()
            if self.supervisor is not None:
                self.supervisor.tick()
            for rid in [r for r in self._abandoned
                        if not self.router.knows(r)
                        or self.router.result(r) is not None]:
                self.router.pop_result(rid)
                self._abandoned.discard(rid)
            fut, self._step_fut = self._step_fut, loop.create_future()
            fut.set_result(None)
            await asyncio.sleep(0)         # let handlers consume

    async def _next_step(self) -> None:
        fut = self._step_fut
        if fut is None:
            await asyncio.sleep(self.idle_sleep_s)
            return
        try:
            await asyncio.wait_for(asyncio.shield(fut),
                                   timeout=self.step_wait_s)
        except asyncio.TimeoutError:
            pass

    # ------------------------------------------------------------- server

    async def start(self, host: str = "127.0.0.1", port: int = 0,
                    warm: bool = True) -> Tuple[str, int]:
        """Warm the replicas (``warm``: ``Router.warmup``, which on the
        card builds the kernels; otherwise the first step's build would
        block the loop and read as a wedge), then bind and start serving;
        returns the bound (host, port) (port 0 = ephemeral). Until the
        replicas are warm, ``/readyz`` answers 503."""
        if warm:
            self.router.warmup()
        self._running = True
        self._server = await asyncio.start_server(self._handle, host,
                                                  port)
        self._stepper = asyncio.ensure_future(self._step_loop())
        self._stepper.add_done_callback(self._on_stepper_done)
        sock = self._server.sockets[0].getsockname()
        return sock[0], sock[1]

    def _on_stepper_done(self, fut: asyncio.Future) -> None:
        """A dead stepping task is a dead server: without this callback an
        exception from ``router.step()`` sits in the never-awaited
        future while the server keeps accepting connections that can
        never complete. Surface it loudly and fail every waiter."""
        if fut.cancelled():
            return
        exc = fut.exception()
        if exc is None:
            return
        self._running = False
        print("serve stepping task died; shutting down:", file=sys.stderr)
        traceback.print_exception(type(exc), exc, exc.__traceback__,
                                  file=sys.stderr)
        # wake every SSE handler blocked on the next step with the
        # failure (they fail their connection instead of spinning on
        # the step_wait_s timeout forever)
        if self._step_fut is not None and not self._step_fut.done():
            self._step_fut.set_exception(exc)
        if self._server is not None:
            self._server.close()

    async def stop(self) -> None:
        self._running = False
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        try:
            if self._stepper is not None:
                self._stepper.cancel()
                try:
                    await self._stepper
                except asyncio.CancelledError:
                    pass
        finally:
            # a stepping task that died re-raises above — the journals still
            # close
            self.router.close()

    async def serve_forever(self, host: str, port: int) -> None:
        h, p = await self.start(host, port)
        print(f"serving on http://{h}:{p} "
              f"({len(self.router.replicas)} replica(s))",
              file=sys.stderr, flush=True)
        async with self._server:
            await self._server.serve_forever()

    # ----------------------------------------------------------- handlers

    async def _read_request(self, reader: asyncio.StreamReader):
        """Read one request (start line + headers + body); None on an
        unparseable start line. Raises ValueError on malformed framing,
        IncompleteReadError/ConnectionError on a vanished peer."""
        line = await reader.readline()
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or 0)
        body = b""
        if n:
            body = await reader.readexactly(n)
        return method, path, body, headers

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                # the slow-loris budget: a peer must DELIVER a complete
                # request within idle_timeout_s or lose the connection —
                # half-sent headers / a stalled body must not pin this
                # handler task forever
                req = await asyncio.wait_for(
                    self._read_request(reader),
                    self.idle_timeout_s or None)
            except asyncio.TimeoutError:
                await self._json(writer, 408,
                                 {"error": "request idle timeout"})
                return
            except ValueError:
                # a request/header line over the StreamReader limit
                # (readline raises ValueError) or a non-numeric
                # Content-Length — answer 400, don't drop the socket
                await self._json(writer, 400,
                                 {"error": "malformed request"})
                return
            if req is None:
                return
            method, path, body, headers = req
            await self._dispatch(method, path.split("?", 1)[0], body,
                                 writer, headers)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _dispatch(self, method: str, path: str, body: bytes,
                        writer: asyncio.StreamWriter,
                        headers: Optional[dict] = None) -> None:
        if (self._buckets is not None and method == "POST"
                and path in ("/v1/submit", "/v1/generate")):
            client = (headers or {}).get(self.rate_limit.header,
                                         "") or "anonymous"
            wait_s = self._buckets.take(client)
            if wait_s > 0:
                self.router.metrics.inc("http_rate_limited")
                await self._json(
                    writer, 429,
                    {"error": "rate limited",
                     "client": client,
                     "retry_after_s": round(wait_s, 3)},
                    extra_headers={"Retry-After":
                                   str(max(1, math.ceil(wait_s)))})
                return
        if path == "/healthz" and method == "GET":
            # liveness: answering at all IS the signal — always 200
            await self._json(writer, 200, self.router.healthz())
        elif path == "/readyz" and method == "GET":
            r = self.router.readyz()
            await self._json(writer, 200 if r["ok"] else 503, r)
        elif path in ("/metrics", "/v1/metrics") and method == "GET":
            text = prometheus_text(self.router.metrics,
                                   prefix="tpu_gpt_fleet")
            await self._raw(writer, 200, text.encode(),
                            "text/plain; version=0.0.4")
        elif path == "/v1/submit" and method == "POST":
            rid, err = self._submit(body)
            if err is not None:
                await self._json(writer, err[0], {"error": err[1]})
            else:
                await self._json(writer, 200,
                                 {"id": rid, "status": "accepted"})
        elif path == "/v1/generate" and method == "POST":
            rid, err = self._submit(body)
            if err is not None:
                await self._json(writer, err[0], {"error": err[1]})
            else:
                await self._stream(rid, writer)
        elif path.startswith("/v1/stream/") and method == "GET":
            rid = path[len("/v1/stream/"):]
            if (not self.router.knows(rid)):
                await self._json(writer, 404, {"error": "unknown id"})
            else:
                await self._stream(rid, writer)
        elif path.startswith("/v1/cancel/") and method == "POST":
            rid = path[len("/v1/cancel/"):]
            await self._json(writer, 200,
                             {"id": rid,
                              "cancelled": self.router.cancel(rid)})
        elif path.startswith("/v1/result/") and method == "GET":
            rid = path[len("/v1/result/"):]
            res = self.router.result(rid)
            if res is not None:
                self.router.pop_result(rid)
                await self._json(writer, 200,
                                 {**res.to_dict(), "tokens": res.tokens})
            elif self.router.knows(rid):
                await self._json(writer, 202, {"id": rid,
                                               "status": "running"})
            else:
                await self._json(writer, 404, {"error": "unknown id"})
        else:
            await self._json(writer, 404 if method in ("GET", "POST")
                             else 405, {"error": f"no route {method} "
                                                 f"{path}"})

    def _vocab_size(self) -> int:
        """The token-id bound of ingress validation: the replicas'
        vocabulary (a worker's from its health RPC, once; 0, which skips
        the check, only while no worker was ever reachable)."""
        if self._vocab:
            return self._vocab
        for rep in self.router.replicas:
            if rep.is_local:
                self._vocab = int(rep.engine.cfg.vocab_size)
                return self._vocab
            try:
                # a short budget: this runs in a submit handler on the
                # loop, and a hung worker must not stall every connection
                self._vocab = int(rep.refresh_health(timeout_s=1.0)
                                  .get("vocab_size", 0))
                if self._vocab:
                    return self._vocab
            except Exception:  # noqa: BLE001 — an unreachable worker:
                continue       # try the next, or skip the check
        return 0

    def _submit(self, body: bytes):
        """Parse + route one submit; returns (id, None) or
        (None, (status, message))."""
        try:
            doc = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            return None, (400, "body is not valid JSON")
        if not isinstance(doc, dict):
            return None, (400, "body must be a JSON object")
        req, perr = request_from_json(
            doc, f"h{next(self._ids):06d}", self.router.clock,
            vocab=self._vocab_size())
        if req is None:
            return None, (400, perr)
        rej = self.router.submit(req)
        if rej is not None:
            status = REASON_STATUS.get(rej.finish_reason, 400)
            return None, (status, rej.finish_reason)
        return req.id, None

    def _emit_new_tokens(self, rid: str,
                         writer: asyncio.StreamWriter, i: int) -> int:
        """Drain the delivery ledger into SSE events; returns the next
        event index."""
        for t in self.router.take_new_tokens(rid):
            writer.write(f"data: {json.dumps({'token': t, 'i': i})}"
                         f"\n\n".encode())
            i += 1
        return i

    async def _drain_sse(self, writer: asyncio.StreamWriter) -> None:
        """drain() with the idle budget: an SSE consumer that stopped
        reading (buffer past the high-water mark, drain suspended
        forever) is indistinguishable from a vanished one — treat it
        as one instead of pinning the handler and the send buffer."""
        try:
            await asyncio.wait_for(writer.drain(),
                                   self.idle_timeout_s or None)
        except asyncio.TimeoutError:
            raise ConnectionError("SSE consumer stalled past the idle "
                                  "budget") from None

    async def _stream(self, rid: str,
                      writer: asyncio.StreamWriter) -> None:
        """SSE token stream through the router's exactly-once delivery
        ledger; a client disconnect mid-stream cancels the request —
        its slot and KV pages free immediately, not at completion."""
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        i = 0
        try:
            await self._drain_sse(writer)
            while True:
                i = self._emit_new_tokens(rid, writer, i)
                await self._drain_sse(writer)
                res = self.router.result(rid)
                if res is not None:
                    # final ledger drain: the request may have finished
                    # (with more tokens) while we were suspended in
                    # drain() above — those must go out before `done`
                    i = self._emit_new_tokens(rid, writer, i)
                    done = {"finish_reason": res.finish_reason,
                            "n_tokens": len(res.tokens),
                            "ttft_s": round(res.ttft_s, 6),
                            "total_s": round(res.total_s, 6)}
                    writer.write(f"event: done\ndata: "
                                 f"{json.dumps(done)}\n\n".encode())
                    await self._drain_sse(writer)
                    self.router.pop_result(rid)
                    return
                if not self.router.knows(rid):
                    writer.write(b"event: error\ndata: "
                                 b"{\"error\": \"request lost\"}\n\n")
                    await self._drain_sse(writer)
                    return
                await self._next_step()
        except (ConnectionError, OSError):
            # client went away mid-stream: release the slot/pages NOW,
            # and hand the id to the stepping task's abandoned sweep — the
            # cancelled (or already-terminal) result must still be
            # popped or the results/ledger maps grow per disconnect
            if self.router.pop_result(rid) is None:
                self.router.cancel(rid)
                self._abandoned.add(rid)

    async def _json(self, writer, status: int, obj: dict,
                    extra_headers: Optional[dict] = None) -> None:
        await self._raw(writer, status,
                        (json.dumps(obj) + "\n").encode(),
                        "application/json", extra_headers)

    async def _raw(self, writer, status: int, payload: bytes,
                   ctype: str,
                   extra_headers: Optional[dict] = None) -> None:
        extra = "".join(f"{k}: {v}\r\n"
                        for k, v in (extra_headers or {}).items())
        writer.write(
            f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, '')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"{extra}"
            f"Connection: close\r\n\r\n".encode())
        writer.write(payload)
        await writer.drain()
