"""Length-prefixed JSON RPC between the router and its worker processes
(a copy of ``replicatinggpt_tpu/serve/rpc.py``: the same frames, codecs
and protocol version, so that either package's client can drive either
package's worker socket).

A worker process (serve/worker.py) owns one engine and speaks this
protocol over a socket; the router holds one :class:`RpcClient` a worker
and drives it with the verbs of the in-process host API.

Framing: a message is an 8-byte header (4-byte big-endian length, 4-byte
big-endian CRC32 of the body) and that many bytes of UTF-8 JSON. A
flipped bit anywhere in the body fails the CRC on the far side and
surfaces as a typed :class:`RpcProtocolError`, never as a mis-decoded
result. Requests are ``{"op": <verb>, ...args}``; responses ``{"ok":
true, ...result}`` or ``{"ok": false, "error": msg}``. Standard library
only.

Two envelope keys ride outside the verb's payload: ``idem``, an
idempotency key on mutating verbs (the worker answers a duplicated or
retried frame from a bounded reply cache, marked ``idem_hit: true``,
instead of executing it again), and ``gen``, the generation fence (a
worker refuses a call stamped with another incarnation's generation with
a "stale generation" protocol error).

Verbs (dispatched in serve/worker.py): ``register`` (sent by the worker
to the supervisor's :class:`RpcListener` once it is warm, replayed and
bound: ``{port, pid, gen, replayed, worker_idx, proto, shape_hash,
...}``; the protocol version and :func:`engine_shape_hash` are checked
there, so a mismatched build is refused before it takes traffic),
``submit``, ``step`` (one engine iteration; the reply carries every
finished result not yet acknowledged, redelivered until the router acks
it, the committed tokens of every active slot, and the gauges),
``stream_drain``, ``cancel`` (``migrated`` journals a finish, so that the
worker's replay never resurrects the id), ``drain`` (refuse submits,
cancel everything in flight as migrated: a rolling restart), ``health``,
``prefix``, ``journal_drain`` (the worker's journal state in bounded
frames: the journal never leaves the worker's disk, its content crosses
the socket), ``summary`` and ``shutdown``. ``page_transfer``, the
disaggregation verb, is answered ``ok: false`` (ROADMAP.md queue A item
9(e)).

Failure model of the client: a socket timeout raises :class:`RpcTimeout`
(the worker may still execute the call: a SIGSTOPped process looks like
this), a connection that dies between frames :class:`RpcDown`, and a
broken stream (a checksum mismatch, a close mid-frame, a generation
fence) :class:`RpcProtocolError`. All three close the connection; the
next call reconnects.
"""

from __future__ import annotations

import json
import socket
import time
import zlib
from typing import Callable, Optional, Tuple

import numpy as np

# REJECT_REPLICA_DOWN is re-exported: the JAX package defines it here
from .requests import (REJECT_REPLICA_DOWN, Request,  # noqa: F401
                       RequestResult, SamplingParams)

#: a corrupt length prefix must not allocate gigabytes
MAX_FRAME = 16 << 20

#: the wire protocol's version, checked at registration (2: the
#: checksummed frames and the ``idem``/``gen`` envelope keys)
PROTO_VERSION = 2

#: frame header: 4-byte big-endian length, 4-byte big-endian CRC32
HEADER_BYTES = 8

#: journal_drain's records a frame
JOURNAL_DRAIN_LIMIT = 256

#: the ROADMAP.md item disaggregation (page transfers, tiers) waits for
DISAGG_ITEM = "queue A item 9(e) (disaggregation)"


class RpcError(Exception):
    """The worker answered ok=false (an application error)."""


class RpcTimeout(RpcError):
    """No response within the timeout: the worker may be hung and may
    still execute the call."""


class RpcDown(RpcError):
    """Connection refused, reset or closed: the worker process is gone."""


class RpcProtocolError(RpcError):
    """The protocol was violated: at registration, a protocol version or
    engine shape that does not match the fleet's (the worker must exit,
    not retry); on the data plane, a broken stream (checksum mismatch, a
    close mid-frame, a generation fence). The router reconnects and
    retries once with the same idempotency key."""


def engine_shape_hash(mcfg, ecfg) -> str:
    """Fingerprint of what must agree between the fleet's expectation and
    a worker's engine: the whole model configuration and the engine knobs
    that size the pool, pages and window. Two builds with the same hash
    give token-identical streams for the same request.

    The JAX package's document with ``"backend": "torch"`` added: this
    port's bf16 streams are not bit-identical to the JAX package's (the
    kernels and their summation orders differ), so a worker of one
    package never registers into a fleet of the other. The weight and
    activation quantization knobs, which this port does not implement
    (ROADMAP.md queue A item 8), hash as "none"."""
    import dataclasses
    import hashlib
    doc = {
        "backend": "torch",
        "proto": PROTO_VERSION,
        "model": {k: str(v) for k, v in
                  sorted(dataclasses.asdict(mcfg).items())},
        "engine": {k: str(getattr(ecfg, k, "none")) for k in
                   ("pool_size", "max_queue", "prefill_chunk",
                    "page_size", "max_pages", "n_pages", "prefix_cache",
                    "decode_window", "mesh_data", "mesh_model",
                    "kv_quant", "weight_quant", "quant_granularity",
                    "act_quant")},
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]


# --------------------------------------------------------------- framing

def encode_frame(obj: dict) -> bytes:
    data = json.dumps(obj).encode()
    if len(data) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(data)} bytes")
    crc = zlib.crc32(data) & 0xFFFFFFFF
    return len(data).to_bytes(4, "big") + crc.to_bytes(4, "big") + data


def decode_header(header: bytes) -> Tuple[int, int]:
    """(body length, expected CRC32) of an 8-byte frame header; a length
    past :data:`MAX_FRAME` raises."""
    n = int.from_bytes(header[:4], "big")
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n} bytes")
    return n, int.from_bytes(header[4:HEADER_BYTES], "big")


def crc_ok(body: bytes, crc: int) -> bool:
    return (zlib.crc32(body) & 0xFFFFFFFF) == crc


# ---------------------------------------------------------- wire codecs

def request_to_wire(req: Request, now: float) -> dict:
    """Request -> JSON-safe dict (the JAX package's document). A deadline
    crosses the process boundary as remaining seconds: an absolute time
    on the router's clock means nothing on the worker's."""
    sp = req.sampling
    return {
        "id": req.id,
        "prompt": np.asarray(req.prompt).tolist(),
        "max_new_tokens": int(req.max_new_tokens),
        "rng_seed": int(req.rng_seed),
        "temperature": float(sp.temperature), "top_k": int(sp.top_k),
        "top_p": float(sp.top_p), "greedy": bool(sp.greedy),
        "deadline_rel": (None if req.deadline is None
                         else max(req.deadline - now, 0.0)),
        "eos_token_id": (None if req.eos_token_id is None
                         else int(req.eos_token_id)),
        # disaggregation's prefill-only requests are not in this port
        "prefill_only": False,
    }


def request_from_wire(doc: dict, now: float) -> Request:
    if doc.get("prefill_only"):
        raise ValueError(f"prefill_only requests are not implemented in "
                         f"replicatinggpt_tpu_torch yet: ROADMAP.md "
                         f"{DISAGG_ITEM}")
    deadline = None
    if doc.get("deadline_rel") is not None:
        deadline = now + float(doc["deadline_rel"])
    return Request(
        id=doc["id"], prompt=np.asarray(doc["prompt"], np.int32),
        max_new_tokens=int(doc["max_new_tokens"]),
        sampling=SamplingParams(
            temperature=float(doc["temperature"]),
            top_k=int(doc["top_k"]), top_p=float(doc["top_p"]),
            greedy=bool(doc["greedy"])),
        deadline=deadline, rng_seed=int(doc["rng_seed"]),
        eos_token_id=(None if doc.get("eos_token_id") is None
                      else int(doc["eos_token_id"])))


def result_to_wire(res: RequestResult) -> dict:
    return {
        "id": res.id, "tokens": list(res.tokens),
        "finish_reason": res.finish_reason,
        "queue_wait_s": res.queue_wait_s, "ttft_s": res.ttft_s,
        "decode_tokens_per_s": res.decode_tokens_per_s,
        "total_s": res.total_s,
    }


def result_from_wire(doc: dict) -> RequestResult:
    return RequestResult(
        id=doc["id"], tokens=list(doc["tokens"]),
        finish_reason=doc["finish_reason"],
        queue_wait_s=float(doc.get("queue_wait_s", 0.0)),
        ttft_s=float(doc.get("ttft_s", 0.0)),
        decode_tokens_per_s=float(doc.get("decode_tokens_per_s", 0.0)),
        total_s=float(doc.get("total_s", 0.0)))


# ---------------------------------------------------------- sync client

def _recv_exact(sock: socket.socket, n: int, mid_frame: bool = False
                ) -> bytes:
    """Read exactly ``n`` bytes. A clean close at a frame boundary is
    :class:`RpcDown`; a close inside a header or a body is
    :class:`RpcProtocolError` (the bytes in flight are lost)."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if buf or mid_frame:
                raise RpcProtocolError(f"connection closed mid-frame "
                                       f"({len(buf)}/{n} bytes)")
            raise RpcDown("connection closed")
        buf += chunk
    return buf


class RpcClient:
    """Blocking single-connection client (the router and the supervisor
    are single-threaded loops: one call in flight at a time). Connects
    lazily; a timeout or a failure closes the socket, so the next call
    starts clean and a half-read reply is never taken for the next
    call's. ``last_frame_bytes`` is the size of the last reply frame."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self.last_frame_bytes = 0
        #: chaos seams (faults/netchaos.py): a transform of the encoded
        #: request frame (corruption), and ``(chunk_bytes, pause_s)``
        #: pacing (a trickle). Both None outside a chaos run.
        self.frame_filter: Optional[Callable[[bytes], bytes]] = None
        self.send_chunking: Optional[Tuple[int, float]] = None

    def connect(self) -> None:
        if self._sock is not None:
            return
        try:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                  1)
        except OSError as e:
            self._sock = None
            raise RpcDown(f"connect {self.host}:{self.port}: {e}") from e

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _send_frame(self, frame: bytes) -> None:
        if self.frame_filter is not None:
            frame = self.frame_filter(frame)
        if self.send_chunking is None:
            self._sock.sendall(frame)
            return
        chunk, pause = self.send_chunking
        for i in range(0, len(frame), chunk):
            self._sock.sendall(frame[i:i + chunk])
            time.sleep(pause)      # the trickle is the injected fault

    def call(self, op: str, timeout_s: Optional[float] = None,
             **kwargs) -> dict:
        """One request/response exchange; returns the reply dict. Raises
        RpcTimeout / RpcDown / RpcProtocolError / RpcError."""
        self.connect()
        self._sock.settimeout(timeout_s if timeout_s is not None
                              else self.timeout_s)
        try:
            self._send_frame(encode_frame({"op": op, **kwargs}))
            n, crc = decode_header(_recv_exact(self._sock, HEADER_BYTES))
            body = _recv_exact(self._sock, n, mid_frame=True)
        except socket.timeout as e:
            self.close()
            raise RpcTimeout(f"{op}: no response") from e
        except (RpcProtocolError, RpcDown):
            self.close()
            raise
        except (OSError, ValueError) as e:
            self.close()
            raise RpcDown(f"{op}: {e}") from e
        self.last_frame_bytes = HEADER_BYTES + n
        if not crc_ok(body, crc):
            # never decode a corrupt reply: a flipped bit in a token list
            # would be a silent wrong answer
            self.close()
            raise RpcProtocolError(f"{op}: response frame checksum "
                                   f"mismatch")
        try:
            doc = json.loads(body)
        except ValueError as e:
            self.close()
            raise RpcDown(f"{op}: undecodable response: {e}") from e
        if not doc.get("ok"):
            if doc.get("kind") == "protocol":
                self.close()
                raise RpcProtocolError(doc.get("error", "protocol mismatch"))
            raise RpcError(doc.get("error", "unknown worker error"))
        return doc


# --------------------------------------------------------- async server

async def serve_connection(reader, writer, dispatch) -> None:
    """One worker-side connection: read a frame, dispatch it, write the
    reply, until the peer goes away. ``dispatch`` is a synchronous
    ``(doc) -> dict`` run on the event loop, the worker's one thread. A
    dispatch exception becomes an ok=false reply (typed ``protocol`` for
    :class:`RpcProtocolError`); a transport error ends the connection."""
    import asyncio
    try:
        while True:
            try:
                header = await reader.readexactly(HEADER_BYTES)
                n, crc = decode_header(header)
                body = await reader.readexactly(n)
            except (asyncio.IncompleteReadError, ConnectionError,
                    ValueError):
                return
            if not crc_ok(body, crc):
                # answer typed (the client's retry path needs to know),
                # then drop the connection: its stream cannot be trusted
                try:
                    writer.write(encode_frame(
                        {"ok": False, "kind": "protocol",
                         "error": "request frame checksum mismatch"}))
                    await writer.drain()
                except (ConnectionError, OSError):
                    pass
                return
            try:
                doc = json.loads(body)
                resp = {"ok": True, **(dispatch(doc) or {})}
            except SystemExit:
                raise
            except Exception as e:  # noqa: BLE001 — the process boundary:
                # a failed dispatch is a framed error, never a dropped
                # socket the router would read as a death
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                if isinstance(e, RpcProtocolError):
                    resp["kind"] = "protocol"
            try:
                writer.write(encode_frame(resp))
                await writer.drain()
            except (ConnectionError, OSError):
                return
    finally:
        try:
            writer.close()
        except (ConnectionError, OSError):
            pass


# ------------------------------------------------------ poll listener

class RpcListener:
    """Poll-driven frame endpoint of the fleet's registration channel.

    The supervisor's loop is single-threaded (ticked from the router's
    driver), so the endpoint is polled, not awaited: :meth:`poll` accepts
    the pending connections, reads one frame from each, answers with the
    handler's reply and returns. The handler gets ``(doc, peer_host)``;
    raising :class:`RpcProtocolError` answers ``kind="protocol"``, so the
    worker exits instead of retrying."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 read_timeout_s: float = 2.0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self._sock.setblocking(False)
        self.read_timeout_s = read_timeout_s

    @property
    def addr(self) -> str:
        h, p = self._sock.getsockname()
        return f"{h}:{p}"

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def poll(self, handler) -> int:
        """Serve every pending connection one request/response frame;
        returns how many were handled. Blocks at most ``read_timeout_s``
        a ready connection; a transport failure drops that one only."""
        handled = 0
        while True:
            try:
                conn, peer = self._sock.accept()
            except OSError:         # BlockingIOError included: none left
                return handled
            try:
                conn.settimeout(self.read_timeout_s)
                n, crc = decode_header(_recv_exact(conn, HEADER_BYTES))
                body = _recv_exact(conn, n, mid_frame=True)
                if not crc_ok(body, crc):
                    conn.sendall(encode_frame(
                        {"ok": False, "kind": "protocol",
                         "error": "request frame checksum mismatch"}))
                    continue
                doc = json.loads(body)
                try:
                    resp = {"ok": True, **(handler(doc, peer[0]) or {})}
                except RpcProtocolError as e:
                    resp = {"ok": False, "kind": "protocol",
                            "error": str(e)}
                except Exception as e:  # noqa: BLE001 — as in
                    # serve_connection: a handler failure frames an error
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                conn.sendall(encode_frame(resp))
            except (OSError, ValueError, RpcError):
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
            handled += 1
