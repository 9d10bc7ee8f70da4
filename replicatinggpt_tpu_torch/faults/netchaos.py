"""Network chaos: deterministic message faults on the fleet's RPC (the port
of ``replicatinggpt_tpu/faults/netchaos.py``).

faults/fleet.py kills, wedges or stops a process; this module hurts a
message. A :class:`FaultyTransport` wraps the router's
:class:`~..serve.rpc.RpcClient` and asks the installed
:class:`~.inject.FaultPlan` before every call. No-op by default (one
module-global read a call), deterministic (a per-link, per-verb call
ordinal, never a wall-clock race), and an injected fault looks like a
real one (a dropped frame raises the :class:`~..serve.rpc.RpcTimeout` a
SIGSTOPped worker gives).

Sites are ``net/{src}->{dst}/{verb}``, e.g. ``net/router->worker1/submit``.
:func:`net_call_fault` tries the spellings most specific first: one verb
on one link, every verb on a link (``net/router->worker1/*``), one verb
fleet-wide (``net/*->*/submit``), everything (:data:`NET_CALL`). The
index is always the transport's own per-verb ordinal on that link.

==================  =====================================================
kind                effect at the transport
==================  =====================================================
``net_delay``       sleep ``arg`` seconds, then send
``net_drop``        nothing is sent; the caller sees :class:`RpcTimeout`
``net_dup``         the frame is sent twice with one idempotency key; the
                    caller gets the second reply (the cached one); calls
                    without an ``idem`` key are sent once
``net_reorder``     the link's previous idempotent frame is re-sent first
                    (a stale duplicate arriving late), its reply given to
                    the observer; then the call proceeds
``net_trickle``     the frame drips onto the wire in ``arg``-byte chunks,
                    ``arg2`` seconds apart
``net_corrupt``     one seeded byte of the frame's body is flipped; the far
                    side's checksum refuses it with a typed protocol error
``net_partition``   ``arg2 == 0``: two-way, :class:`RpcDown` without
                    touching the wire; ``arg2 == 1``: one-way, the request
                    executes and its reply is lost (:class:`RpcTimeout`).
                    ``times`` is the width in calls; the first clean call
                    after it is the heal
==================  =====================================================

The ``observer`` (the router's ``RemoteReplica``) hears
``net_chaos_response(resp)`` for replies the chaos layer swallowed, and
``net_chaos_partition(active)`` on a partition's edges.
``dups_injected`` counts the duplicate frames this transport put on the
wire.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from .inject import Fault, active


def _rpc():
    """serve/rpc.py, imported at first use: the serve package imports this
    module (the router wraps its clients), so a module-level import would
    be circular."""
    from ..serve import rpc
    return rpc

#: the catch-all site: every verb on every link (tried last)
NET_CALL = "net/call"

KIND_NET_DELAY = "net_delay"
KIND_NET_DROP = "net_drop"
KIND_NET_DUP = "net_dup"
KIND_NET_REORDER = "net_reorder"
KIND_NET_TRICKLE = "net_trickle"
KIND_NET_CORRUPT = "net_corrupt"
KIND_NET_PARTITION = "net_partition"

NET_KINDS = (KIND_NET_DELAY, KIND_NET_DROP, KIND_NET_DUP,
             KIND_NET_REORDER, KIND_NET_TRICKLE, KIND_NET_CORRUPT,
             KIND_NET_PARTITION)


def net_site(src: str, dst: str, verb: str) -> str:
    """The site string of one (link, verb)."""
    return f"net/{src}->{dst}/{verb}"


def net_call_fault(src: str, dst: str, verb: str,
                   index: int) -> Optional[Fault]:
    """The installed plan's fault for this call, trying the site's
    spellings most specific first, each at the same per-link, per-verb
    ordinal."""
    plan = active()
    if plan is None:
        return None
    for site in (net_site(src, dst, verb), net_site(src, dst, "*"),
                 net_site("*", "*", verb), NET_CALL):
        f = plan.fire(site, index=index)
        if f is not None:
            return f
    return None


class FaultyTransport:
    """Chaos wrapper with the :class:`~..serve.rpc.RpcClient` call
    surface, always around the router's clients: with no plan installed,
    :meth:`call` is one global read and a straight delegate."""

    def __init__(self, client, src: str, dst: str, observer=None):
        self.client = client
        self.src = src
        self.dst = dst
        self.observer = observer
        self.dups_injected = 0
        self.partitioned = False
        self._counts: Dict[str, int] = {}
        #: (op, timeout_s, kwargs) of the last idem-carrying call: the
        #: frame ``net_reorder`` replays
        self._last_idem: Optional[Tuple[str, Optional[float], dict]] = None

    @property
    def host(self):
        return self.client.host

    @property
    def port(self):
        return self.client.port

    @property
    def timeout_s(self):
        return self.client.timeout_s

    @property
    def last_frame_bytes(self) -> int:
        return self.client.last_frame_bytes

    def connect(self) -> None:
        self.client.connect()

    def close(self) -> None:
        self.client.close()

    def call(self, op: str, timeout_s: Optional[float] = None,
             **kwargs) -> dict:
        if active() is None:
            return self.client.call(op, timeout_s=timeout_s, **kwargs)
        idx = self._counts.get(op, 0)
        self._counts[op] = idx + 1
        f = net_call_fault(self.src, self.dst, op, idx)
        if f is not None and f.kind == KIND_NET_PARTITION:
            return self._partitioned_call(f, op, timeout_s, kwargs)
        if self.partitioned:
            self._set_partitioned(False)   # the first clean call heals
        if f is None:
            return self._send(op, timeout_s, kwargs)
        if f.kind == KIND_NET_DELAY:
            time.sleep(f.arg or 0.05)      # the delay is the fault
            return self._send(op, timeout_s, kwargs)
        if f.kind == KIND_NET_DROP:
            # the caller cannot know whether the worker executed: the
            # maybe-executed failure, not the definitely-dead one
            self.client.close()
            raise _rpc().RpcTimeout(f"{op}: frame dropped (chaos)")
        if f.kind == KIND_NET_DUP:
            return self._dup(op, timeout_s, kwargs)
        if f.kind == KIND_NET_REORDER:
            self._reorder()
            return self._send(op, timeout_s, kwargs)
        if f.kind == KIND_NET_TRICKLE:
            return self._trickle(f, op, timeout_s, kwargs)
        if f.kind == KIND_NET_CORRUPT:
            return self._corrupt(op, timeout_s, kwargs)
        raise ValueError(f"unknown net fault kind {f.kind!r}")

    def _send(self, op: str, timeout_s: Optional[float],
              kwargs: dict) -> dict:
        if "idem" in kwargs:
            self._last_idem = (op, timeout_s, dict(kwargs))
        return self.client.call(op, timeout_s=timeout_s, **kwargs)

    def _dup(self, op: str, timeout_s: Optional[float],
             kwargs: dict) -> dict:
        if "idem" not in kwargs:
            return self._send(op, timeout_s, kwargs)
        self._send(op, timeout_s, kwargs)
        self.dups_injected += 1
        return self.client.call(op, timeout_s=timeout_s, **kwargs)

    def _reorder(self) -> None:
        if self._last_idem is None:
            return
        prev_op, prev_to, prev_kw = self._last_idem
        try:
            stale = self.client.call(prev_op, timeout_s=prev_to, **prev_kw)
        except _rpc().RpcError:
            return                  # the stale frame died on the way
        self.dups_injected += 1
        self._observe_response(stale)

    def _trickle(self, f: Fault, op: str, timeout_s: Optional[float],
                 kwargs: dict) -> dict:
        self.client.send_chunking = (max(int(f.arg), 1),
                                     float(f.arg2) or 0.002)
        try:
            return self._send(op, timeout_s, kwargs)
        finally:
            self.client.send_chunking = None

    def _corrupt(self, op: str, timeout_s: Optional[float],
                 kwargs: dict) -> dict:
        """Flip one seeded byte of the frame's body (never the length
        prefix: the checksum exists to catch a corrupt body)."""
        plan = active()
        rng = (plan.rng(net_site(self.src, self.dst, op))
               if plan is not None else None)

        header = _rpc().HEADER_BYTES

        def flip(frame: bytes) -> bytes:
            if len(frame) <= header:
                return frame
            off = header + (int(rng.integers(0, len(frame) - header))
                            if rng is not None else 0)
            return frame[:off] + bytes([frame[off] ^ 0xFF]) + frame[off + 1:]

        self.client.frame_filter = flip
        try:
            return self._send(op, timeout_s, kwargs)
        finally:
            self.client.frame_filter = None

    def _partitioned_call(self, f: Fault, op: str,
                          timeout_s: Optional[float], kwargs: dict) -> dict:
        self._set_partitioned(True)
        if int(f.arg2) == 0:
            self.client.close()
            raise _rpc().RpcDown(f"{op}: partitioned (chaos)")
        try:
            resp = self._send(op, timeout_s, kwargs)
        except _rpc().RpcError:
            pass
        else:
            self._observe_response(resp)
        self.client.close()
        raise _rpc().RpcTimeout(f"{op}: response lost to one-way partition "
                                f"(chaos)")

    def _observe_response(self, resp: dict) -> None:
        cb = getattr(self.observer, "net_chaos_response", None)
        if cb is not None:
            cb(resp)

    def _set_partitioned(self, now_active: bool) -> None:
        if self.partitioned == now_active:
            return
        self.partitioned = now_active
        cb = getattr(self.observer, "net_chaos_partition", None)
        if cb is not None:
            cb(now_active)
