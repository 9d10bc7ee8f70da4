"""The port's out-of-process fleet (serve/rpc.py, serve/worker.py,
faults/procsup.py, faults/netchaos.py, the router's remote half) against
the JAX package's, on the CPU.

(a) frames, their checks and the request and result wire documents equal
JAX's; (b) a port ``WorkerServer`` and a JAX one, each over the same plain
Python engine, answer the same documents alike (pid and clock fields
aside); (c) each package's ``RpcClient`` drives the other's worker socket;
(d) ``FaultyTransport`` gives JAX's outcomes for the same ``FaultPlan``,
and the re-registration backoff JAX's delays from the same generator;
(e) the supervisor's restart budget, registration, autoscaler and
host-loss mechanics, and ``load_step``, as JAX's tests pin them; (f) the
engine shape hash; (g) two ``serve-worker`` subprocesses at test-tiny on
a port checkpoint of the JAX ``init_params``: greedy streams equal to the
JAX engine's, unchanged and delivered once across a SIGKILL, the worker
restarted and its journal replayed. The JAX soaks, marked slow there, are
ported marked slow.
"""

import asyncio
import dataclasses
import json
import os
import random
import signal
import sys
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.faults import Fault as JFault
from replicatinggpt_tpu.faults import FaultPlan as JFaultPlan
from replicatinggpt_tpu.faults import installed as jinstalled
from replicatinggpt_tpu.faults import netchaos as jnet
from replicatinggpt_tpu.serve import requests as jreq
from replicatinggpt_tpu.serve import rpc as jrpc
from replicatinggpt_tpu.serve import worker as jworker
from replicatinggpt_tpu_torch.config import get_config
from replicatinggpt_tpu_torch.faults import Fault, FaultPlan, installed
from replicatinggpt_tpu_torch.faults import netchaos
from replicatinggpt_tpu_torch.faults.fleet import (FLEET_STEP,
                                                   KIND_HOST_LOSS,
                                                   KIND_PROC_HANG,
                                                   KIND_PROC_KILL)
from replicatinggpt_tpu_torch.faults.procsup import (AutoscaleConfig, BACKOFF,
                                                     QUARANTINED, RETIRED,
                                                     RUNNING, SPAWNING,
                                                     ProcSupervisor,
                                                     SupervisorConfig,
                                                     WorkerSpec,
                                                     make_worker_specs,
                                                     spawn_fleet,
                                                     worker_spec_factory)
from replicatinggpt_tpu_torch.serve import (EngineConfig, RemoteReplica,
                                            RequestJournal, Router,
                                            RouterConfig, SessionLoadConfig,
                                            make_sessions, session_request)
from replicatinggpt_tpu_torch.serve import rpc, worker
from replicatinggpt_tpu_torch.serve.requests import (REJECT_BAD_REQUEST,
                                                     Request, RequestResult,
                                                     SamplingParams)
from test_torch_port_serve_mesh import JCFG as MESH_JCFG
from test_torch_port_serve_mesh import POOL as MESH_POOL
from test_torch_port_serve_mesh import TCFG as MESH_TCFG
from test_torch_port_serve_mesh import tree  # noqa: F401 (a fixture)

pytestmark = [pytest.mark.fleet, pytest.mark.multiproc]

CFG = get_config("test-tiny").model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reqs(n, seed=7, max_new=8, prompt_len=4, cls=Request,
          sampling=SamplingParams):
    rng = np.random.default_rng(seed)
    return [cls(id=f"m{seed}_{i}",
                prompt=rng.integers(1, CFG.vocab_size - 1,
                                    (prompt_len,)).astype(np.int32),
                max_new_tokens=max_new, sampling=sampling(greedy=True),
                rng_seed=seed * 1000 + i) for i in range(n)]


# --------------------------------------------------------------------- (a)

@pytest.mark.parametrize("doc", [
    {"op": "health", "x": 1},
    {"op": "submit", "req": {"id": "a", "prompt": [1, 2, 3]}, "idem": "k",
     "gen": 2},
    {"ok": True, "finished": [], "partials": {"a": [4, 5]}, "idle": False}])
def test_frames_and_checks_match_jax(doc):
    frame = rpc.encode_frame(doc)
    assert frame == jrpc.encode_frame(doc)
    head, body = frame[:rpc.HEADER_BYTES], frame[rpc.HEADER_BYTES:]
    assert rpc.decode_header(head) == jrpc.decode_header(head)
    n, crc = rpc.decode_header(head)
    assert n == len(body) and rpc.crc_ok(body, crc)
    bad = bytes([body[0] ^ 0xFF]) + body[1:]
    assert not rpc.crc_ok(bad, crc) and not jrpc.crc_ok(bad, crc)
    for mod in (rpc, jrpc):
        with pytest.raises(ValueError, match="frame too large"):
            mod.decode_header((1 << 30).to_bytes(4, "big") + b"\0" * 4)
        with pytest.raises(ValueError, match="frame too large"):
            mod.encode_frame({"blob": "x" * (17 << 20)})
    assert (rpc.MAX_FRAME, rpc.PROTO_VERSION, rpc.HEADER_BYTES,
            rpc.JOURNAL_DRAIN_LIMIT, rpc.REJECT_REPLICA_DOWN) == (
        jrpc.MAX_FRAME, jrpc.PROTO_VERSION, jrpc.HEADER_BYTES,
        jrpc.JOURNAL_DRAIN_LIMIT, jrpc.REJECT_REPLICA_DOWN)


def test_wire_documents_match_jax():
    kw = dict(id="w1", prompt=np.asarray([3, 1, 4], np.int32),
              max_new_tokens=7, deadline=105.0, rng_seed=42,
              eos_token_id=5)
    sp = dict(temperature=0.5, top_k=3, top_p=0.9, greedy=False)
    mine = rpc.request_to_wire(Request(sampling=SamplingParams(**sp), **kw),
                               100.0)
    theirs = jrpc.request_to_wire(
        jreq.Request(sampling=jreq.SamplingParams(**sp), **kw), 100.0)
    assert mine == theirs
    back = rpc.request_from_wire(json.loads(json.dumps(theirs)), 200.0)
    assert (back.id, back.prompt.tolist(), back.rng_seed,
            back.eos_token_id) == ("w1", [3, 1, 4], 42, 5)
    assert back.deadline == pytest.approx(205.0)
    assert back.sampling == SamplingParams(**sp)
    res = dict(id="w1", tokens=[1, 2, 3], finish_reason="max_tokens",
               queue_wait_s=0.1, ttft_s=0.2, decode_tokens_per_s=30.0,
               total_s=0.5)
    assert rpc.result_to_wire(RequestResult(**res)) == \
        jrpc.result_to_wire(jreq.RequestResult(**res))
    assert rpc.result_from_wire(res) == RequestResult(**res)
    with pytest.raises(ValueError, match=r"item 9\(e\)"):
        rpc.request_from_wire({**theirs, "prefill_only": True}, 0.0)


# --------------------------------------------------------------------- (b)

class _FakeEngine:
    """The host API a WorkerServer drives, in plain Python (either
    package's Request goes in: only ``.id`` is read)."""

    class cfg:
        vocab_size = CFG.vocab_size

    class scheduler:
        depth = 0

    def __init__(self, capacity=8):
        self.pool = SimpleNamespace(
            alloc=SimpleNamespace(pages_in_use=0, prefix_hit_tokens=0,
                                  prompt_tokens=0),
            page_size=16, cached_prefix_tokens=lambda prompt: 0)
        self.metrics = SimpleNamespace(counters={"requests_admitted": 1})
        self.n_steps = 0
        self._active = np.zeros((2,), bool)
        self._inflight = {}
        self._finish_next = []
        self.cancelled = []
        self.journal = None
        self.capacity = capacity

    @property
    def idle(self):
        return not self._inflight

    def submit(self, req):
        if req.id in self._inflight:
            return RequestResult(id=req.id, tokens=[],
                                 finish_reason=REJECT_BAD_REQUEST)
        if len(self._inflight) >= self.capacity:
            return RequestResult(id=req.id, tokens=[],
                                 finish_reason="rejected_queue_full")
        self._inflight[req.id] = req
        return None

    def step(self):
        self.n_steps += 1
        out = []
        for rid in self._finish_next:
            self._inflight.pop(rid, None)
            out.append(RequestResult(id=rid, tokens=[1, 2],
                                     finish_reason="max_tokens"))
        self._finish_next = []
        return out

    def cancel(self, rid, migrated=False):
        self.cancelled.append((rid, migrated))
        return self._inflight.pop(rid, None) is not None

    def in_flight_ids(self):
        return list(self._inflight)

    def partial_tokens(self, rid):
        return [7] if rid in self._inflight else None


def _wire(reqs):
    return [rpc.request_to_wire(q, 0.0) for q in reqs]


def _scenario(name, tmp):
    """(documents to dispatch, hook(engine, i) run before document i,
    journal path or None, preload journal, replay, gen)."""
    w = _wire(_reqs(3, seed=3))
    if name == "redelivery":
        docs = [{"op": "submit", "req": w[0]}, {"op": "submit", "req": w[1]},
                {"op": "step", "acks": []}, {"op": "step", "acks": []},
                {"op": "step", "acks": [w[0]["id"]]},
                {"op": "step", "acks": [w[1]["id"]]},
                {"op": "stream_drain"}, {"op": "health"}]

        def hook(eng, i):
            if i == 2:
                eng._finish_next = [w[0]["id"], w[1]["id"]]
        return docs, hook, None, False, False, -1
    if name == "reply_cache":
        docs = ([{"op": "submit", "req": w[0], "idem": "k1"}] * 2
                + [{"op": "submit", "req": w[0], "idem": "k2"}]
                + [{"op": "submit", "req": w[1], "idem": f"e{i}"}
                   for i in range(worker.REPLY_CACHE_SIZE + 1)]
                + [{"op": "submit", "req": w[0], "idem": "k1"},
                   {"op": "health"}])
        return docs, None, None, False, False, -1
    if name == "fence":
        docs = [{"op": "step", "acks": [], "gen": 6},
                {"op": "step", "acks": [], "gen": 7},
                {"op": "step", "acks": []},
                {"op": "submit", "req": w[0], "gen": 8, "idem": "f"},
                {"op": "nope"}]
        return docs, None, None, False, False, 7
    if name == "drain":
        docs = [{"op": "submit", "req": w[0]}, {"op": "submit", "req": w[1]},
                {"op": "drain"}, {"op": "submit", "req": w[2]},
                {"op": "health"}, {"op": "journal_drain", "cursor": 0}]
        return docs, None, str(tmp / "drain.jsonl"), True, True, -1
    if name == "replay_cancel":
        docs = [{"op": "health"}, {"op": "cancel", "id": w[0]["id"],
                                   "migrated": True},
                {"op": "cancel", "id": "absent"}, {"op": "health"},
                {"op": "journal_drain", "cursor": 0}]
        return docs, None, str(tmp / "rc.jsonl"), True, True, -1
    assert name == "journal_drain"
    docs = [{"op": "journal_drain", "cursor": 0, "limit": 2},
            {"op": "journal_drain", "cursor": 2, "limit": 2},
            {"op": "journal_drain", "cursor": 4, "limit": 2},
            {"op": "journal_drain", "cursor": 0, "kinds": ["finished"]},
            {"op": "journal_drain", "cursor": 0, "limit": 9999,
             "idem": "d1"},
            {"op": "journal_drain", "cursor": 0, "idem": "d1"}]
    return docs, None, str(tmp / "jd.jsonl"), True, False, -1


def _drive_worker(server_cls, journal_mod, request_cls, sampling_cls, name,
                  tmp):
    docs, hook, jpath, preload, replay, gen = _scenario(name, tmp)
    capacity = 0 if name == "replay_cancel" else 8
    eng = _FakeEngine(capacity=capacity)
    journal = None
    if jpath is not None:
        if preload:
            pre = journal_mod.RequestJournal(jpath)
            qs = _reqs(5, seed=13, cls=request_cls, sampling=sampling_cls)
            for q in qs:
                pre.record_submit(q)
            pre.record_finish(qs[0].id, "max_tokens")
            pre.record_finish(qs[1].id, "cancelled")
            pre.close()
        journal = journal_mod.RequestJournal(jpath, lock=True)
    w = server_cls(eng, journal=journal, clock=lambda: 0.0)
    w.gen = gen
    if replay:
        w.replay_journal(jpath)
    out = []
    for i, doc in enumerate(docs):
        if hook is not None:
            hook(eng, i)
        try:
            r = w.dispatch(dict(doc))
            r.pop("pid", None)
            out.append(json.loads(json.dumps(r)))
        except Exception as e:  # noqa: BLE001 — compared by type/message
            out.append((type(e).__name__, str(e)))
    if journal is not None:
        journal.close()
    return out, eng.cancelled, sorted(w._replies)


@pytest.mark.parametrize("name", ["redelivery", "reply_cache", "fence",
                                  "drain", "replay_cancel", "journal_drain"])
def test_worker_server_answers_as_jax(name, tmp_path):
    from replicatinggpt_tpu.serve import journal as jjournal

    from replicatinggpt_tpu_torch.serve import journal as pjournal
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    mine = _drive_worker(worker.WorkerServer, pjournal, Request,
                         SamplingParams, name, tmp_path / "p")
    theirs = _drive_worker(jworker.WorkerServer, jjournal, jreq.Request,
                           jreq.SamplingParams, name, tmp_path / "j")
    assert mine == theirs


# --------------------------------------------------------------------- (c)

def _serve_in_thread(dispatch, serve_connection):
    """Serve ``dispatch`` on a loopback socket from a daemon asyncio
    thread; returns (port, stop)."""
    ready, started = {}, threading.Event()

    async def main():
        ready["stop"] = asyncio.Event()
        server = await asyncio.start_server(
            lambda r, w: serve_connection(r, w, dispatch), "127.0.0.1", 0)
        ready["port"] = server.sockets[0].getsockname()[1]
        ready["loop"] = asyncio.get_running_loop()
        started.set()
        await ready["stop"].wait()
        server.close()
        await server.wait_closed()

    t = threading.Thread(target=lambda: asyncio.run(main()), daemon=True)
    t.start()
    assert started.wait(10)

    def stop():
        ready["loop"].call_soon_threadsafe(ready["stop"].set)
        t.join(10)

    return ready["port"], stop


def test_each_client_drives_the_other_packages_worker():
    out = {}
    for client_mod, server_mod, server_cls in (
            (jrpc, rpc, worker.WorkerServer),
            (rpc, jrpc, jworker.WorkerServer)):
        eng = _FakeEngine()
        w = server_cls(eng, journal=None)
        w.gen = 3
        port, stop = _serve_in_thread(w.dispatch, server_mod.serve_connection)
        c = client_mod.RpcClient("127.0.0.1", port, timeout_s=5.0)
        try:
            q = _wire(_reqs(1, seed=5))[0]
            got = [c.call("submit", req=q, idem="a", gen=3),
                   c.call("submit", req=q, idem="a", gen=3)]
            eng._finish_next = [q["id"]]
            got.append(c.call("step", acks=[], gen=3))
            got.append(c.call("step", acks=[q["id"]], gen=3))
            with pytest.raises(client_mod.RpcProtocolError,
                               match="stale generation"):
                c.call("step", acks=[], gen=2)
            with pytest.raises(client_mod.RpcError, match="unknown op"):
                c.call("nope")
        finally:
            c.close()
            stop()
        out[client_mod.__name__] = got
    assert out[jrpc.__name__] == out[rpc.__name__]
    assert out[rpc.__name__][1]["idem_hit"] is True


# --------------------------------------------------------------------- (d)

class _Observer:
    def __init__(self):
        self.responses, self.partitions = [], []

    def net_chaos_response(self, resp):
        self.responses.append(resp)

    def net_chaos_partition(self, active):
        self.partitions.append(active)


def _ladder(mods):
    """The JAX ladder (every kind, then a corrupt frame on the catch-all
    site) through one package's transport against its worker; returns
    every call's outcome and the transport's and engine's state."""
    net, fault_cls, plan_cls, inst, rmod, server_cls = mods
    eng = _FakeEngine(capacity=16)
    w = server_cls(eng, journal=None)
    port, stop = _serve_in_thread(w.dispatch, rmod.serve_connection)
    obs = _Observer()
    ft = net.FaultyTransport(rmod.RpcClient("127.0.0.1", port, timeout_s=5),
                             src="router", dst="worker0", observer=obs)
    sub = [{"req": q, "idem": f"lad.{i}"}
           for i, q in enumerate(_wire(_reqs(9, seed=61)))]
    site = net.net_site("router", "worker0", "submit")
    plan = plan_cls(
        fault_cls(site=site, kind=net.KIND_NET_DUP, at=0),
        fault_cls(site=site, kind=net.KIND_NET_REORDER, at=1),
        fault_cls(site=site, kind=net.KIND_NET_DELAY, at=2, arg=0.01),
        fault_cls(site=site, kind=net.KIND_NET_TRICKLE, at=3, arg=5,
                  arg2=0.001),
        fault_cls(site=site, kind=net.KIND_NET_DROP, at=4),
        fault_cls(site=site, kind=net.KIND_NET_PARTITION, at=5, arg2=0),
        fault_cls(site=site, kind=net.KIND_NET_PARTITION, at=6, arg2=1),
        fault_cls(site=net.NET_CALL, kind=net.KIND_NET_CORRUPT, at=8),
        seed=3)
    out = []
    try:
        with inst(plan):
            for kw in sub:
                try:
                    out.append(ft.call("submit", **kw))
                except Exception as e:  # noqa: BLE001 — compared by name
                    out.append(type(e).__name__)
                    ft.close()
            out.append(ft.call("submit", **sub[8]))   # the idem retry
        out.append(ft.call("step", acks=[]))
    finally:
        ft.close()
        stop()
    return (out, ft.dups_injected, ft._counts, obs.responses,
            obs.partitions, sorted(eng._inflight), plan.fired)


def test_netchaos_ladder_matches_jax():
    from replicatinggpt_tpu_torch.serve.worker import WorkerServer
    mine = _ladder((netchaos, Fault, FaultPlan, installed, rpc,
                    WorkerServer))
    theirs = _ladder((jnet, JFault, JFaultPlan, jinstalled, jrpc,
                      jworker.WorkerServer))
    assert mine == theirs
    out = mine[0]
    assert out[0]["idem_hit"] is True and mine[1] == 2
    assert out[4:7] == ["RpcTimeout", "RpcDown", "RpcTimeout"]
    assert out[8] == "RpcProtocolError" and out[9]["accepted"]


class _RecordingRng:
    """Draws from ``random.Random(seed)``, records each draw and its bound,
    and returns 0 (no sleeping)."""

    def __init__(self, seed):
        self.rng = random.Random(seed)
        self.draws = []

    def uniform(self, a, b):
        self.draws.append((a, b, self.rng.uniform(a, b)))
        return 0.0


def _backoff_draws(loop_fn):
    async def main():
        w = SimpleNamespace(stop_event=asyncio.Event(),
                            last_contact=time.monotonic() - 100.0)
        rng = _RecordingRng(5)
        task = asyncio.ensure_future(loop_fn(
            w, "127.0.0.1:1", {"worker_idx": 0, "gen": 0}, idle_s=0.05,
            backoff_s=0.5, backoff_cap_s=2.0, rng=rng))
        deadline = time.monotonic() + 30.0
        while len(rng.draws) < 6:
            assert time.monotonic() < deadline, rng.draws
            await asyncio.sleep(0.001)
        w.stop_event.set()
        await asyncio.wait_for(task, 10.0)
        return rng.draws[:6]

    return asyncio.run(main())


def test_reregister_backoff_matches_jax():
    mine = _backoff_draws(worker._reregister_loop)
    assert mine == _backoff_draws(jworker._reregister_loop)
    assert [b for _, b, _ in mine] == [1.0, 2.0, 2.0, 2.0, 2.0, 2.0]


# --------------------------------------------------------------------- (e)

class _StubRouter:
    """What the supervisor calls on a router, recorded."""

    def __init__(self, n):
        self.replicas = [SimpleNamespace(alive=True, restarts=0, client=None)
                         for _ in range(n)]
        self.rcfg = SimpleNamespace(step_timeout_s=5.0)
        self.supervisor = None
        self.attached, self.added, self.drained = [], [], []
        self.abandoned, self.downs = [], []
        self.load = {"queued": 0, "active": 0, "n_routable": n}
        self.metrics = SimpleNamespace(inc=lambda *a, **k: None)

    def attach_replica(self, idx, port, pid=None, gen=None, host=None):
        self.attached.append((idx, port, pid, gen, host))
        return {"kept": 0, "requeued": 0, "ghosts": 0}

    def add_replica(self, rep):
        self.added.append(rep.idx)
        self.replicas.append(rep)
        return rep.idx

    def offered_load(self):
        return dict(self.load)

    def drain_replica(self, idx):
        self.drained.append(idx)
        return 0

    def mark_down(self, idx, reason=""):
        self.downs.append(idx)

    def abandon_replica(self, idx):
        self.abandoned.append(idx)

    def _event(self, msg):
        pass


def _reg_doc(**over):
    return {"proto": rpc.PROTO_VERSION, "shape_hash": "abc",
            "worker_idx": 0, "gen": 0, "port": 1234, "pid": 42,
            "replayed": 0, **over}


def test_supervisor_restart_budget_ends_in_quarantine(tmp_path):
    spec = WorkerSpec(idx=0, cmd=[sys.executable, "-c",
                                  "import sys; sys.exit(3)"],
                      journal_path=str(tmp_path / "q.jsonl"))
    sup = ProcSupervisor([spec], SupervisorConfig(
        restart_budget=2, backoff_s=0.01, probe_every=0))
    router = _StubRouter(1)
    sup.attach_router(router)
    assert router.supervisor is sup
    sup.start_all(wait=False)
    assert sup.reviving
    deadline = time.monotonic() + 30
    while sup.handles[0].state != QUARANTINED:
        assert time.monotonic() < deadline, sup.events
        sup.tick()
        time.sleep(0.005)
        if sup.handles[0].state == BACKOFF:
            assert sup.reviving
    assert sup.handles[0].crash_restarts == 3
    assert router.abandoned == [0] and router.downs
    assert any("quarantined" in e for e in sup.events)
    assert not sup.reviving
    sup.stop_all()


def test_registration_pins_shape_and_joins_unmanaged(tmp_path):
    sup = ProcSupervisor([WorkerSpec(idx=0, cmd=[],
                                     journal_path=str(tmp_path / "j"))])
    router = _StubRouter(1)
    sup.attach_router(router)
    try:
        sup.handles[0].state, sup.handles[0].gen = SPAWNING, 0
        assert sup._handle_register(_reg_doc(idem="r0"), "10.1.2.3")[
            "idx"] == 0
        assert sup._handle_register(_reg_doc(idem="r0"), "h")["idem_hit"]
        assert router.attached == [(0, 1234, 42, 0, "10.1.2.3")]
        assert sup.handles[0].state == RUNNING and sup.handles[0].ready_s
        assert sup.expect_shape_hash == "abc"
        with pytest.raises(rpc.RpcProtocolError, match="shape"):
            sup._handle_register(_reg_doc(shape_hash="zzz"), "h")
        with pytest.raises(rpc.RpcProtocolError, match="protocol"):
            sup._handle_register(_reg_doc(proto=rpc.PROTO_VERSION + 1), "h")
        with pytest.raises(rpc.RpcProtocolError, match=r"item 9\(e\)"):
            sup._handle_register(_reg_doc(tier="prefill"), "h")
        sup.handles[0].gen = 1
        with pytest.raises(ValueError, match="stale generation"):
            sup._handle_register(_reg_doc(gen=0), "h")
        resp = sup._handle_register(_reg_doc(worker_idx=-1, port=5555),
                                    "10.9.9.9")
        assert resp["idx"] == 1 and router.added == [1]
        assert sup.external == [1]
    finally:
        sup.stop_all()
    pinned = ProcSupervisor(
        [WorkerSpec(idx=0, cmd=[], journal_path=str(tmp_path / "k"))],
        SupervisorConfig(expect_shape_hash="pinned"))
    pinned.attach_router(_StubRouter(1))
    pinned.handles[0].gen = 0
    with pytest.raises(rpc.RpcProtocolError, match="shape"):
        pinned._handle_register(_reg_doc(), "h")
    pinned.stop_all()


def test_protocol_refusal_crosses_the_wire():
    lst = rpc.RpcListener()
    got = {}

    def client():
        c = jrpc.RpcClient("127.0.0.1", lst.port, timeout_s=5.0)
        try:
            c.call("register", proto=99, idem="x")
        except Exception as e:  # noqa: BLE001 — the assertion's target
            got["exc"] = e
        finally:
            c.close()

    def refuse(doc, peer):
        raise rpc.RpcProtocolError(f"worker speaks protocol "
                                   f"v{doc['proto']}")

    t = threading.Thread(target=client)
    t.start()
    deadline = time.monotonic() + 10
    while "exc" not in got and time.monotonic() < deadline:
        lst.poll(refuse)
        time.sleep(0.01)
    t.join(10)
    lst.close()
    assert isinstance(got.get("exc"), jrpc.RpcProtocolError)
    assert "protocol v99" in str(got["exc"])


def test_autoscaler_scales_up_then_down(tmp_path):
    router = _StubRouter(1)
    sup = ProcSupervisor(
        [WorkerSpec(idx=0, cmd=[], journal_path=str(tmp_path / "j"))],
        SupervisorConfig(probe_every=0),
        autoscale=AutoscaleConfig(min_workers=1, max_workers=2,
                                  up_backlog_per_worker=2.0, up_patience=3,
                                  down_patience=3, cooldown_ticks=0),
        spec_factory=worker_spec_factory(str(tmp_path / "scale"),
                                         ["--preset", "test-tiny"]))
    sup.attach_router(router)
    spawned = []
    sup._spawn = lambda h: (spawned.append(h.spec.idx),
                            setattr(h, "state", SPAWNING))
    try:
        sup.handles[0].state = RUNNING
        router.load = {"queued": 9, "active": 1, "n_routable": 1}
        sup._tick_autoscale()
        router.load = {"queued": 0, "active": 1, "n_routable": 1}
        sup._tick_autoscale()
        assert sup.scale_ups == 0
        router.load = {"queued": 9, "active": 2, "n_routable": 1}
        for _ in range(8):
            sup._tick_autoscale()
        assert sup.scale_ups == 1 and spawned == [1] and router.added == [1]
        sup.handles[1].state = RUNNING
        router.load = {"queued": 0, "active": 1, "n_routable": 2}
        for _ in range(3):
            sup._tick_autoscale()
        assert sup.scale_downs == 1 and router.drained == [1]
        h1 = sup.handles[1]
        assert h1.retiring and h1.intentional_stop
        sup._on_exit(h1, 0)
        assert h1.state == RETIRED and spawned == [1] and not sup.reviving
        router.load = {"queued": 0, "active": 0, "n_routable": 1}
        for _ in range(10):
            sup._tick_autoscale()
        assert sup.scale_downs == 1
    finally:
        sup.stop_all()


def test_host_loss_kills_and_deletes_the_workdir(tmp_path):
    wd = tmp_path / "w0"
    wd.mkdir()
    jpath = wd / "journal.jsonl"
    jpath.write_text('{"ev": "submit", "id": "x"}\n')
    sup = ProcSupervisor([WorkerSpec(
        idx=0, cmd=[sys.executable, "-c", "import time; time.sleep(60)"],
        journal_path=str(jpath), workdir=str(wd))],
        SupervisorConfig(probe_every=0))
    try:
        h = sup.handles[0]
        sup._spawn(h)
        sup.chaos_host_loss(0)
        assert h.proc.poll() is not None and not wd.exists()
        sup._spawn(h)
        assert wd.exists() and not jpath.exists()
    finally:
        sup.stop_all()
    assert not sup.pids()


def test_load_step_draws_match_jax():
    from replicatinggpt_tpu.config import get_config as jget
    from replicatinggpt_tpu.serve.loadgen import SessionLoadConfig as JSLC
    from replicatinggpt_tpu.serve.loadgen import make_sessions as jmake
    kw = dict(n_sessions=9, turns=1, rate=50.0, seed=4, prefix_len=4,
              max_new_tokens=2, load_step=True)
    mine = make_sessions(CFG, SessionLoadConfig(**kw))
    theirs = jmake(jget("test-tiny").model, JSLC(**kw))
    assert [s.due_t for s in mine] == [s.due_t for s in theirs]
    assert [s.group for s in mine] == [s.group for s in theirs]
    flat = make_sessions(CFG, SessionLoadConfig(**{**kw,
                                                   "load_step": False}))
    g0 = np.diff([0.0] + [s.due_t for s in flat])
    g1 = np.diff([0.0] + [s.due_t for s in mine])
    assert np.allclose(g1[:3], g0[:3]) and np.allclose(g1[3:6], g0[3:6] / 2)
    assert np.allclose(g1[6:], g0[6:] * 2)


def test_offered_load_and_add_replica():
    r = Router(rcfg=RouterConfig(n_replicas=0), backends=[])
    try:
        assert r.offered_load() == {"queued": 0, "active": 0,
                                    "n_routable": 0}
        assert r.add_replica(RemoteReplica(0)) == 0
        assert not r.replicas[0].alive
        assert r.metrics.counters["fleet_replicas_added"] == 1
        with pytest.raises(AssertionError, match="append-only"):
            r.add_replica(RemoteReplica(5))
    finally:
        r.close()


def test_worker_argv_builds_the_launchers_model_and_engine():
    """``serve --multiproc`` forwards its model and engine flags: the
    worker's parse of them gives the launcher's model, engine, device and
    shape hash (JAX's round trip of ``config_override_args``); a launcher
    without ``--journal-dir`` is refused."""
    from replicatinggpt_tpu_torch import cli
    from replicatinggpt_tpu_torch.config import (config_from_args,
                                                 config_override_args)
    p = cli.build_parser()
    serve = p.parse_args([
        "serve", "--preset", "test-tiny", "--n-layer", "3", "--n-head", "4",
        "--n-embd", "64", "--block-size", "48", "--vocab-size", "80",
        "--dropout", "0.1", "--dtype", "bfloat16", "--attention", "ring",
        "--loss-chunk", "16", "--decode-cache-layout", "packed", "--remat",
        "--device", "cpu", "--pool-size", "3", "--page-size", "8",
        "--paged-kernel", "--kv-quant", "int8", "--decode-window", "4",
        "--decode-window-auto", "--multiproc", "--seed", "5", "--lr",
        "0.002"])
    argv = (["serve-worker", "--preset", serve.preset]
            + config_override_args(serve) + cli.engine_forward_args(serve))
    w = p.parse_args(argv)
    assert config_from_args(w) == config_from_args(serve)
    assert config_from_args(w).model.remat is True
    assert config_from_args(w).train.seed == 5
    assert config_override_args(p.parse_args(["serve", "--no-remat"])) == \
        ["--no-remat"]
    assert config_from_args(w).train.lr == 0.002
    assert cli.engine_config_from_args(w) == cli.engine_config_from_args(
        serve)
    assert w.device == "cpu"
    assert rpc.engine_shape_hash(config_from_args(w).model,
                                 cli.engine_config_from_args(w)) == \
        rpc.engine_shape_hash(config_from_args(serve).model,
                              cli.engine_config_from_args(serve))
    assert config_override_args(p.parse_args(["serve"])) == []
    with pytest.raises(SystemExit, match="requires --journal-dir"):
        cli.main(["serve", "--preset", "test-tiny", "--device", "cpu",
                  "--multiproc"])


def _mesh_fleet_run(fleet, reqs):
    """Submit ``reqs``, step to idle reading the delivery ledger; return
    (tokens and reason by id, first replica by id, delivered streams)."""
    for q in reqs:
        assert fleet.submit(q) is None
    first = {rid: fi.replica for rid, fi in fleet._inflight.items()}
    results, streams = {}, {q.id: [] for q in reqs}
    for _ in range(200):
        if fleet.idle:
            break
        for res in fleet.step():
            results[res.id] = res
        for rid in streams:
            streams[rid].extend(fleet.take_new_tokens(rid))
    assert fleet.idle
    fleet.close()
    return ({k: (list(v.tokens), v.finish_reason)
             for k, v in results.items()}, first, streams)


def test_mesh_replicas_in_one_process(tree):
    """A serving mesh a replica in the in-process fleet (``mesh_data=2``,
    each replica splitting its own weights): tokens, finish reasons,
    first routes and delivered streams equal the JAX router's over the
    same engine configuration and weights, and the tokens one 1x1
    engine's."""
    from replicatinggpt_tpu.serve import EngineConfig as JEngineConfig
    from replicatinggpt_tpu.serve import Router as JRouter
    from replicatinggpt_tpu.serve import RouterConfig as JRouterConfig
    from replicatinggpt_tpu.serve import SamplingParams as JSampling
    from replicatinggpt_tpu_torch.models.gpt import params_from_numpy
    from replicatinggpt_tpu_torch.serve import Engine
    rng = np.random.default_rng(9)
    docs = [(f"s{i}", rng.integers(1, 64, (int(rng.integers(2, 12)),))
             .astype(np.int32)) for i in range(6)]

    def reqs(cls, sampling):
        return [cls(id=rid, prompt=p, max_new_tokens=6,
                    sampling=sampling(greedy=True)) for rid, p in docs]

    want = _mesh_fleet_run(
        JRouter(tree, MESH_JCFG, JRouterConfig(n_replicas=2),
                JEngineConfig(**MESH_POOL, mesh_data=2)),
        reqs(jreq.Request, JSampling))
    model = params_from_numpy(tree, MESH_TCFG, device="cpu")
    fleet = Router(model, MESH_TCFG, RouterConfig(n_replicas=2),
                   EngineConfig(**MESH_POOL, mesh_data=2), device="cpu")
    assert all(rep.engine.group is not None for rep in fleet.replicas)
    got = _mesh_fleet_run(fleet, reqs(Request, SamplingParams))
    assert got == want
    assert len(set(want[1].values())) == 2
    assert all(got[2][k] == v[0] for k, v in got[0].items())
    one = Engine(model, MESH_TCFG, EngineConfig(**MESH_POOL), device="cpu")
    for q in reqs(Request, SamplingParams):
        assert one.submit(q) is None
    assert {r.id: list(r.tokens) for r in one.drain()} == \
        {k: v[0] for k, v in got[0].items()}


# --------------------------------------------------------------------- (f)

def test_engine_shape_hash_fields_and_backend(tmp_path):
    from replicatinggpt_tpu.config import get_config as jget
    from replicatinggpt_tpu.serve import EngineConfig as JEngineConfig
    base = rpc.engine_shape_hash(CFG, EngineConfig())
    assert base == rpc.engine_shape_hash(CFG, EngineConfig())
    for f in dataclasses.fields(CFG):
        v = getattr(CFG, f.name)
        other = ("x" if isinstance(v, str) else (not v) if isinstance(v, bool)
                 else v + 1 if isinstance(v, (int, float)) else None)
        assert rpc.engine_shape_hash(
            dataclasses.replace(CFG, **{f.name: other}),
            EngineConfig()) != base, f.name
    jfields = ("pool_size", "max_queue", "prefill_chunk", "page_size",
               "max_pages", "n_pages", "prefix_cache", "decode_window",
               "mesh_data", "mesh_model", "kv_quant", "quant_granularity")
    for name in jfields:
        v = getattr(EngineConfig(), name)
        other = ("int8" if name == "kv_quant" else "head"
                 if name == "quant_granularity" else (not v)
                 if isinstance(v, bool) else v + 1)
        assert rpc.engine_shape_hash(
            CFG, EngineConfig(**{name: other})) != base, name
    # the JAX document hashes the two weight-quant knobs this port
    # refuses (ROADMAP.md queue A item 8): "none" here, always
    assert not hasattr(EngineConfig(), "weight_quant")
    # the same configuration hashes apart from the JAX package's
    theirs = jrpc.engine_shape_hash(jget("test-tiny").model, JEngineConfig())
    assert theirs != base
    sup = ProcSupervisor([WorkerSpec(idx=0, cmd=[],
                                     journal_path=str(tmp_path / "j"))],
                         SupervisorConfig(expect_shape_hash=base))
    sup.attach_router(_StubRouter(1))
    sup.handles[0].gen = 0
    with pytest.raises(rpc.RpcProtocolError, match="shape"):
        sup._handle_register(_reg_doc(shape_hash=theirs), "h")
    sup._handle_register(_reg_doc(shape_hash=base), "h")
    sup.stop_all()


# --------------------------------------------------------------------- (g)

@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """A port checkpoint of the JAX ``init_params`` of test-tiny (seed 0),
    and a greedy reference through the JAX in-process engine."""
    from replicatinggpt_tpu.config import get_config as jget
    from replicatinggpt_tpu.models.gpt import init_params as jinit
    from replicatinggpt_tpu.serve import Engine as JEngine
    from replicatinggpt_tpu.serve import EngineConfig as JEngineConfig

    from replicatinggpt_tpu_torch.models.gpt import params_from_numpy
    from replicatinggpt_tpu_torch.train.checkpoint import CheckpointManager
    from replicatinggpt_tpu_torch.train.state import TrainState
    jcfg = jget("test-tiny").model
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit(jax.random.PRNGKey(0), jcfg))
    ck = tmp_path_factory.mktemp("ck")
    CheckpointManager(str(ck)).save(TrainState(
        step=0, model=params_from_numpy(tree, CFG, device="cpu"),
        optimizer=None, rng=None))
    reqs = _reqs(6, seed=21, max_new=20, prompt_len=5)
    eng = JEngine(jax.tree_util.tree_map(jax.numpy.asarray, tree), jcfg,
                  JEngineConfig(pool_size=2, max_queue=16))
    for q in reqs:
        assert eng.submit(jreq.Request(
            id=q.id, prompt=q.prompt, max_new_tokens=q.max_new_tokens,
            sampling=jreq.SamplingParams(greedy=True),
            rng_seed=q.rng_seed)) is None
    want = {r.id: list(r.tokens) for r in eng.drain()}
    return str(ck), reqs, want


def _spawn(root, ck, n=2, **rkw):
    specs = make_worker_specs(
        n, str(root), ["--preset", "test-tiny"],
        ["--pool-size", "2", "--max-queue", "16", "--device", "cpu",
         "--checkpoint-dir", ck], env={"OMP_NUM_THREADS": "1"})
    rcfg = RouterConfig(n_replicas=n, step_timeout_s=5.0,
                        ledger_path=str(root / "router_ledger.jsonl"), **rkw)
    return spawn_fleet(specs, rcfg, SupervisorConfig(
        backoff_s=0.1, probe_every=4, probe_timeout_s=2.0))


def _drain(router, sup, reqs, budget_s=120.0):
    """Submit ``reqs``, step the fleet (ticking the supervisor) to idle
    reading the delivery ledger every step; no id may be in flight on two
    live workers at any step. Returns (results, streams)."""
    for q in reqs:
        assert router.submit(q) is None
    results, streams = {}, {q.id: [] for q in reqs}
    deadline = time.monotonic() + budget_s
    while not router.idle:
        assert time.monotonic() < deadline, (router.events[-6:],
                                             sup.events[-6:])
        for res in router.step():
            results[res.id] = res
        for rid in streams:
            streams[rid].extend(router.take_new_tokens(rid))
        sup.tick()
        live = [rid for rep in router.replicas if rep.alive
                for rid in rep._partials]
        assert len(live) == len(set(live)), live
    return results, streams


def test_worker_fleet_matches_jax_engine_across_sigkill(jax_weights,
                                                        tmp_path):
    """Two serve-worker processes on the CPU: greedy streams equal the JAX
    engine's; then ``proc_kill`` of worker 0 at router step 4 (a real
    SIGKILL mid-decode): every stream is unchanged and delivered once,
    the worker restarts and replays its journal."""
    ck, reqs, want = jax_weights
    router, sup = _spawn(tmp_path, ck)
    try:
        assert all(rep.alive and rep.warmed for rep in router.replicas)
        results, streams = _drain(router, sup, reqs[:3])
        for q in reqs[:3]:
            assert results[q.id].tokens == want[q.id] == streams[q.id]
        with installed(FaultPlan(Fault(site=FLEET_STEP, kind=KIND_PROC_KILL,
                                       at=router.n_steps + 4,
                                       arg=0))) as plan:
            results, streams = _drain(router, sup, reqs[3:])
        assert plan.fired and sup.handles[0].crash_restarts == 1
        for q in reqs[3:]:
            assert results[q.id].finish_reason == "max_tokens"
            assert results[q.id].tokens == want[q.id] == streams[q.id]
        assert router.metrics.counters["fleet_replica_downs"] >= 1
        attach = [e for e in sup.events
                  if "worker 0 registered+attached (gen 1" in e]
        assert attach and "kept 0" not in attach[-1], sup.events
        log = open(sup.handles[0].spec.log_path).read()
        assert "journal replay:" in log
        pids = sup.pids()
        assert len(pids) == 2
    finally:
        sup.stop_all()
        router.close()
    assert not sup.pids()
    for p in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(p, 0)
    assert RequestJournal.unfinished(str(tmp_path / "router_ledger.jsonl")) \
        == []


# ------------------------------------------------------- slow soaks (JAX's)

@pytest.mark.chaos
@pytest.mark.slow
def test_sigkill_and_hang_soak_exactly_once(jax_weights, tmp_path):
    """JAX's SIGKILL soak: ``proc_kill`` of worker 0 at step 4 and
    ``proc_hang`` of worker 1 at step 8 for 3 ticks; every stream equals
    the JAX engine's, delivered once."""
    ck, reqs, want = jax_weights
    router, sup = _spawn(tmp_path, ck)
    try:
        plan = FaultPlan(
            Fault(site=FLEET_STEP, kind=KIND_PROC_KILL, at=4, arg=0),
            Fault(site=FLEET_STEP, kind=KIND_PROC_HANG, at=8, arg=3,
                  arg2=1))
        with installed(plan):
            results, streams = _drain(router, sup, reqs, budget_s=240)
        assert len(plan.fired) == 2 and sup.handles[0].crash_restarts == 1
        for q in reqs:
            assert results[q.id].tokens == want[q.id] == streams[q.id]
        assert any("CHAOS proc_hang" in e for e in sup.events)
    finally:
        sup.stop_all()
        router.close()


@pytest.mark.chaos
@pytest.mark.slow
def test_rolling_restart_soak_zero_drops(jax_weights, tmp_path):
    """JAX's rolling-restart soak on one worker: zero drops, ``readyz``
    503 in the zero-worker window and 200 after."""
    ck, reqs, want = jax_weights
    router, sup = _spawn(tmp_path, ck, n=1)
    try:
        for q in reqs:
            assert router.submit(q) is None
        results, streams = {}, {q.id: [] for q in reqs}
        for _ in range(3):
            for res in router.step():
                results[res.id] = res
            sup.tick()
        sup.start_rolling_restart()
        saw_503 = 0
        deadline = time.monotonic() + 240
        while not router.idle or sup.rolling_active:
            assert time.monotonic() < deadline, sup.events[-6:]
            for res in router.step():
                results[res.id] = res
            for rid in streams:
                streams[rid].extend(router.take_new_tokens(rid))
            sup.tick()
            saw_503 += not router.readyz()["ok"]
        assert saw_503 and router.readyz()["ok"]
        assert sup.handles[0].gen == 1 and sup.handles[0].crash_restarts == 0
        for q in reqs:
            assert results[q.id].tokens == want[q.id]
    finally:
        sup.stop_all()
        router.close()


@pytest.mark.chaos
@pytest.mark.slow
def test_host_loss_soak_exactly_once(jax_weights, tmp_path):
    """JAX's host-loss soak: worker 0 killed and its directory deleted at
    step 4; the router's ledger recovers the work, streams exactly once."""
    ck, reqs, want = jax_weights
    router, sup = _spawn(tmp_path, ck, n=3)
    try:
        with installed(FaultPlan(Fault(site=FLEET_STEP, kind=KIND_HOST_LOSS,
                                       at=4, arg=0))):
            results, streams = _drain(router, sup, reqs, budget_s=240)
        for q in reqs:
            assert results[q.id].tokens == want[q.id] == streams[q.id]
        attach = [e for e in sup.events
                  if "worker 0 registered+attached (gen 1" in e]
        assert attach and "kept 0" in attach[-1]
    finally:
        sup.stop_all()
        router.close()
    assert RequestJournal.unfinished(str(tmp_path / "router_ledger.jsonl")) \
        == []


@pytest.mark.slow
def test_autoscale_load_step_soak_zero_drops(tmp_path):
    """JAX's autoscaler soak: a load step on a one-worker fleet scales up
    under the backlog and down in the lull, dropping nothing."""
    cfg_args = ["--preset", "test-tiny"]
    eng_args = ["--pool-size", "1", "--max-queue", "64", "--device", "cpu"]
    specs = make_worker_specs(1, str(tmp_path), cfg_args, eng_args)
    router, sup = spawn_fleet(
        specs, RouterConfig(n_replicas=1, step_timeout_s=5.0, retry_max=8,
                            ledger_path=str(tmp_path / "ledger.jsonl")),
        SupervisorConfig(backoff_s=0.2, probe_every=0),
        autoscale=AutoscaleConfig(min_workers=1, max_workers=3,
                                  up_backlog_per_worker=0.5, up_patience=2,
                                  down_active_per_worker=2.0,
                                  down_patience=20, cooldown_ticks=10),
        spec_factory=worker_spec_factory(str(tmp_path), cfg_args,
                                         eng_args))
    # JAX's trace, its 16 two-turn sessions as 32 one-turn arrivals
    lcfg = SessionLoadConfig(n_sessions=32, turns=1, n_prefix_groups=2,
                             prefix_len=8, user_len_min=1, user_len_max=2,
                             max_new_tokens=8, rate=2.0, greedy=True,
                             seed=0, load_step=True)
    arrivals = sorted(make_sessions(CFG, lcfg), key=lambda s: s.due_t)
    results, streams = {}, {}
    try:
        t0 = time.monotonic()
        while arrivals or not router.idle or sup.scale_downs == 0:
            assert time.monotonic() - t0 < 240, sup.events[-10:]
            while arrivals and arrivals[0].due_t <= time.monotonic() - t0:
                q = session_request(arrivals.pop(0), lcfg)
                assert router.submit(q) is None
                streams[q.id] = []
            results.update({r.id: r for r in router.step()})
            for rid in streams:
                streams[rid].extend(router.take_new_tokens(rid))
            sup.tick()
            time.sleep(0.01)
        assert sup.scale_ups >= 1 and sup.scale_downs >= 1, sup.events[-10:]
        assert sorted(results) == sorted(streams)
        for rid, res in results.items():
            assert res.ok and streams[rid] == list(res.tokens), rid
    finally:
        sup.stop_all()
        router.close()


@pytest.mark.chaos
@pytest.mark.slow
def test_serve_multiproc_sse_exactly_once_across_sigkill(jax_weights,
                                                         tmp_path):
    """The front door over a worker process: one SSE stream carries each
    token of the JAX engine's result once across a SIGKILL of its
    worker."""
    from replicatinggpt_tpu_torch.serve.http import ServeApp
    ck, reqs, want = jax_weights
    q = reqs[0]
    router, sup = _spawn(tmp_path, ck, n=1)
    app = ServeApp(router, supervisor=sup, idle_timeout_s=0)

    async def main():
        host, port = await app.start()
        try:
            r, w = await asyncio.open_connection(host, port)
            body = json.dumps({"id": q.id, "prompt": q.prompt.tolist(),
                               "max_new_tokens": q.max_new_tokens,
                               "greedy": True}).encode()
            w.write(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                    + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            await w.drain()
            buf = b""
            while buf.count(b"\ndata: ") < 3:
                chunk = await asyncio.wait_for(r.read(4096), 60)
                assert chunk, buf
                buf += chunk
            os.kill(sup.handles[0].pid, signal.SIGKILL)
            while b"event: done" not in buf:
                chunk = await asyncio.wait_for(r.read(4096), 240)
                assert chunk, buf
                buf += chunk
            w.close()
            return buf
        finally:
            await app.stop()

    buf = asyncio.run(main())
    toks = [json.loads(line[6:])["token"] for line in buf.decode().split("\n")
            if line.startswith("data: ") and '"token"' in line]
    assert toks == want[q.id]
    assert sup.handles[0].crash_restarts == 1
    sup.stop_all()
