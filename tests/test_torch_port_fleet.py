"""The port's in-process fleet (serve/router.py, serve/loadgen.py,
faults/fleet.py) against the JAX package's, on the CPU (f32, dropout
off, 2 layers, C=32, greedy unless said).

The same requests go through the JAX ``Router`` and the port's, on a
clean run, under ``replica_kill`` at step 3 with journals, and under
``replica_wedge`` on a virtual clock: each id's tokens and finish reason,
the replica each id was first routed to, the fleet counters and each
id's delivery through ``take_new_tokens`` (exactly once) must be equal.
Each JAX scenario runs once, in a module fixture. The rest mirror the JAX
fleet tests against the port: ledger recovery after a restart, the
fleet-wide duplicate rejection before and after a kill, the retry ladder
with no survivor, the cancel of a requeued request, hot-key skew, the
prefix-hit rate under affinity, a sampled request regenerated after a
kill, and ``migrated=True`` on a windowed engine.
"""

import jax
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.faults import Fault as JFault
from replicatinggpt_tpu.faults import FaultPlan as JFaultPlan
from replicatinggpt_tpu.faults import installed as jinstalled
from replicatinggpt_tpu.models.gpt import init_params as jinit
from replicatinggpt_tpu.serve import EngineConfig as JEngineConfig
from replicatinggpt_tpu.serve import Request as JRequest
from replicatinggpt_tpu.serve import Router as JRouter
from replicatinggpt_tpu.serve import RouterConfig as JRouterConfig
from replicatinggpt_tpu.serve import SamplingParams as JSampling
from replicatinggpt_tpu.serve import SessionLoadConfig as JSessionLoadConfig
from replicatinggpt_tpu.serve import StepClock as JStepClock
from replicatinggpt_tpu.serve import make_sessions as jmake_sessions
from replicatinggpt_tpu.serve import run_fleet_replay as jrun_fleet_replay
from replicatinggpt_tpu_torch.config import ModelConfig
from replicatinggpt_tpu_torch.faults import Fault, FaultPlan, installed
from replicatinggpt_tpu_torch.faults.fleet import (FLEET_SESSION, FLEET_STEP,
                                                   KIND_HOST_LOSS,
                                                   KIND_HOT_KEY_SKEW,
                                                   KIND_PROC_HANG,
                                                   KIND_PROC_KILL,
                                                   KIND_REPLICA_KILL,
                                                   KIND_REPLICA_WEDGE)
from replicatinggpt_tpu_torch.models.gpt import params_from_numpy
from replicatinggpt_tpu_torch.serve import (REJECT_FLEET_CAPACITY, Engine,
                                            EngineConfig, Request, Router,
                                            RouterConfig, SamplingParams,
                                            SessionLoadConfig, StepClock,
                                            make_sessions, run_fleet_replay)
from replicatinggpt_tpu_torch.serve.requests import (FINISH_CANCELLED,
                                                     FINISH_MAX_TOKENS,
                                                     REJECT_BAD_REQUEST)

JCFG = JConfig(vocab_size=65, block_size=64, n_layer=2, n_head=2, n_embd=32,
               dropout=0.0, attn_dropout=0.0, dtype="float32")
TCFG = ModelConfig(vocab_size=65, block_size=64, n_layer=2, n_head=2,
                   n_embd=32, dtype="float32")
POOL = dict(pool_size=2, max_queue=16)
#: the counters both routers must agree on
COUNTERS = ("fleet_requests_submitted", "fleet_dedup_rejects",
            "fleet_requests_routed", "fleet_requests_finished",
            "fleet_requeued_requests", "fleet_requeue_submits",
            "fleet_requeue_retries", "fleet_requeue_exhausted",
            "fleet_replica_kills", "fleet_replica_wedges",
            "fleet_replica_rejoins", "fleet_stale_finishes")
#: the wedge scenario: replica 0's steps 4-5 stall 0.4 s against a 0.2 s
#: budget (a tiny model's step takes milliseconds on either side, so only
#: the injected stalls cross it, even on a loaded host)
WEDGE = dict(at=4, times=2, arg=0.4, arg2=0)
WEDGE_RCFG = dict(wedge_budget_s=0.2, wedge_patience=2, quarantine_steps=5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jtree():
    return jinit(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def model(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                             TCFG, device="cpu")


def _reqs(make, sampling, n=8, seed=7, max_new=10, greedy=True):
    rng = np.random.default_rng(seed)
    return [make(
        id=f"r{i}",
        prompt=rng.integers(1, 64, (int(rng.integers(2, 12)),))
        .astype(np.int32),
        max_new_tokens=max_new,
        sampling=sampling(greedy=greedy, top_k=20, temperature=0.9),
        rng_seed=100 + i) for i in range(n)]


def _drive(router, reqs, clock=None):
    """Submit ``reqs`` (and a duplicate of the first), then step to idle
    while reading the delivery ledger each step; after step 5 every
    unfinished id is submitted again (a stale client retry, rejected
    fleet-wide). Asserts no id is active on two live replicas at any
    step. Returns (tokens and reason by id, first replica by id, the
    counters of COUNTERS, the delivered streams)."""
    for q in reqs:
        assert router.submit(q) is None
    first = {rid: fi.replica for rid, fi in router._inflight.items()}
    assert router.submit(reqs[0]) is not None
    results, streams = {}, {q.id: [] for q in reqs}
    steps = 0
    while not router.idle:
        for res in router.step():
            results[res.id] = res
        steps += 1
        if clock is not None:
            clock.advance(0.01)
        for rid in streams:
            streams[rid].extend(router.take_new_tokens(rid))
        if steps == 5:
            for q in reqs:
                if q.id not in results:
                    dup = router.submit(q)
                    assert dup.finish_reason == REJECT_BAD_REQUEST
        live = [rid for rep in router.replicas if rep.alive
                for rid in rep.engine.in_flight_ids()
                if hasattr(rep.engine, "in_flight_ids")]
        assert len(live) == len(set(live)), live
        assert steps < 500
    c = router.metrics.counters
    out = ({k: (list(v.tokens), v.finish_reason) for k, v in results.items()},
           first, {k: int(c.get(k, 0)) for k in COUNTERS}, streams)
    router.close()
    return out


def _jax_scenario(jtree, name, journal_dir):
    clock = JStepClock() if name == "wedge" else None
    faults = {"clean": (),
              "kill": (JFault(site=FLEET_STEP, kind=KIND_REPLICA_KILL,
                              at=3, arg=0),),
              "wedge": (JFault(site=FLEET_STEP, kind=KIND_REPLICA_WEDGE,
                               **WEDGE),)}[name]
    rkw = WEDGE_RCFG if name == "wedge" else {}
    with jinstalled(JFaultPlan(*faults)):
        r = JRouter(jtree, JCFG,
                    JRouterConfig(n_replicas=2, journal_dir=journal_dir,
                                  **rkw),
                    JEngineConfig(**POOL),
                    **({"clock": clock} if clock else {}))
        return _drive(r, _reqs(JRequest, JSampling), clock)


def _port_scenario(model, name, journal_dir, ecfg=None, greedy=True):
    clock = StepClock() if name == "wedge" else None
    faults = {"clean": (),
              "kill": (Fault(site=FLEET_STEP, kind=KIND_REPLICA_KILL,
                             at=3, arg=0),),
              "wedge": (Fault(site=FLEET_STEP, kind=KIND_REPLICA_WEDGE,
                              **WEDGE),)}[name]
    rkw = WEDGE_RCFG if name == "wedge" else {}
    with installed(FaultPlan(*faults)):
        r = Router(model, TCFG,
                   RouterConfig(n_replicas=2, journal_dir=journal_dir,
                                **rkw),
                   ecfg or EngineConfig(**POOL), device="cpu",
                   **({"clock": clock} if clock else {}))
        return _drive(r, _reqs(Request, SamplingParams, greedy=greedy),
                      clock)


@pytest.fixture(scope="module")
def jax_runs(jtree, tmp_path_factory):
    return {name: _jax_scenario(jtree, name,
                                str(tmp_path_factory.mktemp(f"j{name}")))
            for name in ("clean", "kill", "wedge")}


@pytest.mark.parametrize("name", ["clean", "kill", "wedge"])
def test_router_matches_jax_router(model, jax_runs, name, tmp_path):
    """Tokens, finish reasons, first routes, fleet counters and
    exactly-once delivery equal the JAX router's."""
    got = _port_scenario(model, name, str(tmp_path))
    want = jax_runs[name]
    toks, first, counters, streams = got
    assert toks == want[0]
    assert first == want[1]
    assert counters == want[2]
    assert streams == want[3]
    assert all(streams[k] == v[0] for k, v in toks.items())
    assert all(reason == FINISH_MAX_TOKENS for _, reason in toks.values())
    assert counters["fleet_dedup_rejects"] >= 1
    if name == "kill":
        assert counters["fleet_replica_kills"] == 1
        assert counters["fleet_requeued_requests"] > 0
    if name == "wedge":
        assert counters["fleet_replica_wedges"] >= 1
        assert counters["fleet_replica_rejoins"] >= 1


def test_windowed_fleet_under_wedge_and_kill(model, jax_runs, tmp_path):
    """A fleet of windowed engines (``--decode-window 4``): the wedge's
    hedged re-route cancels with ``migrated=True`` and resubmits in the
    same step, the kill requeues from the journal; the streams equal the
    JAX router's clean run."""
    ecfg = EngineConfig(decode_window=4, **POOL)
    for name in ("wedge", "kill"):
        toks, _, counters, streams = _port_scenario(
            model, name, str(tmp_path / name), ecfg=ecfg)
        assert toks == jax_runs["clean"][0], name
        assert streams == jax_runs["clean"][3], name
        assert counters["fleet_requeued_requests"] > 0, name


def test_migrated_cancel_frees_the_slot_now(model):
    """``cancel(migrated=True)`` on a windowed engine with a window in
    flight reads it, frees the slot and pages at once (the id can be
    submitted again before the next step), journals nothing twice and
    surfaces the cancelled result from the next step; a plain cancel
    waits for the next window boundary."""
    eng = Engine(model, TCFG, EngineConfig(decode_window=4, pool_size=2),
                 device="cpu")
    a = Request(id="a", prompt=np.arange(1, 9, dtype=np.int32),
                max_new_tokens=30, sampling=SamplingParams(greedy=True))
    b = Request(id="b", prompt=np.arange(3, 9, dtype=np.int32),
                max_new_tokens=30, sampling=SamplingParams(greedy=True))
    assert eng.submit(a) is None and eng.submit(b) is None
    for _ in range(4):
        eng.step()
    assert eng._inflight is not None and eng.partial_tokens("a")
    assert eng.cancel("b")                       # plain: a kill flag
    assert eng.pool.slot_of("b") is not None
    assert eng.cancel("a", migrated=True)
    assert eng.pool.slot_of("a") is None and eng._inflight is None
    assert eng.partial_tokens("a") is None
    assert eng.in_flight_ids() == ["b"]
    assert eng.submit(a) is None                 # the id is free again
    out = {r.id: r for r in eng.step()}
    assert out["a"].finish_reason == FINISH_CANCELLED
    assert out["a"].tokens
    assert eng.metrics_summary()["window_breaks"]["cancel"] == 1
    assert out["b"].finish_reason == FINISH_CANCELLED   # at the boundary
    done = {r.id: r for r in eng.drain()}
    assert done["a"].finish_reason == FINISH_MAX_TOKENS


def test_sampled_requests_regenerate_after_kill(model, tmp_path):
    """Sampled requests with fixed rng_seeds, killed mid-decode and
    regenerated on the other replica, give the uninterrupted streams:
    each slot draws from its own generator, seeded from rng_seed."""
    clean = _port_scenario(model, "clean", str(tmp_path / "c"),
                           greedy=False)
    killed = _port_scenario(model, "kill", str(tmp_path / "k"),
                            greedy=False)
    assert killed[2]["fleet_requeued_requests"] > 0
    assert killed[0] == clean[0]
    assert killed[3] == clean[3]


def test_router_ledger_recovery_after_restart(model, jax_runs, tmp_path):
    """A router that dies with requests in flight: its successor, on the
    same ledger, requeues the accepted-but-unfinished ones and finishes
    them with the uninterrupted tokens; a second restart recovers
    nothing."""
    ledger = str(tmp_path / "ledger.jsonl")
    reqs = _reqs(Request, SamplingParams)
    r = Router(model, TCFG, RouterConfig(n_replicas=2, ledger_path=ledger),
               EngineConfig(**POOL), device="cpu")
    for q in reqs:
        assert r.submit(q) is None
    done = {}
    for _ in range(12):
        done.update({res.id: res for res in r.step()})
    assert 0 < len(done) < len(reqs)
    r.close()                                    # the crash
    r2 = Router(model, TCFG, RouterConfig(n_replicas=2, ledger_path=ledger),
                EngineConfig(**POOL), device="cpu")
    assert (r2.metrics.counters["fleet_ledger_recovered"]
            == len(reqs) - len(done))
    rest = {res.id: res for res in r2.drain()}
    assert sorted(rest) == sorted(q.id for q in reqs if q.id not in done)
    want = jax_runs["clean"][0]
    for rid, res in {**done, **rest}.items():
        assert list(res.tokens) == want[rid][0], rid
    r2.close()
    r3 = Router(model, TCFG, RouterConfig(n_replicas=1, ledger_path=ledger),
                EngineConfig(**POOL), device="cpu")
    assert "fleet_ledger_recovered" not in r3.metrics.counters
    r3.close()


def test_duplicate_id_rejected_before_and_after_kill(model, tmp_path):
    """An in-flight id is rejected fleet-wide, before a kill and while its
    request sits between replicas after one; each request decodes once."""
    reqs = _reqs(Request, SamplingParams, n=4, max_new=12)
    with installed(FaultPlan(Fault(site=FLEET_STEP, kind=KIND_REPLICA_KILL,
                                   at=3, arg=0))):
        r = Router(model, TCFG,
                   RouterConfig(n_replicas=2, journal_dir=str(tmp_path),
                                retry_backoff_steps=2),
                   EngineConfig(**POOL), device="cpu")
        for q in reqs:
            assert r.submit(q) is None
        assert r.submit(reqs[0]).finish_reason == REJECT_BAD_REQUEST
        results, retried = {}, False
        while not r.idle:
            results.update({res.id: res for res in r.step()})
            if r.metrics.counters.get("fleet_replica_kills") and not retried:
                retried = True
                for q in reqs:
                    if q.id not in results:
                        assert (r.submit(q).finish_reason
                                == REJECT_BAD_REQUEST), q.id
    assert retried
    assert sorted(results) == sorted(q.id for q in reqs)
    assert r.metrics.counters["fleet_requests_finished"] == len(reqs)
    assert r.metrics.counters["fleet_dedup_rejects"] >= 2
    r.close()


def test_kill_with_no_survivors_exhausts_retry_ladder(model, tmp_path):
    reqs = _reqs(Request, SamplingParams, n=3, max_new=12)
    with installed(FaultPlan(Fault(site=FLEET_STEP, kind=KIND_REPLICA_KILL,
                                   at=2, arg=0))):
        r = Router(model, TCFG,
                   RouterConfig(n_replicas=1, journal_dir=str(tmp_path),
                                retry_max=2, retry_backoff_steps=1),
                   EngineConfig(**POOL), device="cpu")
        for q in reqs:
            assert r.submit(q) is None
        results = {res.id: res for res in r.drain(max_steps=200)}
    assert r.n_alive == 0 and len(results) == len(reqs)
    assert all(res.finish_reason == REJECT_FLEET_CAPACITY
               for res in results.values())
    assert r.metrics.counters["fleet_requeue_exhausted"] == len(reqs)
    r.close()


def test_cancel_of_requeued_request_surfaces_from_step(model, tmp_path):
    reqs = _reqs(Request, SamplingParams, n=2, max_new=12)
    with installed(FaultPlan(Fault(site=FLEET_STEP, kind=KIND_REPLICA_KILL,
                                   at=2, arg=0))):
        r = Router(model, TCFG,
                   RouterConfig(n_replicas=1, journal_dir=str(tmp_path),
                                retry_max=5, retry_backoff_steps=8),
                   EngineConfig(**POOL), device="cpu")
        for q in reqs:
            assert r.submit(q) is None
        for _ in range(4):
            r.step()
        assert r._requeue, "expected requests between replicas"
        target = r._requeue[0].req.id
        assert r.cancel(target)
        assert not r.idle
        surfaced = r.step()
    assert any(res.id == target and res.finish_reason == FINISH_CANCELLED
               for res in surfaced)
    assert r.result(target).finish_reason == FINISH_CANCELLED
    r.close()


def test_process_fault_kinds(model):
    """``proc_kill``, ``proc_hang`` and ``host_loss`` are logged and
    ignored by a router without a supervisor (the in-process fleet), as
    the JAX router does; ``transfer_kill``'s tiers are refused with their
    ROADMAP item."""
    for kind in (KIND_PROC_KILL, KIND_PROC_HANG, KIND_HOST_LOSS):
        with installed(FaultPlan(Fault(site=FLEET_STEP, kind=kind, at=0,
                                       arg=0))):
            r = Router(model, TCFG, RouterConfig(n_replicas=1),
                       EngineConfig(**POOL), device="cpu")
            r.step()
            assert f"{kind} ignored" in r.events[-1]
            r.close()
    with pytest.raises(NotImplementedError, match=r"item 9\(e\)"):
        Router(model, TCFG, RouterConfig(tiers=("prefill", "decode")),
               device="cpu")


def test_hot_key_skew_and_sessions_match_jax():
    """``make_sessions`` draws the JAX package's sessions from the same
    seed; with ``hot_key_skew`` planned every session joins group 0."""
    kw = dict(n_sessions=16, turns=2, n_prefix_groups=4, prefix_len=8,
              seed=5)
    base, jbase = (make_sessions(TCFG, SessionLoadConfig(**kw)),
                   jmake_sessions(JCFG, JSessionLoadConfig(**kw)))
    for s, j in zip(base, jbase):
        assert (s.group, s.due_t) == (j.group, j.due_t)
        assert np.array_equal(s.context, j.context)
        assert all(np.array_equal(a, b)
                   for a, b in zip(s.user_turns, j.user_turns))
    with installed(FaultPlan(Fault(site=FLEET_SESSION,
                                   kind=KIND_HOT_KEY_SKEW, at=0, times=16,
                                   arg=1.0))) as plan:
        skewed = make_sessions(TCFG, SessionLoadConfig(**kw))
        assert plan.count(FLEET_SESSION) == 16
    assert len({s.group for s in base}) > 1
    assert all(s.group == 0 for s in skewed)


LCFG = dict(n_sessions=8, turns=3, prefix_len=12, n_prefix_groups=2,
            max_new_tokens=4, user_len_min=2, user_len_max=3, seed=3)


@pytest.fixture(scope="module")
def jax_hit_rates(jtree):
    out = {}
    for n, aff in ((1, True), (2, True), (2, False)):
        s = jrun_fleet_replay(jtree, JCFG, JSessionLoadConfig(**LCFG),
                              JRouterConfig(n_replicas=n, affinity=aff),
                              JEngineConfig(pool_size=2, max_queue=32,
                                            page_size=4),
                              warmup=False, virtual_dt=0.01)
        out[(n, aff)] = s["aggregate_prefix_hit_rate"]
    return out


def test_prefix_affinity_keeps_fleet_hit_rate(model, jax_hit_rates):
    """Session traffic: the 2-replica fleet's prefix-hit rate stays within
    10% of one replica's and beats the fleet without affinity; each of the
    three equals the JAX fleet's. Every turn completes, and the streams
    are the delivered tokens exactly once."""
    got = {}
    for n, aff in ((1, True), (2, True), (2, False)):
        s = run_fleet_replay(model, TCFG, SessionLoadConfig(**LCFG),
                             RouterConfig(n_replicas=n, affinity=aff),
                             EngineConfig(pool_size=2, max_queue=32,
                                          page_size=4),
                             warmup=False, virtual_dt=0.01,
                             collect_streams=True, device="cpu")
        assert s["n_completed"] == LCFG["n_sessions"] * LCFG["turns"]
        assert all(s["streams"][k] == list(v.tokens)
                   for k, v in s["results"].items())
        got[(n, aff)] = s["aggregate_prefix_hit_rate"]
    assert got == jax_hit_rates
    single, fleet, blind = got[(1, True)], got[(2, True)], got[(2, False)]
    assert single > 0.3, single
    assert fleet >= 0.9 * single, (fleet, single)
    assert fleet >= blind, (fleet, blind)
