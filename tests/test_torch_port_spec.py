"""Speculative decoding and the serving engine's self-healing in the port,
on the CPU, against the JAX package (f32, dropout off, test-tiny width).

The functions: ``decode_step_multi``, ``verify_step_multi`` (padding and
past-the-buffer writes dropped on both sides) and
``prefill_chunk_into_slot`` at 1e-5, logits and cache; greedy acceptance
exactly; stochastic acceptance in distribution (total variation <= 0.02
over 20,000 draws); the n-gram drafter's proposals, the watchdog, the
speculative health monitor, the load shedder and the request journal
exactly. The engine: greedy streams with each drafter equal the port's
non-speculative engine and the JAX speculative engine on the kernel and
gather routes; a model drafter with the target's weights accepts all;
the accept-collapse fault, shedding, the operator pin, the stall seam
and the journal's crash recovery. The CLI's ``--spec``.
"""

import contextlib
import dataclasses
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replicatinggpt_tpu import faults as jfaults
from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.faults import watchdog as jwd
from replicatinggpt_tpu.models import gpt as jgpt
from replicatinggpt_tpu.serve import Engine as JEngine
from replicatinggpt_tpu.serve import EngineConfig as JEngineConfig
from replicatinggpt_tpu.serve import ModelDrafter as JModelDrafter
from replicatinggpt_tpu.serve import NGramDrafter as JNGramDrafter
from replicatinggpt_tpu.serve import Request as JRequest
from replicatinggpt_tpu.serve import RequestJournal as JJournal
from replicatinggpt_tpu.serve import SamplingParams as JSampling
from replicatinggpt_tpu.serve import speculative as jspec
from replicatinggpt_tpu_torch import cli, faults
from replicatinggpt_tpu_torch.config import ModelConfig
from replicatinggpt_tpu_torch.faults import watchdog as twd
from replicatinggpt_tpu_torch.models import gpt as tgpt
from replicatinggpt_tpu_torch.models.gpt import params_from_numpy
from replicatinggpt_tpu_torch.serve import (Engine, EngineConfig,
                                            JournalBusyError, ModelDrafter,
                                            NGramDrafter, Request,
                                            RequestJournal, SamplingParams,
                                            draft_config_from_preset,
                                            make_drafter)
from replicatinggpt_tpu_torch.serve import engine as engine_mod
from replicatinggpt_tpu_torch.serve import speculative as tspec
from replicatinggpt_tpu_torch.serve.requests import (FINISH_MAX_TOKENS,
                                                     FINISH_SHED)
from replicatinggpt_tpu_torch.serve.speculative import DraftContext
from replicatinggpt_tpu_torch.serve.cache_pool import CachePool

JCFG = JConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2, n_embd=32,
               dropout=0.0, attn_dropout=0.0, dtype="float32",
               decode_cache_layout="packed")
TCFG = ModelConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2,
                   n_embd=32, dtype="float32", decode_cache_layout="packed")
TOL = dict(atol=1e-5, rtol=1e-5)
POOL = dict(pool_size=3, page_size=8, prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The JAX init tree with its matrices and embeddings scaled by 8 (at
    init scale a 2-layer model repeats one token): as JAX arrays, the
    port's compute params and its model."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jgpt.init_params(jax.random.PRNGKey(3),
                                                   JCFG))
    for name, arr in tree["blocks"].items():
        if name.endswith("_kernel"):
            tree["blocks"][name] = 8 * arr
    for name in ("wte", "wpe"):
        tree[name] = 8 * tree[name]
    model = params_from_numpy(tree, TCFG, device="cpu")
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tgpt.compute_params(model, "cpu"), model)


def _caches(B: int, seed: int = 0):
    """A contiguous (L, B, S, C) cache with random rows, JAX and torch."""
    rng = np.random.default_rng(seed)
    arrs = {n: rng.standard_normal((2, B, 32, 32)).astype(np.float32)
            for n in ("k", "v")}
    return ({n: jnp.asarray(a) for n, a in arrs.items()},
            {n: torch.from_numpy(a.copy()) for n, a in arrs.items()})


def _assert_caches(tc, jc):
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   err_msg=n, **TOL)


# ------------------------------------------------------------- functions


def test_decode_step_multi_matches_jax(weights):
    """Per-slot positions, one slot past the buffer (its write drops on
    both sides, its position embedding the last row's)."""
    jparams, tparams, _ = weights
    jc, tc = _caches(4)
    tok = np.array([3, 17, 60, 5], np.int32)
    pos = np.array([0, 13, 31, 32], np.int32)
    fn = jax.jit(functools.partial(jgpt.decode_step_multi, cfg=JCFG))
    want, jc = fn(jparams, jnp.asarray(tok), jnp.asarray(pos), jc)
    got, tc = tgpt.decode_step_multi(tparams, torch.from_numpy(tok),
                                     torch.from_numpy(pos), tc, TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches(tc, jc)


def test_verify_step_multi_matches_jax(weights):
    """A (B, W=5) window: full windows, padding rows (n_valid < 4) and a
    slot near the end of its buffer whose rows past it drop."""
    jparams, tparams, _ = weights
    jc, tc = _caches(3, seed=1)
    rng = np.random.default_rng(2)
    window = rng.integers(0, 65, (3, 5)).astype(np.int32)
    pos = np.array([0, 10, 29], np.int32)
    n_valid = np.array([4, 1, 4], np.int32)
    fn = jax.jit(functools.partial(jgpt.verify_step_multi, cfg=JCFG))
    want, jc = fn(jparams, jnp.asarray(window), jnp.asarray(pos),
                  jnp.asarray(n_valid), jc)
    got, tc = tgpt.verify_step_multi(tparams, torch.from_numpy(window),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(n_valid), tc, TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches(tc, jc)


def test_prefill_chunk_into_slot_matches_jax(weights):
    jparams, tparams, _ = weights
    jc, tc = _caches(3, seed=3)
    chunk = np.random.default_rng(4).integers(0, 65, (1, 8)).astype(np.int32)
    fn = jax.jit(functools.partial(jgpt.prefill_chunk_into_slot, cfg=JCFG))
    jc = fn(jparams, jnp.asarray(chunk), jnp.int32(16), jnp.int32(1), jc)
    tc = tgpt.prefill_chunk_into_slot(tparams, torch.from_numpy(chunk), 16,
                                      1, tc, TCFG)
    _assert_caches(tc, jc)


def _accept_inputs(B, W, V, seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((B, W, V))).astype(np.float32)
    window = rng.integers(0, V, (B, W)).astype(np.int32)
    # half the drafts are the raw argmax of the position before them
    hit = rng.random((B, W - 1)) < 0.7
    window[:, 1:] = np.where(hit, logits[:, :-1].argmax(-1), window[:, 1:])
    n_valid = rng.integers(0, W, (B,)).astype(np.int32)
    return logits, window, n_valid


def test_spec_accept_greedy_matches_jax():
    """Greedy rows: the accepted counts and committed tokens equal JAX's
    exactly."""
    B, W, V = 16, 5, 65
    logits, window, n_valid = _accept_inputs(B, W, V, 0)
    temp = np.full((B,), 0.8, np.float32)
    top_k = np.full((B,), 10, np.int32)
    top_p = np.zeros((B,), np.float32)
    greedy = np.ones((B,), bool)
    n_j, out_j, _ = jax.jit(jspec.spec_accept_and_sample)(
        jax.random.split(jax.random.PRNGKey(0), B), jnp.asarray(logits),
        jnp.asarray(window), jnp.asarray(n_valid), jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(greedy))
    noise = tspec.spec_noise([None] * B, B, W, V, "cpu")
    n_t, out_t = tspec.spec_accept_and_sample(
        torch.from_numpy(logits), torch.from_numpy(window),
        torch.from_numpy(n_valid), torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p),
        torch.from_numpy(greedy), noise)
    assert n_t.tolist() == np.asarray(n_j).tolist()
    assert out_t.tolist() == np.asarray(out_j).tolist()
    assert 0 < int(n_t.sum()) < int(n_valid.sum())


@pytest.mark.parametrize("draft", ["right", "wrong", "random"])
def test_spec_accept_stochastic_distribution(draft):
    """Sampled rows: over 20,000 draws the first committed token follows
    the filtered target distribution (temperature 0.9, top-k 6 of V = 8)
    within total variation 0.02, whatever the draft: always the target's
    most likely token, always one outside its support, or random."""
    N, W, V = 20_000, 3, 8
    base = np.array([2.0, 1.5, 1.0, 0.5, 0.3, 0.0, -0.5, -1.0], np.float32)
    logits = torch.from_numpy(np.broadcast_to(base, (N, W, V)).copy())
    g = torch.Generator().manual_seed(7)
    d = {"right": torch.zeros((N, W - 1), dtype=torch.long),
         "wrong": torch.full((N, W - 1), 7, dtype=torch.long),
         "random": torch.randint(0, V, (N, W - 1), generator=g)}[draft]
    window = torch.cat([torch.zeros((N, 1), dtype=torch.long), d], 1)
    n_valid = torch.full((N,), W - 1)
    temp, top_k = torch.full((N,), 0.9), torch.full((N,), 6)
    top_p = torch.zeros((N,))
    noise = (torch.rand((N, W), generator=g),
             torch.empty((2, N, V)).exponential_(1, generator=g))
    n_acc, out = tspec.spec_accept_and_sample(
        logits, window, n_valid, temp, top_k, top_p,
        torch.zeros((N,), dtype=torch.bool), noise)
    assert bool((n_acc <= n_valid).all()) and bool((out >= 0).all())
    assert bool((out < V).all())
    want = torch.softmax(torch.where(torch.arange(V) < 6,
                                     torch.from_numpy(base) / 0.9,
                                     torch.tensor(-torch.inf)), 0)
    got = torch.bincount(out[:, 0].long(), minlength=V).double() / N
    tv = 0.5 * (got - want.double()).abs().sum().item()
    assert tv <= 0.02, (draft, tv, got.tolist())
    if draft == "wrong":
        assert int(n_acc.max()) == 0


def test_ngram_drafter_matches_jax():
    rng = np.random.default_rng(5)
    hists = [rng.integers(0, 6, (int(rng.integers(1, 30)),))
             .astype(np.int32) for _ in range(12)] + [None]
    P = len(hists)
    ctx = dict(tok=np.zeros((P,), np.int32), pos=np.zeros((P,), np.int32),
               active=np.array([h is not None for h in hists]),
               histories=hists)
    for k, n in ((4, 3), (2, 1), (5, 2)):
        want = JNGramDrafter(k, ngram=n).draft(jspec.DraftContext(**ctx))
        got = NGramDrafter(k, ngram=n).draft(DraftContext(**ctx))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert want[1].sum() > 0


def test_policies_match_jax():
    """The watchdog, the speculative health monitor and the shedder make
    JAX's decisions over one seeded sequence of observations."""
    rng = np.random.default_rng(9)
    cfg = dict(stall_factor=2.5, stall_floor_s=0.0, stall_min_steps=6,
               spec_disable_threshold=0.4, spec_window=4,
               spec_reprobe_after=3, shed_watermark=0.3, shed_patience=2)
    j, t = jwd.ResilienceConfig(**cfg), twd.ResilienceConfig(**cfg)
    assert (twd.DEFAULT_SERVE_RESILIENCE.__dict__
            == jwd.DEFAULT_SERVE_RESILIENCE.__dict__)
    laps = np.where(rng.random(200) < 0.05, 0.2, 0.01 + 0.002 *
                    rng.random(200))
    jw, tw = jwd.StepWatchdog(j), twd.StepWatchdog(t)
    got = [tw.observe(float(x)) for x in laps]
    assert got == [jw.observe(float(x)) for x in laps] and any(got)
    jh, th = jwd.SpecHealth(j), twd.SpecHealth(t)
    dec_j, dec_t = [], []
    for drafted, rate in zip(rng.integers(0, 9, 300), rng.random(300)):
        acc = int(drafted * rate)
        for h, out in ((jh, dec_j), (th, dec_t)):
            if h.cooldown > 0:
                out.append(("tick", h.tick_disabled()))
            elif h.observe(int(drafted), acc):
                h.on_disable()
                out.append(("disable", h.cooldown))
            elif len(h.window) == h.cfg.spec_window and acc > 4:
                h.on_reenable()
                out.append(("reenable",))
    assert dec_t == dec_j and ("disable", 3) in dec_t
    js, ts = jwd.LoadShedder(j), twd.LoadShedder(t)
    depths = rng.integers(0, 20, 300)
    got = [ts.observe(int(d), 16) for d in depths]
    assert got == [js.observe(int(d), 16) for d in depths] and any(got)


def _jreq(r):
    sp = r.sampling
    return JRequest(id=r.id, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens,
                    sampling=JSampling(temperature=sp.temperature,
                                       top_k=sp.top_k, top_p=sp.top_p,
                                       greedy=sp.greedy),
                    rng_seed=r.rng_seed, eos_token_id=r.eos_token_id)


def test_journal_matches_jax(tmp_path):
    """The same submits and finishes give the same lines; a file written
    by either side gives the same unfinished set on the other, with a
    torn tail record; the write lock refuses a second writer."""
    reqs = [Request(id=f"j{i}", prompt=np.arange(i + 1), max_new_tokens=3,
                    sampling=SamplingParams(temperature=0.7, top_k=5,
                                            greedy=i % 2 == 0),
                    rng_seed=10 + i, eos_token_id=(4 if i == 2 else None))
            for i in range(5)]
    paths = {}
    for side, J, mk in (("t", RequestJournal, lambda r: r),
                        ("j", JJournal, _jreq)):
        path = str(tmp_path / f"{side}.jsonl")
        jr = J(path, lock=True)
        for r in reqs:
            jr.record_submit(mk(r))
        jr.record_finish("j1", "max_tokens")
        jr.record_finish("j3", "shed")
        jr.close()
        with open(path, "a") as f:
            f.write('{"ev": "submit", "id": "torn", "pro')
        paths[side] = path
    lines = {s: open(p).read().splitlines() for s, p in paths.items()}
    assert lines["t"] == lines["j"]
    for path in paths.values():
        want = [(r.id, r.prompt.tolist(), r.rng_seed, r.eos_token_id)
                for r in JJournal.unfinished(path)]
        got = [(r.id, r.prompt.tolist(), r.rng_seed, r.eos_token_id)
               for r in RequestJournal.unfinished(path)]
        assert got == want and [g[0] for g in got] == ["j0", "j2", "j4"]
    held = RequestJournal(paths["t"], lock=True)
    with pytest.raises(JournalBusyError):
        RequestJournal(paths["t"], lock=True)
    held.close()


# ---------------------------------------------------------------- engine


def _trace():
    """(prompt, max_new) per request: tiled short patterns (the n-gram
    drafter's regime) and random prompts, one running to its buffer's
    end (a length cap)."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(6):
        pat = rng.integers(0, 65, (int(rng.integers(1, 4)),))
        P = int(rng.integers(3, 14))
        prompt = (np.tile(pat, P)[:P] if i % 2 == 0
                  else rng.integers(0, 65, (P,)))
        out.append((prompt.astype(np.int32), 33 - P if i == 3 else
                    int(rng.integers(6, 16))))
    return out


def _drive(engine, make_request):
    for i, (prompt, n) in enumerate(_trace()):
        assert engine.submit(make_request(f"q{i}", prompt, n)) is None
    return {r.id: list(r.tokens) for r in engine.drain()}


def _treq(rid, prompt, n):
    return Request(id=rid, prompt=prompt, max_new_tokens=n,
                   sampling=SamplingParams(greedy=True),
                   rng_seed=sum(map(ord, rid)))


def _engine(model, route="kernel", drafter=None, **kw):
    eng = Engine(model, TCFG, EngineConfig(paged_kernel=route != "gather",
                                           **{**POOL, **kw}),
                 device="cpu", drafter=drafter)
    assert eng.kernel_route.verify == (
        "none" if drafter is None else route if route != "fused"
        else "kernel"), eng.kernel_route
    return eng


@pytest.fixture(scope="module")
def draft():
    """A 1-layer draft model of another seed: its config and model."""
    cfg = dataclasses.replace(TCFG, n_layer=1)
    return cfg, tgpt.init_params(cfg, torch.Generator().manual_seed(4),
                                 "cpu")


@pytest.fixture(scope="module")
def jax_spec(weights):
    """The JAX speculative engine's greedy streams, k = 4 (its gather
    route), with the n-gram drafter and with a model drafter of the
    target's weights (the collapse test's drafter: one set of JAX
    programs)."""
    jparams = weights[0]
    out = {}
    for kind, d in (("ngram", JNGramDrafter(4, ngram=3)),
                    ("model", JModelDrafter(jparams, JCFG, 4, 3))):
        eng = JEngine(jparams, JCFG, JEngineConfig(**POOL), drafter=d)
        out[kind] = _drive(eng, lambda rid, p, n: _jreq(_treq(rid, p, n)))
        out[kind + "_summary"] = eng.metrics_summary()["speculative"]
    return out


def test_engine_spec_streams_equal_plain_and_jax(weights, draft, jax_spec,
                                                monkeypatch):
    """Greedy streams with the n-gram drafter, a model drafter of other
    weights (1 layer, another seed) and one of the target's weights equal
    the port's plain engine's and the JAX speculative engine's, on the
    kernel route (the plain version of ``paged_window_attention`` at W =
    5) and the gather route; the accept rates equal JAX's, and the
    target-weight drafter's is 1."""
    *_, model = weights
    base = _drive(_engine(model), _treq)
    assert base == jax_spec["ngram"] == jax_spec["model"]
    calls = []

    def spy(*a, **kw):
        calls.append((a[1].shape[1], kw.get("use_kernel")))
        return tgpt.verify_step_paged(*a, **kw)

    monkeypatch.setattr(engine_mod, "verify_step_paged", spy)
    drafters = {"ngram": lambda: NGramDrafter(4, ngram=3),
                "model": lambda: ModelDrafter(model, TCFG, 4, 3,
                                              device="cpu"),
                "other": lambda: ModelDrafter(draft[1], draft[0], 4, 3,
                                              device="cpu")}
    for kind, make in drafters.items():
        for route in ("kernel", "gather"):
            eng = _engine(model, route, make())
            calls.clear()
            got = _drive(eng, _treq)
            assert got == base, (kind, route)
            sp = eng.metrics_summary()["speculative"]
            assert calls and set(calls) == {(5, route == "kernel")}
            assert len(calls) == sp["verify_steps"]
            if kind in jax_spec:
                assert sp["accept_rate"] == jax_spec[kind + "_summary"][
                    "accept_rate"], (kind, route)
    assert 0 < jax_spec["ngram_summary"]["accept_rate"] < 1
    assert jax_spec["model_summary"]["accept_rate"] == 1.0


def test_engine_spec_on_windowed_engine(weights):
    """A drafter on a windowed engine (decode_window 4): speculation
    runs, no window does, and the streams are the plain engine's."""
    *_, model = weights
    base = _drive(_engine(model), _treq)
    eng = _engine(model, drafter=NGramDrafter(4), decode_window=4)
    assert _drive(eng, _treq) == base
    s = eng.metrics_summary()
    assert s["dispatch"]["decode_windows"] == 0
    assert s["speculative"]["verify_steps"] > 0


def test_model_drafter_with_target_weights_accepts_all(weights):
    """At k = 3."""
    *_, model = weights
    eng = _engine(model, drafter=ModelDrafter(model, TCFG, 3, 3,
                                              device="cpu"))
    base = _drive(_engine(model), _treq)
    assert _drive(eng, _treq) == base
    assert eng.metrics_summary()["speculative"]["accept_rate"] == 1.0


def _collapse_reqs(make=_treq):
    return [make("a", np.array([5, 6, 5, 6, 5, 6], np.int32), 24),
            make("b", np.array([7, 8, 7, 8, 7, 8], np.int32), 24)]


def test_accept_collapse_disables_then_reprobes_as_jax(weights):
    """The ``spec/draft`` collapse fault: exactly one disable and one
    re-probe, as the JAX engine counts them, speculation healthy again at
    the end, and the streams the plain engine's."""
    jparams, _, model = weights
    kw = dict(spec_disable_threshold=0.4, spec_window=3,
              spec_reprobe_after=4)
    counts = {}
    jeng = JEngine(jparams, JCFG, JEngineConfig(**POOL),
                   drafter=JModelDrafter(jparams, JCFG, 4, 3),
                   rcfg=jwd.ResilienceConfig(**kw))
    for r in _collapse_reqs(lambda *a: _jreq(_treq(*a))):
        assert jeng.submit(r) is None
    with jfaults.installed(jfaults.FaultPlan(jfaults.Fault(
            site="spec/draft", kind="collapse", times=3))):
        jout = {r.id: r.tokens for r in jeng.drain()}
    counts["jax"] = {k: jeng.metrics.counters.get(k, 0)
                     for k in ("spec_disables", "spec_reprobes")}
    eng = Engine(model, TCFG, EngineConfig(paged_kernel=True, **POOL),
                 device="cpu", drafter=ModelDrafter(model, TCFG, 4, 3,
                                                    device="cpu"),
                 rcfg=twd.ResilienceConfig(**kw))
    reqs = _collapse_reqs()
    for r in reqs:
        assert eng.submit(r) is None
    with faults.installed(faults.FaultPlan(faults.Fault(
            site="spec/draft", kind="collapse", times=3))):
        out = {r.id: r for r in eng.drain()}
    counts["torch"] = {k: eng.metrics.counters.get(k, 0)
                       for k in ("spec_disables", "spec_reprobes")}
    assert counts["torch"] == counts["jax"] == {"spec_disables": 1,
                                                "spec_reprobes": 1}, counts
    assert eng.spec_active and any("re-probe" in e for e in eng.events)
    plain = Engine(model, TCFG, EngineConfig(**POOL), device="cpu")
    for r in reqs:
        assert plain.submit(r) is None
    want = {r.id: r.tokens for r in plain.drain()}
    for r in reqs:
        assert out[r.id].finish_reason == FINISH_MAX_TOKENS
        assert out[r.id].tokens == want[r.id] == jout[r.id]
    assert eng.metrics_summary()["recovery"]["spec_disables"] == 1


def test_operator_spec_pin_sticks(weights):
    *_, model = weights
    eng = Engine(model, TCFG, EngineConfig(pool_size=1, max_queue=4),
                 device="cpu", drafter=NGramDrafter(2),
                 rcfg=twd.ResilienceConfig(spec_disable_threshold=0.4,
                                           spec_window=3,
                                           spec_reprobe_after=1))
    eng.set_spec_active(False)
    assert eng.submit(_treq("q0", np.array([5, 6, 5, 6], np.int32),
                            6)) is None
    out = eng.drain()
    assert out[0].finish_reason == FINISH_MAX_TOKENS
    assert not eng.spec_active
    s = eng.metrics_summary()
    assert s["recovery"]["spec_reprobes"] == 0
    assert s["speculative"]["verify_steps"] == 0
    eng.set_spec_active(True)
    assert eng.spec_active


def test_load_shedding_sheds_jax_ids(weights):
    """Sustained overload on 3 slots sheds the same request ids as the
    JAX engine, each before any work; every request is accounted for."""
    jparams, _, model = weights
    kw = dict(shed_watermark=0.25, shed_patience=2)
    reqs = [_treq(f"q{i}", np.array([1 + i % 7, 2], np.int32), 6)
            for i in range(12)]
    jeng = JEngine(jparams, JCFG, JEngineConfig(max_queue=16, **POOL),
                   rcfg=jwd.ResilienceConfig(**kw))
    eng = Engine(model, TCFG, EngineConfig(max_queue=16, **POOL),
                 device="cpu", rcfg=twd.ResilienceConfig(**kw))
    shed = {}
    for side, e, mk in (("jax", jeng, _jreq), ("torch", eng, lambda r: r)):
        for r in reqs:
            assert e.submit(mk(r)) is None
        out = e.drain()
        assert len(out) == 12
        shed[side] = sorted(r.id for r in out
                            if r.finish_reason == FINISH_SHED)
        assert all(not r.tokens for r in out
                   if r.finish_reason == FINISH_SHED)
    assert shed["torch"] == shed["jax"] and shed["torch"]
    assert eng.metrics.counters["shed_requests"] == len(shed["torch"])


def test_step_delay_seam_counts_a_stall(weights):
    *_, model = weights
    eng = Engine(model, TCFG, EngineConfig(pool_size=2, max_queue=8),
                 device="cpu",
                 rcfg=twd.ResilienceConfig(stall_factor=2.0,
                                           stall_floor_s=0.02,
                                           stall_min_steps=5))
    for i in range(3):
        assert eng.submit(_treq(f"q{i}", np.array([1 + i, 2, 3], np.int32),
                                12)) is None
    with faults.installed(faults.FaultPlan(faults.Fault(
            site="serve/step", kind="delay", at=8, arg=1.0))):
        out = eng.drain()
    assert [r.finish_reason for r in out] == [FINISH_MAX_TOKENS] * 3
    assert eng.metrics.counters.get("watchdog_stalls", 0) >= 1
    assert any("stall" in e for e in eng.events)


def test_journal_requeues_after_a_crash(weights, tmp_path):
    """An engine stopped mid-flight: a fresh engine requeues the
    journal's unfinished requests (the JAX reader agrees on which) and
    serves them with the streams an uninterrupted engine gives."""
    *_, model = weights
    path = str(tmp_path / "journal.jsonl")
    reqs = [_treq(f"q{i}", np.array([2 + i, 3, 4], np.int32),
                  3 if i < 2 else 10) for i in range(6)]
    jr = RequestJournal(path)
    eng = Engine(model, TCFG, EngineConfig(pool_size=2, max_queue=8),
                 device="cpu", journal=jr)
    for r in reqs:
        assert eng.submit(r) is None
    done = set()
    for _ in range(4):
        done |= {r.id for r in eng.step()}
    del eng
    jr.close()
    pending = RequestJournal.unfinished(path)
    assert pending and {r.id for r in pending} == {r.id for r in reqs} - done
    assert [r.id for r in JJournal.unfinished(path)] == \
        [r.id for r in pending]
    jr2 = RequestJournal(path)
    eng2 = Engine(model, TCFG, EngineConfig(pool_size=2, max_queue=8),
                  device="cpu", journal=jr2)
    for r in pending:
        assert eng2.submit(r) is None
    got = {r.id: r.tokens for r in eng2.drain()}
    jr2.close()
    ref = Engine(model, TCFG, EngineConfig(pool_size=2, max_queue=8),
                 device="cpu")
    for r in reqs:
        assert ref.submit(r) is None
    want = {r.id: r.tokens for r in ref.drain()}
    assert got == {r.id: want[r.id] for r in pending}
    assert RequestJournal.unfinished(path) == []


def test_drafter_factory_and_checks(weights):
    *_, model = weights
    assert make_drafter("off", 4, 3, 2) is None
    d = make_drafter("ngram", 5, 2, 2)
    assert isinstance(d, NGramDrafter) and (d.k, d.ngram) == (5, 2)
    with pytest.raises(ValueError):
        make_drafter("model", 4, 3, 2)
    with pytest.raises(ValueError):
        make_drafter("bogus", 4, 3, 2)
    dc = draft_config_from_preset(dataclasses.replace(
        TCFG, vocab_size=101, block_size=64), "char-gpt")
    assert (dc.vocab_size, dc.block_size, dc.n_layer, dc.n_embd) == (
        101, 64, 6, 384)
    assert dc.dtype == TCFG.dtype
    bad = dataclasses.replace(TCFG, vocab_size=66)
    bad_model = tgpt.init_params(bad, torch.Generator().manual_seed(0),
                                 "cpu")
    with pytest.raises(AssertionError):
        Engine(model, TCFG, EngineConfig(pool_size=2), device="cpu",
               drafter=ModelDrafter(bad_model, bad, 2, 2, device="cpu"))
    with pytest.raises(ValueError, match="item 16"):
        Engine(model, TCFG, EngineConfig(pool_size=2, mesh_data=2),
               device="cpu", drafter=NGramDrafter(2))
    pool = CachePool(TCFG, 2, device="cpu")
    s = pool.acquire("a", 5)
    assert pool.slot_of("a") == s and pool.positions[s] == 5
    assert pool.seq_len == 32 and pool.n_free == 1
    pool.release(s)
    assert pool.n_free == 2


def test_cli_spec_replay_and_mesh_refusal():
    argv = ["serve-replay", "--preset", "test-tiny", "--device", "cpu",
            "--decode-cache-layout", "packed", "--paged-kernel",
            "--n-requests", "6", "--rate", "5000", "--greedy",
            "--prompt-mode", "repeat", "--prompt-len-max", "24",
            "--page-size", "8", "--request-max-new-tokens", "6",
            "--spec", "ngram", "--spec-k", "3", "--json"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    lines = out.getvalue().strip().splitlines()
    s = json.loads(lines[-1])
    assert s["n_completed"] == 6
    assert s["kernel_route"]["verify"] == "kernel"
    assert any(line.startswith("speculative (ngram, k=3)")
               for line in lines)
    with pytest.raises(SystemExit, match="ROADMAP.md queue A item 16"):
        cli.main(argv + ["--mesh-shape", "2x2"])
