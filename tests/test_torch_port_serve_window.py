"""Decode windows and mixed prefill+decode windows in the port's serving
engine, on the CPU.

The window functions against the JAX package's, f32, at 1e-5:
``verify_step_paged`` on both routes (the JAX kernel route runs its
Pallas kernel in interpret mode, jit-wrapped for one compile),
``decode_window_paged`` and ``mixed_window_paged`` (k = 4, greedy).
Then the engine: greedy streams at k in {2, 4, 8} and auto-tuned equal
the port's k = 1 streams on the kernel and gather routes and the JAX
engine's at k = 4; stochastic streams equal k = 1 in the port; the
lifecycle (admissions, a backlog, eos, cancels, deadlines, the
autotuner, deferred radix registration) with no window break; the CLI.
"""

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.models import gpt as jgpt
from replicatinggpt_tpu.models.gpt import init_params as jinit
from replicatinggpt_tpu.quant import QuantConfig as JQuantConfig
from replicatinggpt_tpu.quant import kv as jkv
from replicatinggpt_tpu.serve import Engine as JEngine
from replicatinggpt_tpu.serve import EngineConfig as JEngineConfig
from replicatinggpt_tpu.serve import Request as JRequest
from replicatinggpt_tpu.serve import SamplingParams as JSampling
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.config import ModelConfig
from replicatinggpt_tpu_torch.models import gpt as tgpt
from replicatinggpt_tpu_torch.models.gpt import params_from_numpy
from replicatinggpt_tpu_torch.serve import (Engine, EngineConfig, Request,
                                            SamplingParams)
from replicatinggpt_tpu_torch.serve.requests import (FINISH_CANCELLED,
                                                     FINISH_DEADLINE,
                                                     FINISH_EOS)

JCFG = JConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2, n_embd=64,
               dropout=0.0, attn_dropout=0.0, dtype="float32",
               decode_cache_layout="packed")
TCFG = ModelConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2,
                   n_embd=64, dtype="float32", decode_cache_layout="packed")
H, C, L, PSZ, MP, N = 2, 64, 2, 8, 4, 12
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The JAX init tree, its matrices and embeddings scaled by 16 (at
    init scale a 2-layer model repeats one token; these streams vary
    from step to step, so an eos can land mid-window) and its layernorm
    parameters and biases perturbed: as JAX arrays, numpy arrays, the
    port's compute params and its model."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit(jax.random.PRNGKey(5), JCFG))
    rng = np.random.default_rng(5)
    for name, arr in tree["blocks"].items():
        tree["blocks"][name] = (16 * arr if name.endswith("_kernel") else
                                arr + 0.1 * rng.standard_normal(arr.shape)
                                ).astype(np.float32)
    for name in ("wte", "wpe"):
        tree[name] = 16 * tree[name]
    model = params_from_numpy(tree, TCFG, device="cpu")
    return (jax.tree_util.tree_map(jnp.asarray, tree), tree,
            tgpt.compute_params(model, "cpu"), model)


def _pools(kv: str, seed: int = 0):
    """A JAX pool and the same pool in torch: random rows at every
    position (quantized on an int8 pool, page granularity)."""
    rng = np.random.default_rng(seed)
    quant = kv != "none"
    jpool = jgpt.init_paged_kv_pool(
        JCFG, N, PSZ, quant=JQuantConfig(kv_dtype=kv) if quant else None)
    for name in ("k", "v"):
        rows = rng.standard_normal((L, N, PSZ, C)).astype(np.float32)
        if quant:
            q, s = jkv.quantize_rows(jnp.asarray(rows), kv, H, "page")
            jpool[name], jpool[name + "s"] = q, s
        else:
            jpool[name] = jnp.asarray(rows)
    tpool = {n: torch.from_numpy(np.array(a)) for n, a in jpool.items()}
    return jpool, tpool


def _assert_pools(tpool, jpool):
    for name, a in jpool.items():
        np.testing.assert_allclose(tpool[name].float().numpy(),
                                   np.asarray(a, np.float32), err_msg=name,
                                   **TOL)


# slot 0: a chunk at 5..12 crossing a page; slot 1: 3 valid rows at
# 14..16 then padding; slot 2 inactive, its stale table slot 0's pages;
# slot 3: a decode row at column 0 (pos 20), the rest padding
V_POS = np.array([5, 14, 9, 20], np.int32)
V_NVALID = np.array([7, 2, 5, 0], np.int32)
V_ACTIVE = np.array([True, True, False, True])
V_TABLES = np.array([[3, 7, 0, 0], [1, 4, 9, 0], [3, 7, 0, 0],
                     [10, 2, 6, 0]], np.int32)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("kv", ["none", "int8"])
def test_verify_step_paged_matches_jax(weights, use_kernel, kv):
    """A (B, W=8) window through the paged pool, port against JAX, f32:
    the valid rows' logits and the whole pool at 1e-5, through a chunk
    that crosses a page, padding rows, an inactive slot whose stale
    table names a live slot's pages (its writes drop), a decode row, an
    unquantized and an int8 pool; both routes."""
    jparams, _, tparams, _ = weights
    rng = np.random.default_rng(1)
    window = rng.integers(0, 65, (4, 8)).astype(np.int32)
    jpool, tpool = _pools(kv)
    fn = jax.jit(functools.partial(jgpt.verify_step_paged, cfg=JCFG,
                                   use_kernel=use_kernel))
    want, jpool = fn(jparams, jnp.asarray(window), jnp.asarray(V_POS),
                     jnp.asarray(V_NVALID), jnp.asarray(V_ACTIVE),
                     jnp.asarray(V_TABLES), jpool)
    got, tpool = tgpt.verify_step_paged(
        tparams, torch.from_numpy(window), torch.from_numpy(V_POS),
        torch.from_numpy(V_NVALID), torch.from_numpy(V_ACTIVE),
        torch.from_numpy(V_TABLES), tpool, TCFG, use_kernel=use_kernel,
        max_pos=int(V_POS.max()))
    rows = (np.arange(8)[None] <= V_NVALID[:, None]) & V_ACTIVE[:, None]
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               **TOL)
    _assert_pools(tpool, jpool)


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_dropped_writes_share_a_page_with_live_ones(kv):
    """Writes with a valid mask against JAX's ``mode='drop'`` scatter: a
    dropped row aimed at the very row a live row writes (a stale table
    naming a live slot's page), dropped rows elsewhere, and a call in
    which no row is valid (the pool keeps every byte)."""
    jpool, tpool = _pools(kv, seed=3)
    rng = np.random.default_rng(4)
    phys = np.array([5, 5, 2, 5, 8], np.int32)
    woff = np.array([3, 3, 0, 6, 7], np.int32)
    valid = np.array([False, True, True, False, False])
    k, v = (rng.standard_normal((5, C)).astype(np.float32)
            for _ in range(2))
    jw = jnp.where(jnp.asarray(valid), jnp.asarray(woff), PSZ)
    jpool = jgpt._scatter_kv(jpool, 1, jnp.asarray(phys), jw, jnp.asarray(k),
                             jnp.asarray(v), True, H)
    before = {n: t.clone() for n, t in tpool.items()}
    tp, tw, tk, tv = (torch.from_numpy(a) for a in (phys, woff, k, v))
    drop = tgpt._drop_plan(tpool, tp, tw, torch.from_numpy(valid), True)
    tgpt._scatter_kv(tpool, 1, tp, tw, tk, tv, True, H, drop=drop)
    _assert_pools(tpool, jpool)
    assert torch.equal(tpool["k"][0], before["k"][0])
    snap = {n: t.clone() for n, t in tpool.items()}
    none = tgpt._drop_plan(tpool, tp, tw, torch.zeros(5, dtype=torch.bool),
                           True)
    for layer in range(L):
        tgpt._scatter_kv(tpool, layer, tp, tw, tk, tv, True, H, drop=none)
    for name, t in tpool.items():
        assert torch.equal(t, snap[name]), name


def _greedy_j(rngs, logits):
    return jnp.argmax(logits, -1).astype(jnp.int32), rngs


def _greedy_t(t, logits):
    return torch.argmax(logits, -1).to(torch.int32)


# k = 4 windows over 4 slots: slot 0 decodes and stops at its eos
# mid-window, slot 1's budget of 2 runs out mid-window, slot 2 (mixed
# window: prefills 2 chunks of 8, the second padded, then decodes), slot
# 3 is inactive with its stale table on slot 0's pages
W_POS = np.array([12, 17, 15, 0], np.int32)
W_TABLES = np.array([[3, 7, 11, 0], [1, 4, 9, 0], [10, 2, 6, 0],
                     [3, 7, 11, 0]], np.int32)
W_BUDGET = np.array([6, 2, 9, 5], np.int32)
W_ACTIVE = np.array([True, True, True, False])


def _window_args(mixed: bool, eos0: int):
    rng = np.random.default_rng(6)
    tok = rng.integers(0, 65, (4,)).astype(np.int32)
    eos = np.array([eos0, -1, -1, -1], np.int32)
    args = [tok, W_POS, W_ACTIVE, W_BUDGET, eos]
    if mixed:
        pf_left = np.array([0, 0, 2, 0], np.int32)
        pf_off = np.array([0, 0, 2, 0], np.int32)
        pf_limit = np.array([0, 0, 16, 0], np.int32)   # 14 real tokens
        pf_toks = rng.integers(0, 65, (4, 4, 8)).astype(np.int32)
        args += [pf_left, pf_off, pf_limit, pf_toks]
    return args


def _run_port(tparams, args, tpool, mixed: bool, use_kernel: bool,
              use_fused: bool = False):
    t = [torch.from_numpy(np.array(a)) for a in args]
    fn = tgpt.mixed_window_paged if mixed else tgpt.decode_window_paged
    kw = {} if mixed else {"use_fused": use_fused}
    return fn(tparams, *t, torch.from_numpy(W_TABLES), tpool, TCFG,
              sample_fn=_greedy_t, length=4, use_kernel=use_kernel,
              max_pos=[32] * 4, **kw)


@pytest.mark.parametrize("mixed", [False, True])
def test_windows_match_jax(weights, mixed):
    """``decode_window_paged`` / ``mixed_window_paged`` (k = 4, greedy,
    f32) against the JAX package's, the port on its kernel, fused (decode
    window) and gather routes: toks, emitted, tok, pos, active and budget
    identical, the pool at 1e-5, through an eos mid-window, a budget run
    out mid-window, a prefill of two chunks (the last padded) that flips
    to decode mid-window, and an inactive slot on a live slot's pages."""
    jparams, _, tparams, _ = weights
    # slot 0's eos: its first greedy token after step 0 not seen before
    _, tpool = _pools("none", seed=2)
    probe = _run_port(tparams, _window_args(mixed, -1), tpool, mixed, False)
    seq = probe[0][:, 0].tolist()
    eos0 = next(x for i, x in enumerate(seq[1:3], 1) if x not in seq[:i])
    args = _window_args(mixed, eos0)
    jpool, _ = _pools("none", seed=2)
    jfn = jgpt.mixed_window_paged if mixed else jgpt.decode_window_paged
    fn = jax.jit(functools.partial(jfn, cfg=JCFG, sample_fn=_greedy_j,
                                   length=4))
    rngs = jnp.zeros((4, 2), jnp.uint32)
    j = [jnp.asarray(a) for a in args]
    if mixed:
        want = fn(jparams, *j[:5], *j[5:], jnp.asarray(W_TABLES), jpool,
                  rngs)
    else:
        want = fn(jparams, *j, jnp.asarray(W_TABLES), jpool, rngs)
    want = [np.asarray(a) for a in want[:6]] + [want[6]]
    routes = [(True, False), (False, False)] + ([] if mixed
                                                else [(False, True)])
    for use_kernel, use_fused in routes:
        _, tpool = _pools("none", seed=2)
        got = _run_port(tparams, args, tpool, mixed, use_kernel, use_fused)
        for g, w, name in zip(got, want, ("toks", "emitted", "tok", "pos",
                                          "active", "budget")):
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{name} {use_kernel}")
        _assert_pools(tpool, want[6])
    em = want[1]
    assert not em[:, 3].any() and em[:, 1].sum() == 2
    assert em[:, 0].sum() in (2, 3) and not em[-1, 0]    # the eos
    if mixed:
        assert em[:, 2].tolist() == [False, False, True, True]


# ---------------------------------------------------------------- engine


def _trace():
    """(arrival step, prompt, max_new) of each request: a shared 2-page
    prefix, that prefix alone once it is cached (a whole-prompt hit: a
    copy-on-write split), prompts of up to 4 chunks, arrivals while
    windows fly, a backlog (a pool of 3)."""
    rng = np.random.default_rng(11)
    pre = rng.integers(0, 65, (16,))
    out = []
    for step, tail, n in [(0, 4, 9), (0, 7, 12), (3, None, 6), (1, 9, 10),
                          (2, 3, 14), (2, 12, 5), (5, 1, 8)]:
        prompt = pre if tail is None else np.concatenate(
            [pre, rng.integers(0, 65, (tail,))])
        out.append((step, prompt.astype(np.int32), n))
    return out


def _drive(engine, make_request, trace=None, eos=None):
    """Submit each request at its arrival step, then drain; the streams
    and finish reasons by id."""
    trace = trace or _trace()
    eos = eos or {}
    res, step = {}, 0
    while step <= max(s for s, *_ in trace) or not engine.idle:
        for i, (at, prompt, n) in enumerate(trace):
            if at == step:
                rid = f"q{i}"
                assert engine.submit(make_request(rid, prompt, n,
                                                  eos.get(rid))) is None
        for r in engine.step():
            res[r.id] = (list(r.tokens), r.finish_reason)
        step += 1
    return res


def _treq(greedy=True):
    def make(rid, prompt, n, eos):
        sp = (SamplingParams(greedy=True) if greedy
              else SamplingParams(temperature=0.8, top_k=20))
        return Request(id=rid, prompt=prompt, max_new_tokens=n, sampling=sp,
                       rng_seed=int(rid[1:]) + 3, eos_token_id=eos)
    return make


POOL = dict(pool_size=3, page_size=8, prefill_chunk=8)


def _engine(model, k=1, auto=False, route="kernel", clock=None, **kw):
    eng = Engine(model, TCFG, EngineConfig(
        paged_kernel=route != "gather", decode_window=k,
        decode_window_auto=auto, **{**POOL, **kw}),
        **({} if clock is None else {"clock": clock}), device="cpu")
    if route == "kernel":
        eng._use_fused, eng._use_kernel = False, True
    assert eng.kernel_route.window == ("none" if k == 1 else
                                       "gather" if route == "gather"
                                       else "kernel")
    return eng


@pytest.fixture(scope="module")
def jax_k4(weights):
    """The JAX engine's greedy streams at decode_window=4 (its gather
    route) and the eos picked for q1 (a token inside its first full
    window)."""
    jparams, *_ = weights
    eng = JEngine(jparams, JCFG, JEngineConfig(decode_window=4, **POOL))
    res = _drive(eng, lambda rid, p, n, eos: JRequest(
        id=rid, prompt=p, max_new_tokens=n, sampling=JSampling(greedy=True),
        rng_seed=int(rid[1:]) + 3, eos_token_id=eos))
    assert all(r == "max_tokens" or r == "length_cap"
               for _, r in res.values()), res
    return res


def _bounded(monkeypatch):
    """Hold every window step's host bound to the card's positions: a
    bound below one would size the kernels' split from a wrong span."""
    seen = []
    for name, at in (("decode_step_paged", 3), ("verify_step_paged", 4)):
        fn = getattr(tgpt, name)

        def wrapped(*a, _fn=fn, _at=at, max_pos=None, **kw):
            pos, active = a[2], a[_at]            # the positions, active
            if max_pos is not None:
                assert max_pos >= int(torch.where(active, pos, 0).max())
                seen.append(max_pos)
            return _fn(*a, max_pos=max_pos, **kw)
        monkeypatch.setattr(tgpt, name, wrapped)
    return seen


def test_engine_window_streams_equal_k1_and_jax(weights, jax_k4,
                                                monkeypatch):
    """Greedy streams at k = 2, 4, 8 and auto-tuned up to 8 equal the
    port's k = 1 streams on the kernel and gather routes and the JAX
    engine's at k = 4, through arrivals while windows fly, a backlog, a
    shared prefix and a copy-on-write split, with no window break; every
    window step's bound on the positions holds."""
    *_, model = weights
    seen = _bounded(monkeypatch)
    want = {rid: toks for rid, (toks, _) in jax_k4.items()}
    for route in ("kernel", "gather"):
        eng = _engine(model, route=route)
        base = _drive(eng, _treq())
        assert {r: t for r, (t, _) in base.items()} == want, route
        assert eng.metrics_summary()["pages"]["cow_copies"] >= 1
        for k, auto in ((2, False), (4, False), (8, False), (8, True)):
            eng = _engine(model, k, auto, route)
            got = _drive(eng, _treq())
            assert got == base, (route, k, auto)
            s = eng.metrics_summary()
            assert not any(s["window_breaks"].values()), s
            assert s["dispatch"]["mixed_windows"] > 0
            assert s["pages"]["cow_copies"] >= 1
            assert s["pages"]["prefix_hits"] >= 2
    assert seen


def test_engine_fused_route_windows(weights):
    """The fused all-layers route inside the decode windows (the
    per-layer kernel route in the mixed ones) gives the k = 1 streams."""
    *_, model = weights
    base = _drive(_engine(model, route="fused"), _treq())
    eng = _engine(model, 4, route="fused")
    assert eng.kernel_route.decode == "fused"
    assert _drive(eng, _treq()) == base


def test_engine_stochastic_windows_equal_k1(weights):
    """Sampled streams (temperature, top-k, one generator a slot) at k =
    2 and 4 equal k = 1: a slot draws on the host's schedule (nothing
    while it prefills), never on the card's active flags."""
    *_, model = weights
    base = _drive(_engine(model), _treq(greedy=False))
    for k in (2, 4):
        assert _drive(_engine(model, k), _treq(greedy=False)) == base, k


def _one(model, k, eos=None, rid="q0", **kw):
    eng = _engine(model, k, pool_size=2, **kw)
    prompt = np.array([9, 2, 6, 40, 41], np.int32)
    return eng, _treq()(rid, prompt + int(rid[1:]), 20, eos)


def _alone(model, rid="q0"):
    eng, req = _one(model, 1, rid=rid)
    eng.submit(req)
    return eng.drain()[0].tokens


def test_eos_inside_window_releases_slot_and_pages(weights):
    """An eos that lands mid-window ends the stream there, with reason
    eos, and frees the slot and its pages at that window's drain."""
    *_, model = weights
    base = _alone(model)
    eos = next(x for i, x in enumerate(base[2:], 2) if x not in base[:i])
    want = base[:base.index(eos) + 1]
    for k in (1, 4, 8):
        eng, req = _one(model, k, eos=eos)
        eng.submit(req)
        res = eng.drain()[0]
        assert res.finish_reason == FINISH_EOS and res.tokens == want, k
        assert eng.pool.n_free == 2 and eng.idle
        pages = eng.metrics_summary()["pages"]
        assert pages["pages_in_use"] == pages["radix_pages"]


def test_cancel_and_deadline_ride_the_next_window(weights):
    """A cancel while a window flies is a mask, not a read: the window in
    flight keeps flying, the next window carries the kill flag, the
    result (reason cancelled) has the committed tokens, a prefix of the
    k = 1 stream, and no token comes after it; the other slot's stream
    goes on unchanged. A deadline passing mid-window is the same mask
    with reason deadline."""
    *_, model = weights
    base, other = _alone(model), _alone(model, "q1")
    for reason in (FINISH_CANCELLED, FINISH_DEADLINE):
        clock = [0.0]
        eng, req = _one(model, 4, clock=lambda: clock[0])
        if reason == FINISH_DEADLINE:
            req.deadline = 100.0
        eng.submit(req)
        eng.submit(_one(model, 1, rid="q1")[1])
        eng.step()                    # admission: the mixed window
        eng.step()                    # window 2 flies, window 1 read
        assert eng._inflight is not None
        if reason == FINISH_CANCELLED:
            assert eng.cancel("q0")
        else:
            clock[0] = 100.0
        assert eng._inflight is not None
        res = {r.id: r for r in eng.step()}["q0"]
        assert eng._inflight is not None     # window 3 carries the mask
        assert res.finish_reason == reason
        assert 1 <= len(res.tokens) < 20
        assert res.tokens == base[:len(res.tokens)]
        n = len(res.tokens)
        rest = {r.id: r for r in eng.drain()}
        assert set(rest) == {"q1"} and rest["q1"].tokens == other
        assert len(res.tokens) == n and eng.idle and eng.pool.n_free == 2
        assert not any(eng.metrics_summary()["window_breaks"].values())


def test_cancel_racing_a_finished_window(weights):
    """A cancel while the window in flight already holds the request's
    eos: the natural finish (eos, the stream up to it) surfaces, not a
    cancellation; a cancel after the host read that finish finds
    nothing."""
    *_, model = weights
    base = _alone(model)
    # window 1 (mixed) emits 3 tokens at k=4; window 2 the next 4: the
    # eos is the first new token among base[3:7]
    eos = next(x for i, x in enumerate(base[3:7], 3) if x not in base[:i])
    eng, req = _one(model, 4, eos=eos)
    eng.submit(req)
    eng.step()
    out = eng.step()                  # window 2 launched, window 1 read
    assert not out and eng._inflight is not None
    assert eng.cancel("q0")
    res = {r.id: r for r in eng.drain()}["q0"]
    assert res.finish_reason == FINISH_EOS
    assert res.tokens == base[:base.index(eos) + 1]
    assert not eng.cancel("q0")


def test_deferred_radix_registration(weights):
    """A prompt prefilled inside a window registers its pages at that
    window's drain: a same-prefix request admitted while it flies gets no
    prefix hit, one admitted after the drain claims the pages; the
    streams equal k = 1's."""
    *_, model = weights
    rng = np.random.default_rng(2)
    pre = rng.integers(0, 65, (16,))
    trace = [(0, np.concatenate([pre, [5, 6]]).astype(np.int32), 6),
             (1, np.concatenate([pre, [7]]).astype(np.int32), 6),
             (2, np.concatenate([pre, [8, 9, 1]]).astype(np.int32), 6)]
    base = _drive(_engine(model), _treq(), trace)
    eng = _engine(model, 4)
    hits = []
    orig = eng._admit_finalize

    def spy(req, t_submit, now, slot, cap, claimed):
        hits.append((req.id, claimed, len(eng.pool.alloc.page_node)))
        return orig(req, t_submit, now, slot, cap, claimed)
    eng._admit_finalize = spy
    assert _drive(eng, _treq(), trace) == base
    assert hits == [("q0", 0, 0), ("q1", 0, 0), ("q2", 16, 2)], hits


def test_autotune_climbs_buckets(weights):
    """With auto-tuning the window starts at the smallest bucket and
    climbs one bucket per 8 windows while the host's launch time is a
    share of the wall (on the CPU it is all of it), up to the cap."""
    *_, model = weights
    assert EngineConfig(decode_window=8,
                        decode_window_auto=True).window_buckets() == (2, 4,
                                                                      8)
    assert EngineConfig(decode_window=6).window_buckets() == (6,)
    assert EngineConfig(decode_window=8).warmup_tokens() == 18
    eng = _engine(model, 8, auto=True, pool_size=1)
    assert eng._window_cur == 2
    rng = np.random.default_rng(9)
    trace = [(0, rng.integers(0, 65, (4,)).astype(np.int32), 27)
             for _ in range(3)]
    base = _drive(_engine(model, pool_size=1), _treq(), trace)
    assert _drive(eng, _treq(), trace) == base
    d = eng.metrics_summary()["dispatch"]
    assert d["window_k"] == 8 and d["autotune_increases"] == 2, d


def test_windowed_cli_and_refusals():
    """``--decode-window 8`` and ``--decode-window-auto`` run through the
    CLI on the CPU; a window on a mesh is refused with its ROADMAP item;
    ``--spec`` beside a window runs speculatively, no window launched."""
    argv = ["serve-replay", "--preset", "test-tiny", "--device", "cpu",
            "--decode-cache-layout", "packed", "--paged-kernel",
            "--n-requests", "6", "--rate", "1000", "--greedy",
            "--prompt-mode", "shared_prefix", "--prompt-len-max", "24",
            "--page-size", "8", "--request-max-new-tokens", "6",
            "--decode-window", "8", "--json"]
    for extra in ([], ["--decode-window-auto"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main(argv + extra) == 0
        lines = out.getvalue().strip().splitlines()
        s = json.loads(lines[-1])
        assert s["n_completed"] == 6
        assert s["dispatch"]["window_k_max"] == 8
        assert s["kernel_route"]["window"] == "kernel"
        assert any(line.startswith("dispatch split") for line in lines)
    with pytest.raises(SystemExit, match="ROADMAP.md queue A item 14"):
        cli.main(argv + ["--mesh-shape", "2x2"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv + ["--spec", "ngram"]) == 0
    s = json.loads(out.getvalue().strip().splitlines()[-1])
    assert s["n_completed"] == 6 and s["speculative"]["verify_steps"] > 0
    assert s["dispatch"]["decode_windows"] == 0
    model = tgpt.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="item 14"):
        Engine(model, TCFG, EngineConfig(decode_window=4, mesh_data=2),
               device="cpu")
