"""The port's fused paged decode and quantized KV pools against the JAX
package, on the CPU.

The same numpy inputs and weights (``params_from_numpy`` carries the JAX
``init_params`` tree across) go through both sides. The JAX Pallas
kernels run in interpret mode, as the JAX package's own tests run them;
the port's wrappers take their plain versions on CPU tensors. Covers
``quant/kv.py`` (exact), the plain versions of ``fused_paged_decode_layers``
and of the quantized ``paged_window_attention`` (f32, 1e-5), the route
rule, the engine's greedy streams on the fused route (unquantized and
int8, through a prefix hit, a copy-on-write split and an eviction) and
the CLI's quantization flags.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.config import get_config as jget_config
from replicatinggpt_tpu.models import gpt as jgpt
from replicatinggpt_tpu.models.gpt import init_params as jinit
from replicatinggpt_tpu.ops import decode_pallas as jdp
from replicatinggpt_tpu.ops import paged_pallas as jpp
from replicatinggpt_tpu.quant import QuantConfig as JQuantConfig
from replicatinggpt_tpu.quant import kv as jkv
from replicatinggpt_tpu.serve import Engine as JEngine
from replicatinggpt_tpu.serve import EngineConfig as JEngineConfig
from replicatinggpt_tpu.serve import Request as JRequest
from replicatinggpt_tpu.serve import SamplingParams as JSampling
from replicatinggpt_tpu.serve import pages as jpages
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.config import ModelConfig, get_config
from replicatinggpt_tpu_torch.models import gpt as tgpt
from replicatinggpt_tpu_torch.models.gpt import params_from_numpy
from replicatinggpt_tpu_torch.ops import decode as tdec
from replicatinggpt_tpu_torch.ops import paged_attention as tpa
from replicatinggpt_tpu_torch.quant import QuantConfig
from replicatinggpt_tpu_torch.quant import kv as tkv
from replicatinggpt_tpu_torch.serve import (Engine, EngineConfig, Request,
                                            SamplingParams)
from replicatinggpt_tpu_torch.serve import pages as tpages
from replicatinggpt_tpu_torch.serve.engine import decide_kernel_route

# D=32: inside the JAX fused envelope at f32
JCFG = JConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2, n_embd=64,
               dropout=0.0, attn_dropout=0.0, dtype="float32",
               decode_cache_layout="packed")
TCFG = ModelConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2,
                   n_embd=64, dtype="float32", decode_cache_layout="packed")
MODES = [("none", "page"), ("int8", "page"), ("fp8", "head")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=5):
    """The JAX init tree with layernorm parameters and biases perturbed
    (init leaves them 1 and 0)."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit(jax.random.PRNGKey(seed), JCFG))
    rng = np.random.default_rng(seed)
    for name, arr in tree["blocks"].items():
        if not name.endswith("_kernel"):
            tree["blocks"][name] = (arr + 0.1 * rng.standard_normal(
                arr.shape)).astype(np.float32)
    return tree


def _to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype (fp8 via bytes)."""
    a = np.asarray(a)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bytes(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
            else t).numpy()


# --------------------------------------------------------------- (a) quant


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("gran", ["page", "head"])
def test_quant_kv_matches_jax_exactly(kv_dtype, gran):
    """quantize_rows (stored values and fp8 bytes, scales),
    fake_quantize_rows / fake_quantize_row_body and dequant_gathered are
    bit-identical to the JAX package's; an all-zero row gets SCALE_EPS
    and round-trips to zero."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 64))
         * rng.uniform(1e-3, 40.0, (3, 5, 1))).astype(np.float32)
    x[0, 0] = 0.0
    H = 4
    qj, sj = jkv.quantize_rows(jnp.asarray(x), kv_dtype, H, gran)
    qt, st = tkv.quantize_rows(torch.from_numpy(x), kv_dtype, H, gran)
    assert qt.dtype == tkv.kv_store_dtype(kv_dtype)
    np.testing.assert_array_equal(_bytes(qt), _bytes(_to_torch(qj)))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (st[0, 0] == tkv.SCALE_EPS).all() and not qt[0, 0].float().any()
    want = np.asarray(jkv.fake_quantize_rows(jnp.asarray(x), kv_dtype, H,
                                             gran))
    got = tkv.fake_quantize_rows(torch.from_numpy(x), kv_dtype, H, gran)
    np.testing.assert_array_equal(got.numpy(), want)
    body = np.asarray(jkv.fake_quantize_row_body(jnp.asarray(x[1, :1]),
                                                 kv_dtype, H, gran))
    np.testing.assert_array_equal(tkv.fake_quantize_row_body(
        torch.from_numpy(x[1, :1]), kv_dtype, H, gran).numpy(), body)
    np.testing.assert_array_equal(tkv.fake_quantize_row_body(
        torch.from_numpy(x), kv_dtype, H, gran).numpy(), want)
    # a gathered packed view (B=3, mp=5, psz=1, C) and its scales
    g, s = qt[:, :, None], st[:, :, None]
    deq = tkv.dequant_gathered(g, s, True, H, torch.float32)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(
        jkv.dequant_gathered(jnp.asarray(np.asarray(qj)[:, :, None]),
                             jnp.asarray(np.asarray(sj)[:, :, None]), True,
                             H, jnp.float32)))


def test_quant_geometry_matches_jax():
    """Storage dtypes, scale shapes, pool modes and the page byte counts
    the admission capacity is sized by."""
    for kv_dtype in ("int8", "fp8"):
        assert tkv.kv_qmax(kv_dtype) == jkv.kv_qmax(kv_dtype)
        assert tkv.kv_itemsize(kv_dtype) == jkv.kv_itemsize(kv_dtype) == 1
    for cfg_name in ("char-gpt", "gpt2-small", "test-tiny"):
        jc, tc = jget_config(cfg_name).model, get_config(cfg_name).model
        for kv_dtype in ("none", "int8", "fp8"):
            for gran in ("page", "head"):
                assert tpages.page_bytes(tc, 16, kv_dtype, gran) \
                    == jpages.page_bytes(jc, 16, kv_dtype, gran)
                assert tpages.n_pages_for_hbm(2 ** 30, tc, 16, kv_dtype,
                                              gran) \
                    == jpages.n_pages_for_hbm(2 ** 30, jc, 16, kv_dtype, gran)
    for layout in ("packed", "heads"):
        tc = dataclasses.replace(TCFG, decode_cache_layout=layout)
        jc = dataclasses.replace(JCFG, decode_cache_layout=layout)
        for gran in ("page", "head"):
            want = jkv.init_scales(jc, 6, 8, gran)
            got = tkv.init_scales(tc, 6, 8, gran)
            assert {n: tuple(t.shape) for n, t in got.items()} \
                == {n: tuple(a.shape) for n, a in want.items()}
            assert got["ks"].data_ptr() != got["vs"].data_ptr()
            pool = {"k": torch.zeros(1, dtype=torch.int8), **got}
            assert tkv.pool_quant_mode(pool) == ("int8", gran)
    assert tkv.pool_quant_mode({"k": torch.zeros(1)}) == (None, None)
    with pytest.raises(ValueError):
        QuantConfig(kv_dtype="int4").validate()
    with pytest.raises(ValueError):
        QuantConfig(kv_dtype="int8", granularity="row").validate()


@pytest.mark.parametrize("layout", ["packed", "heads"])
@pytest.mark.parametrize("kv_dtype,gran", [("int8", "page"), ("fp8", "head")])
def test_quantized_pool_write_and_gather_match_jax(layout, kv_dtype, gran):
    """A quantized pool in either layout: quantize-on-write (rows and
    scales at the same coordinates) and the dequantized gathered view,
    against the JAX package's ``_scatter_kv`` / ``_gather_kv``."""
    jc = dataclasses.replace(JCFG, decode_cache_layout=layout)
    tc = dataclasses.replace(TCFG, decode_cache_layout=layout)
    jpool = jgpt.init_paged_kv_pool(jc, 6, 8, quant=JQuantConfig(
        kv_dtype=kv_dtype, granularity=gran))
    tpool = tgpt.init_paged_kv_pool(tc, 6, 8, quant=QuantConfig(
        kv_dtype=kv_dtype, granularity=gran))
    rng = np.random.default_rng(3)
    phys = np.array([4, 1, 4, 0], np.int32)
    woff = np.array([0, 7, 3, 5], np.int32)
    k, v = (rng.standard_normal((4, 64)).astype(np.float32) for _ in range(2))
    jpool = jgpt._scatter_kv(jpool, 1, jnp.asarray(phys), jnp.asarray(woff),
                             jnp.asarray(k), jnp.asarray(v),
                             layout == "packed", 2)
    tgpt._scatter_kv(tpool, 1, torch.from_numpy(phys), torch.from_numpy(woff),
                     torch.from_numpy(k), torch.from_numpy(v),
                     layout == "packed", 2)
    assert set(tpool) == set(jpool) == {"k", "v", "ks", "vs"}
    for n in tpool:
        np.testing.assert_array_equal(_bytes(tpool[n]),
                                      _bytes(_to_torch(jpool[n])), n)
    tables = np.array([[4, 1, 0], [0, 4, 5]], np.int32)
    want = jgpt._gather_kv(jpool, 1, jnp.asarray(tables), layout == "packed",
                           2, jnp.float32)
    got = tgpt._gather_kv(tpool, 1, torch.from_numpy(tables),
                          layout == "packed", 2, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------ (b) fused paged decode


def _fused_inputs(kv_dtype, gran, seed=0):
    """Ragged positions (one slot at 0, one inactive slot at 0), a
    permuted table with stale ids past each live frontier, a pool of
    random rows, quantized by the JAX package when asked."""
    rng = np.random.default_rng(seed)
    L, N, psz, C, mp = 2, 24, 8, 64, 4
    pos = np.array([5, 0, 17, 23, 0], np.int32)      # slot 4: inactive
    B = pos.size
    tables = rng.permutation(N)[:B * mp].reshape(B, mp).astype(np.int32)
    live = (pos + psz - 1) // psz
    tables[np.arange(mp)[None, :] >= live[:, None]] = N + 5
    x0 = (0.5 * rng.standard_normal((B, C))).astype(np.float32)
    k, v = (rng.standard_normal((L, N, psz, C)).astype(np.float32)
            for _ in range(2))
    if kv_dtype == "none":
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    else:
        kq, ks = jkv.quantize_rows(jnp.asarray(k), kv_dtype, 2, gran)
        vq, vs = jkv.quantize_rows(jnp.asarray(v), kv_dtype, 2, gran)
        jc = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    return x0, pos, tables, jc


@pytest.mark.parametrize("kv_dtype,gran", MODES)
def test_fused_paged_ref_matches_jax_kernel(kv_dtype, gran):
    """(b) fused_paged_decode_layers_ref against the JAX
    fused_paged_decode_layers (interpret mode), f32, atol = rtol = 1e-5:
    x, and every layer's raw fresh K/V rows. The CPU wrapper is the
    plain version and counts no launch."""
    tree = _tree()
    x0, pos, tables, jc = _fused_inputs(kv_dtype, gran)
    # the JAX kernel's table entries must lie in the pool; the port's
    # plain version never reads those past the live frontier
    jt = np.where(tables < 24, tables, 0)
    want = jdp.fused_paged_decode_layers(
        jnp.asarray(x0), {n: jnp.asarray(a) for n, a in
                          tree["blocks"].items()},
        jnp.asarray(pos), jnp.asarray(jt), jc, JCFG)
    blocks = {n: torch.from_numpy(a.copy()) for n, a in tree["blocks"].items()}
    cache = {n: _to_torch(a) for n, a in jc.items()}
    args = (torch.from_numpy(x0), blocks, torch.from_numpy(pos),
            torch.from_numpy(tables), cache, TCFG)
    before = tdec.fused_paged_decode_layers.launches
    got = tdec.fused_paged_decode_layers(*args)
    assert tdec.fused_paged_decode_layers.launches == before
    ref = tdec.fused_paged_decode_layers_ref(*args)
    for g, r, w in zip(got, ref, want):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_fused_paged_ref_never_reads_past_pos():
    """NaN in every pool row at or past a slot's position changes
    nothing."""
    tree = _tree()
    x0, pos, tables, jc = _fused_inputs("int8", "page")
    blocks = {n: torch.from_numpy(a.copy()) for n, a in tree["blocks"].items()}
    clean = {n: _to_torch(a) for n, a in jc.items()}
    dirty = {n: t.clone() for n, t in clean.items()}
    psz = 8
    for b, p in enumerate(pos):
        for g in range(p, 4 * psz):
            page = tables[b, g // psz]
            if page < 24:
                dirty["ks"][:, page, g % psz] = float("nan")
                dirty["vs"][:, page, g % psz] = float("nan")
    args = (torch.from_numpy(x0), blocks, torch.from_numpy(pos),
            torch.from_numpy(tables))
    for a, b in zip(tdec.fused_paged_decode_layers_ref(*args, clean, TCFG),
                    tdec.fused_paged_decode_layers_ref(*args, dirty, TCFG)):
        assert torch.equal(a, b)


def test_fused_route_rule_matches_jax():
    """The port's fused envelope is the JAX one at the shapes that
    matter: char-gpt bf16 yes; f32 no (7.08 MB of weights a layer > 6
    MiB) unless the pool is int8/fp8 (the pool's itemsize is what
    counts); GPT-2 124M never; and the engine's route follows."""
    char, small = get_config("char-gpt").model, get_config("gpt2-small").model
    jchar, jsmall = jget_config("char-gpt").model, jget_config(
        "gpt2-small").model
    cases = [(char, jchar, "bfloat16", "none", True),
             (char, jchar, "float32", "none", False),
             (char, jchar, "float32", "int8", True),
             (char, jchar, "float32", "fp8", True),
             (small, jsmall, "bfloat16", "none", False),
             (small, jsmall, "bfloat16", "int8", False)]
    for tc, jc, dt, kv, want in cases:
        tc = dataclasses.replace(tc, dtype=dt, decode_cache_layout="packed")
        jc = dataclasses.replace(jc, dtype=dt, decode_cache_layout="packed")
        isz = 1 if kv != "none" else (2 if dt == "bfloat16" else 4)
        for gran in ("page", "head"):
            j = jdp.fused_paged_decode_supported(jc, 8, 16, isz,
                                                 kv_quant=kv,
                                                 granularity=gran)
            t = tdec.fused_paged_decode_supported(tc, 8, 16, isz,
                                                  kv_quant=kv,
                                                  granularity=gran)
            assert j == t == want, (tc.n_embd, dt, kv, gran)
            r = decide_kernel_route(
                tc, EngineConfig(paged_kernel=True, kv_quant=kv,
                                 quant_granularity=gran), 16, 0, isz, 8)
            assert r.decode == ("fused" if want else "kernel"), r
            assert r.summary()["kv_quant"] == kv
            assert r.summary()["granularity"] == gran
    heads = dataclasses.replace(char, decode_cache_layout="heads")
    assert not tdec.fused_paged_decode_supported(heads, 8, 16, 2)
    assert decide_kernel_route(heads, EngineConfig(paged_kernel=True), 16, 16,
                               2, 8).decode == "gather"


# ---------------------------------------- (c) quantized paged attention


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("kv_dtype,gran", [("int8", "page"), ("int8", "head"),
                                           ("fp8", "page"), ("fp8", "head")])
def test_quantized_paged_attention_ref_matches_jax(W, kv_dtype, gran):
    """(c) paged_window_attention_ref with scales against the JAX
    kernel's quantized branch (interpret mode), f32, atol 1e-5."""
    rng = np.random.default_rng(2)
    H, psz, mp, N, C = 2, 8, 4, 24, 64
    pos = np.array([0, 8, 13, 16, 29], np.int32)
    B = pos.size
    tables = rng.permutation(N)[:B * mp].reshape(B, mp).astype(np.int32)
    q, kn, vn = (rng.standard_normal((B, W, C)).astype(np.float32)
                 for _ in range(3))
    kp, vp = (rng.standard_normal((N, psz, C)).astype(np.float32)
              for _ in range(2))
    kq, ks = jkv.quantize_rows(jnp.asarray(kp), kv_dtype, H, gran)
    vq, vs = jkv.quantize_rows(jnp.asarray(vp), kv_dtype, H, gran)
    want = np.asarray(jpp.paged_window_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), kq, vq,
        jnp.asarray(tables), jnp.asarray(pos), n_head=H, k_scales=ks,
        v_scales=vs))
    t = [torch.from_numpy(a) for a in (q, kn, vn)]
    pages = [_to_torch(a) for a in (kq, vq)]
    scales = {"k_scales": _to_torch(ks), "v_scales": _to_torch(vs)}
    got = tpa.paged_window_attention(*t, *pages, torch.from_numpy(tables),
                                     torch.from_numpy(pos), n_head=H,
                                     **scales)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        tpa.paged_window_attention(*t, *pages, torch.from_numpy(tables),
                                   torch.from_numpy(pos), n_head=H,
                                   k_scales=scales["k_scales"])
    ok, reasons = tpa.paged_attention_envelope(H, C // H, psz, itemsize=1,
                                               kv_quant=kv_dtype,
                                               granularity=gran)
    assert ok and reasons == ()
    ok, reasons = tpa.paged_attention_envelope(H, C // H, psz, itemsize=1)
    assert reasons == ("dtype",)
    _, reasons = tpa.paged_attention_envelope(H, 24, psz, itemsize=1,
                                              kv_quant="int4",
                                              granularity="row")
    assert set(reasons) == {"kv_quant_unknown", "granularity_unknown",
                            "head_dim"}


# ------------------------------------------------------- (d) the engine


def _waves():
    """(prompt, max_new) per request, in three waves: a 2-page prompt;
    its extension (prefix hit) and its exact repeat (a full-prompt hit:
    copy-on-write split); a fresh 24-token prompt that needs an
    eviction, and the first prompt again."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 65, (16,))
    d = rng.integers(0, 65, (24,))
    return [[(a, 4)],
            [(np.concatenate([a, rng.integers(0, 65, (3,))]), 4), (a, 4)],
            [(d, 5), (a, 3)]]


POOL = dict(pool_size=2, page_size=8, n_pages=5)


def _drive(engine, make_request):
    streams, rid = {}, 0
    for wave in _waves():
        for prompt, n in wave:
            assert engine.submit(make_request(f"q{rid}", prompt, n)) is None
            rid += 1
        for r in engine.drain():
            assert r.ok, r
            streams[r.id] = list(r.tokens)
    return streams, engine.metrics_summary()["pages"]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_fused_engine_greedy_streams_match_jax(kv_quant, monkeypatch):
    """(d) the port's engine on the fused route gives the JAX engine's
    greedy streams on ITS fused route (forced open on the CPU, as the
    JAX package's quant tests force it) through a prefix hit, a
    copy-on-write split and an eviction, with the same page
    accounting."""
    monkeypatch.setattr(jpp, "_paged_attn_backend_ok", lambda: True)
    tree = _tree()
    jeng = JEngine(tree, JCFG, JEngineConfig(paged_kernel=True,
                                             kv_quant=kv_quant, **POOL))
    assert jeng._use_fused
    want, jp = _drive(jeng, lambda rid, p, n: JRequest(
        id=rid, prompt=p, max_new_tokens=n,
        sampling=JSampling(greedy=True)))
    model = params_from_numpy(tree, TCFG, device="cpu")
    eng = Engine(model, TCFG, EngineConfig(paged_kernel=True,
                                           kv_quant=kv_quant, **POOL),
                 device="cpu")
    assert eng.kernel_route.decode == "fused"
    assert eng.kernel_route.summary()["kv_quant"] == kv_quant
    got, pages = _drive(eng, lambda rid, p, n: Request(
        id=rid, prompt=p, max_new_tokens=n,
        sampling=SamplingParams(greedy=True)))
    assert got == want
    assert pages["prefix_hits"] >= 2 and pages["cow_copies"] >= 1
    assert pages["evictions"] >= 1
    for key in ("prefix_hits", "prefix_hit_tokens", "cow_copies",
                "evictions", "pages_in_use", "radix_pages", "kv_quant",
                "quant_granularity", "bytes_per_page", "kv_quant_bits"):
        assert pages[key] == jp[key], key


def test_quantized_pool_cow_copies_scales_and_routes_agree():
    """A copy-on-write split copies a quantized page's rows AND scales;
    on an int8 pool the fused, per-layer kernel and gather routes give
    the same greedy streams."""
    model = params_from_numpy(_tree(), TCFG, device="cpu")
    pool = tpages.PagedCachePool(TCFG, 2, page_size=8, n_pages=6,
                                 device="cpu",
                                 quant=QuantConfig(kv_dtype="int8",
                                                   granularity="head"))
    c = pool.cache
    assert c["k"].dtype == torch.int8 and c["ks"].shape == (2, 6, 8, 2)
    for name, t in c.items():
        t[:, 3] = torch.arange(t[:, 3].numel()).reshape(t[:, 3].shape) \
            .to(t.dtype)
    pool.copy_page(3, 5)
    for name, t in c.items():
        assert torch.equal(t[:, 5], t[:, 3]), name
    streams = {}
    for route in ("fused", "kernel", "gather"):
        ecfg = EngineConfig(paged_kernel=route != "gather", kv_quant="int8",
                            **POOL)
        eng = Engine(model, TCFG, ecfg, device="cpu")
        if route == "kernel":
            eng._use_fused, eng._use_kernel = False, True
        assert eng._use_fused == (route == "fused")
        streams[route], pages = _drive(eng, lambda rid, p, n: Request(
            id=rid, prompt=p, max_new_tokens=n,
            sampling=SamplingParams(greedy=True)))
        assert pages["cow_copies"] >= 1
    assert streams["fused"] == streams["kernel"] == streams["gather"]


# --------------------------------------------------------------- (e) CLI


def test_serve_replay_cli_accepts_kv_quant():
    """(e) --kv-quant / --quant-granularity reach the engine and its
    summary; --weight-quant stays refused."""
    argv = ["serve-replay", "--preset", "test-tiny", "--device", "cpu",
            "--decode-cache-layout", "packed", "--paged-kernel",
            "--n-requests", "4", "--rate", "1000", "--greedy",
            "--prompt-mode", "shared_prefix", "--prompt-len-max", "24",
            "--page-size", "8", "--request-max-new-tokens", "3",
            "--kv-quant", "fp8", "--quant-granularity", "head", "--json"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    text = out.getvalue().strip().splitlines()
    s = json.loads(text[-1])
    assert s["n_completed"] == 4
    assert s["kernel_route"]["kv_quant"] == "fp8"
    assert s["kernel_route"]["granularity"] == "head"
    assert s["pages"]["kv_quant"] == "fp8" and s["pages"]["kv_quant_bits"] == 8
    assert any(line.startswith("quant: KV fp8 (head-granularity")
               for line in text)
    with pytest.raises(SystemExit, match="ROADMAP"):
        cli.main(argv + ["--weight-quant", "int8"])
