"""Sharded serving in the port against the JAX package, on the CPU.

The port's ``serve-replay --mesh-shape DxM``: the paged pool's pages
split over 'data', heads, pool channels and weights over 'model', the
shards in one process (``LocalServeGroup``) or one a process
(``ProcessServeGroup``, gloo here). Checked at the JAX mesh tests' size
(``tests/test_serve_mesh.py``: 2 layers, 2 heads, C=32, 65 tokens, block
32), packed layout, weights through ``params_from_numpy``:

- row #1's partials mode (``owned=``, ``fold=False``), the plain twin,
  against the JAX kernel in interpret mode at 1e-5 (f32 and an int8
  pool; random owned subsets, a slot that owns nothing);
- the sharded attention over a 2x2 ``LocalServeGroup`` against JAX's
  ``sharded_paged_window_attention`` on a 2x2 CPU mesh
  (``tests/conftest.py`` forces 8 devices) and the port's unsharded
  attention;
- greedy streams of the 2x2 engine through prefix hits, copy-on-write
  splits and evictions, equal to the 1x1 engine's and the JAX 2x2
  engine's (f32 and int8 pools), the mesh page statistics, and a
  copy-on-write split across data shards;
- the trace in 4 gloo processes as ``torchrun`` starts them (streams
  and page accounting equal to one process, copy-on-write splits across
  data shards among them); a vocabulary-parallel embedding and head;
- the CLI in one process; a launch whose size is not D x M, and
  ``train --mesh-shape``, refused; the tiktoken refusal names no queue
  item.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.models.gpt import init_params as jinit
from replicatinggpt_tpu.ops import paged_pallas as jpp
from replicatinggpt_tpu.parallel.mesh import make_serve_mesh
from replicatinggpt_tpu.quant import kv as jkv
from replicatinggpt_tpu.serve import Engine as JEngine
from replicatinggpt_tpu.serve import EngineConfig as JEngineConfig
from replicatinggpt_tpu.serve import Request as JRequest
from replicatinggpt_tpu.serve import SamplingParams as JSampling
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.config import ModelConfig
from replicatinggpt_tpu_torch.models.gpt import (init_params,
                                                 params_from_numpy)
from replicatinggpt_tpu_torch.ops import paged_attention as tpa
from replicatinggpt_tpu_torch.parallel.mesh import (page_shards,
                                                    parse_mesh_shape)
from replicatinggpt_tpu_torch.parallel.serve_group import LocalServeGroup
from replicatinggpt_tpu_torch.serve import (Engine, EngineConfig, Request,
                                            SamplingParams)
from replicatinggpt_tpu_torch.tokenizers import get_tokenizer

REPO = pathlib.Path(__file__).resolve().parent.parent
JCFG = JConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2, n_embd=32,
               dropout=0.0, attn_dropout=0.0, dtype="float32",
               decode_cache_layout="packed")
TCFG = ModelConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2,
                   n_embd=32, dtype="float32", decode_cache_layout="packed")
MESH = dict(mesh_data=2, mesh_model=2)
# 6 pages of 8 tokens, 2 slots: the JAX mesh tests' pressure pool
POOL = dict(pool_size=2, max_queue=64, page_size=8, n_pages=6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(np.asarray,
                                  jinit(jax.random.PRNGKey(0), JCFG))


def _to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ------------------------------------------------ (1) the partials mode


def _partials_inputs(seed: int, W: int = 2):
    """Window rows and a pool of 12 pages of 4 rows, 4 slots of 6
    logical pages at ragged positions (slot 0 at pos 0), and a random
    owned subset of each slot's live pages (slot 1 owns none)."""
    rng = np.random.default_rng(seed)
    B, C, N, psz, mp = 4, 32, 12, 4, 6
    pos = np.array([0, 9, 14, 23], np.int32)
    tables = np.stack([rng.permutation(N)[:mp]
                       for _ in range(B)]).astype(np.int32)
    live = (pos + psz - 1) // psz
    owned = (np.arange(mp)[None] < live[:, None]) & (rng.random((B, mp))
                                                     < 0.6)
    owned[1] = False
    owned[3, live[3] - 1] = True          # the partial last page, owned
    q, kn, vn = (rng.standard_normal((B, W, C)).astype(np.float32)
                 for _ in range(3))
    kp, vp = (rng.standard_normal((N, psz, C)).astype(np.float32)
              for _ in range(2))
    return q, kn, vn, kp, vp, tables, pos, owned


@pytest.mark.parametrize("kv_dtype", ["none", "int8"])
def test_partials_twin_matches_jax(kv_dtype):
    """The plain twin of the partials mode against JAX
    ``paged_window_attention(..., owned=, fold=False)`` in interpret
    mode: acc, m[..., :H] and l[..., :H] at 1e-5 (f32). JAX reads a
    table the wrapper filled with owned ids; the port's table holds ids
    past the pool wherever a page is not owned, which it never reads. A
    slot that owns nothing gives m = -1e30, l = 0, acc = 0."""
    H = 2
    q, kn, vn, kp, vp, tables, pos, owned = _partials_inputs(3)
    scales = {}
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    if kv_dtype != "none":
        jk, ks = jkv.quantize_rows(jk, kv_dtype, H, "page")
        jv, vs = jkv.quantize_rows(jv, kv_dtype, H, "page")
        scales = {"k_scales": ks, "v_scales": vs}
    eff = jpp._fill_last_owned(jnp.asarray(tables), jnp.asarray(owned))
    # jit: one interpret-mode compile instead of an eager walk
    want = jax.jit(functools.partial(
        jpp.paged_window_attention, n_head=H, fold=False))(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jk, jv, eff,
        jnp.asarray(pos), owned=jnp.asarray(owned), **scales)
    acc_w, m_w, l_w = (np.asarray(a) for a in want)
    garbage = np.where(owned, tables, 10_000).astype(np.int32)
    got = tpa.paged_window_attention(
        *(_to_torch(a) for a in (q, kn, vn, jk, jv, garbage, pos)),
        n_head=H, owned=_to_torch(owned.astype(np.int32)), fold=False,
        **{k: _to_torch(v) for k, v in scales.items()})
    acc, m, l = (t.numpy() for t in got)
    assert acc.shape == q.shape and m.shape == l.shape == q.shape[:2] + (H,)
    np.testing.assert_allclose(acc, acc_w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(m, m_w[..., :H], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l, l_w[..., :H], atol=1e-5, rtol=1e-5)
    assert (m[:2] == tpa.NEG_INF).all() and not l[:2].any() \
        and not acc[:2].any()


def test_sharded_attention_matches_jax_mesh():
    """``sharded_paged_window_attention`` over ``LocalServeGroup(2, 2)``
    (each model shard's columns, each data shard's block of pages)
    against JAX's on a 2x2 CPU mesh, and against the port's unsharded
    fold mode, f32 at 1e-5; a W=2 window exercises the causal fold."""
    H, W = 2, 2
    q, kn, vn, kp, vp, tables, pos, _ = _partials_inputs(4, W)
    mesh = make_serve_mesh(2, 2)
    want = np.asarray(jax.jit(functools.partial(
        jpp.sharded_paged_window_attention, n_head=H, mesh=mesh))(
        *(jnp.asarray(a) for a in (q, kn, vn, kp, vp, tables, pos))))
    group = LocalServeGroup(2, 2)
    N, C = kp.shape[0], q.shape[-1]
    nl, cl = N // 2, C // 2
    t = {k: _to_torch(a) for k, a in zip(
        ("q", "kn", "vn", "kp", "vp", "tab", "pos"),
        (q, kn, vn, kp, vp, tables, pos))}
    outs = []
    for m in group.model_shards:
        cols = slice(m * cl, (m + 1) * cl)
        blocks = {n: [t[n][d * nl:(d + 1) * nl, :, cols]
                      for d in group.data_shards] for n in ("kp", "vp")}
        outs.append(tpa.sharded_paged_window_attention(
            t["q"][..., cols], t["kn"][..., cols], t["vn"][..., cols],
            blocks["kp"], blocks["vp"], t["tab"], t["pos"], group,
            n_head=H // 2))
    got = torch.cat(outs, -1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    whole = tpa.paged_window_attention(
        t["q"], t["kn"], t["vn"], t["kp"], t["vp"], t["tab"], t["pos"],
        n_head=H)
    np.testing.assert_allclose(got, whole.numpy(), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------ (2) the engine


def _pressure_trace(n=10, max_new=4):
    """The JAX mesh tests' trace: a shared page-aligned prompt every
    third request (prefix hit and a full-prompt copy-on-write split)
    among random prompts that overrun the 6-page pool (evictions)."""
    rng = np.random.default_rng(1)
    shared = ((np.arange(16) % 9) + 2).astype(np.int32)
    out = []
    for i in range(n):
        prompt = shared.copy() if i % 3 == 0 else rng.integers(
            0, 65, (int(rng.integers(3, 20)),)).astype(np.int32)
        out.append((f"e{i}", prompt, max_new))
    return out


def _drive(engine, make_request):
    for rid, prompt, n in _pressure_trace():
        assert engine.submit(make_request(rid, prompt, n)) is None
    streams = {r.id: list(r.tokens) for r in engine.drain()}
    return streams, engine.metrics_summary()["pages"]


@pytest.fixture(scope="module", params=["none", "int8"])
def jax_mesh_run(request, tree):
    """The JAX engine on a 2x2 mesh (its gather route on the CPU)."""
    eng = JEngine(tree, JCFG, JEngineConfig(decode_window=1,
                                            kv_quant=request.param,
                                            **POOL, **MESH))
    assert eng.mesh is not None and eng.mesh.size == 4
    streams, pages = _drive(eng, lambda rid, p, n: JRequest(
        id=rid, prompt=p, max_new_tokens=n,
        sampling=JSampling(greedy=True)))
    return request.param, streams, pages


def test_engine_2x2_streams_match_1x1_and_jax(tree, jax_mesh_run):
    """Greedy streams of the port's 2x2 engine, on the kernel route
    (partials per data shard, merged, folded) and on the gather route,
    equal the port's 1x1 kernel route and the JAX 2x2 engine's, through
    prefix hits, copy-on-write splits and evictions, with the JAX page
    accounting; an int8 pool too (page-granularity scales from the
    whole row's max over the model shards)."""
    kv, want, jpages = jax_mesh_run
    model = params_from_numpy(tree, TCFG, device="cpu")

    def run(**kw):
        eng = Engine(model, TCFG, EngineConfig(kv_quant=kv, **POOL, **kw),
                     device="cpu")
        return eng, _drive(eng, lambda rid, p, n: Request(
            id=rid, prompt=p, max_new_tokens=n,
            sampling=SamplingParams(greedy=True)))

    one, (got1, _) = run(paged_kernel=True)
    assert one.kernel_route.decode == "kernel" and one.group is None
    for kernel in (True, False):
        eng, (got, pages) = run(paged_kernel=kernel, **MESH)
        route = eng.kernel_route.summary()
        assert route["decode"] == ("kernel" if kernel else "gather")
        assert route["sharded"] == kernel and route["mesh"] == [2, 2]
        assert got == got1 == want, (kv, kernel)
        assert pages["evictions"] > 0 and pages["cow_copies"] > 0
        assert pages["prefix_hit_tokens"] > 0
        for key in ("prefix_hits", "prefix_hit_tokens", "cow_copies",
                    "evictions", "pages_in_use", "radix_pages",
                    "mesh_shape", "aggregate_pages", "pages_per_chip",
                    "pages_in_use_by_chip"):
            assert pages[key] == jpages[key], key
        assert eng.pool.alloc.ref.max() == 0


def test_mesh_stats_geometry_and_cross_block_copy(tree):
    """The JAX mesh stats (``test_mesh_pages_per_chip_and_aggregate_
    stats``); the divisibility drop (7 pages on data=2 replicate, and the
    route falls back to gather with ``mesh_indivisible``); a
    copy-on-write split from one data shard's block into the other's."""
    model = params_from_numpy(tree, TCFG, device="cpu")
    eng = Engine(model, TCFG, EngineConfig(pool_size=2, max_queue=8,
                                           page_size=8, n_pages=8,
                                           paged_kernel=True, **MESH),
                 device="cpu")
    assert eng.submit(Request(id="a", prompt=np.arange(1, 17),
                              max_new_tokens=4,
                              sampling=SamplingParams(greedy=True))) is None
    eng.step()
    pg = eng.metrics_summary()["pages"]
    assert pg["mesh_shape"] == [2, 2] == pg["effective_mesh_shape"]
    assert pg["aggregate_pages"] == 8 and pg["pages_per_chip"] == 4
    assert len(pg["pages_in_use_by_chip"]) == 2
    assert sum(pg["pages_in_use_by_chip"]) == pg["pages_in_use"]
    assert len(pg["page_utilization_by_chip"]) == 2
    eng.drain()
    pool = eng.pool
    assert sorted(pool.cache) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert pool.cache[(1, 1)]["k"].shape == (2, 4, 8, 16)
    for blk in pool.cache.values():
        blk["k"][:, 1].normal_()
    pool.copy_page(1, 6)          # block 0's page 1 -> block 1's page 2
    for m in (0, 1):
        torch.testing.assert_close(pool.cache[(1, m)]["k"][:, 2],
                                   pool.cache[(0, m)]["k"][:, 1])
    odd = Engine(model, TCFG, EngineConfig(pool_size=2, page_size=8,
                                           n_pages=7, paged_kernel=True,
                                           **MESH), device="cpu")
    assert odd.kernel_route.decode == "gather"
    assert "mesh_indivisible" in odd.kernel_route.reasons
    assert odd.pool.stats()["effective_mesh_shape"] == [1, 2]
    assert page_shards(7, 2) == 1 and page_shards(8, 2) == 2
    assert parse_mesh_shape("4,1") == (4, 1)
    for bad in ("", "2", "2x2x2", "0x2", "ax2"):
        with pytest.raises(ValueError):
            parse_mesh_shape(bad)


# --------------------------------------------- (3) CLI and processes

REPLAY = ["serve-replay", "--preset", "test-tiny", "--device", "cpu",
          "--decode-cache-layout", "packed", "--paged-kernel",
          "--n-requests", "4", "--rate", "1000000", "--greedy",
          "--prompt-mode", "shared_prefix", "--page-size", "8",
          "--request-max-new-tokens", "4", "--mesh-shape", "2x2", "--json"]


def _summary(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def one_process_replay():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(REPLAY) == 0
    return _summary(out.getvalue())


def test_serve_replay_mesh_cli(one_process_replay, monkeypatch):
    """``serve-replay --mesh-shape 2x2`` runs in one process on the
    kernel route, sharded; ``train --mesh-shape`` stays refused; a launch
    of 3 processes for a 2x2 mesh raises before it joins a group."""
    s = one_process_replay
    assert s["n_completed"] == 4
    assert s["kernel_route"]["sharded"] and s["pages"]["mesh_shape"] == [2, 2]
    with pytest.raises(SystemExit, match="queue A item 11"):
        cli.main(["train", "--preset", "test-tiny", "--device", "cpu",
                  "--mesh-shape", "2x2"])
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="3 processes for --mesh-shape 2x2"):
        cli.main(REPLAY)


# a child of the process test: one shard of the 2x2 mesh, the trace of
# argv[2] through the engine, rank 0's streams and pages out as JSON
CHILD = """
import json, sys
import torch
from replicatinggpt_tpu_torch.config import ModelConfig
from replicatinggpt_tpu_torch.models.gpt import init_params
from replicatinggpt_tpu_torch.parallel.distributed import setup_serve
from replicatinggpt_tpu_torch.serve import (Engine, EngineConfig, Request,
                                            SamplingParams)
torch.set_num_threads(1)
cfg = ModelConfig(**json.loads(sys.argv[1]))
dev = setup_serve((2, 2), "cpu")
model = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
eng = Engine(model, cfg, EngineConfig(**json.loads(sys.argv[3])), device=dev)
for rid, prompt, n in json.loads(sys.argv[2]):
    assert eng.submit(Request(id=rid, prompt=prompt, max_new_tokens=n,
                              sampling=SamplingParams(greedy=True))) is None
streams = {r.id: list(r.tokens) for r in eng.drain()}
if eng.group.is_main:
    print(json.dumps({"streams": streams, "group": eng.group.describe(),
                      "pages": eng.metrics_summary()["pages"]}))
torch.distributed.destroy_process_group()
"""


def test_engine_2x2_in_four_processes():
    """The pressure trace in 4 gloo processes, one shard each
    (``ProcessServeGroup``), started with the variables ``torchrun`` sets
    (without its agent, which adds ~2 s here): rank 0's clock and
    decisions on every rank, copy-on-write splits across data shards as
    point-to-point sends, and the same greedy streams and page accounting
    as the 2x2 engine in one process."""
    ecfg = dict(paged_kernel=True, **POOL, **MESH)
    model = init_params(TCFG, torch.Generator().manual_seed(0),
                        device="cpu")
    eng = Engine(model, TCFG, EngineConfig(**ecfg), device="cpu")
    copies = []
    copy = eng.pool.copy_page
    eng.pool.copy_page = lambda src, dst: (copies.append((src, dst)),
                                           copy(src, dst))
    want, pages = _drive(eng, lambda rid, p, n: Request(
        id=rid, prompt=p, max_new_tokens=n,
        sampling=SamplingParams(greedy=True)))
    assert any(s // 3 != d // 3 for s, d in copies), copies
    trace = json.dumps([(rid, p.tolist(), n)
                        for rid, p, n in _pressure_trace()])
    argv = [sys.executable, "-c", CHILD,
            json.dumps(dataclasses.asdict(TCFG)), trace, json.dumps(ecfg)]
    with socket.socket() as sock:      # a free port for the rendezvous
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    procs = []
    for rank in range(4):
        env = dict(os.environ, OMP_NUM_THREADS="1", RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="4",
                   MASTER_ADDR="localhost", MASTER_PORT=port,
                   PYTHONPATH=str(REPO) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      env=env, cwd=REPO))
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert not any(out.strip() for out, _ in outs[1:])
    got = json.loads(outs[0][0])
    assert got["group"] == "4 processes, one shard each (gloo)"
    assert got["streams"] == want
    for key in ("cow_copies", "evictions", "prefix_hit_tokens",
                "pages_in_use_by_chip"):
        assert got["pages"][key] == pages[key], key


@pytest.mark.parametrize("tied", [True, False])
def test_vocab_parallel_embedding_and_head(tied):
    """Where the vocabulary divides over 'model' (64 on 2), ``wte`` (and
    an untied head) split by vocabulary: the embedding looks each id up
    in its shard and sums over 'model', the head gathers the shards'
    logits; greedy streams equal the 1x1 engine's."""
    cfg = dataclasses.replace(TCFG, vocab_size=64, tied_head=tied)
    model = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    reqs = [(f"v{i}", np.arange(i, i + 9) % 64, 5) for i in range(3)]
    streams = []
    for mesh in ({}, MESH):
        eng = Engine(model, cfg, EngineConfig(pool_size=2, page_size=8,
                                              paged_kernel=True, **mesh),
                     device="cpu")
        for rid, p, n in reqs:
            assert eng.submit(Request(id=rid, prompt=p, max_new_tokens=n,
                                      sampling=SamplingParams(
                                          greedy=True))) is None
        streams.append({r.id: r.tokens for r in eng.drain()})
    assert isinstance(eng.params["wte"], dict)
    assert eng.params["wte"][1].shape == (32, 32)
    assert streams[0] == streams[1]


def test_tiktoken_refusal_names_no_queue_item():
    """C1: the tiktoken branch is refused for what it needs (ranks over
    the network), naming no ROADMAP item."""
    with pytest.raises(NotImplementedError) as e:
        get_tokenizer("tiktoken:o200k_base")
    msg = str(e.value)
    assert "network" in msg and "item" not in msg
