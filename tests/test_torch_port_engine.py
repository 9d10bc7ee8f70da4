"""The port's serving engine against the JAX engine, its CLI, and the
port's import hygiene — on the CPU.

The JAX engine runs its default (gather) route; the port runs all three
of its routes (the kernel routes take the wrappers' plain versions on
CPU tensors). Greedy streams must be identical through a
prefix hit, a copy-on-write split and an LRU eviction.
"""

import ast
import contextlib
import io
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.models.gpt import init_params as jinit
from replicatinggpt_tpu.serve import Engine as JEngine
from replicatinggpt_tpu.serve import EngineConfig as JEngineConfig
from replicatinggpt_tpu.serve import ReplayConfig as JReplayConfig
from replicatinggpt_tpu.serve import Request as JRequest
from replicatinggpt_tpu.serve import SamplingParams as JSampling
from replicatinggpt_tpu.serve.replay import make_trace as jmake_trace
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.config import ModelConfig
from replicatinggpt_tpu_torch.models.gpt import params_from_numpy
from replicatinggpt_tpu_torch.serve import (Engine, EngineConfig,
                                            ReplayConfig, Request,
                                            SamplingParams, make_trace)

REPO = pathlib.Path(__file__).resolve().parent.parent
JCFG = JConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2, n_embd=64,
               dropout=0.0, attn_dropout=0.0, dtype="float32",
               decode_cache_layout="packed")
TCFG = ModelConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2,
                   n_embd=64, dtype="float32", decode_cache_layout="packed")
# 5 physical pages of 8 tokens, 2 slots: the third wave must evict
POOL = dict(pool_size=2, page_size=8, n_pages=5)


def _waves():
    """(prompt, max_new) per request, in three submission waves: a
    2-page prompt; its extension (prefix hit) and its exact repeat (a
    full-prompt hit: copy-on-write split); then a fresh 24-token prompt
    that needs an eviction, and the first prompt again."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 65, (16,))
    d = rng.integers(0, 65, (24,))
    return [[(a, 4)],
            [(np.concatenate([a, rng.integers(0, 65, (3,))]), 4), (a, 4)],
            [(d, 5), (a, 3)]]


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


@pytest.fixture(scope="module")
def jax_run():
    tree = jinit(jax.random.PRNGKey(5), JCFG)
    eng = JEngine(tree, JCFG, JEngineConfig(**POOL))
    streams, pages = _drive(eng, lambda rid, p, n: JRequest(
        id=rid, prompt=p, max_new_tokens=n,
        sampling=JSampling(greedy=True)))
    return jax.tree_util.tree_map(np.asarray, tree), streams, pages


@pytest.mark.parametrize("paged_kernel", [True, False])
def test_engine_greedy_streams_match_jax(jax_run, paged_kernel):
    """(d) identical greedy streams through a prefix hit, a COW split and
    an eviction, with the same page accounting. With ``paged_kernel`` the
    route rule takes the fused all-layers kernel at these widths (as the
    JAX rule does), and the per-layer kernel route, forced, gives the
    same streams."""
    tree, want, jpages = jax_run
    model = params_from_numpy(tree, TCFG, device="cpu")
    routes = ("fused", "kernel") if paged_kernel else ("gather",)
    for route in routes:
        eng = Engine(model, TCFG, EngineConfig(paged_kernel=paged_kernel,
                                               **POOL), device="cpu")
        assert eng.kernel_route.decode == routes[0]
        if route == "kernel":
            eng._use_fused, eng._use_kernel = False, True
        got, pages = _drive(eng, lambda rid, p, n: Request(
            id=rid, prompt=p, max_new_tokens=n,
            sampling=SamplingParams(greedy=True)))
        assert got == want, route
        assert pages["prefix_hits"] >= 2 and pages["cow_copies"] >= 1
        assert pages["evictions"] >= 1
        for key in ("prefix_hits", "prefix_hit_tokens", "cow_copies",
                    "evictions", "pages_in_use", "radix_pages"):
            assert pages[key] == jpages[key], key


def test_engine_cancel_deadline_eos_and_rejects():
    """The lifecycle paths of the port's engine: cancel (queued and
    running), an active deadline, an eos stop, and submit-time
    rejections; every slot and page is released afterwards."""
    t = [0.0]
    model = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(1),
                                                 JCFG)), TCFG, device="cpu")
    eng = Engine(model, TCFG, EngineConfig(pool_size=2, page_size=8),
                 clock=lambda: t[0], device="cpu")
    greedy = SamplingParams(greedy=True)
    rng = np.random.default_rng(0)

    def req(rid, **kw):
        return Request(id=rid, prompt=rng.integers(0, 65, (5,)),
                       max_new_tokens=8, sampling=greedy, **kw)

    assert eng.submit(req("a")) is None
    assert eng.submit(req("b", deadline=0.5)) is None
    assert eng.submit(req("c")) is None            # queued: 2 slots
    assert eng.submit(req("a")).finish_reason == "rejected_bad_request"
    assert eng.submit(req("x", eos_token_id=65)).finish_reason \
        == "rejected_bad_request"
    eng.step()
    assert eng.cancel("c") and eng.cancel("a") and not eng.cancel("zz")
    t[0] = 1.0                                     # b's deadline passes
    out = {r.id: r for r in eng.step()}
    assert out["c"].finish_reason == "cancelled" and not out["c"].tokens
    assert out["a"].finish_reason == "cancelled" and len(out["a"].tokens) == 1
    assert out["b"].finish_reason == "deadline"
    # eos: stop on the first greedy token, which is then the last one
    probe = Engine(model, TCFG, EngineConfig(pool_size=2, page_size=8),
                   device="cpu")
    prompt = rng.integers(0, 65, (5,))
    probe.submit(Request(id="p", prompt=prompt, max_new_tokens=1,
                         sampling=greedy))
    first = probe.drain()[0].tokens[0]
    assert eng.submit(Request(id="e", prompt=prompt, max_new_tokens=8,
                              sampling=greedy, eos_token_id=first)) is None
    (res,) = eng.drain()
    assert res.finish_reason == "eos" and res.tokens == [first]
    assert eng.idle and eng.pool.n_free == 2
    assert eng.pool.alloc.ref.sum() == 0


def test_make_trace_is_the_jax_trace():
    for mode in ("shared_prefix", "random"):
        kw = dict(n_requests=6, rate=50.0, seed=3, prompt_len_max=20,
                  prompt_mode=mode, greedy=True)
        want = jmake_trace(JCFG, JReplayConfig(**kw))
        got = make_trace(TCFG, ReplayConfig(**kw))
        assert [t for t, _ in got] == [t for t, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert g.id == w.id and g.rng_seed == w.rng_seed
            np.testing.assert_array_equal(g.prompt, w.prompt)


def test_serve_replay_cli_on_cpu():
    """(d) the port's own CLI entry completes every request on the CPU,
    and refuses a flag it does not implement."""
    out = io.StringIO()
    argv = ["serve-replay", "--preset", "test-tiny", "--device", "cpu",
            "--decode-cache-layout", "packed", "--paged-kernel",
            "--n-requests", "6", "--rate", "1000", "--greedy",
            "--prompt-mode", "shared_prefix", "--prompt-len-max", "24",
            "--page-size", "8",
            "--request-max-new-tokens", "4", "--json"]
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert summary["n_completed"] == 6
    assert summary["kernel_route"]["decode"] == "kernel"
    assert summary["pages"]["prefix_hits"] > 0
    with pytest.raises(SystemExit, match="ROADMAP"):
        cli.main(argv + ["--weight-quant", "int8"])


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    """(e) no file of the port, nor chip_smoke.py, imports jax,
    replicatinggpt_tpu or regex (the card's machine has no regex)."""
    files = sorted((REPO / "replicatinggpt_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    names = {str(f.relative_to(REPO)) for f in files}
    assert {f"replicatinggpt_tpu_torch/{m}.py" for m in (
        "faults/watchdog", "serve/journal", "serve/speculative",
        "serve/cache_pool", "serve/rpc", "serve/worker", "faults/procsup",
        "faults/netchaos")} <= names
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "replicatinggpt_tpu",
                                  "regex")]
    assert len(files) > 10 and not bad, bad


def test_entry_points_without_device_need_a_card():
    """(e) called without a device on a CUDA-less box, the entry points
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    model = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(0),
                                                 JCFG)), TCFG, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(model, TCFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve-replay", "--preset", "test-tiny",
                  "--n-requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["generate", "--preset", "test-tiny",
                  "--sample-tokens", "4"])
    from replicatinggpt_tpu_torch.sample.generate import (GenerateConfig,
                                                          generate)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(model, [[1, 2]], TCFG, GenerateConfig(max_new_tokens=4))
