"""The port's generation path against the JAX package's, on the CPU.

The same weights (the JAX ``init_params`` tree, layernorm parameters and
biases perturbed so their casts show) and the same numpy inputs go
through both sides. The JAX decode kernels run in interpret mode; the
port's wrappers take their plain versions on CPU tensors. Also the
``generate`` CLI and ``train --sample-after`` on ``--device cpu``.
"""

import contextlib
import dataclasses
import importlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.config import get_config as jget_config
from replicatinggpt_tpu.models import gpt as jgpt
from replicatinggpt_tpu.ops import decode_pallas as jdp
from replicatinggpt_tpu.sample import GenerateConfig as JGenerateConfig
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.config import ModelConfig
from replicatinggpt_tpu_torch.config import get_config
from replicatinggpt_tpu_torch.models import gpt as tgpt
from replicatinggpt_tpu_torch.ops import decode as tdec
from replicatinggpt_tpu_torch.sample import generate as tgen

# the JAX package re-exports generate() under the submodule's name
jgen = importlib.import_module("replicatinggpt_tpu.sample.generate")

# D=32 (inside both kernels' envelopes), f32
JCFG = JConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2, n_embd=64,
               dropout=0.0, attn_dropout=0.0, dtype="float32",
               tied_head=False, activation="gelu")
TCFG = ModelConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2,
                   n_embd=64, tied_head=False, activation="gelu",
                   dtype="float32")
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(jcfg, seed=3):
    tree = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for name, arr in tree["blocks"].items():
        if not name.endswith("_kernel"):
            tree["blocks"][name] = (arr + 0.1 * rng.standard_normal(
                arr.shape)).astype(np.float32)
    return tree


def _both(jcfg, tcfg, seed=3):
    """(JAX params, port model, its compute params) of the same
    weights."""
    tree = _tree(jcfg, seed)
    model = tgpt.params_from_numpy(tree, tcfg, device="cpu")
    return (jax.tree_util.tree_map(jnp.asarray, tree), model,
            tgpt.compute_params(model, "cpu"))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [0, 5, 15])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6),
                                       ("bfloat16", 2e-2)])
def test_packed_decode_attention_ref_matches_jax(pos, dtype, tol):
    B, S, H, D = 3, 16, 4, 32
    C = H * D
    rng = np.random.default_rng(pos)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, C),) * 3 + ((B, S, C),) * 2]
    jd, td = DT[dtype]
    want = jdp.packed_decode_attention(
        *(jnp.asarray(a, jd) for a in arrs), jnp.int32(pos), n_head=H)
    got = tdec.packed_decode_attention(
        *(torch.from_numpy(a).to(td) for a in arrs), pos, n_head=H)
    assert got.dtype == td and got.shape == (B, C)
    _close(_np(got), want, tol)


_jfused = jax.jit(jdp.fused_decode_layers, static_argnums=(4,))


@pytest.mark.parametrize("layout", ["heads", "packed"])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_fused_decode_layers_ref_matches_jax(layout, dtype, tol):
    """x, the fresh K/V rows and the written cache at pos 0, 7 and S-1,
    over warm random caches (L=2, C=128, H=2, S=64, ReLU)."""
    jcfg = JConfig(vocab_size=64, block_size=64, n_layer=2, n_head=2,
                   n_embd=128, dropout=0.0, attn_dropout=0.0, dtype=dtype,
                   activation="relu", decode_cache_layout=layout)
    tcfg = ModelConfig(vocab_size=64, block_size=64, n_layer=2, n_head=2,
                       n_embd=128, dtype=dtype, activation="relu",
                       decode_cache_layout=layout)
    tree = _tree(jcfg)
    jd, td = DT[dtype]
    jblocks = {k: jnp.asarray(v) for k, v in tree["blocks"].items()}
    tblocks = {k: torch.tensor(v) for k, v in tree["blocks"].items()}
    rng = np.random.default_rng(11)
    shape = tuple(jgpt.init_kv_cache(jcfg, 1)["k"].shape)
    kc, vc = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    for pos in (0, 7, 63):
        x0 = rng.standard_normal((1, 128)).astype(np.float32)
        jx, jcache = _jfused(jnp.asarray(x0, jd), jblocks, jnp.int32(pos),
                             {"k": jnp.asarray(kc, jd),
                              "v": jnp.asarray(vc, jd)}, jcfg)
        tcache = {"k": torch.from_numpy(kc).to(td),
                  "v": torch.from_numpy(vc).to(td)}
        tx, newk, newv = tdec.fused_decode_layers(
            torch.from_numpy(x0).to(td), tblocks, pos, tcache, tcfg)
        assert tx.dtype == newk.dtype == td
        _close(_np(tx), jx, tol)
        jk, jv = (np.asarray(jcache[n], np.float32) for n in ("k", "v"))
        fresh = (np.s_[:, :, pos] if layout == "packed"
                 else np.s_[:, :, :, pos])
        _close(_np(newk).reshape(jk[fresh].shape), jk[fresh], tol)
        _close(_np(newv).reshape(jv[fresh].shape), jv[fresh], tol)
        tgpt.write_fresh_kv(tcache, newk, newv, pos, tcfg)
        _close(_np(tcache["k"]), jk, tol)
        _close(_np(tcache["v"]), jv, tol)


# ---------------------------------------------------------------------------
# model steps
# ---------------------------------------------------------------------------

_JAX_STEPS = {}


def _jax_steps(layout, B, toks):
    """JAX's prefill of toks[:, :3] and decode_step (kernel gate
    closed, one jitted program) over positions 3..8: (logits per step,
    final cache), computed once per (layout, B)."""
    if (layout, B) not in _JAX_STEPS:
        jcfg = dataclasses.replace(JCFG, decode_cache_layout=layout)
        jp, _, _ = _both(jcfg, dataclasses.replace(
            TCFG, decode_cache_layout=layout))
        step = jax.jit(jgpt.decode_step,
                       static_argnames=("cfg", "allow_pallas"))
        cache = jgpt.prefill(jp, jnp.asarray(toks[:, :3]),
                             jgpt.init_kv_cache(jcfg, B), jcfg)
        logits = []
        for pos in range(3, 9):
            lg, cache = step(jp, jnp.asarray(toks[:, pos]), jnp.int32(pos),
                             cache, cfg=jcfg, allow_pallas=False)
            logits.append(np.asarray(lg))
        _JAX_STEPS[layout, B] = logits, {n: np.asarray(c)
                                         for n, c in cache.items()}
    return _JAX_STEPS[layout, B]


@pytest.mark.parametrize("layout", ["heads", "packed"])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("kernels", [False, True])
def test_decode_step_matches_jax(layout, B, kernels):
    """6 steps from a prefilled 3-token prompt against JAX's decode_step
    with its kernel gate closed; the port runs its plain route and its
    kernel route (fused at B=1, packed attention at B=2 packed; both
    take the plain versions on the CPU): logits and caches at 1e-5."""
    tcfg = dataclasses.replace(TCFG, decode_cache_layout=layout)
    _, _, tp = _both(dataclasses.replace(JCFG, decode_cache_layout=layout),
                     tcfg)
    route = tgpt.decode_route(tcfg, B, torch.float32, 32, kernels)
    assert route == ("plain" if not kernels else "fused" if B == 1
                     else "packed" if layout == "packed" else "plain")
    toks = np.random.default_rng(B).integers(0, 65, (B, 9)).astype(np.int32)
    jlogits, jcache = _jax_steps(layout, B, toks)
    tcache = tgpt.prefill(tp, torch.from_numpy(toks[:, :3]),
                          tgpt.init_kv_cache(tcfg, B), tcfg)
    for pos, jl in zip(range(3, 9), jlogits):
        tl, tcache = tgpt.decode_step(tp, torch.from_numpy(toks[:, pos]),
                                      pos, tcache, tcfg,
                                      allow_kernels=kernels)
        _close(tl.numpy(), jl, 1e-5)
    for n in ("k", "v"):
        _close(tcache[n].numpy(), jcache[n], 1e-5)


@pytest.mark.parametrize("layout", ["heads", "packed"])
def test_prefill_matches_jax(layout):
    jcfg = dataclasses.replace(JCFG, decode_cache_layout=layout)
    tcfg = dataclasses.replace(TCFG, decode_cache_layout=layout)
    jp, _, tp = _both(jcfg, tcfg)
    toks = np.random.default_rng(4).integers(0, 65, (2, 11)).astype(np.int32)
    jc = jgpt.prefill(jp, jnp.asarray(toks), jgpt.init_kv_cache(jcfg, 2),
                      jcfg)
    tc = tgpt.prefill(tp, torch.from_numpy(toks), tgpt.init_kv_cache(tcfg, 2),
                      tcfg)
    assert tgpt.cache_seq_axis(tcfg) == jgpt.cache_seq_axis(jcfg)
    for n in ("k", "v"):
        assert tuple(tc[n].shape) == tuple(jc[n].shape)
        _close(tc[n].numpy(), jc[n], 1e-5)


def test_decode_route_matches_jax_envelopes():
    """The port's route rule is the JAX envelopes' (as decode_step reads
    them with the kernel gate open), over presets, batches, layouts,
    dtypes and cache lengths; char-gpt at B=1 takes the fused kernel,
    GPT-2 124M does not."""
    seen = set()
    for name in ("char-gpt", "gpt2-small", "test-tiny"):
        for layout in ("heads", "packed"):
            for dtype in ("bfloat16", "float32"):
                jcfg = dataclasses.replace(jget_config(name).model,
                                           decode_cache_layout=layout,
                                           dtype=dtype)
                tcfg = dataclasses.replace(get_config(name).model,
                                           decode_cache_layout=layout,
                                           dtype=dtype)
                isz = 2 if dtype == "bfloat16" else 4
                for B in (1, 2, 8):
                    for S in (jcfg.block_size, 64, 100):
                        want = ("fused" if jdp.fused_decode_supported(
                            jcfg, B, isz, seq_len=S) else "packed"
                            if layout == "packed"
                            and jdp.packed_decode_supported(
                                jcfg, isz, seq_len=S) else "plain")
                        got = tgpt.decode_route(tcfg, B, tcfg.compute_dtype,
                                                S)
                        assert got == want, (name, layout, dtype, B, S)
                        seen.add(got)
    assert seen == {"fused", "packed", "plain"}
    char, small = get_config("char-gpt").model, get_config("gpt2-small").model
    assert tgpt.decode_route(char, 1, torch.bfloat16, 256) == "fused"
    assert tgpt.decode_route(small, 1, torch.bfloat16, 1024) == "plain"
    packed = dataclasses.replace(small, decode_cache_layout="packed")
    assert tgpt.decode_route(packed, 8, torch.bfloat16, 1024) == "packed"
    assert tgpt.decode_route(char, 1, torch.float32, 256) == "plain"
    assert tgpt.decode_route(char, 1, torch.bfloat16, 256, False) == "plain"


# ---------------------------------------------------------------------------
# generate()
# ---------------------------------------------------------------------------

def _spy(monkeypatch, name):
    calls = []
    orig = getattr(tgpt, name)

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tgpt, name, spy)
    return calls


@pytest.mark.parametrize("layout,prompt,n", [
    ("heads", [[1, 5, 9]], 80),                 # two window refreshes+
    ("packed", [[1, 5, 9], [3, 3, 3]], 50),     # the packed route, B=2
])
def test_generate_greedy_tokens_identical_to_jax(monkeypatch, layout,
                                                 prompt, n):
    jcfg = dataclasses.replace(JCFG, decode_cache_layout=layout)
    tcfg = dataclasses.replace(TCFG, decode_cache_layout=layout)
    jp, model, _ = _both(jcfg, tcfg, seed=0)
    want = np.asarray(jgen.generate(
        jp, np.asarray(prompt, np.int32), jcfg,
        JGenerateConfig(max_new_tokens=n, greedy=True)))
    route = "fused_decode_layers" if layout == "heads" \
        else "packed_decode_attention"
    calls = _spy(monkeypatch, route)
    got = tgen.generate(model, prompt, tcfg,
                        tgen.GenerateConfig(max_new_tokens=n, greedy=True),
                        device="cpu")
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # steps: first segment min(pow2(n), 32 - 4 + 1) = 29, then 17 each
    steps = 29 + 17 * -(-(n - 29) // 17)
    assert len(calls) == steps * (1 if layout == "heads"
                                  else TCFG.n_layer)


def test_generate_sampling_keeps_top_k_support():
    """Sampled tokens stay inside the top-k set of their step's logits
    (the draw itself uses torch's stream, not JAX's), and a generator
    seed reproduces the stream."""
    _, model, tp = _both(JCFG, TCFG)
    gcfg = tgen.GenerateConfig(max_new_tokens=12, top_k=3, temperature=0.7)
    runs = [tgen.generate(model, [[2, 4]], TCFG, gcfg,
                          torch.Generator().manual_seed(5), device="cpu")
            for _ in range(2)]
    assert torch.equal(*runs)
    toks = runs[0][0].tolist()
    seq = [2, 4] + toks
    cache = tgpt.prefill(tp, torch.tensor([[2, 4]]),
                         tgpt.init_kv_cache(TCFG, 1), TCFG)
    for i, t in enumerate(toks):
        logits, cache = tgpt.decode_step(tp, torch.tensor([seq[i + 1]]),
                                         i + 1, cache, TCFG)
        assert t in torch.topk(logits[0], 3).indices.tolist()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return out.getvalue()


def _vocab():
    from replicatinggpt_tpu_torch.data.dataset import load_corpus
    return set(load_corpus("datasets/shakespeare.txt"))


def test_generate_cli_samples_from_random_init(capsys):
    text = _run_cli(["generate", "--preset", "test-tiny", "--device", "cpu",
                     "--sample-tokens", "40", "--prompt", "ROMEO:",
                     "--top-k", "10"])
    assert text.endswith("\n")
    sample = text[:-1]
    assert len(sample) == 40 and set(sample) <= _vocab()
    assert "no checkpoint found; sampling from random init" in \
        capsys.readouterr().err


def test_train_sample_after_samples_the_trained_weights():
    text = _run_cli(["train", "--preset", "test-tiny", "--device", "cpu",
                     "--max-iters", "2", "--eval-interval", "0",
                     "--eval-iters", "1", "--log-interval", "1",
                     "--sample-after", "--sample-tokens", "25"])
    assert "Step 1, Loss:" in text
    sample = text[-26:-1]
    assert len(sample) == 25 and set(sample) <= _vocab()


def test_generate_cli_draws_only_the_tokenizers_ids(capsys):
    """A model with more vocabulary rows than the tokenizer has ids (a
    GPT-2 preset over the corpus BPE) samples only ids it can decode;
    where the two agree the stream is the unlimited one."""
    text = _run_cli(["generate", "--preset", "test-tiny", "--device", "cpu",
                     "--vocab-size", "1024", "--sample-tokens", "60"])
    sample = text[:-1]
    assert len(sample) == 60 and set(sample) <= _vocab()
    cfg = get_config("test-tiny").model
    model = tgpt.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    runs = [tgen.generate(model, [[0]], cfg, tgen.GenerateConfig(
        max_new_tokens=30, vocab_limit=n), device="cpu") for n in (0, 65)]
    assert torch.equal(runs[0], runs[1])
    capped = tgen.generate(model, [[0]], cfg, tgen.GenerateConfig(
        max_new_tokens=30, vocab_limit=7), device="cpu")
    assert int(capped.max()) < 7


def test_generate_cli_refuses_checkpoints():
    """generate takes --checkpoint-dir now (tests/test_torch_port_
    checkpoint.py); a flag it still refuses is the mesh (item 11)."""
    with pytest.raises(SystemExit, match="queue A item 11"):
        cli.main(["generate", "--preset", "test-tiny", "--device", "cpu",
                  "--mesh-shape", "2x2"])
