"""The port's GPT-2 training slice against the JAX package, on the CPU.

- the packed flash kernels' plain versions (``flash_packed_fwd_ref`` /
  ``flash_packed_bwd_ref`` through ``FlashPacked``) against the JAX
  head-group families that GPT-2 124M takes: ``family="group"``, and
  ``family="group_stream"`` at equal blocks (its triangular kernels) and
  at ``block_q=128, block_k=64`` (its streamed kernels), in Pallas
  interpret mode at B=2, T=256, C=256, H=4 (D=64, two heads a group),
  unit-scale inputs; f32 with dropout off and at 0.1 from
  the same int32 seed (the hash is bit-exact), elementwise at 1e-5
  (forward) and 2e-4 (gradients, the JAX package's own tolerance for its
  flash gradients); bf16 at dropout 0.1, held in norm, relative to the
  reference, against JAX and against an f64 witness (see ``BF16_REL``);
  the blocks walk 64-key tiles, the plain versions' (see ``FAMILIES``);
- the plain versions against that f64 witness alone, f32 and bf16,
  dropout off and at 0.1;
- a gpt2-flavour loss curve (gelu, tied head, cosine warmup, clipping,
  sequential batches of BPE tokens) against JAX ``make_train_step`` at
  1e-4 relative;
- the GPT-2 presets field by field, the attention route at T=1024, and
  the CLI's BPE path on the CPU.
"""

import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.config import TrainConfig as JTrainConfig
from replicatinggpt_tpu.config import get_config as jget
from replicatinggpt_tpu.data import loader as jloader
from replicatinggpt_tpu.models import gpt as jgpt
from replicatinggpt_tpu.ops import flash_pallas as jfp
from replicatinggpt_tpu.train import state as jstate
from replicatinggpt_tpu.train import steps as jsteps
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.config import ModelConfig, TrainConfig
from replicatinggpt_tpu_torch.config import get_config
from replicatinggpt_tpu_torch.data import loader as tloader
from replicatinggpt_tpu_torch.models import gpt as tgpt
from replicatinggpt_tpu_torch.ops import flash_packed as tfp
from replicatinggpt_tpu_torch.ops.flash_attention import describe_route
from replicatinggpt_tpu_torch.tokenizers import ByteBPETokenizer
from replicatinggpt_tpu_torch.train import state as tstate
from replicatinggpt_tpu_torch.train import steps as tsteps

B, T, C, H = 2, 256, 256, 4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32 (atol, rtol) of the output, then of the gradient
F32_TOLS = ((1e-5, 0.0), (2e-4, 0.0))
# f32 plain versions against the f64 witness, as ||x - ref|| / ||ref||
# (read 2.4e-7 forward and 4.2e-7 for the gradients)
F32_REL = 2e-6
# bf16, as ||x - ref|| / ||ref||: the plain versions round p z and ds
# to bf16 before their products, from the running max of each 64-key
# tile, where the JAX kernels round them, so the two are one computation
# up to f32 summation order (read 4.0e-5 output, 1.2e-4 gradient) and
# equally far from the f64 witness (read 2.7e-3 to 3.1e-3, about bf16's
# rms rounding)
BF16_REL = {"jax": 1e-3, "witness": 4e-3}
# each family at 64-key tiles (block_k = the plain versions' TILE): the
# JAX kernels round p from the running max of their own key tile, so at
# 128-key tiles the two round at other points and differ by about bf16's
# rms rounding, close to the 1e-3 bound; T=256 walks 4 tiles, the
# streamed family with 128-row q tiles
FAMILIES = {"group": ("group", {"block_q": 64, "block_k": 64}),
            "group_stream_tri": ("group_stream",
                                 {"block_q": 64, "block_k": 64}),
            "group_stream": ("group_stream", {"block_q": 128, "block_k": 64})}
# f32 with dropout off and on; bf16 once, with dropout (the same code)
CASES = [("float32", 0.0), ("float32", 0.1), ("bfloat16", 0.1)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small eager ops run much faster on one intra-op thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bpe(corpus_text):
    """A small BPE of the corpus (the trainer is held to the JAX one in
    tests/test_torch_port_bpe.py)."""
    return ByteBPETokenizer.train(corpus_text[:20_000], 320)


def _jax_seed(key) -> int:
    """The int32 kernel seed _flash_prologue derives from a dropout key."""
    return int(jax.random.randint(key, (1,), 0, 2 ** 31 - 1,
                                  dtype=jnp.int32)[0])


def _witness(qkv: torch.Tensor, w: torch.Tensor, seed: int, rate: float):
    """Causal attention with the hash's dropout, and its gradient, in f64
    from the (rounded) inputs the kernels see."""
    x = qkv.double().requires_grad_(True)
    q, k, v = (t.reshape(B, T, H, -1).transpose(1, 2) for t in x.split(C, -1))
    s = (q @ k.transpose(-1, -2)) * (C // H) ** -0.5
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(),
                      float("-inf"))
    p = torch.softmax(s, -1)
    if rate:
        p = p * tfp._mult(B, H, T, seed, rate, "cpu").double()
    o = (p @ v).transpose(1, 2).reshape(B, T, C)
    o.backward(w.double())
    return o.detach(), x.grad


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_versions_match_the_f64_witness(dtype, rate):
    """The plain versions (the CPU path of the kernels' wrappers) round
    once from f32: within f32's reach of the exact attention, and within
    bf16's rms rounding in bf16, forward and gradients."""
    tdt = DTYPES[dtype][1]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, T, 3 * C)).astype(
        np.float32)).to(tdt).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((B, T, C)).astype(
        np.float32)).to(tdt)
    o = tfp.flash_packed_attention(x, H, seed=99, rate=rate)
    o.backward(w)
    ref_o, ref_g = _witness(x.detach(), w, 99, rate)
    limit = F32_REL if dtype == "float32" else BF16_REL["witness"]
    assert _rel(o.detach().float(), ref_o) <= limit
    assert _rel(x.grad.float(), ref_g) <= limit


@pytest.mark.parametrize("dtype,rate", CASES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_flash_twins_match_jax_group_families(family, dtype, rate):
    jdt, tdt = DTYPES[dtype]
    name, blocks = FAMILIES[family]
    rng = np.random.default_rng(4)
    qkv = rng.standard_normal((B, T, 3 * C)).astype(np.float32)
    w = rng.standard_normal((B, T, C)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    kw = dict(dropout_rate=rate, dropout_rng=key) if rate else {}

    def attend(x):
        return jfp.pallas_flash_attention_packed(x, H, family=name,
                                                 **blocks, **kw)

    want_o, vjp = jax.vjp(attend, jnp.asarray(qkv, jdt))
    (want_g,) = vjp(jnp.asarray(w, jdt))
    want_o, want_g = (np.asarray(a, np.float32) for a in (want_o, want_g))
    seed = _jax_seed(key) if rate else 0
    x = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    before = (tfp.flash_packed_fwd.launches, tfp.flash_packed_bwd.launches)
    o = tfp.flash_packed_attention(x, H, seed=seed, rate=rate)
    o.backward(torch.from_numpy(w).to(tdt))
    assert (tfp.flash_packed_fwd.launches,
            tfp.flash_packed_bwd.launches) == before   # CPU: plain versions
    assert o.dtype == x.grad.dtype == tdt
    got_o, got_g = o.detach().float().numpy(), x.grad.float().numpy()
    if dtype == "float32":
        (atol_o, rtol_o), (atol_g, rtol_g) = F32_TOLS
        np.testing.assert_allclose(got_o, want_o, atol=atol_o, rtol=rtol_o)
        np.testing.assert_allclose(got_g, want_g, atol=atol_g, rtol=rtol_g)
        return
    ref_o, ref_g = _witness(x.detach(), torch.from_numpy(w).to(tdt), seed,
                            rate)
    for got, want, ref in ((got_o, want_o, ref_o), (got_g, want_g, ref_g)):
        assert _rel(got, want) <= BF16_REL["jax"]
        assert _rel(got, ref) <= BF16_REL["witness"]


def test_gpt2_flavour_loss_curve_matches_jax(bpe, corpus_text):
    """5 steps of a gelu / tied-head model with warmup-cosine, clipping
    and sequential BPE batches against the JAX train step."""
    Tm, Hm, Cm = 128, 2, 64
    kw = dict(vocab_size=bpe.vocab_size, block_size=Tm, n_layer=2,
              n_head=Hm, n_embd=Cm, dropout=0.0, attn_dropout=0.0,
              tied_head=True, activation="gelu", dtype="float32")
    jcfg, tcfg = JConfig(**kw), ModelConfig(**kw)
    tk = dict(batch_size=B, lr=3e-3, max_iters=5, warmup_iters=2,
              lr_schedule="cosine", grad_clip=1.0, seed=0,
              sampling="sequential")
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jgpt.init_params(k, jcfg))(jax.random.PRNGKey(0)))
    jt = JTrainConfig(**tk)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                              opt_state=jstate.make_optimizer(jt).init(jp),
                              rng=jax.random.PRNGKey(1))
    jstep = jsteps.make_train_step(jcfg, jt, donate=False)
    tt = TrainConfig(**tk)
    ts = tstate.create_train_state(
        tcfg, tt, "cpu", model=tgpt.params_from_numpy(tree, tcfg,
                                                       device="cpu"))
    tstep = tsteps.make_train_step(tcfg, tt)
    data = bpe.encode_np(corpus_text[:60_000])
    ours = tloader.make_batcher("sequential", data, B, Tm)
    theirs = jloader.make_batcher("sequential", data, B, Tm)
    jl, tl = [], []
    for _ in range(5):
        (x, y), (jx, jy) = ours.next_batch(), theirs.next_batch()
        np.testing.assert_array_equal(x, jx)
        state, m = jstep(state, (jnp.asarray(jx), jnp.asarray(jy)))
        jl.append(float(m["loss"]))
        tl.append(float(tstep(ts, (torch.from_numpy(x.astype(np.int16)),
                                   torch.from_numpy(y.astype(np.int16))))))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("preset", ["gpt2-small", "gpt2-shakespeare"])
def test_gpt2_presets_match_jax(preset):
    j, t = jget(preset), get_config(preset)
    for f in dataclasses.fields(t.model):
        if hasattr(j.model, f.name):
            assert getattr(t.model, f.name) == getattr(j.model, f.name), f
    for f in dataclasses.fields(t.train):
        assert getattr(t.train, f.name) == getattr(j.train, f.name), f
    assert (t.tokenizer, t.dataset) == (j.tokenizer, j.dataset)


def test_gpt2_small_takes_the_packed_kernel_at_t1024():
    """The slice's attention is the packed flash kernel at T=1024 and at
    long T, where the JAX package takes its head-group families; so is
    D=256 (one head a group), while gpt2-xl's 25 heads of D=64 form no
    head pair and take the split-heads kernel."""
    mcfg = get_config("gpt2-small").model
    for seq in (1024, 8192):
        assert describe_route(mcfg, seq).startswith(
            f"packed flash attention (csrc/flash_packed.cu")
    assert describe_route(dataclasses.replace(mcfg, n_embd=768 * 4),
                          1024).startswith("packed flash")   # D=256
    assert describe_route(get_config("gpt2-xl").model, 1024).startswith(
        "split-heads flash attention")


def test_train_and_generate_cli_with_the_bpe_on_cpu(bpe, tmp_path):
    """``train --preset gpt2-shakespeare`` with a saved BPE (cut to a
    tiny width, its vocabulary the BPE's 320 tokens: like the JAX
    tokenizer's, ``decode`` refuses ids no token has) prints the
    reference's per-step loss lines and a decoded sample; ``generate``
    encodes its prompt through the same BPE."""
    path = tmp_path / "bpe.json"
    bpe.save(str(path))
    # 4 heads of D=32 form a head group: the packed route, as the preset's
    small = ["--tokenizer", f"bpe:{path}", "--n-layer", "1", "--n-head",
             "4", "--n-embd", "128", "--block-size", "64", "--vocab-size",
             str(bpe.vocab_size), "--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["train", "--preset", "gpt2-shakespeare",
                         "--max-iters", "3", "--eval-iters", "1",
                         "--sample-after", "--sample-tokens", "16",
                         *small]) == 0
    text = out.getvalue()
    assert [int(s) for s in re.findall(r"^Step (\d+), Loss: \d+\.\d{6}",
                                       text, re.M)] == [0, 1, 2]
    assert "vocab 320" in text and "packed flash attention" in text
    assert text.rstrip("\n").splitlines()[-1]          # the decoded sample
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["generate", "--preset", "gpt2-shakespeare",
                         "--prompt", "ROMEO:", "--sample-tokens", "8",
                         *small]) == 0
    assert out.getvalue().strip()                     # 8 decoded tokens
