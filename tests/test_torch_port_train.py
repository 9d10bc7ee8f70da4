"""The port's training slice against the JAX package, on the CPU.

Small shapes (2 layers, C=64, H=2, D=32, T=128, B=2), inputs made from
a seed with numpy and handed to both sides, JAX weights carried across
with ``params_from_numpy``. The JAX packed flash family runs in Pallas
interpret mode, as its own tests run it off-TPU; the port's wrappers
take their plain versions on CPU tensors. Tolerances: f32 forward 1e-5,
gradients 2e-4 (the JAX package's own for its flash gradients), loss
curves 1e-4 relative.
"""

import contextlib
import dataclasses
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.config import TrainConfig as JTrainConfig
from replicatinggpt_tpu.data import loader as jloader
from replicatinggpt_tpu.data.dataset import TokenDataset as JTokenDataset
from replicatinggpt_tpu.models import gpt as jgpt
from replicatinggpt_tpu.ops import attention as jattn
from replicatinggpt_tpu.ops import flash_pallas as jfp
from replicatinggpt_tpu.tokenizers import CharTokenizer as JCharTokenizer
from replicatinggpt_tpu.train import state as jstate
from replicatinggpt_tpu.train import steps as jsteps
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.config import ModelConfig, TrainConfig
from replicatinggpt_tpu_torch.config import get_config
from replicatinggpt_tpu_torch.data import loader as tloader
from replicatinggpt_tpu_torch.data.dataset import TokenDataset
from replicatinggpt_tpu_torch.models import gpt as tgpt
from replicatinggpt_tpu_torch.ops import attention as tattn
from replicatinggpt_tpu_torch.ops import flash_packed as tfp
from replicatinggpt_tpu_torch.ops.flash_attention import packed_qkv_attention
from replicatinggpt_tpu_torch.tokenizers import CharTokenizer, get_tokenizer
from replicatinggpt_tpu_torch.train import state as tstate
from replicatinggpt_tpu_torch.train import steps as tsteps

B, T, H, D = 2, 128, 2, 32
C = H * D
V = 65


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small eager ops run much faster on one intra-op thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 3 * C)) * scale).astype(np.float32)


def _jax_seed(key) -> int:
    """The int32 kernel seed _flash_prologue derives from a dropout key."""
    return int(jax.random.randint(key, (1,), 0, 2 ** 31 - 1,
                                  dtype=jnp.int32)[0])


# --------------------------------------------------------------------------
# 1. the dropout hash
# --------------------------------------------------------------------------

def test_fmix32_and_dropout_mask_bit_exact():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    x[:8] = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, 2 ** 32 - 1,
             0x85EBCA6B, 0xC2B2AE35]
    assert (x >= 2 ** 31).sum() > 1000
    want = np.asarray(jfp._fmix32(jnp.asarray(x.astype(np.uint32))))
    got = tfp.fmix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    seed, bq, bk = 1_234_567_891, 16, 32
    for bh, q_first, k_first, rate in ((0, 0, 0, 0.2), (7, 64, 32, 0.2),
                                       (3, 112, 96, 0.1)):
        want = np.asarray(jfp._dropout_mult(
            jnp.int32(seed), jnp.int32(bh), q_first, k_first, bq, bk, rate))
        got = tfp.dropout_mult(
            seed, torch.tensor([bh]), q_first + torch.arange(bq),
            k_first + torch.arange(bk), rate)[0].numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < (got == 0).sum() < got.size


# --------------------------------------------------------------------------
# 2-3. the kernel functions: forward and gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_packed_fwd_ref_matches_jax(rate):
    qkv = _qkv(1)
    key = jax.random.PRNGKey(7)
    jq = jnp.asarray(qkv)
    kw = dict(dropout_rate=rate, dropout_rng=key) if rate else {}
    want_o = np.asarray(jfp.pallas_flash_attention_packed(jq, H, **kw))
    seed = _jax_seed(key) if rate else 0
    _, want_lse = jfp._packed_fwd(jq, jnp.array([seed], jnp.int32),
                                  D ** -0.5, True, H, T, T, rate)
    before = tfp.flash_packed_fwd.launches
    o, lse = tfp.flash_packed_fwd(torch.from_numpy(qkv), H, seed=seed,
                                  rate=rate)
    assert tfp.flash_packed_fwd.launches == before   # CPU: plain version
    np.testing.assert_allclose(o.numpy(), want_o, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_packed_grad_matches_jax(rate):
    qkv = _qkv(2)
    w = np.random.default_rng(3).standard_normal((B, T, C)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    kw = dict(dropout_rate=rate, dropout_rng=key) if rate else {}

    def jloss(x):
        return jnp.sum(jfp.pallas_flash_attention_packed(x, H, **kw) * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(qkv)))
    seed = _jax_seed(key) if rate else 0
    wt = torch.from_numpy(w)
    x = torch.from_numpy(qkv).requires_grad_(True)
    (tfp.flash_packed_attention(x, H, seed=seed, rate=rate) * wt).sum() \
        .backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=2e-4, rtol=0)
    # the plain backward == autograd through the plain forward
    y = torch.from_numpy(qkv).requires_grad_(True)
    o, _ = tfp.flash_packed_fwd_ref(y, H, seed=seed, rate=rate)
    (o * wt).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=1e-5,
                               rtol=0)


def test_flash_packed_envelope_and_checks():
    assert tfp.flash_packed_envelope(256, 384, 6, 2) == (True, ())
    ok, reasons = tfp.flash_packed_envelope(32, 32, 2, 8)
    assert not ok and set(reasons) == {"head_dim", "seq_len", "dtype"}
    char = get_config("char-gpt").model
    tiny = get_config("test-tiny").model
    assert tgpt.attention_for(char, 256) is packed_qkv_attention
    assert tgpt.attention_for(tiny, 32) is tgpt.split_attention
    with pytest.raises(ValueError):
        tfp.flash_packed_fwd(torch.zeros(B, T, 3 * C + 1), H)
    with pytest.raises(ValueError):
        tfp.flash_packed_bwd(torch.zeros(B, T, 3 * C), torch.zeros(B, T, C),
                             torch.zeros(B, T, H + 1),
                             torch.zeros(B, T, H + 1), H)


def test_full_causal_attention_and_dropout():
    """The split-heads core against JAX's at dropout off; the uint8
    dropout's kept entries scale by 1/(1-q) at the quantized rate."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((B, H, 64, D)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jattn.full_causal_attention(
        *(jnp.asarray(a) for a in (q, k, v))))
    got = tattn.full_causal_attention(
        *(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert tattn.quantize_dropout_rate(0.2) == jattn.quantize_dropout_rate(
        0.2)
    x = torch.ones(256, 256)
    out = tattn.uint8_inverted_dropout(x, 0.2,
                                       torch.Generator().manual_seed(0))
    qr = tattn.quantize_dropout_rate(0.2)
    vals = sorted(out.unique().tolist())
    assert len(vals) == 2 and vals[0] == 0.0
    assert vals[1] == pytest.approx(1 / (1 - qr))
    assert abs((out == 0).float().mean().item() - qr) < 0.01


# --------------------------------------------------------------------------
# 4. the model forward
# --------------------------------------------------------------------------

def _cfgs(flavor, loss_chunk=0, dropout=0.0):
    tied, act = {"relu_untied": (False, "relu"),
                 "gelu_tied": (True, "gelu")}[flavor]
    kw = dict(vocab_size=V, block_size=T, n_layer=2, n_head=H, n_embd=C,
              dropout=dropout, attn_dropout=dropout, tied_head=tied,
              activation=act, dtype="float32", loss_chunk=loss_chunk)
    return JConfig(**kw), ModelConfig(**kw)


def _weights(jcfg, seed=3):
    tree = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for name, arr in tree["blocks"].items():
        if not name.endswith("_kernel"):   # exercise LN scales and biases
            tree["blocks"][name] = (arr + 0.1 * rng.standard_normal(
                arr.shape)).astype(np.float32)
    return tree


def _tokens(seed, batch=B):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (batch, T)).astype(np.int32),
            rng.integers(0, V, (batch, T)).astype(np.int32))


@pytest.mark.parametrize("flavor", ["relu_untied", "gelu_tied"])
def test_forward_logits_and_loss_match_jax(flavor):
    jcfg, tcfg = _cfgs(flavor)
    tree = _weights(jcfg)
    idx, tgt = _tokens(5)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jl, jloss = jgpt.forward(jp, jnp.asarray(idx), jcfg,
                             targets=jnp.asarray(tgt))
    model = tgpt.params_from_numpy(tree, tcfg, device="cpu")
    with torch.no_grad():
        tl, tloss = tgpt.forward(model.tree(), torch.from_numpy(idx), tcfg,
                                 targets=torch.from_numpy(tgt))
        _, closs = tgpt.forward(model.tree(), torch.from_numpy(idx),
                                dataclasses.replace(tcfg, loss_chunk=64),
                                targets=torch.from_numpy(tgt))
    _, jcloss = jgpt.forward(jp, jnp.asarray(idx),
                             dataclasses.replace(jcfg, loss_chunk=64),
                             targets=jnp.asarray(tgt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5)
    np.testing.assert_allclose(float(closs), float(jcloss), atol=1e-5)
    np.testing.assert_allclose(float(closs), float(tloss), atol=1e-5)


# --------------------------------------------------------------------------
# 5. the optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sched,clip", [("constant", 0.0),
                                        ("warmup", 0.5),
                                        ("cosine", 1.0)])
def test_optimizer_matches_optax(sched, clip):
    kw = dict(lr=3e-2, grad_clip=clip, max_iters=6, weight_decay=0.1)
    if sched == "warmup":
        kw.update(warmup_iters=2)
    if sched == "cosine":
        kw.update(lr_schedule="cosine", warmup_iters=1, min_lr=1e-3)
    rng = np.random.default_rng(6)
    p0 = {"a": rng.standard_normal((4, 5)).astype(np.float32),
          "b": rng.standard_normal((7,)).astype(np.float32)}
    grads = [{n: (rng.standard_normal(a.shape) * 2).astype(np.float32)
              for n, a in p0.items()} for _ in range(3)]
    opt = jstate.make_optimizer(JTrainConfig(**kw))
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    st = opt.init(jp)
    for g in grads:
        upd, st = opt.update({n: jnp.asarray(a) for n, a in g.items()}, st,
                             jp)
        jp = {n: jp[n] + upd[n] for n in jp}
    tp = {n: torch.nn.Parameter(torch.from_numpy(a.copy()))
          for n, a in p0.items()}
    topt = tstate.make_optimizer(tp.values(), TrainConfig(**kw))
    for g in grads:
        for n, p in tp.items():
            p.grad = torch.from_numpy(g[n].copy())
        topt.step()
    for n in p0:
        np.testing.assert_allclose(tp[n].detach().numpy(), np.asarray(jp[n]),
                                   atol=1e-6, rtol=1e-5)
    jsched = jstate.lr_schedule_fn(JTrainConfig(**kw))
    tsched = tstate.lr_schedule_fn(TrainConfig(**kw))
    for c in range(8):
        want = jsched(c) if callable(jsched) else jsched
        got = tsched(c) if callable(tsched) else tsched
        assert got == pytest.approx(float(want), rel=1e-6, abs=1e-9)


# --------------------------------------------------------------------------
# 6. training
# --------------------------------------------------------------------------

def test_ten_train_steps_match_jax(tiny_corpus):
    jcfg, tcfg = _cfgs("relu_untied")
    kw = dict(batch_size=B, lr=3e-3, max_iters=10, warmup_iters=2,
              lr_schedule="cosine", grad_clip=1.0, seed=0)
    tree = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(jax.random.PRNGKey(0), jcfg))
    jt = JTrainConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                              opt_state=jstate.make_optimizer(jt).init(jp),
                              rng=jax.random.PRNGKey(1))
    jstep = jsteps.make_train_step(jcfg, jt, donate=False)
    model = tgpt.params_from_numpy(tree, tcfg, device="cpu")
    tt = TrainConfig(**kw)
    ts = tstate.create_train_state(tcfg, tt, "cpu", model=model)
    tstep = tsteps.make_train_step(tcfg, tt)
    data = CharTokenizer.from_text(tiny_corpus).encode_np(tiny_corpus)
    batcher = tloader.RandomBatcher(data, B, T, seed=9)
    jl, tl = [], []
    for _ in range(10):
        x, y = batcher.next_batch()
        state, m = jstep(state, (jnp.asarray(x), jnp.asarray(y)))
        jl.append(float(m["loss"]))
        tl.append(float(tstep(ts, (torch.from_numpy(x.astype(np.uint8)),
                                   torch.from_numpy(y.astype(np.uint8))))))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert ts.step == 10 and max(jl[-3:]) < jl[0]


def test_grad_accum_equals_full_batch():
    """Two stacked microbatches of 2 rows give the 4-row batch's loss."""
    _, tcfg = _cfgs("gelu_tied")
    x, y = _tokens(10, batch=4)
    losses = []
    for accum in (1, 2):
        tt = TrainConfig(batch_size=4 // accum, grad_accum_steps=accum,
                         lr=1e-3, seed=0)
        ts = tstate.create_train_state(tcfg, tt, "cpu")
        step = tsteps.make_train_step(tcfg, tt)
        xb, yb = (torch.from_numpy(a).reshape(accum, 4 // accum, T)
                  if accum > 1 else torch.from_numpy(a) for a in (x, y))
        losses.append([float(step(ts, (xb, yb))) for _ in range(2)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


# --------------------------------------------------------------------------
# 7. data, batchers and the CLI
# --------------------------------------------------------------------------

def test_tokenizer_dataset_and_batchers_match_jax(tiny_corpus):
    jtok = JCharTokenizer.from_text(tiny_corpus)
    tok = get_tokenizer("char", corpus_text=tiny_corpus)
    assert tok.chars == jtok.chars
    np.testing.assert_array_equal(tok.encode_np(tiny_corpus),
                                  np.asarray(jtok.encode(tiny_corpus)))
    assert tok.decode(tok.encode("ROMEO:")) == "ROMEO:"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_tokenizer("tiktoken:gpt2", corpus_text=tiny_corpus)
    ds = TokenDataset.from_text(tiny_corpus, tok)
    jds = JTokenDataset.from_text(tiny_corpus, jtok)
    np.testing.assert_array_equal(ds.train, jds.train)
    np.testing.assert_array_equal(ds.val, jds.val)
    for kind in ("random", "sequential"):
        a = tloader.make_batcher(kind, ds.train, 4, 16, seed=5)
        b = jloader.make_batcher(kind, jds.train, 4, 16, seed=5)
        for _ in range(3):
            for x, y in zip(a.next_batch(), b.next_batch()):
                np.testing.assert_array_equal(x, y)


def test_prefetch_yields_every_batch_and_raises_producer_errors():
    items = [(np.full((2, 3), i, np.uint8),) for i in range(5)]
    got = [t[0][0, 0].item() for t in tloader.prefetch(iter(items), "cpu")]
    assert got == list(range(5))

    def bad():
        yield items[0]
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(tloader.prefetch(bad(), "cpu"))


def test_train_cli_on_cpu(tmp_path):
    """The port's CLI trains test-tiny on the CPU with the reference's log
    lines, the loss falls, and unported flags are refused."""
    jsonl = tmp_path / "log.jsonl"
    argv = ["train", "--preset", "test-tiny", "--device", "cpu",
            "--max-iters", "20", "--eval-interval", "10", "--eval-iters",
            "2", "--log-interval", "5", "--log-jsonl", str(jsonl)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    text = out.getvalue()
    steps = re.findall(r"^Step (\d+), Loss: (\d+\.\d{6}) \| [\d,]+ "
                       r"tok/s/chip$", text, re.M)
    evals = re.findall(r"^step (\d+) : train loss (\d+\.\d{4}), val loss = "
                       r"(\d+\.\d{4})$", text, re.M)
    assert [int(s) for s, _ in steps] == [4, 9, 14, 19]
    assert [int(e[0]) for e in evals] == [0, 10, 20]
    assert float(evals[-1][2]) < float(evals[0][2])
    assert float(steps[-1][1]) < float(steps[0][1])
    events = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [e["event"] for e in events].count("step") == 4
    with pytest.raises(SystemExit, match="ROADMAP"):
        cli.main(argv + ["--tp", "2"])
    with pytest.raises(SystemExit, match="ROADMAP"):
        cli.main(argv + ["--steps-per-dispatch", "4"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["train", "--preset", "test-tiny", "--max-iters", "1"])


def test_char_gpt_preset_matches_jax():
    from replicatinggpt_tpu.config import get_config as jget
    j, t = jget("char-gpt"), get_config("char-gpt")
    for f in dataclasses.fields(t.model):
        if hasattr(j.model, f.name):
            assert getattr(t.model, f.name) == getattr(j.model, f.name), f
    for f in dataclasses.fields(t.train):
        assert getattr(t.train, f.name) == getattr(j.train, f.name), f
    assert (t.tokenizer, t.dataset) == (j.tokenizer, j.dataset)
