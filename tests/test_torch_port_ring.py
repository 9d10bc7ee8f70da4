"""The port's sequence parallelism against the JAX package, on the CPU.

- the chunk op's plain version (``FlashChunk`` on CPU tensors) against
  ``flash_pallas._flash_chunk`` in Pallas interpret mode, with one int32
  seed on both sides so that both hash the same dropout mask: B=1, H=2,
  Tq=Tk=128, D=32, 64-row blocks, offsets fully visible (q at Tk),
  partly masked on a tile boundary (q at 64), the diagonal (0), fully
  masked (q at -Tk), a chunk starting past its first rows at no tile
  boundary (k at 32) and one Tq != Tk case; dropout 0 and 0.2; (o, lse)
  and the three gradients under a loss that feeds both o and lse, f32 at
  1e-5 (the offsets are traced on the JAX side: one interpret-mode
  compile serves each rate and shape); then bf16 at Tq=Tk=192 (three
  64-key tiles) with dropout 0.1, rows before the chunk's first key, in
  norm at 1e-3 (both round p z and ds to bf16 over 64-key tiles);
- the port's ring (``LocalSeqGroup(4)``) against the JAX ``ring_attention``
  on the conftest's virtual mesh (seq=4, einsum hops), forward and
  gradients at 1e-5, and against the port's dense plain core;
- the port's one-process ``--sp 2`` train step against the JAX sharded
  train step on a mesh of seq=2 (4 heads, ``attention_impl='ring'``), both
  from JAX's ``init_params``: the loss and every updated parameter at
  1e-4;
- the seq-only launch's train step (``ProcessDataGroup(1, 2)``, one
  ``ProcessSeqGroup`` shard a process) in 2 gloo processes against the
  one-process group (attention dropout on, so both must hash the same
  masks): loss, gradients and updated weights at 1e-5;
- the CLI: ``train --sp 2 --attention ring`` runs and logs the
  sequence-parallelism line, and the refused flags say which ROADMAP item
  brings them.

One process at one intra-op thread: ~25 s.
"""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from replicatinggpt_tpu.config import MeshConfig as JMesh
from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.config import TrainConfig as JTrainConfig
from replicatinggpt_tpu.ops import flash_pallas as jfp
from replicatinggpt_tpu.parallel import (make_batch_sharding, make_mesh,
                                         ring_attention as jring,
                                         select_attention_fn as jselect,
                                         shard_train_state)
from replicatinggpt_tpu.train import state as jstate
from replicatinggpt_tpu.train import steps as jsteps
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.config import (MeshConfig, ModelConfig,
                                             TrainConfig)
from replicatinggpt_tpu_torch.models import gpt as tgpt
from replicatinggpt_tpu_torch.ops import flash_chunk as tfc
from replicatinggpt_tpu_torch.ops.attention import NEG_INF
from replicatinggpt_tpu_torch.ops.flash_packed import attention_ref
from replicatinggpt_tpu_torch.parallel import (LocalSeqGroup,
                                               ProcessDataGroup,
                                               ProcessSeqGroup,
                                               make_ring_attention_fn,
                                               ring_attention,
                                               select_attention_fn)
from replicatinggpt_tpu_torch.parallel import distributed as tdist
from replicatinggpt_tpu_torch.train import state as tstate
from replicatinggpt_tpu_torch.train import steps as tsteps

TOL = 1e-5
# bf16 chunk twin against JAX, as ||x - ref|| / ||ref|| (read at most
# 2.1e-4: o 6.9e-5, dq 1.7e-4, dk 2.1e-4)
BF16_REL_JAX = 1e-3
D, BLOCK = 32, 64
# id: (Tq, Tk, q_offset, k_offset)
CHUNKS = {
    "visible": (128, 128, 128, 0),
    "aligned": (128, 128, 64, 0),
    "diagonal": (128, 128, 0, 0),
    "masked": (128, 128, -128, 0),
    "unaligned": (128, 128, 0, 32),
    "tq_ne_tk": (64, 128, 96, 0),
}
SEED = 123_457


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small eager ops run much faster on one intra-op thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_weights(o, lse):
    """A loss that feeds both outputs: sum(o w) + sum(lse' wl), lse' the
    rows with a visible key."""
    rng = np.random.default_rng(5)
    return (rng.standard_normal(o.shape).astype(np.float32),
            rng.standard_normal(lse.shape).astype(np.float32))


@functools.partial(jax.jit, static_argnames=("rate",))
def _jax_chunk(q, k, v, w, wl, offs, rate):
    def loss(q, k, v):
        o, lse = jfp._flash_chunk(q, k, v, jnp.array([SEED], jnp.int32),
                                  offs, D ** -0.5, True, BLOCK, BLOCK, rate)
        seen = jnp.where(lse > NEG_INF / 2, lse, 0.0)
        return jnp.sum(o * w) + jnp.sum(seen * wl), (o, lse)

    (_, (o, lse)), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    return o, lse, g


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("case", list(CHUNKS))
def test_chunk_plain_matches_pallas_flash_chunk(case, rate):
    Tq, Tk, q_off, k_off = CHUNKS[case]
    rng = np.random.default_rng(Tq + Tk + q_off)
    q = rng.standard_normal((1, 2, Tq, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, Tk, D)).astype(np.float32)
            for _ in range(2))
    w, wl = _loss_weights(q, q[..., 0])
    want_o, want_lse, want_g = _jax_chunk(
        *(jnp.asarray(a) for a in (q, k, v, w, wl)),
        jnp.array([q_off, k_off, 0], jnp.int32), rate=rate)
    x = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = (tfc.flash_chunk_fwd.launches, tfc.flash_chunk_bwd.launches)
    o, lse = tfc.flash_chunk(*x, q_offset=q_off, k_offset=k_off, seed=SEED,
                             rate=rate)
    seen = torch.where(lse > NEG_INF / 2, lse, torch.zeros_like(lse))
    ((o * torch.from_numpy(w)).sum()
     + (seen * torch.from_numpy(wl)).sum()).backward()
    assert (tfc.flash_chunk_fwd.launches,
            tfc.flash_chunk_bwd.launches) == before    # CPU: plain versions
    want_o, want_lse = np.asarray(want_o), np.asarray(want_lse)
    got_o, got_lse = o.detach().numpy(), lse.detach().numpy()
    np.testing.assert_allclose(got_lse, want_lse, atol=TOL, rtol=TOL)
    blind = ~(np.arange(Tq) + q_off >= k_off)        # rows with no key
    np.testing.assert_array_equal(got_lse[..., blind], np.float32(NEG_INF))
    # the JAX kernel leaves a blind row of a walked tile at the tile's
    # value mean (weight exp(NEG_INF) = 0 in any merge); the port writes 0
    np.testing.assert_array_equal(got_o[..., blind, :], 0.0)
    np.testing.assert_allclose(got_o[..., ~blind, :],
                               want_o[..., ~blind, :], atol=TOL, rtol=TOL)
    if case == "masked":
        assert blind.all() and not np.asarray(want_o).any()
    for t, want in zip(x, want_g):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)
    if case == "masked":
        assert not any(t.grad.any() for t in x)


def test_chunk_plain_rounds_as_pallas_flash_chunk_in_bf16():
    """bf16 q, k, v: the plain versions round p z before P V and ds
    before dQ, dK where the JAX chunk kernel rounds them, over the same
    64-key tiles, so o on the rows that see a key and the gradients agree
    with it up to f32 summation order, in norm at ``BF16_REL_JAX``; lse
    (f32 on both sides) at ``TOL``."""
    Tq = Tk = 192
    q_off, k_off = 0, 32          # rows 0-31 see no key of this chunk
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, 2, T, D)).astype(np.float32)
               for T in (Tq, Tk, Tk))
    w, wl = _loss_weights(q, q[..., 0])
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, w)]
    want_o, want_lse, want_g = _jax_chunk(
        *bf, jnp.asarray(wl), jnp.array([q_off, k_off, 0], jnp.int32),
        rate=0.1)
    x = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
         for a in (q, k, v)]
    o, lse = tfc.flash_chunk(*x, q_offset=q_off, k_offset=k_off, seed=SEED,
                             rate=0.1)
    seen = torch.where(lse > NEG_INF / 2, lse, torch.zeros_like(lse))
    ((o * torch.from_numpy(w).to(torch.bfloat16)).sum()
     + (seen * torch.from_numpy(wl)).sum()).backward()
    rows = np.arange(Tq) + q_off >= k_off
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)
    pairs = [(o.detach().float().numpy()[..., rows, :],
              np.asarray(want_o, np.float32)[..., rows, :])]
    pairs += [(t.grad.float().numpy(), np.asarray(g, np.float32))
              for t, g in zip(x, want_g)]
    for got, want in pairs:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_REL_JAX, err


def test_chunk_at_offset_zero_is_the_heads_function():
    """At offsets 0 and Tq = Tk the chunk op is the (B, H, T, D) flash
    function, dropout mask included."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 64, D))
                                .astype(np.float32)) for _ in range(3))
    o, lse = tfc.flash_chunk(q, k, v, seed=SEED, rate=0.2)
    ro, rlse = attention_ref(q, k, v, causal=True, scale=D ** -0.5,
                             seed=SEED, rate=0.2)
    torch.testing.assert_close(o, ro, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, rlse, atol=1e-6, rtol=1e-6)


def test_ring_matches_jax_ring_and_dense():
    B, H, T = 1, 2, 256
    rng = np.random.default_rng(11)
    q, k, v, w = (rng.standard_normal((B, H, T, D)).astype(np.float32)
                  for _ in range(4))
    mesh = make_mesh(JMesh(seq=4))

    def jloss(q, k, v):
        o = jring(q, k, v, mesh=mesh, hop_impl="einsum")
        return jnp.sum(o * w), o

    (_, want_o), want_g = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    group = LocalSeqGroup(4)
    x = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = tfc.flash_chunk_fwd.launches
    o = ring_attention(*x, group=group)
    (o * torch.from_numpy(w)).sum().backward()
    assert tfc.flash_chunk_fwd.launches == before     # CPU: plain versions
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                               atol=TOL, rtol=TOL)
    for t, want in zip(x, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)
    # the dense plain core on the whole sequence
    y = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    dense, _ = attention_ref(*y, causal=True, scale=D ** -0.5)
    (dense * torch.from_numpy(w)).sum().backward()
    torch.testing.assert_close(o, dense, atol=TOL, rtol=TOL)
    for a, b in zip(x, y):
        torch.testing.assert_close(a.grad, b.grad, atol=TOL, rtol=TOL)


def _ring_cfg(**kw):
    base = dict(vocab_size=64, block_size=32, n_layer=2, n_head=4, n_embd=64,
                dropout=0.0, attn_dropout=0.0, dtype="float32",
                attention_impl="ring")
    base.update(kw)
    return base


def test_sp2_train_step_matches_jax_sharded_step():
    kw = _ring_cfg()
    jcfg, tcfg = JConfig(**kw), ModelConfig(**kw)
    tk = dict(batch_size=4, lr=1e-3)
    jt, tt = JTrainConfig(**tk), TrainConfig(**tk)
    mesh_cfg = JMesh(seq=2)
    mesh = make_mesh(mesh_cfg)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, (4, 32), dtype=np.int32)
    y = np.roll(x, -1, axis=1).astype(np.int32)
    state = shard_train_state(
        lambda: jstate.create_train_state(jax.random.PRNGKey(0), jcfg, jt),
        mesh, mesh_cfg)
    tree = jax.tree_util.tree_map(np.asarray, state.params)
    bs = make_batch_sharding(mesh)
    jfn = jselect(jcfg, mesh_cfg, mesh)
    assert jfn.impl_name == "ring"
    jstep = jsteps.make_train_step(jcfg, jt, donate=False, attention_fn=jfn)
    new_state, m = jstep(state, (jax.device_put(x, bs),
                                 jax.device_put(y, bs)))
    group = LocalSeqGroup(2)
    tfn = select_attention_fn(tcfg, MeshConfig(seq=2), group)
    assert tfn.impl_name == "ring"
    ts = tstate.create_train_state(
        tcfg, tt, "cpu", model=tgpt.params_from_numpy(tree, tcfg))
    loss = tsteps.make_train_step(tcfg, tt, tfn, group)(
        ts, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(loss), float(m["loss"]), rtol=1e-4)
    want = jax.tree_util.tree_map(np.asarray, new_state.params)
    got = ts.model.tree()
    for name, t in got["blocks"].items():
        np.testing.assert_allclose(t.detach().numpy(), want["blocks"][name],
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    for name in ("wte", "wpe", "ln_f_scale", "ln_f_bias"):
        np.testing.assert_allclose(got[name].detach().numpy(), want[name],
                                   atol=1e-4, rtol=1e-4, err_msg=name)


GROUP_KW = dict(vocab_size=65, block_size=128, n_layer=2, n_head=2,
                n_embd=64, dropout=0.0, attn_dropout=0.1, dtype="float32",
                attention_impl="ring")


def _group_step(group, seed: int = 0):
    """One train step of the GROUP_KW model through ``group``'s ring (a
    ``LocalSeqGroup``, or a launch's ``ProcessDataGroup`` of one data
    shard): (loss, {name: gradient}, {name: updated weight})."""
    torch.set_num_threads(1)
    mcfg, tcfg = ModelConfig(**GROUP_KW), TrainConfig(batch_size=2, lr=1e-3,
                                                      seed=seed)
    ring = group.seq if isinstance(group, ProcessDataGroup) else group
    state = tstate.create_train_state(mcfg, tcfg, "cpu", stream=ring.rank)
    group.broadcast_(list(state.model.parameters()))
    fn = make_ring_attention_fn(ring, dropout_rate=mcfg.attn_dropout)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 65, (2, 128)))
    loss = tsteps.make_train_step(mcfg, tcfg, fn, group)(
        state, (x, torch.roll(x, -1, 1)))
    named = list(state.model.named_parameters())
    return (float(loss), {n: p.grad.clone() for n, p in named},
            {n: p.detach().clone() for n, p in named})


def _group_worker(rank: int, world: int, init: str, out: str) -> None:
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        torch.save(_group_step(ProcessDataGroup(1, 2)), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def test_process_group_step_matches_one_process(tmp_path):
    """2 gloo processes, one shard each: the K/V exchange and its
    autograd, the position offsets, the batch columns, the gradient
    average and the rank-independent attention masks."""
    ctx = mp.get_context("spawn")
    out = str(tmp_path / "result")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_group_worker, args=(r, 2, init, out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    want_loss, want_g, want_w = _group_step(LocalSeqGroup(2))
    for r in range(2):
        loss, grads, weights = torch.load(f"{out}.{r}")
        np.testing.assert_allclose(loss, want_loss, rtol=TOL)
        for name in want_g:
            torch.testing.assert_close(grads[name], want_g[name], atol=TOL,
                                       rtol=TOL, msg=name)
            torch.testing.assert_close(weights[name], want_w[name],
                                       atol=TOL, rtol=TOL, msg=name)


def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["train", "--preset", "test-tiny", "--device", "cpu",
                         *argv]) == 0
    return out.getvalue()


def test_train_sp_cli_on_cpu():
    text = _cli("--sp", "2", "--attention", "ring", "--max-iters", "2",
                "--eval-iters", "1", "--log-interval", "1")
    assert ("sequence parallelism: seq axis 2, impl 'ring' (configured "
            "'ring'), one process holding all 2 shards") in text
    assert "attention: ring attention over 2 sequence shards" in text
    assert "Step 1, Loss:" in text


@pytest.mark.parametrize("argv,exc", [
    (["--attention", "ulysses"], SystemExit),
    (["--sp", "2"], NotImplementedError),          # 'auto', 2 heads: Ulysses
    (["--sp", "2", "--attention", "einsum"], NotImplementedError),
    (["--dp", "2", "--tp", "2"], SystemExit), (["--tp", "2"], SystemExit),
    (["--pp", "2"], SystemExit), (["--fsdp", "--pp", "2"], SystemExit),
    (["--microbatches", "4"], SystemExit)])
def test_train_refuses_what_is_not_ported(argv, exc):
    with pytest.raises(exc, match="queue A item 11"):
        _cli(*argv, "--max-iters", "1")


def test_launch_must_match_sp(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="2 processes for data 1 x seq 4"):
        tdist.setup(1, 4, "cpu")
    assert not dist.is_initialized()
    monkeypatch.delenv("WORLD_SIZE")
    dev, group = tdist.setup(1, 4, "cpu")
    assert dev.type == "cpu" and isinstance(group.seq, LocalSeqGroup)
    assert tdist.local_seq_slice(64) == slice(0, 64)
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        MeshConfig(model=2).validate()


def test_group_refuses_tensors_its_backend_cannot_move():
    group = ProcessSeqGroup.__new__(ProcessSeqGroup)
    group.backend = "nccl"
    with pytest.raises(ValueError, match="NCCL"):
        group.check(torch.zeros(1))
    group.backend = "gloo"
    group.check(torch.zeros(1))
