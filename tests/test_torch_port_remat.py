"""Remat and the GPT-2 ladder of the port, against itself and the JAX
package, on the CPU.

- remat ``full`` and ``dots`` against no remat at f32 with dropout 0.2,
  on the packed route and on the split-heads kernel route: the loss and
  every gradient are identical (each block's dropout streams are seeded
  before the block runs, so a recompute draws the forward's masks);
- the forward and one AdamW step with remat on, against JAX ``forward``
  and ``make_train_step`` with ``remat=True``, on an odd-headed 2-layer
  config (C=160, H=5, D=32: no head group, so the split-heads kernel
  route), at 1e-4 relative;
- the four presets this slice adds (``gpt2-medium``, ``gpt2-large``,
  ``gpt2-xl``, ``char-gpt1-ref``) field by field against the JAX ones,
  the route each preset takes at its ``block_size`` against the JAX
  package's head-layout test, the ``--remat`` / ``--no-remat`` /
  ``--remat-policy`` overlay, and ``train --preset gpt2-xl`` through the
  CLI at a tiny width.
"""

import argparse
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.config import TrainConfig as JTrainConfig
from replicatinggpt_tpu.config import get_config as jget
from replicatinggpt_tpu.models import gpt as jgpt
from replicatinggpt_tpu.ops import flash_pallas as jfp
from replicatinggpt_tpu.train import state as jstate
from replicatinggpt_tpu.train import steps as jsteps
from replicatinggpt_tpu_torch import cli
from replicatinggpt_tpu_torch.config import (PRESETS, ModelConfig,
                                             TrainConfig, add_config_flags,
                                             add_train_flags,
                                             config_from_args, get_config)
from replicatinggpt_tpu_torch.models import gpt as tgpt
from replicatinggpt_tpu_torch.ops import attention as tattn
from replicatinggpt_tpu_torch.ops.flash_attention import describe_route
from replicatinggpt_tpu_torch.ops.flash_heads import flash_heads_fwd
from replicatinggpt_tpu_torch.train import state as tstate
from replicatinggpt_tpu_torch.train import steps as tsteps

NEW_PRESETS = ["gpt2-medium", "gpt2-large", "gpt2-xl", "char-gpt1-ref"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small eager ops run much faster on one intra-op thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_and_grads(mcfg, idx, tgt, seed=3):
    model = tgpt.init_params(mcfg, torch.Generator().manual_seed(0))
    rng = tattn.DropoutRNG(seed)
    _, loss = tgpt.forward(model.tree(), idx, mcfg, targets=tgt, rng=rng,
                           train=True)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


# (n_head, n_embd): the packed route (4 heads of D=32 form a group) and
# the split-heads kernel route (3 heads of D=32 do not)
ROUTES = {"packed": (4, 128), "split_heads": (3, 96)}


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_remat_gives_the_loss_and_gradients_of_no_remat(route, policy):
    H, C = ROUTES[route]
    mcfg = ModelConfig(vocab_size=65, block_size=64, n_layer=2, n_head=H,
                       n_embd=C, dropout=0.2, attn_dropout=0.2,
                       dtype="float32")
    want_fn = (tgpt.packed_qkv_attention if route == "packed"
               else tgpt.split_attention)
    assert tgpt.attention_for(mcfg, 64) is want_fn
    rng = np.random.default_rng(2)
    idx, tgt = (torch.from_numpy(rng.integers(0, 65, (2, 64))) for _ in "ab")
    loss0, grads0 = _loss_and_grads(mcfg, idx, tgt)
    loss1, grads1 = _loss_and_grads(
        dataclasses.replace(mcfg, remat=True, remat_policy=policy), idx, tgt)
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys()
    for name in grads0:
        assert torch.equal(grads0[name], grads1[name]), name
    # another seed draws other masks: the streams do reach every block
    assert not torch.equal(_loss_and_grads(mcfg, idx, tgt, seed=4)[0], loss0)


def test_remat_forward_and_adamw_step_match_jax():
    """Odd-headed (C=160, H=5) 2-layer f32 model, remat on, on the
    split-heads kernel route (its plain version here): the forward's
    logits and loss, and two steps of AdamW (the second's loss after the
    first's update) against JAX with ``remat=True``."""
    kw = dict(vocab_size=65, block_size=128, n_layer=2, n_head=5,
              n_embd=160, dropout=0.0, attn_dropout=0.0, tied_head=True,
              activation="gelu", dtype="float32", remat=True)
    jcfg, tcfg = JConfig(**kw), ModelConfig(**kw)
    assert tgpt.attention_for(tcfg, 128) is tgpt.split_attention
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jgpt.init_params(k, jcfg))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(8)
    batches = [tuple(rng.integers(0, 65, (2, 128)).astype(np.int32)
                     for _ in "xy") for _ in range(2)]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jlogits, _ = jax.jit(lambda p, x: jgpt.forward(p, x, jcfg))(
        jp, jnp.asarray(batches[0][0]))
    tk = dict(batch_size=2, lr=1e-3, max_iters=2, seed=0)
    jt = JTrainConfig(**tk)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                              opt_state=jstate.make_optimizer(jt).init(jp),
                              rng=jax.random.PRNGKey(1))
    jstep = jsteps.make_train_step(jcfg, jt, donate=False)
    tt = TrainConfig(**tk)
    ts = tstate.create_train_state(
        tcfg, tt, "cpu", model=tgpt.params_from_numpy(tree, tcfg))
    tstep = tsteps.make_train_step(tcfg, tt)
    with torch.no_grad():
        tlogits, _ = tgpt.forward(ts.model.tree(),
                                  torch.from_numpy(batches[0][0]), tcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-4)
    before = flash_heads_fwd.launches
    jl, tl = [], []
    for x, y in batches:
        state, m = jstep(state, (jnp.asarray(x), jnp.asarray(y)))
        jl.append(float(m["loss"]))
        tl.append(float(tstep(ts, tuple(torch.from_numpy(a)
                                        for a in (x, y)))))
    assert flash_heads_fwd.launches == before     # CPU: plain version
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)


@pytest.mark.parametrize("preset", NEW_PRESETS)
def test_ladder_presets_match_jax(preset):
    j, t = jget(preset), get_config(preset)
    for f in dataclasses.fields(t.model):
        assert getattr(t.model, f.name) == getattr(j.model, f.name), f
    for f in dataclasses.fields(t.train):
        assert getattr(t.train, f.name) == getattr(j.train, f.name), f
    assert (t.tokenizer, t.dataset) == (j.tokenizer, j.dataset)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_route_of_each_preset_at_its_block_size(preset):
    """Packed where the JAX package's packed families can lay out the
    heads (``_group_geometry``), the split-heads kernel where D is a
    kernel width but the heads form no group, the plain core elsewhere."""
    m = get_config(preset).model
    route = describe_route(m, m.block_size)
    if jfp._group_geometry(m.n_embd, m.n_head) is not None:
        assert route.startswith("packed flash attention")
    elif m.head_dim in (32, 64, 128, 256):
        assert route.startswith("split-heads flash attention")
    else:
        assert route.startswith("split-heads attention, plain core")
    want = {"gpt2-xl": "split-heads flash", "char-gpt1-ref": "split-heads "
            "attention, plain", "test-tiny": "split-heads attention, plain"}
    assert route.startswith(want.get(preset, "packed flash"))


def test_remat_cli_overlay():
    p = argparse.ArgumentParser()
    add_config_flags(p)
    add_train_flags(p)
    assert config_from_args(p.parse_args(
        ["--preset", "gpt2-xl"])).model.remat
    off = config_from_args(p.parse_args(["--preset", "gpt2-xl",
                                         "--no-remat"])).model
    on = config_from_args(p.parse_args(["--preset", "char-gpt", "--remat",
                                        "--remat-policy", "dots"])).model
    assert not off.remat and on.remat and on.remat_policy == "dots"
    with pytest.raises(ValueError, match="remat_policy"):
        dataclasses.replace(on, remat_policy="some").validate()


def test_train_gpt2_xl_cli_on_cpu():
    """``train --preset gpt2-xl`` at a tiny width (25 heads of D=32, one
    layer, T=64, the char tokenizer) logs the split-heads kernel route
    and remat, and trains."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["train", "--preset", "gpt2-xl", "--device", "cpu",
                         "--tokenizer", "char", "--vocab-size", "65",
                         "--n-layer", "1", "--n-embd", "800",
                         "--block-size", "64", "--batch-size", "2",
                         "--max-iters", "2", "--eval-iters", "1",
                         "--log-interval", "1"]) == 0
    text = out.getvalue()
    assert "attention: split-heads flash attention" in text
    assert "remat=full" in text and "Step 1, Loss:" in text
