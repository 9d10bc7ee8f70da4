"""The port's paged model steps against the JAX package's, on the CPU.

A 2-layer, C=64, H=2, page-8 f32 model: the JAX ``init_params`` tree is
carried across with ``params_from_numpy``; pools start from the same
random contents on both sides. ``decode_step_paged`` is compared on the
kernel route (JAX: the Pallas kernel in interpret mode; port: the
wrapper's plain version on CPU tensors) and on the gather route.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.config import ModelConfig as JConfig
from replicatinggpt_tpu.models import gpt as jgpt
from replicatinggpt_tpu_torch.config import ModelConfig
from replicatinggpt_tpu_torch.models import gpt as tgpt

JCFG = JConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2, n_embd=64,
               dropout=0.0, attn_dropout=0.0, dtype="float32",
               decode_cache_layout="packed", tied_head=False,
               activation="gelu")
TCFG = ModelConfig(vocab_size=65, block_size=32, n_layer=2, n_head=2,
                   n_embd=64, tied_head=False, activation="gelu",
                   dtype="float32", decode_cache_layout="packed")
PSZ, MP, N = 8, 4, 20


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(jax.random.PRNGKey(3), JCFG))
    # non-trivial layernorm/bias values, so their casts are exercised
    rng = np.random.default_rng(3)
    for name, arr in tree["blocks"].items():
        if not name.endswith("_kernel"):
            tree["blocks"][name] = (arr + 0.1 * rng.standard_normal(
                arr.shape)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = tgpt.params_from_numpy(tree, TCFG, device="cpu")
    return jparams, tgpt.compute_params(model, "cpu")


def _cfgs(layout):
    return (dataclasses.replace(JCFG, decode_cache_layout=layout),
            dataclasses.replace(TCFG, decode_cache_layout=layout))


def _pools(layout, seed=0):
    jcfg, tcfg = _cfgs(layout)
    shape = tuple(jgpt.init_paged_kv_pool(jcfg, N, PSZ)["k"].shape)
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


def _assert_pools(tpool, jpool):
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy(),
                                   np.asarray(jpool[name]), atol=1e-5,
                                   rtol=0)


def test_params_from_numpy_roundtrip(weights):
    jparams, tparams = weights
    np.testing.assert_array_equal(tparams["lm_head"].numpy(),
                                  np.asarray(jparams["lm_head"]))
    np.testing.assert_array_equal(
        tparams["blocks"]["qkv_kernel"].numpy(),
        np.asarray(jparams["blocks"]["qkv_kernel"]))
    with pytest.raises(ValueError):
        bad = jax.tree_util.tree_map(np.asarray, jparams)
        bad["wte"] = bad["wte"][:, :32]
        tgpt.params_from_numpy(bad, TCFG, device="cpu")


@pytest.mark.parametrize("layout,use_kernel", [
    ("packed", True), ("packed", False), ("heads", False)])
def test_decode_step_paged_matches_jax(weights, layout, use_kernel):
    """(b) one multi-slot decode step: an active slot at a page edge, one
    mid-page, one at position 0, and an inactive slot whose write must be
    dropped; logits within 1e-4 and the pools equal."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs(layout)
    jpool, tpool = _pools(layout)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, 65, (4,)).astype(np.int32)
    pos = np.array([8, 13, 0, 21], np.int32)
    active = np.array([True, True, True, False])
    tables = rng.permutation(N)[:16].reshape(4, MP).astype(np.int32)
    tables[1, 2:] = 0                          # unmapped past the frontier
    jl, jpool = jgpt.decode_step_paged(
        jparams, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(active),
        jnp.asarray(tables), jpool, jcfg, use_pallas=use_kernel)
    tl, tpool = tgpt.decode_step_paged(
        tparams, torch.from_numpy(tok), torch.from_numpy(pos),
        torch.from_numpy(active), torch.from_numpy(tables), tpool, tcfg,
        use_kernel=use_kernel)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    _assert_pools(tpool, jpool)


@pytest.mark.parametrize("layout", ["packed", "heads"])
def test_prefill_chunk_paged_matches_jax(weights, layout):
    """(b) a padded final chunk past a prefix hit: writes in [offset,
    limit) only, queries attend the earlier chunks through the table."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs(layout)
    jpool, tpool = _pools(layout, seed=2)
    rng = np.random.default_rng(2)
    chunk = rng.integers(0, 65, (1, 8)).astype(np.int32)
    table_row = np.array([5, 2, 9, 0], np.int32)
    offset, limit = 11, 16                     # 5 real tokens, 3 padding
    jpool = jgpt.prefill_chunk_paged(
        jparams, jnp.asarray(chunk), jnp.int32(offset), jnp.int32(limit),
        jnp.asarray(table_row), jpool, jcfg)
    tpool = tgpt.prefill_chunk_paged(
        tparams, torch.from_numpy(chunk), offset, limit,
        torch.from_numpy(table_row), tpool, tcfg)
    _assert_pools(tpool, jpool)


def test_decode_position_out_of_bounds_raises(weights):
    _, tparams = weights
    _, tpool = _pools("packed")
    tables = np.zeros((1, MP), np.int32)
    with pytest.raises(IndexError):
        tgpt.decode_step_paged(
            tparams, torch.zeros(1, dtype=torch.int32),
            torch.tensor([MP * PSZ], dtype=torch.int32),
            torch.tensor([True]), torch.from_numpy(tables), tpool, TCFG)
