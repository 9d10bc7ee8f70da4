"""The PyTorch port's attention and sampling ops against the JAX package
(``replicatinggpt_tpu_torch`` vs ``replicatinggpt_tpu``), on the CPU.

Inputs are made from a seed with numpy and handed to both sides. The
JAX paged kernel runs in Pallas interpret mode off-TPU, as its own tests
run it. The CUDA kernel itself is checked against its plain version by
the ``cuda``-marked tests of test_torch_port_cuda.py (skipped without a
card) and by ``chip_smoke.py`` on the card.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.ops import attention as jattn
from replicatinggpt_tpu.ops import paged_pallas as jpp
from replicatinggpt_tpu_torch.ops import attention as tattn
from replicatinggpt_tpu_torch.ops import paged_attention as tpa
from replicatinggpt_tpu_torch.sample import generate as tgen

# the JAX package's sample/__init__ re-exports a function named generate
jgen = importlib.import_module("replicatinggpt_tpu.sample.generate")

H, PSZ, MP, N, C = 2, 8, 4, 24, 64


def _paged_inputs(W, seed=0):
    """Slots at pos 0 (fresh rows only), a page edge, mid-page and a
    frontier inside the last page; table entries past each slot's live
    frontier hold stale ids (one row an id past the pool)."""
    rng = np.random.default_rng(seed)
    pos = np.array([0, 8, 13, 16, 29], np.int32)
    B = pos.size
    tables = rng.permutation(N)[: B * MP].reshape(B, MP).astype(np.int32)
    tables[2, 2:] = 0                       # unmapped entries hold 0
    tables[0, :] = N + 3                    # pos 0: nothing is live
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (mk(B, W, C), mk(B, W, C), mk(B, W, C), mk(N, PSZ, C),
            mk(N, PSZ, C), tables, pos)


@pytest.mark.parametrize("W", [1, 4])
def test_paged_attention_ref_matches_jax_kernel(W):
    """(a) the plain paged attention against JAX paged_window_attention
    (interpret mode), f32, atol 2e-5; the CPU wrapper is the plain
    version and counts no launch."""
    args = _paged_inputs(W)
    want = np.asarray(jpp.paged_window_attention(
        *(jnp.asarray(a) for a in args), n_head=H))
    t = [torch.from_numpy(a) for a in args]
    got = tpa.paged_window_attention_ref(*t, n_head=H).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    before = tpa.paged_window_attention.launches
    via = tpa.paged_window_attention(*t, n_head=H).numpy()
    np.testing.assert_array_equal(via, got)
    assert tpa.paged_window_attention.launches == before


def test_paged_attention_wrapper_checks_and_envelope():
    q, kn, vn, kp, vp, tables, pos = (torch.from_numpy(a)
                                      for a in _paged_inputs(1))
    with pytest.raises(ValueError):
        tpa.paged_window_attention(q, kn[:, :, :32], vn, kp, vp, tables,
                                   pos, n_head=H)
    with pytest.raises(ValueError):
        tpa.paged_window_attention(q, kn, vn, kp, vp, tables[:2], pos,
                                   n_head=H)
    ok, reasons = tpa.paged_attention_envelope(12, 64, 16, itemsize=2,
                                               window=1, max_pages=64)
    assert ok and reasons == ()
    ok, reasons = tpa.paged_attention_envelope(4, 60, 16, itemsize=1,
                                               window=4096, max_pages=64)
    assert not ok and set(reasons) == {"dtype", "head_dim", "smem_budget"}


def test_attention_cores_match_jax():
    rng = np.random.default_rng(1)
    B, Hh, S, D, W = 3, 2, 24, 16, 4
    q1 = rng.standard_normal((B, Hh, 1, D)).astype(np.float32)
    qw = rng.standard_normal((B, Hh, W, D)).astype(np.float32)
    k = rng.standard_normal((B, Hh, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hh, S, D)).astype(np.float32)
    idx = np.array([0, 7, 23], np.int32)
    base = np.array([0, 5, 20], np.int32)
    want = np.asarray(jattn.cached_attention(
        jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx)))
    got = tattn.cached_attention(*(torch.from_numpy(a)
                                   for a in (q1, k, v, idx))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    want = np.asarray(jattn.windowed_cached_attention(
        jnp.asarray(qw), jnp.asarray(k), jnp.asarray(v), jnp.asarray(base)))
    got = tattn.windowed_cached_attention(
        *(torch.from_numpy(a) for a in (qw, k, v, base))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def _filter_inputs():
    """Rows: top-k only, top-p only, both, all off (k >= V, p >= 1), a
    row of tied logits under top-k and top-p, greedy-style defaults."""
    rng = np.random.default_rng(2)
    V = 300
    logits = (rng.standard_normal((6, V)) * 2).astype(np.float32)
    logits[4, :] = np.round(logits[4, :])   # many exact ties
    logits[4, 10:20] = 3.0                  # a tie run at the top
    temp = np.array([1.0, 0.7, 1.3, 1.0, 1.0, 1.0], np.float32)
    top_k = np.array([5, 0, 40, V, 12, 0], np.int32)
    top_p = np.array([0.0, 0.6, 0.9, 1.0, 0.5, 0.0], np.float32)
    return logits, temp, top_k, top_p


def test_filter_logits_batched_matches_jax():
    """(c) the per-row filter pipeline: identical kept sets (ties at the
    k-th value kept; top-p ties ranked by descending index, as JAX) and
    equal kept values."""
    args = _filter_inputs()
    want = np.asarray(jgen.filter_logits_batched(
        *(jnp.asarray(a) for a in args)))
    got = tgen.filter_logits_batched(
        *(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)
    # the off-switch rows pass through untouched
    np.testing.assert_array_equal(got[3], args[0][3])
    # the tie row keeps a strict subset that JAX keeps too
    assert 0 < np.isfinite(got[4]).sum() < got.shape[1]


def test_top_p_tie_order_matches_jax():
    """A fully tied row under top-p: the nucleus is a prefix of JAX's
    order (descending index), not torch's descending sort order."""
    logits = np.zeros((1, 8), np.float32)
    p = np.array([0.3], np.float32)
    want = np.asarray(jgen.batched_top_p_filter(jnp.asarray(logits),
                                                jnp.asarray(p)))
    got = tgen.batched_top_p_filter(torch.from_numpy(logits),
                                    torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got[0]).tolist() == [False] * 5 + [True] * 3


def test_sample_tokens_batched_greedy_and_kept_set():
    logits, temp, top_k, top_p = _filter_inputs()
    greedy = np.array([True, False, False, True, False, False])
    gens = [None if g else torch.Generator().manual_seed(i)
            for i, g in enumerate(greedy)]
    gens[5] = None                          # an idle slot
    t = [torch.from_numpy(a) for a in (logits, temp, top_k, top_p, greedy)]
    want = np.asarray(jgen.filter_logits_batched(
        *(jnp.asarray(a) for a in (logits, temp, top_k, top_p))))
    for _ in range(5):
        toks = tgen.sample_tokens_batched(gens, *t).numpy()
        for b in range(6):
            if greedy[b]:
                assert toks[b] == int(np.argmax(logits[b]))
            elif gens[b] is None:
                assert toks[b] == 0
            else:
                assert np.isfinite(want[b, toks[b]])
