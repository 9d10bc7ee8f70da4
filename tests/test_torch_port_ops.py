"""The PyTorch port's attention and sampling ops against the JAX package
(``replicatinggpt_tpu_torch`` vs ``replicatinggpt_tpu``), on the CPU.

Inputs are made from a seed with numpy and handed to both sides. The
JAX paged kernel runs in Pallas interpret mode off-TPU, as its own tests
run it. The CUDA kernel itself is checked against its plain version by
the ``cuda``-marked tests of test_torch_port_cuda.py (skipped without a
card) and by ``chip_smoke.py`` on the card.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replicatinggpt_tpu.ops import attention as jattn
from replicatinggpt_tpu.ops import paged_pallas as jpp
from replicatinggpt_tpu_torch.ops import attention as tattn
from replicatinggpt_tpu_torch.ops import paged_attention as tpa
from replicatinggpt_tpu_torch.ops.paged_attention import NEG_INF
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


def _split_merge_twin(q, k_new, v_new, k_pages, v_pages, tables, pos, *,
                      n_head, ranks, tile, k_scales=None, v_scales=None):
    """csrc/paged_window_attention.cu's algebra in plain torch: each
    slot's live history in tiles of ``tile`` rows, dealt round-robin to
    ``ranks`` ranks (tile t to rank t % ranks); an online softmax per rank
    over its tiles; the ranks merged by logsumexp in rank order (a rank
    with no tile holds m = -1e30, l = 0); then the fresh (W, W) block,
    row j <= w, in order."""
    B, W, C = q.shape
    N, psz, _ = k_pages.shape
    mp = tables.shape[1]
    H, D = n_head, C // n_head
    scale = D ** -0.5
    out = torch.empty(B, W, C)

    def history(pages, scales, prow):
        rows = pages.reshape(N * psz, C)[prow].float().reshape(-1, H, D)
        if scales is None:
            return rows
        sc = scales.reshape(N * psz, -1)[prow]          # (n, 1) or (n, H)
        return rows * sc[..., None]

    for b in range(B):
        p = int(pos[b])
        live = min(-(-p // psz), mp)
        n_hist = min(p, live * psz)
        g = torch.arange(n_hist)
        prow = tables[b, g // psz].long() * psz + g % psz
        kh = history(k_pages, k_scales, prow)
        vh = history(v_pages, v_scales, prow)
        qh = q[b].float().reshape(W, H, D)
        n_tiles = -(-n_hist // tile)
        states = []
        for r in range(ranks):
            m = torch.full((W, H), NEG_INF)
            l_ = torch.zeros(W, H)
            acc = torch.zeros(W, H, D)
            for t in range(r, n_tiles, ranks):
                sl = slice(t * tile, min(n_hist, (t + 1) * tile))
                s = torch.einsum("whd,thd->wht", qh, kh[sl]) * scale
                mn = torch.maximum(m, s.amax(-1))
                a = torch.exp(m - mn)
                e = torch.exp(s - mn[..., None])
                l_ = l_ * a + e.sum(-1)
                acc = acc * a[..., None] + torch.einsum("wht,thd->whd", e,
                                                        vh[sl])
                m = mn
            states.append((m, l_, acc))
        M = states[0][0]
        for m, _, _ in states[1:]:
            M = torch.maximum(M, m)
        L = torch.zeros(W, H)
        A = torch.zeros(W, H, D)
        for m, l_, acc in states:
            f = torch.exp(m - M)
            L = L + l_ * f
            A = A + acc * f[..., None]
        kn = k_new[b].float().reshape(W, H, D)
        vn = v_new[b].float().reshape(W, H, D)
        for w in range(W):
            for j in range(w + 1):
                s = (qh[w] * kn[j]).sum(-1) * scale
                mn = torch.maximum(M[w], s)
                a, e = torch.exp(M[w] - mn), torch.exp(s - mn)
                L[w] = L[w] * a + e
                A[w] = A[w] * a[:, None] + e[:, None] * vn[j]
                M[w] = mn
        out[b] = (A / L[..., None]).reshape(W, C)
    return out.to(q.dtype)


@pytest.mark.parametrize("ranks", [1, 2, 3, 8])
@pytest.mark.parametrize("kv_dtype,gran", [("none", "page"), ("int8", "page"),
                                           ("fp8", "head")])
@pytest.mark.parametrize("W", [1, 4])
def test_cluster_split_merge_matches_plain_version(ranks, kv_dtype, gran, W):
    """Row #1's split over a cluster and its merge against the plain
    version, f32, atol = rtol = 1e-5 (the two sum in different orders):
    8-row tiles of a 32-row table, so 8 ranks leave ranks with no tile."""
    from replicatinggpt_tpu_torch.quant.kv import (fake_quantize_rows,
                                                   quantize_rows)
    q, kn, vn, kp, vp, tables, pos = (torch.from_numpy(a)
                                      for a in _paged_inputs(W))
    kw = {}
    if kv_dtype != "none":
        (kp, ks), (vp, vs) = (quantize_rows(t, kv_dtype, H, gran)
                              for t in (kp, vp))
        kn, vn = (fake_quantize_rows(t, kv_dtype, H, gran) for t in (kn, vn))
        kw = {"k_scales": ks, "v_scales": vs}
    want = tpa.paged_window_attention_ref(q, kn, vn, kp, vp, tables, pos,
                                          n_head=H, **kw)
    got = _split_merge_twin(q, kn, vn, kp, vp, tables, pos, n_head=H,
                            ranks=ranks, tile=8, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_cluster_split_merge_matches_jax_kernel():
    """The twin at 3 ranks against JAX paged_window_attention (interpret
    mode) at the shape test_paged_attention_ref_matches_jax_kernel
    already compiles, f32, atol 2e-5."""
    args = _paged_inputs(1)
    want = np.asarray(jpp.paged_window_attention(
        *(jnp.asarray(a) for a in args), n_head=H))
    t = [torch.from_numpy(a) for a in args]
    got = _split_merge_twin(*t, n_head=H, ranks=3, tile=8).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _parent_paged_smem(W, D, mp):
    """The row #1 kernel's shared memory before the cluster split: f32
    tiles of 64 rows, window rows, scores and the table prefix."""
    ks = D + 8
    return 4 * (W * D + W * ks + 2 * W * D + 64 * ks + 64 * D
                + W * max(64, W) + 3 * W + mp)


def _parent_fused_smem(C, S, D, isz):
    """The row #3 kernel's shared memory before the split-K redesign."""
    return 4 * (4 * C + 32 * 8 * (16 // isz) + 9) + 4 * (D + S + 256 + 9)


def test_kernel_envelopes_accept_what_they_accepted_before():
    """Neither redesigned kernel refuses a shape its predecessor took: at
    every sampled shape inside the old shared-memory budget the new
    carve-up fits too, and the kernel's split stays inside a cluster."""
    from replicatinggpt_tpu_torch.ops import decode as tdec
    limit = 232_448
    for W in (1, 2, 4, 7, 16, 64, 150):
        for D in range(8, 257, 8):
            for mp in (1, 64, 4096, 40_000, 55_000):
                if _parent_paged_smem(W, D, mp) > limit:
                    continue
                for isz, quant in ((2, False), (4, False), (1, True)):
                    assert tpa.smem_bytes(W, D, mp, 16, isz,
                                          quant) <= limit
                    assert 1 <= tpa.cluster_ranks(W, D, mp, 16, isz,
                                                  quant) <= 8
    for D in (4, 8, 16, 32, 64, 128, 256):
        for C in range(D, 16_000, 7 * D):
            for S in (8, 256, 1024, 30_000, 55_000):
                for isz in (2, 4):
                    if _parent_fused_smem(C, S, D, isz) <= limit:
                        assert tdec.fused_smem_bytes(C, S, D, isz) <= limit
    assert tpa.cluster_ranks(1, 64, 64, 16, 2) == 4     # the 124M step
    assert tpa.cluster_ranks(1, 64, 256, 16, 2) == 8
    assert tpa.cluster_ranks(1, 64, 4, 8, 2) == 1


def test_cluster_split_follows_the_callers_span():
    """Row #1's split sized from a bound on pos that the caller holds on
    the host (the engine's step): one rank (a plain grid) while a
    history fits one CTA's ring, more as it grows, the whole table's
    split without a bound; any span fits the shared memory that the
    whole table's split fits."""
    ranks = [tpa.cluster_ranks(1, 64, 64, 16, 2, False, span)
             for span in (0, 1, 64, 256, 257, 512, 1000, 1024, 10 ** 6)]
    assert ranks == [1, 1, 1, 1, 2, 2, 4, 4, 4]
    assert tpa.cluster_ranks(1, 64, 64, 16, 2) == 4
    assert tpa.ring_stages(1, 64, 64, 16, 2, False, 64) == 2
    limit = 232_448
    for W in (1, 4, 9):
        for D in (8, 64, 128, 256):
            for mp in (1, 64, 4096, 40_000):
                for isz, quant in ((2, False), (4, False), (1, True)):
                    if tpa.smem_bytes(W, D, mp, 16, isz, quant) > limit:
                        continue
                    for span in (1, 17, 64, 300, 2048, mp * 16):
                        assert tpa.smem_bytes(W, D, mp, 16, isz, quant,
                                              span) <= limit


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


# ---------------------------------------------------------------------------
# rows #4 and #2 (the redesigned decode kernels): torch twins of the
# kernels' splits
# ---------------------------------------------------------------------------

from replicatinggpt_tpu.ops import decode_pallas as jdp  # noqa: E402
from replicatinggpt_tpu_torch.ops import decode as tdec  # noqa: E402


def _packed_split_twin(q, k_new, v_new, k_cache, v_cache, pos, *, n_head,
                       ranks):
    """csrc/packed_decode_attention.cu's algebra in plain torch: the
    history < pos cut into ``ranks`` contiguous ranges of ceil(pos /
    ranks) rows; each rank's (m, l) over its scores (a rank with no row
    holds m = -1e30, l = 0); the global m = max(m_all, s_new) and denom in
    rank order; each rank's weights exp(s - m) / denom rounded to the
    cache dtype before its P V; the partials summed in rank order, then
    round(p_new / denom) * v_new."""
    B, C = q.shape
    H, D = n_head, C // n_head
    scale = D ** -0.5
    rows = -(-pos // ranks)
    qh = q.float().reshape(B, H, D)
    kh = k_cache.float().reshape(B, -1, H, D)
    vh = v_cache.float().reshape(B, -1, H, D)
    s_new = (k_new.float().reshape(B, H, D) * qh).sum(-1) * scale
    scores, ms, ls = [], [], []
    for r in range(ranks):
        sl = slice(min(r * rows, pos), min((r + 1) * rows, pos))
        s = torch.einsum("bhd,bthd->bht", qh, kh[:, sl]) * scale
        m = s.amax(-1) if s.shape[-1] else torch.full((B, H), NEG_INF)
        scores.append((sl, s))
        ms.append(m)
        ls.append(torch.exp(s - m[..., None]).sum(-1))
    M = s_new
    for m in ms:
        M = torch.maximum(M, m)
    denom = torch.zeros(B, H)
    for m, l_ in zip(ms, ls):
        denom = denom + l_ * torch.exp(m - M)
    p_new = torch.exp(s_new - M)
    denom = denom + p_new
    out = torch.zeros(B, H, D)
    for sl, s in scores:
        w = (torch.exp(s - M[..., None]) / denom[..., None]).to(
            v_cache.dtype).float()
        out = out + torch.einsum("bht,bthd->bhd", w, vh[:, sl])
    w_new = (p_new / denom).to(v_new.dtype).float()
    out = out + w_new[..., None] * v_new.float().reshape(B, H, D)
    return out.reshape(B, C).to(q.dtype)


def _packed_arrays(pos_seed, B=3, S=16, Hh=4, D=32):
    rng = np.random.default_rng(pos_seed)
    C = Hh * D
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, C),) * 3 + ((B, S, C),) * 2]


@pytest.mark.parametrize("ranks", [1, 2, 3, 8])
@pytest.mark.parametrize("pos", [0, 5, 13, 15])
def test_packed_split_merge_matches_plain_version(ranks, pos):
    """Row #4's split over ranks and its two-pass merge against the plain
    version, f32, atol = rtol = 1e-5: at 8 ranks of pos 5 or 13 some ranks
    get no rows."""
    t = [torch.from_numpy(a) for a in _packed_arrays(pos)]
    want = tdec.packed_decode_attention_ref(*t, pos, n_head=4)
    got = _packed_split_twin(*t, pos, n_head=4, ranks=ranks)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_packed_split_merge_matches_jax_kernel():
    """The twin at 3 ranks against JAX packed_decode_attention (interpret
    mode) at the shape test_torch_port_generate.py already compiles, f32,
    atol 2e-6."""
    arrs = _packed_arrays(15)
    want = np.asarray(jdp.packed_decode_attention(
        *(jnp.asarray(a) for a in arrs), jnp.int32(15), n_head=4))
    got = _packed_split_twin(*(torch.from_numpy(a) for a in arrs), 15,
                             n_head=4, ranks=3).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def _paged_step_twin(x0, blocks, pos, tables, cache, cfg, *, splits, span):
    """csrc/fused_paged_decode_layers.cu's attention algebra in plain torch
    inside the plain step: each slot's live history cut into ``splits``
    contiguous ranges of ceil(span / splits) rows (the last takes the
    rest), an online softmax state (m, l, acc) per range (m = -1e30, l = 0
    for none), the fresh column as one more state (s_new, 1, v_new), the
    states merged by logsumexp in split order, the fresh one last."""
    from replicatinggpt_tpu_torch.ops.paged_attention import gather_history
    from replicatinggpt_tpu_torch.quant.kv import (fake_quantize_row_body,
                                                   pool_quant_mode)
    cd = x0.dtype
    w = {n: blocks[n].to(cd) for n in tdec.BLOCK_NAMES}
    kv_dtype, gran = pool_quant_mode(cache)
    L, N, psz, C = cache["k"].shape
    B, mp = tables.shape
    H = cfg.n_head
    D = C // H
    scale = D ** -0.5
    rows = -(-span // splits)
    pos = pos.long()
    tab = torch.where(torch.arange(mp)[None] < ((pos + psz - 1) // psz)[:, None],
                      tables.long(), 0)
    x = x0
    newk, newv = [], []
    for i in range(L):
        h = tdec._ln_row(x, w["ln1_scale"][i], w["ln1_bias"][i],
                         cfg.layernorm_eps)
        q, k_row, v_row = tdec._row_matmul(h, w["qkv_kernel"][i],
                                           w["qkv_bias"][i]).split(C, dim=-1)
        newk.append(k_row)
        newv.append(v_row)
        if kv_dtype is not None:
            k_row, v_row = (fake_quantize_row_body(t, kv_dtype, H, gran)
                            .to(cd) for t in (k_row, v_row))
        hist = {n: gather_history(cache[n][i], cache[n + "s"][i]
                                  if kv_dtype is not None else None, tab, H)
                .reshape(B, mp * psz, H, D) for n in ("k", "v")}
        qh = q.float().reshape(B, H, D)
        attn = torch.empty(B, H, D)
        for b in range(B):
            n_hist = int(pos[b])
            states = []
            for s in range(splits):
                r0 = min(s * rows, n_hist)
                r1 = n_hist if s == splits - 1 else min(r0 + rows, n_hist)
                sc = torch.einsum("hd,thd->ht", qh[b],
                                  hist["k"][b, r0:r1]) * scale
                if sc.shape[-1] == 0:
                    states.append((torch.full((H,), NEG_INF), torch.zeros(H),
                                   torch.zeros(H, D)))
                    continue
                m = sc.amax(-1)
                e = torch.exp(sc - m[:, None])
                states.append((m, e.sum(-1), torch.einsum(
                    "ht,thd->hd", e, hist["v"][b, r0:r1])))
            kn = k_row[b].float().reshape(H, D)
            states.append(((kn * qh[b]).sum(-1) * scale, torch.ones(H),
                           v_row[b].float().reshape(H, D)))
            M = states[0][0]
            for m, _, _ in states[1:]:
                M = torch.maximum(M, m)
            Ls, A = torch.zeros(H), torch.zeros(H, D)
            for m, l_, acc in states:
                f = torch.exp(m - M)
                Ls = Ls + l_ * f
                A = A + acc * f[:, None]
            attn[b] = A / Ls[:, None]
        attn = tdec._row_matmul(attn.reshape(B, C).to(cd),
                                w["attn_out_kernel"][i], w["attn_out_bias"][i])
        x_mid = x + attn
        h = tdec._ln_row(x_mid, w["ln2_scale"][i], w["ln2_bias"][i],
                         cfg.layernorm_eps)
        h = tdec._row_matmul(h, w["mlp_up_kernel"][i], w["mlp_up_bias"][i])
        h = (torch.nn.functional.gelu(h.float(), approximate="tanh")
             if cfg.activation == "gelu" else torch.relu(h.float())).to(cd)
        x = x_mid + tdec._row_matmul(h, w["mlp_down_kernel"][i],
                                     w["mlp_down_bias"][i])
    return x, torch.stack(newk), torch.stack(newv)


def _paged_step_inputs(kv_dtype="none", gran="page", seed=0):
    """A 2-layer C=64 step over ragged slots (0, a page edge, mid-page,
    the table's last row), stale ids past each live frontier."""
    from replicatinggpt_tpu_torch.config import ModelConfig
    from replicatinggpt_tpu_torch.models.gpt import BLOCK_SHAPES
    from replicatinggpt_tpu_torch.quant.kv import quantize_rows
    rng = np.random.default_rng(seed)
    L, Nn, psz, mp, Cc = 2, 24, 8, 4, 64
    cfg = ModelConfig(vocab_size=64, block_size=mp * psz, n_layer=L,
                      n_head=H, n_embd=Cc, activation="gelu",
                      decode_cache_layout="packed")
    pos = torch.tensor([5, 0, 16, 31, 9], dtype=torch.int32)
    tables = torch.from_numpy(rng.permutation(Nn)[:5 * mp].reshape(5, mp)
                              .astype(np.int32))
    live = (pos + psz - 1) // psz
    tables[torch.arange(mp)[None] >= live[:, None]] = Nn + 3
    blocks = {n: torch.from_numpy(0.05 * rng.standard_normal(
        (L, *s(Cc))).astype(np.float32)) for n, s in BLOCK_SHAPES.items()}
    kv = [torch.from_numpy(rng.standard_normal((L, Nn, psz, Cc)).astype(
        np.float32)) for _ in range(2)]
    if kv_dtype == "none":
        cache = {"k": kv[0], "v": kv[1]}
    else:
        (kq, ks), (vq, vs) = (quantize_rows(t, kv_dtype, H, gran) for t in kv)
        cache = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    x0 = torch.from_numpy(rng.standard_normal((5, Cc)).astype(np.float32))
    return x0, blocks, pos, tables, cache, cfg


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("kv_dtype,gran", [("none", "page"),
                                           ("int8", "head")])
def test_paged_split_merge_matches_plain_version(splits, kv_dtype, gran):
    """Row #2's split of each history and its logsumexp merge against the
    plain step, f32, atol = rtol = 1e-5; a span of 32 rows at 8 splits
    leaves the slots at pos 0, 5 and 9 splits with no rows, and a span of
    6 (below every long slot's pos) makes the last split take the rest."""
    args = _paged_step_inputs(kv_dtype, gran)
    want = tdec.fused_paged_decode_layers_ref(*args)
    for span in (32, 6):
        got = _paged_step_twin(*args, splits=splits, span=span)
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_paged_split_merge_matches_jax_kernel():
    """The twin at 3 splits against JAX fused_paged_decode_layers
    (interpret mode), f32, atol = rtol = 1e-5, on the pool of
    test_torch_port_serve_fused.py's fused step."""
    x0, blocks, pos, tables, cache, cfg = _paged_step_inputs()
    from replicatinggpt_tpu.config import ModelConfig as JConfig
    jcfg = JConfig(vocab_size=64, block_size=32, n_layer=2, n_head=H,
                   n_embd=64, dropout=0.0, attn_dropout=0.0,
                   activation="gelu", decode_cache_layout="packed")
    jt = np.where(tables.numpy() < 24, tables.numpy(), 0)
    want = jdp.fused_paged_decode_layers(
        jnp.asarray(x0.numpy()), {n: jnp.asarray(a.numpy())
                                  for n, a in blocks.items()},
        jnp.asarray(pos.numpy()), jnp.asarray(jt),
        {n: jnp.asarray(a.numpy()) for n, a in cache.items()}, jcfg)
    got = _paged_step_twin(x0, blocks, pos, tables, cache, cfg, splits=3,
                           span=32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def _parent_attend_smem(S, D):
    """Row #4's shared memory before the cluster split: q, the scores of
    the whole cache, the partial sums and the reductions."""
    return 4 * (D + S + 256 + 8 + 1)


def _parent_fused_paged_smem(C, D, mp, isz):
    """Row #2's shared memory before the split-K redesign."""
    rows = 8 * 4 * C + 8 * 8 * 8 * (16 // isz)
    att = 3 * D + 64 * (D + 8) + 64 * D + 64 + 256 + 4 + mp
    return 4 * (8 + 1 + max(rows, att))


def test_redesigned_decode_envelopes_accept_what_they_accepted_before():
    """Neither redesigned decode kernel refuses a shape its predecessor
    took: at every sampled shape inside the old shared-memory budget the
    new carve-up fits, and every pos < S splits into at most 8 ranks that
    fit too."""
    limit = 232_448
    for D in (4, 8, 16, 32, 64, 128, 256):
        for S in (1, 2, 8, 64, 129, 1024, 1025, 5000, 30_000, 57_000,
                  57_600):
            if _parent_attend_smem(S, D) > limit:
                continue
            assert tdec.attend_smem_bytes(S, D) <= limit
            for isz in (2, 4):
                for pos in {0, 1, S // 2, max(S - 1, 0)}:
                    sp = tdec.packed_decode_split(D, isz, pos)
                    assert 1 <= sp["ranks"] <= 8
                    assert sp["ranks"] * sp["rows"] >= pos
                    assert sp["smem"] <= limit
                    assert sp["held"] == min(sp["rows"], sp["held"])
        for C in range(D, 16_000, 11 * D):
            for mp in (1, 64, 4096, 48_000):
                for isz in (2, 4):
                    if _parent_fused_paged_smem(C, D, mp, isz) <= limit:
                        assert tdec.fused_paged_smem_bytes(C, D, mp,
                                                           isz) <= limit


def test_fused_paged_route_rule_answers_as_before(monkeypatch):
    """fused_paged_decode_supported gives the parent's answer on every
    preset, slot count, page size, pool type and granularity."""
    from replicatinggpt_tpu_torch.config import PRESETS
    cases = [(name, n, psz, isz, kv, gran)
             for name in sorted(PRESETS) for n in (1, 8, 32)
             for psz in (8, 16) for isz, kv in ((4, "none"), (2, "none"),
                                                (1, "int8"), (1, "fp8"))
             for gran in ("page", "head")]

    def answers():
        return [tdec.fused_paged_decode_supported(
            dataclasses.replace(PRESETS[name].model,
                                decode_cache_layout="packed"),
            n, psz, isz, kv_quant=kv, granularity=gran)
            for name, n, psz, isz, kv, gran in cases]

    new = answers()
    monkeypatch.setattr(tdec, "fused_paged_smem_bytes",
                        _parent_fused_paged_smem)
    assert new == answers()
    assert any(new) and not all(new)


def test_packed_split_follows_pos():
    """Row #4's split from pos alone: one rank (a plain grid) up to 128
    history rows, one more per 128, at most 8; every row held in shared
    memory at GPT-2 124M's widths."""
    ranks = [tdec.packed_decode_split(64, 2, p)["ranks"]
             for p in (0, 1, 127, 128, 129, 256, 257, 318, 896, 897, 1023,
                       5000)]
    assert ranks == [1, 1, 1, 1, 2, 2, 3, 3, 7, 8, 8, 8]
    for pos in range(0, 1024, 7):
        sp = tdec.packed_decode_split(64, 2, pos)
        assert sp["held"] == sp["rows"] == -(-pos // sp["ranks"])
    splits = [tdec.fused_paged_attn_splits(span, 8, 6, 132)
              for span in (0, 64, 65, 255, 1000)]
    assert splits == [1, 1, 2, 2, 2]
    assert [tdec.fused_paged_attn_splits(span, 1, 6, 132)
            for span in (64, 65, 255, 1000)] == [1, 2, 4, 8]
