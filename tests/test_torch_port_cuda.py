"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a card every test here skips. The bf16
flash inputs lie on an exact grid (``_on_grid``), so that a kernel and
its plain version round p z and ds from equal scores.

Imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from replicatinggpt_tpu_torch.ops import decode as dec
from replicatinggpt_tpu_torch.ops import flash_chunk as fc
from replicatinggpt_tpu_torch.ops import flash_heads as fh
from replicatinggpt_tpu_torch.ops import flash_packed as fp
from replicatinggpt_tpu_torch.ops import paged_attention as pa

H, PSZ, MP, N, C = 2, 8, 4, 24, 64


def _on_grid(x: np.ndarray, dtype) -> np.ndarray:
    """bf16 flash inputs on a grid of 1/32 within [-4, 4]: every product
    of two is a multiple of 2^-10 below 16, so a sum of D <= 256 of them
    is exact in f32 in any order (cuBLAS's, the tensor cores'). The
    scores and dO V^T then agree bit for bit between a kernel and its
    plain version, and so do the bf16 roundings of p z and ds that
    follow; with inputs off the grid, f32 summation order alone moves a
    few in a million of those roundings by one bf16 ulp, which no
    elementwise tolerance of the outputs can tell from a fault. f32
    inputs stay as drawn."""
    if dtype != torch.bfloat16:
        return x
    return np.clip(np.round(x * 32), -128, 128) / 32


def _inputs(W, dtype, seed=0):
    """Slots at pos 0, a page edge, mid-page and inside the last page;
    table entries past each live frontier hold ids past the pool."""
    rng = np.random.default_rng(seed)
    pos = np.array([0, 8, 13, 16, 29], np.int32)
    B = pos.size
    tables = rng.permutation(N)[: B * MP].reshape(B, MP).astype(np.int32)
    live = (pos + PSZ - 1) // PSZ
    tables[np.arange(MP)[None, :] >= live[:, None]] = N + 3
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).cuda().to(dtype)
    return (mk(B, W, C), mk(B, W, C), mk(B, W, C), mk(N, PSZ, C),
            mk(N, PSZ, C), torch.from_numpy(tables).cuda(),
            torch.from_numpy(pos).cuda())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_attention_kernel_matches_ref(card, W, dtype, tol):
    args = _inputs(W, dtype)
    before = pa.paged_window_attention.launches
    got = pa.paged_window_attention(*args, n_head=H)
    torch.cuda.synchronize()
    assert pa.paged_window_attention.launches == before + 1
    ref = pa.paged_window_attention_ref(*args, n_head=H)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_paged_attention_kernel_rejects_what_it_does_not_take(card):
    args = list(_inputs(1, torch.float32))
    with pytest.raises(TypeError):
        pa.paged_window_attention(*args[:5], args[5].long(), args[6],
                                  n_head=H)
    with pytest.raises(TypeError):
        pa.paged_window_attention(args[0].half(), *args[1:], n_head=H)
    strided = torch.cat([args[0], args[0]], dim=-1)[..., :C]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError):
        pa.paged_window_attention(strided, *args[1:], n_head=H)


def _edge_inputs(W, dtype, kv_dtype, gran, mp, seed=0, stale=False):
    """Slots at pos 0, 1, psz - 1, psz, psz + 1 and mp * psz - 1 beside
    an empty one; table entries past each live frontier point past the
    pool (with ``stale``, the empty slot's table is the longest slot's:
    the pages another slot owns); the pool rows at positions >= pos
    inside each slot's last live page hold NaN (a quantized pool: their
    scales). Returns the kernel's (args, kw) and the plain version's,
    whose pool has those rows finite: the kernel must not read them, and
    the plain version masks them without selecting (0 x NaN)."""
    from replicatinggpt_tpu_torch.quant.kv import (fake_quantize_rows,
                                                   quantize_rows)
    rng = np.random.default_rng(seed)
    pos = np.array([0, 1, PSZ - 1, PSZ, PSZ + 1, mp * PSZ - 1, 0], np.int32)
    B = pos.size
    n = B * mp + 3
    tables = rng.permutation(n)[:B * mp].reshape(B, mp).astype(np.int32)
    live = (pos + PSZ - 1) // PSZ
    tables[np.arange(mp)[None, :] >= live[:, None]] = n + 5
    if stale:
        tables[-1] = tables[-2]
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).cuda()
    q, kn, vn, kp, vp = mk(B, W, C), mk(B, W, C), mk(B, W, C), \
        mk(n, PSZ, C), mk(n, PSZ, C)
    if kv_dtype == "none":
        pages = {"k": kp.to(dtype), "v": vp.to(dtype)}
    else:
        (kq, ks), (vq, vs) = (quantize_rows(t, kv_dtype, H, gran)
                              for t in (kp, vp))
        kn, vn = (fake_quantize_rows(t, kv_dtype, H, gran) for t in (kn, vn))
        pages = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    clean = {k: t.clone() for k, t in pages.items()}
    dirty = ("k", "v") if kv_dtype == "none" else ("ks", "vs")
    for b, p in enumerate(pos):
        for g in range(p, live[b] * PSZ):
            for name in dirty:
                pages[name][tables[b, g // PSZ], g % PSZ] = float("nan")
    rows = [t.to(dtype) for t in (q, kn, vn)]
    tabs = (torch.from_numpy(tables).cuda(), torch.from_numpy(pos).cuda())

    def call(pool):
        kw = {"n_head": H}
        if kv_dtype != "none":
            kw.update(k_scales=pool["ks"], v_scales=pool["vs"])
        return (*rows, pool["k"], pool["v"], *tabs), kw

    return call(pages), call(clean)


# (compute dtype, pool, scale granularity); tolerances as TOL
EDGE_POOLS = [(torch.float32, "none", "page"),
              (torch.bfloat16, "none", "page")]
EDGE_POOLS += [(dt, kv, gran) for kv in ("int8", "fp8")
               for gran in ("page", "head")
               for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("mp,max_pos,ranks", [
    (4, None, 1), (64, None, 2), (96, None, 3), (128, None, 4),
    (256, None, 8), (256, 20, 1), (256, 300, 2)])
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("dtype,kv_dtype,gran", EDGE_POOLS)
def test_paged_attention_kernel_edge_positions(card, mp, max_pos, ranks, W,
                                               dtype, kv_dtype, gran):
    """The cluster split at 1-8 ranks (ranks that own no tile among
    them), sized from the table or from a caller's ``max_pos`` below
    the longest slot's pos (its ranks then stream more tiles), slots at
    every page edge and at the table's last row, NaN past pos, every
    pool type; two launches give the same bits."""
    (args, kw), (ref_args, ref_kw) = _edge_inputs(W, dtype, kv_dtype, gran,
                                                  mp)
    quant = kv_dtype != "none"
    assert pa.cluster_ranks(W, C // H, mp, PSZ, 1 if quant else
                            dtype.itemsize, quant, max_pos) == ranks
    if max_pos is not None:
        kw = {**kw, "max_pos": max_pos}
    before = pa.paged_window_attention.launches
    got = pa.paged_window_attention(*args, **kw)
    again = pa.paged_window_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.paged_window_attention.launches == before + 2
    assert torch.equal(got, again)
    ref = pa.paged_window_attention_ref(*ref_args, **ref_kw)
    assert torch.isfinite(got).all()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 5, 8, 64])
@pytest.mark.parametrize("span", ["tight", "table"])
@pytest.mark.parametrize("dtype,kv_dtype,gran", EDGE_POOLS)
def test_paged_attention_kernel_wide_windows(card, W, span, dtype, kv_dtype,
                                             gran):
    """Row #1 at the mixed window's widths (W = 5 is not a multiple of
    the 4 rows a pass holds; 64 is the 124M prefill chunk, 16 passes):
    every pool type, slots at every page edge and at the table's last
    row (its window rows run past the table), an inactive slot at pos 0
    whose stale table names the longest slot's pages (it must read
    none), NaN past pos; the split sized from the longest pos (the
    engine's bound) or from the whole table (a bound above every pos:
    only slower). Held to the plain version at the W in {1, 4}
    tolerances; two launches give the same bits."""
    mp = 8
    (args, kw), (ref_args, ref_kw) = _edge_inputs(W, dtype, kv_dtype, gran,
                                                  mp, stale=True)
    if span == "tight":
        kw = {**kw, "max_pos": int(args[6].max())}
    before = pa.paged_window_attention.launches_by_window.get(W, 0)
    got = pa.paged_window_attention(*args, **kw)
    again = pa.paged_window_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.paged_window_attention.launches_by_window[W] == before + 2
    assert torch.equal(got, again) and torch.isfinite(got).all()
    ref = pa.paged_window_attention_ref(*ref_args, **ref_kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_batched_sampler_draws_multinomials_tokens(card):
    """The engine's sampler, which reads nothing back, draws what
    ``torch.multinomial`` draws from the same CUDA generator state."""
    from replicatinggpt_tpu_torch.sample.generate import (
        filter_logits_batched, sample_tokens_batched)
    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((4, 1000), generator=g, device="cuda") * 3
    temp = torch.tensor([1.0, 0.7, 1.3, 1.0], device="cuda")
    top_k = torch.tensor([0, 20, 50, 0], device="cuda", dtype=torch.int32)
    top_p = torch.tensor([0.0, 0.0, 0.9, 0.5], device="cuda")
    greedy = torch.zeros(4, dtype=torch.bool, device="cuda")
    probs = torch.softmax(filter_logits_batched(logits, temp, top_k, top_p),
                          -1)
    for seed in range(8):
        gens = [torch.Generator(device="cuda").manual_seed(seed * 4 + b)
                for b in range(4)]
        twins = [torch.Generator(device="cuda").manual_seed(seed * 4 + b)
                 for b in range(4)]
        for _ in range(3):
            got = sample_tokens_batched(gens, logits, temp, top_k, top_p,
                                        greedy)
            want = [int(torch.multinomial(probs[b], 1, generator=t)[0])
                    for b, t in enumerate(twins)]
            assert got.tolist() == want


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["kernel", "fused", "gather"])
def test_window_launch_reads_nothing_back(card, route):
    """A windowed engine's launch enqueues its window without one host
    sync (``torch.cuda.set_sync_debug_mode('error')``): a steady decode
    window, and a mixed window right after an admission (its uploads,
    the prefill chunks, the lifecycle pack, the page tables)."""
    from replicatinggpt_tpu_torch.config import ModelConfig
    from replicatinggpt_tpu_torch.models.gpt import init_params
    from replicatinggpt_tpu_torch.serve import (Engine, EngineConfig,
                                                Request, SamplingParams)
    cfg = ModelConfig(vocab_size=65, block_size=64, n_layer=2, n_head=2,
                      n_embd=64, dtype="float32",
                      decode_cache_layout="packed")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    eng = Engine(model, cfg, EngineConfig(
        pool_size=4, page_size=8, paged_kernel=route != "gather",
        decode_window=4), device="cuda")
    if route == "kernel":
        eng._use_fused, eng._use_kernel = False, True
    assert eng.kernel_route.decode == route or route == "kernel"
    rng = np.random.default_rng(0)

    def req(i, greedy):
        return Request(id=f"r{i}", prompt=rng.integers(0, 65, (9,)),
                       max_new_tokens=40, rng_seed=i,
                       sampling=SamplingParams(greedy=greedy, top_k=10))
    for i in range(2):
        assert eng.submit(req(i, i == 0)) is None
    for _ in range(3):
        eng.step()
    assert eng._inflight is not None and not eng._pf_left.any()
    for admit in (False, True):
        if admit:
            assert eng.submit(req(2, False)) is None
            eng._admit_queue(eng.clock(), [], eng._admit_windowed)
            assert eng._pf_left.any() and eng._li is None
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            w = eng._launch(eng._window_cur)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        eng._drain_pending()
        eng._inflight = w
    out = {r.id: r for r in eng.drain()}
    assert set(out) == {"r0", "r1", "r2"}
    assert all(len(r.tokens) == 40 for r in out.values())


def _partials_inputs(B, dtype, kv_dtype, gran, seed=0, mp=128):
    """B slots at positions up to 1000 (one at 0) over a pool of B * mp
    pages of PSZ rows split into 2 data blocks; each slot's table a
    random draw, so its pages interleave the blocks. The rows at
    positions >= pos inside each slot's last live page hold NaN (a
    quantized pool: their scales) in the kernel's pool only. Returns the
    tables, pos, the window rows, the kernel's pool and the clean one."""
    from replicatinggpt_tpu_torch.quant.kv import quantize_rows
    rng = np.random.default_rng(seed)
    pos = np.array([0, 1000, 17, 333, 777, 16, 501, 64][:B], np.int32)
    if B == 1:
        pos[0] = 333
    n = B * mp
    tables = rng.permutation(n).reshape(B, mp).astype(np.int32)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).cuda()
    rows = [mk(B, 1, C).to(dtype) for _ in range(3)]
    kp, vp = mk(n, PSZ, C), mk(n, PSZ, C)
    if kv_dtype == "none":
        clean = {"k": kp.to(dtype), "v": vp.to(dtype)}
    else:
        (kq, ks), (vq, vs) = (quantize_rows(t, kv_dtype, H, gran)
                              for t in (kp, vp))
        clean = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    dirty = {k: t.clone() for k, t in clean.items()}
    live = (pos + PSZ - 1) // PSZ
    names = ("k", "v") if kv_dtype == "none" else ("ks", "vs")
    for b, p in enumerate(pos):
        for g in range(p, live[b] * PSZ):
            for name in names:
                dirty[name][tables[b, g // PSZ], g % PSZ] = float("nan")
    return tables, pos, rows, dirty, clean


def _block(pool, d, n_blocks):
    """Data block d of a pool dict: its pages (and their scales)."""
    blk = pool["k"].shape[0] // n_blocks
    return {k: t[d * blk:(d + 1) * blk] for k, t in pool.items()}


def _partials_call(rows, pool, loc, own, pos, **kw):
    sc = ({"k_scales": pool["ks"], "v_scales": pool["vs"]} if "ks" in pool
          else {})
    return pa.paged_window_attention(*rows, pool["k"], pool["v"], loc, pos,
                                     n_head=H, owned=own, **sc, **kw)


def _partials_ref(rows, pool, loc, own, pos):
    sc = ({"k_scales": pool["ks"], "v_scales": pool["vs"]} if "ks" in pool
          else {})
    return pa.paged_window_attention_ref(*rows, pool["k"], pool["v"], loc,
                                         pos, n_head=H, owned=own, fold=False,
                                         **sc)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("owned", ["block0", "block1", "none", "all"])
@pytest.mark.parametrize("dtype,kv_dtype,gran", EDGE_POOLS)
def test_paged_partials_kernel_matches_ref(card, B, owned, dtype, kv_dtype,
                                           gran):
    """Row #1's partials mode (``owned=``, ``fold=False``) against its
    plain twin: raw f32 acc, m and l over the pages one data block owns
    (interleaved with the other block's), over none (m = -1e30, l = acc =
    0) or over every live page, in every pool, at atol = rtol = 1e-4
    (f32 partials whatever the input dtype: another summation order); the
    kernel never reads a row past pos (NaN there) nor an unowned table
    entry (ids past the block there); the split sized from the owned
    rows' bound; two launches give the same bits."""
    tables, pos, rows, dirty, clean = _partials_inputs(B, dtype, kv_dtype,
                                                       gran)
    n_blocks = 1 if owned == "all" else 2
    d = 1 if owned == "block1" else 0
    blk = tables.size // n_blocks
    live = (pos + PSZ - 1) // PSZ
    own = ((np.arange(tables.shape[1])[None] < live[:, None])
           & (tables >= d * blk) & (tables < (d + 1) * blk))
    if owned == "none":
        own[:] = False
    loc = np.where(own, tables - d * blk, blk + 7).astype(np.int32)
    page_rows = np.clip(pos[:, None] - np.arange(tables.shape[1]) * PSZ, 0,
                        PSZ)
    span = int((page_rows * own).sum(1).max())
    args = (torch.from_numpy(loc).cuda(),
            torch.from_numpy(own.astype(np.int32)).cuda(),
            torch.from_numpy(pos).cuda())
    before = pa.paged_window_attention.partials_launches
    got = _partials_call(rows, _block(dirty, d, n_blocks), *args,
                         fold=False, max_pos=span)
    again = _partials_call(rows, _block(dirty, d, n_blocks), *args,
                           fold=False, max_pos=span)
    torch.cuda.synchronize()
    assert pa.paged_window_attention.partials_launches == before + 2
    ref = _partials_ref(rows, _block(clean, d, n_blocks), *args)
    for g, a, r in zip(got, again, ref):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert torch.equal(g, a)
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
    if owned == "none":
        assert (got[1] == pa.NEG_INF).all() and not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("dtype,kv_dtype,gran", EDGE_POOLS)
def test_paged_partials_merge_matches_fold_kernel(card, B, dtype, kv_dtype,
                                                  gran):
    """Two data blocks' partials merged by logsumexp and folded with the
    fresh row (``sharded_paged_window_attention`` over
    ``LocalServeGroup(2, 1)``) against the unsharded fold mode of the
    kernel: f32 at 1e-4, bf16 at 2e-2 (the merge's f32 order, then one
    rounding to bf16 on each side)."""
    from replicatinggpt_tpu_torch.parallel.serve_group import \
        LocalServeGroup
    from replicatinggpt_tpu_torch.quant.kv import fake_quantize_rows
    tables, pos, rows, dirty, _ = _partials_inputs(B, dtype, kv_dtype, gran)
    if kv_dtype != "none":
        rows = rows[:1] + [fake_quantize_rows(t.float(), kv_dtype, H, gran)
                           .to(dtype) for t in rows[1:]]
    tab, p = torch.from_numpy(tables).cuda(), torch.from_numpy(pos).cuda()
    blocks = [_block(dirty, d, 2) for d in (0, 1)]
    sc = {}
    if kv_dtype != "none":
        sc = {"k_scales": [b["ks"] for b in blocks],
              "v_scales": [b["vs"] for b in blocks]}
    got = pa.sharded_paged_window_attention(
        *rows, [b["k"] for b in blocks], [b["v"] for b in blocks], tab, p,
        LocalServeGroup(2, 1), n_head=H, **sc)
    whole_sc = ({"k_scales": dirty["ks"], "v_scales": dirty["vs"]}
                if kv_dtype != "none" else {})
    want = pa.paged_window_attention(*rows, dirty["k"], dirty["v"], tab, p,
                                     n_head=H, **whole_sc)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_paged_attention_smem_mirror_matches_kernel(card):
    """ops/paged_attention.py's carve-up, tile rows, ring stages and
    cluster ranks equal the kernel's own at shapes around every halving
    of the tile and every cluster size, with and without a span."""
    import ctypes
    lib = pa._lib()
    fn = lib.paged_window_attention_carve
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 4)()
    for W in (1, 4, 9, 64):
        for D in (8, 32, 64, 128, 256):
            for mp in (1, 8, 64, 4096):
                for isz, quant in ((2, False), (4, False), (1, True)):
                    for span in (None, 0, 65, 300, 1024):
                        assert fn(W, D, mp, 16, isz, int(quant),
                                  mp * 16 if span is None else span,
                                  out) == 0
                        assert tuple(out) == (
                            pa.smem_bytes(W, D, mp, 16, isz, quant, span),
                            pa.tile_rows(W, D, mp, isz, quant),
                            pa.ring_stages(W, D, mp, 16, isz, quant, span),
                            pa.cluster_ranks(W, D, mp, 16, isz, quant,
                                             span))


def _flash_inputs(T, H, dtype, D=64, B=2, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(_on_grid(  # noqa: E731
        rng.standard_normal(s).astype(np.float32), dtype)).cuda().to(dtype)
    return mk(B, T, 3 * H * D), mk(B, T, H * D)


# the kernels and their plain versions sum in f32 in different orders and
# round once to the output's type (bf16: after rounding p z and ds at the
# same points from equal f32 values, see _on_grid): bf16 o and d(qkv)
# agree to one bf16 ulp (at most 2^-7 of the value, under rtol) plus an
# f32 difference far under atol; lse is f32 on both sides
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-4, 1e-2)}


def _hold_flash(got, want):
    for g, w in zip(got, want):
        atol, rtol = FLASH_TOL[g.dtype]
        torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 256])
@pytest.mark.parametrize("H", [1, 6])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_packed_kernels_match_ref(card, T, H, rate, dtype):
    """Forward (o, lse) and backward (d(qkv), from the same lse and
    delta) of the CUDA kernels against the plain versions, with the
    same dropout seed."""
    qkv, do = _flash_inputs(T, H, dtype)
    seed = 987_654_321
    f0, b0 = fp.flash_packed_fwd.launches, fp.flash_packed_bwd.launches
    o, lse = fp.flash_packed_fwd(qkv, H, seed=seed, rate=rate)
    delta = fp.packed_delta(do, o, H)
    dqkv = fp.flash_packed_bwd(qkv, do, lse, delta, H, seed=seed, rate=rate)
    torch.cuda.synchronize()
    assert (fp.flash_packed_fwd.launches, fp.flash_packed_bwd.launches) \
        == (f0 + 1, b0 + 1)
    ro, rlse = fp.flash_packed_fwd_ref(qkv, H, seed=seed, rate=rate)
    rd = fp.flash_packed_bwd_ref(qkv, do, lse, delta, H, seed=seed,
                                 rate=rate)
    _hold_flash((o, lse, dqkv), (ro, rlse, rd))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,rate,dtype", [
    (4, 1024, 0.0, torch.float32), (4, 1024, 0.1, torch.float32),
    (4, 1024, 0.0, torch.bfloat16), (4, 1024, 0.1, torch.bfloat16),
    (1, 8192, 0.0, torch.float32), (1, 8192, 0.0, torch.bfloat16)])
def test_flash_packed_kernels_at_gpt2_shapes(card, B, T, rate, dtype):
    """GPT-2 124M's heads (H=12, D=64) at its T=1024, and at T=8192:
    the shapes of the JAX head-group families (TPU rows #7-#12)."""
    qkv, do = _flash_inputs(T, 12, dtype, B=B, seed=2)
    o, lse = fp.flash_packed_fwd(qkv, 12, seed=11, rate=rate)
    delta = fp.packed_delta(do, o, 12)
    dqkv = fp.flash_packed_bwd(qkv, do, lse, delta, 12, seed=11, rate=rate)
    torch.cuda.synchronize()
    ro, rlse = fp.flash_packed_fwd_ref(qkv, 12, seed=11, rate=rate)
    rd = fp.flash_packed_bwd_ref(qkv, do, lse, delta, 12, seed=11, rate=rate)
    _hold_flash((o, lse, dqkv), (ro, rlse, rd))


@pytest.mark.cuda
def test_flash_packed_autograd_on_card(card):
    """FlashPacked launches one forward and one backward and its gradient
    (with a non-contiguous upstream gradient) matches autograd through
    the plain forward."""
    qkv, _ = _flash_inputs(128, 6, torch.float32, seed=1)
    g = torch.randn(2, 128, 2 * 384, device="cuda")[..., ::2]
    assert not g.is_contiguous()
    x = qkv.clone().requires_grad_(True)
    f0, b0 = fp.flash_packed_fwd.launches, fp.flash_packed_bwd.launches
    fp.flash_packed_attention(x, 6, seed=5, rate=0.2).backward(g)
    torch.cuda.synchronize()
    assert (fp.flash_packed_fwd.launches, fp.flash_packed_bwd.launches) \
        == (f0 + 1, b0 + 1)
    y = qkv.clone().requires_grad_(True)
    fp.flash_packed_fwd_ref(y, 6, seed=5, rate=0.2)[0].backward(g)
    torch.testing.assert_close(x.grad, y.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_packed_kernel_rejects_what_it_does_not_take(card):
    qkv, _ = _flash_inputs(64, 2, torch.float32, D=48)
    with pytest.raises(ValueError, match="envelope"):
        fp.flash_packed_fwd(qkv, 2)
    qkv, _ = _flash_inputs(96, 2, torch.float32)
    with pytest.raises(ValueError, match="envelope"):
        fp.flash_packed_fwd(qkv, 2)
    qkv, _ = _flash_inputs(64, 2, torch.float16)
    with pytest.raises(TypeError):
        fp.flash_packed_fwd(qkv, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_packed_kernels_at_d256(card, dtype):
    """D=256 heads (f32: the backward on 32-row tiles; bf16: 64-row tiles
    over column chunks of D) through the packed entry points, with
    dropout."""
    qkv, do = _flash_inputs(128, 2, dtype, D=256, seed=3)
    o, lse = fp.flash_packed_fwd(qkv, 2, seed=21, rate=0.1)
    delta = fp.packed_delta(do, o, 2)
    dqkv = fp.flash_packed_bwd(qkv, do, lse, delta, 2, seed=21, rate=0.1)
    torch.cuda.synchronize()
    ro, rlse = fp.flash_packed_fwd_ref(qkv, 2, seed=21, rate=0.1)
    rd = fp.flash_packed_bwd_ref(qkv, do, lse, delta, 2, seed=21, rate=0.1)
    _hold_flash((o, lse, dqkv), (ro, rlse, rd))


def _heads_inputs(B, H, T, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: torch.from_numpy(_on_grid(  # noqa: E731
        rng.standard_normal((B, H, T, D)).astype(np.float32),
        dtype)).cuda().to(dtype)
    return mk(), mk(), mk(), mk()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,D", [(2, 25, 256, 64), (1, 2, 256, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_heads_kernels_match_ref(card, B, H, T, D, causal, rate,
                                       dtype):
    """The (B, H, T, D) forward (o, lse) and backward (dq, dk, dv, from
    the same lse and delta) against the plain versions: gpt2-xl's 25
    heads of D=64, and D=256."""
    q, k, v, do = _heads_inputs(B, H, T, D, dtype, seed=T + D)
    kw = dict(causal=causal, seed=123_456, rate=rate)
    f0, b0 = fh.flash_heads_fwd.launches, fh.flash_heads_bwd.launches
    o, lse = fh.flash_heads_fwd(q, k, v, **kw)
    delta = fh.heads_delta(do, o)
    grads = fh.flash_heads_bwd(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (fh.flash_heads_fwd.launches, fh.flash_heads_bwd.launches) \
        == (f0 + 1, b0 + 1)
    ro, rlse = fh.flash_heads_fwd_ref(q, k, v, **kw)
    rg = fh.flash_heads_bwd_ref(q, k, v, do, lse, delta, **kw)
    _hold_flash((o, lse, *grads), (ro, rlse, *rg))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("T", [64, 192, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.2])
def test_flash_heads_tensor_core_kernels_over_the_envelope(card, D, T,
                                                           causal, rate):
    """The bf16 (tensor-core) forward and backward against the rounding
    plain versions at every head size the envelope takes, one tile,
    three tiles (each rounding p from a new running max) and sixteen,
    causal or not, dropout 0, 0.1 and 0.2."""
    q, k, v, do = _heads_inputs(1, 2, T, D, torch.bfloat16, seed=D + T)
    kw = dict(causal=causal, seed=31_337, rate=rate)
    o, lse = fh.flash_heads_fwd(q, k, v, **kw)
    delta = fh.heads_delta(do, o)
    grads = fh.flash_heads_bwd(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    ro, rlse = fh.flash_heads_fwd_ref(q, k, v, **kw)
    rg = fh.flash_heads_bwd_ref(q, k, v, do, lse, delta, **kw)
    _hold_flash((o, lse, *grads), (ro, rlse, *rg))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 256])
def test_flash_f32_keeps_the_cuda_core_body(card, D):
    """f32 q, k, v run the CUDA-core body, which rounds nowhere: forward
    and backward within 1e-5 of the plain versions."""
    q, k, v, do = _heads_inputs(2, 3, 192, D, torch.float32, seed=D)
    kw = dict(seed=5, rate=0.1)
    o, lse = fh.flash_heads_fwd(q, k, v, **kw)
    delta = fh.heads_delta(do, o)
    grads = fh.flash_heads_bwd(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    ro, rlse = fh.flash_heads_fwd_ref(q, k, v, **kw)
    rg = fh.flash_heads_bwd_ref(q, k, v, do, lse, delta, **kw)
    for got, want in zip((o, lse, *grads), (ro, rlse, *rg)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_flash_heads_autograd_on_card(card):
    """FlashHeads launches one forward and one backward, with a custom
    scale, and its gradients match autograd through the plain forward."""
    q, k, v, _ = _heads_inputs(2, 3, 128, 32, torch.float32, seed=4)
    g = torch.randn(2, 3, 128, 64, device="cuda")[..., ::2]
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = fh.flash_heads_fwd.launches, fh.flash_heads_bwd.launches
    fh.flash_heads_attention(*x, scale=0.3, seed=5, rate=0.2).backward(g)
    torch.cuda.synchronize()
    assert (fh.flash_heads_fwd.launches, fh.flash_heads_bwd.launches) \
        == (f0 + 1, b0 + 1)
    y = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fh.flash_heads_fwd_ref(*y, scale=0.3, seed=5, rate=0.2)[0].backward(g)
    for a, b in zip(x, y):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_heads_kernel_rejects_what_it_does_not_take(card):
    for shape, dtype, err in (((1, 2, 64, 48), torch.float32, ValueError),
                              ((1, 2, 96, 64), torch.float32, ValueError),
                              ((1, 2, 64, 64), torch.float16, TypeError)):
        q = torch.zeros(shape, device="cuda", dtype=dtype)
        with pytest.raises(err):
            fh.flash_heads_fwd(q, q, q)
    q = torch.zeros(1, 2, 64, 128, device="cuda").transpose(2, 3)[..., :64, :]
    with pytest.raises(ValueError):
        fh.flash_heads_fwd(q, q, q)


def _chunk_inputs(B, H, Tq, Tk, D, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def mk(T):
        return torch.from_numpy(_on_grid(rng.standard_normal((B, H, T, D))
                                         .astype(np.float32), dtype)
                                ).cuda().to(dtype)

    return mk(Tq), mk(Tk), mk(Tk), mk(Tq), torch.from_numpy(
        rng.standard_normal((B, H, Tq)).astype(np.float32)).cuda()


# (Tq, Tk, q_offset, k_offset): fully visible, diagonal, partly masked on
# a tile boundary and off it, fully masked, rows before the chunk's first
# key in a walked tile, Tq != Tk
CHUNK_HOPS = [(128, 128, 128, 0), (128, 128, 128, 128), (128, 128, 64, 0),
              (128, 128, 96, 0), (128, 128, -128, 0), (128, 128, 0, 32),
              (64, 192, 160, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("Tq,Tk,q_off,k_off", CHUNK_HOPS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_chunk_kernels_match_ref(card, Tq, Tk, q_off, k_off, rate,
                                       dtype):
    """The chunk forward (o, lse) and backward (dq, dk, dv from the
    clamped lse and delta' with a nonzero lse cotangent) against the
    plain versions at global offsets; a fully masked hop gives o = 0,
    lse = NEG_INF and gradients exactly 0."""
    q, k, v, do, dlse = _chunk_inputs(2, 3, Tq, Tk, 64, dtype,
                                      seed=Tq + q_off)
    kw = dict(q_offset=q_off, k_offset=k_off, seed=424_242, rate=rate,
              bh_offset=5)
    f0, b0 = fc.flash_chunk_fwd.launches, fc.flash_chunk_bwd.launches
    o, lse = fc.flash_chunk_fwd(q, k, v, **kw)
    do, lse_c, deltap = fc.chunk_bwd_inputs(o, lse, do, dlse)
    grads = fc.flash_chunk_bwd(q, k, v, do, lse_c, deltap, **kw)
    torch.cuda.synchronize()
    assert (fc.flash_chunk_fwd.launches, fc.flash_chunk_bwd.launches) \
        == (f0 + 1, b0 + 1)
    ro, rlse = fc.flash_chunk_fwd_ref(q, k, v, **kw)
    rg = fc.flash_chunk_bwd_ref(q, k, v, do, lse_c, deltap, **kw)
    _hold_flash((o, lse, *grads), (ro, rlse, *rg))
    if q_off + Tq <= k_off:
        assert not o.any() and not any(g.any() for g in grads)
        assert (lse == fc.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_chunk_at_offset_zero_is_the_heads_kernel(card, dtype):
    """Offsets 0, Tq = Tk: the chunk kernel's o, lse and gradients equal
    the heads kernel's bit for bit, dropout mask included."""
    q, k, v, do, _ = _chunk_inputs(2, 25, 256, 256, 64, dtype, seed=9)
    kw = dict(seed=77, rate=0.1)
    o, lse = fc.flash_chunk_fwd(q, k, v, **kw)
    ho, hlse = fh.flash_heads_fwd(q, k, v, **kw)
    delta = fh.heads_delta(do, ho)
    g = fc.flash_chunk_bwd(q, k, v, do, lse, delta, **kw)
    hg = fh.flash_heads_bwd(q, k, v, do, hlse, delta, **kw)
    for a, b in zip((o, lse, *g), (ho, hlse, *hg)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_chunk_autograd_and_ring_on_card(card):
    """FlashChunk launches one forward and one backward and matches
    autograd through the plain forward; the ring over 4 shards in one
    process launches 10 hops and matches the dense plain attention."""
    from replicatinggpt_tpu_torch.parallel import (LocalSeqGroup,
                                                   ring_attention)
    q, k, v, g, dl = _chunk_inputs(2, 3, 128, 128, 32, torch.float32,
                                   seed=4)
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = fc.flash_chunk_fwd.launches, fc.flash_chunk_bwd.launches
    o, lse = fc.flash_chunk(*x, q_offset=64, k_offset=0, seed=5, rate=0.2)
    ((o * g).sum() + (lse * dl).sum()).backward()
    torch.cuda.synchronize()
    assert (fc.flash_chunk_fwd.launches, fc.flash_chunk_bwd.launches) \
        == (f0 + 1, b0 + 1)
    y = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ro, rlse = fc.flash_chunk_fwd_ref(*y, q_offset=64, k_offset=0, seed=5,
                                      rate=0.2)
    ((ro * g).sum() + (rlse * dl).sum()).backward()
    for a, b in zip(x, y):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)
    q, k, v, g, _ = _chunk_inputs(2, 3, 512, 512, 64, torch.float32, seed=6)
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0 = fc.flash_chunk_fwd.launches
    out = ring_attention(*x, group=LocalSeqGroup(4))
    (out * g).backward(torch.ones_like(out))
    assert fc.flash_chunk_fwd.launches == f0 + 10
    y = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref, _ = fh.flash_heads_fwd_ref(*y)
    (ref * g).backward(torch.ones_like(ref))
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    for a, b in zip(x, y):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_chunk_kernel_rejects_what_it_does_not_take(card):
    for (tq, tk, d), dtype, err in (((64, 96, 64), torch.float32, ValueError),
                                    ((64, 64, 48), torch.float32, ValueError),
                                    ((64, 64, 64), torch.float16, TypeError)):
        q = torch.zeros(1, 2, tq, d, device="cuda", dtype=dtype)
        k = torch.zeros(1, 2, tk, d, device="cuda", dtype=dtype)
        with pytest.raises(err):
            fc.flash_chunk_fwd(q, k, k)
    q = torch.zeros(1, 2, 64, 64, device="cuda")
    with pytest.raises(ValueError):
        fc.flash_chunk_fwd(q, q.cpu(), q)


def _nan_past(cache, pos, seq_axis):
    """Rows at positions >= pos hold NaN: the kernels must not read them."""
    idx = [slice(None)] * cache.dim()
    idx[seq_axis] = slice(pos, None)
    cache[tuple(idx)] = float("nan")
    return cache


#: positions that give every rank count of the packed decode kernel's
#: split at S=1024 (one rank per 128 rows, at most 8), each at a rank
#: edge and one past it, beside 0, 1 and S - 1
PACKED_POS = (0, 1, 127, 128, 129, 255, 257, 383, 385, 511, 513, 639, 641,
              767, 769, 895, 897, 1023)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_packed_decode_attention_split_over_every_rank_count(card, D, dtype,
                                                             tol):
    """Row #4 at B in {1, 8, 32}, S=1024, every rank count: q/k_new/v_new
    as slices of one (B, 3C) row, NaN in every cache row >= pos, a second
    launch bit for bit the first, one launch a call."""
    S, C = 1024, 512
    H = C // D
    rng = np.random.default_rng(D)
    for B in (1, 8, 32):
        mk = lambda *s: torch.from_numpy(  # noqa: E731
            rng.standard_normal(s).astype(np.float32)).cuda().to(dtype)
        q, kn, vn = mk(B, 3 * C).split(C, dim=-1)
        kc0, vc0 = mk(B, S, C), mk(B, S, C)
        for pos in PACKED_POS:
            if B == 32 and pos % 128 not in (0, 1, 127):
                continue    # the widest batch at the edges only
            kc = _nan_past(kc0.clone(), pos, 1)
            vc = _nan_past(vc0.clone(), pos, 1)
            before = dec.packed_decode_attention.launches
            got = dec.packed_decode_attention(q, kn, vn, kc, vc, pos,
                                              n_head=H)
            again = dec.packed_decode_attention(q, kn, vn, kc, vc, pos,
                                                n_head=H)
            torch.cuda.synchronize()
            assert dec.packed_decode_attention.launches == before + 2
            ref = dec.packed_decode_attention_ref(q, kn, vn, kc, vc, pos,
                                                  n_head=H)
            assert torch.isfinite(got).all(), (B, pos)
            assert torch.equal(got, again), (B, pos)
            torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                       rtol=tol, msg=f"B={B} pos={pos}")


@pytest.mark.cuda
def test_packed_decode_split_mirror_matches_kernel(card):
    """ops.decode.packed_decode_split against the kernel's own split."""
    import ctypes
    lib = dec._lib("packed_decode_attention")
    out = (ctypes.c_long * 4)()
    for D in (8, 32, 64, 128, 256):
        for isz in (2, 4):
            for pos in (0, 1, 127, 128, 129, 1000, 1023, 1025, 5000,
                        57_000):
                assert lib.packed_decode_attention_split(D, isz, pos,
                                                         out) == 0
                want = dec.packed_decode_split(D, isz, pos)
                assert list(out) == [want[k] for k in ("ranks", "rows",
                                                       "held", "smem")]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_packed_decode_attention_kernel_matches_ref(card, D, dtype, tol):
    B, S, C = 3, 80, 256
    H = C // D
    rng = np.random.default_rng(D)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).cuda().to(dtype)
    qkv = mk(B, 3 * C)            # q/k_new/v_new as slices, row stride 3C
    q, kn, vn = qkv.split(C, dim=-1)
    for pos in (0, 32, S - 1):
        kc = _nan_past(mk(B, S, C), pos, 1)
        vc = _nan_past(mk(B, S, C), pos, 1)
        before = dec.packed_decode_attention.launches
        got = dec.packed_decode_attention(q, kn, vn, kc, vc, pos, n_head=H)
        torch.cuda.synchronize()
        assert dec.packed_decode_attention.launches == before + 1
        ref = dec.packed_decode_attention_ref(q, kn, vn, kc, vc, pos,
                                              n_head=H)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


def _fused_inputs(layout, D, dtype, pos, S=64, C=256, L=2, seed=0,
                  activation="gelu"):
    """Weights at the path's scales (the residual projections at 0.02 /
    sqrt(2L), as ``init_params`` draws them), layernorm parameters and
    biases perturbed so their casts show, NaN in every cache row >=
    pos."""
    from replicatinggpt_tpu_torch.config import ModelConfig
    from replicatinggpt_tpu_torch.models.gpt import BLOCK_SHAPES
    H = C // D
    cfg = ModelConfig(vocab_size=64, block_size=S, n_layer=L, n_head=H,
                      n_embd=C, dtype="float32" if dtype == torch.float32
                      else "bfloat16", activation=activation,
                      decode_cache_layout=layout)
    rng = np.random.default_rng(seed)
    resid = 0.02 * (2 * L) ** -0.5
    blocks = {}
    for name, shape in BLOCK_SHAPES.items():
        a = rng.standard_normal((L, *shape(C))).astype(np.float32)
        if name.endswith("_scale"):
            a = 1 + 0.1 * a
        elif name.endswith("_kernel"):
            a = a * (resid if name in ("attn_out_kernel", "mlp_down_kernel")
                     else 0.02)
        else:
            a = 0.1 * a
        blocks[name] = torch.from_numpy(a).cuda()
    blocks = dec.fused_weights(blocks, dtype)
    shape = (L, 1, S, C) if layout == "packed" else (L, 1, H, S, D)
    seq = 2 if layout == "packed" else 3
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).cuda().to(dtype)
    cache = {"k": _nan_past(mk(*shape), pos, seq),
             "v": _nan_past(mk(*shape), pos, seq)}
    return mk(1, C), blocks, cache, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["heads", "packed"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("L", [1, 6])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_fused_decode_layers_kernel_matches_ref(card, layout, D, dtype, tol,
                                                L, activation):
    """pos at 0, 1, a tile edge and the cache's last row, NaN at and past
    pos; two launches give the same bits."""
    for pos in (0, 1, 63, 64, 255):
        x0, blocks, cache, cfg = _fused_inputs(layout, D, dtype, pos, S=256,
                                               L=L, activation=activation)
        before = dec.fused_decode_layers.launches
        got = dec.fused_decode_layers(x0, blocks, pos, cache, cfg)
        again = dec.fused_decode_layers(x0, blocks, pos, cache, cfg)
        torch.cuda.synchronize()
        assert dec.fused_decode_layers.launches == before + 2
        ref = dec.fused_decode_layers_ref(x0, blocks, pos, cache, cfg)
        for g, a, r in zip(got, again, ref):
            assert g.shape == r.shape and g.dtype == r.dtype
            assert torch.isfinite(g).all()
            assert torch.equal(g, a)
            torch.testing.assert_close(g.float(), r.float(), atol=tol,
                                       rtol=tol)


@pytest.mark.cuda
def test_fused_decode_plan_fills_the_card(card):
    """The grid covers every SM, the shared memory is the mirror's, and
    every product's items cover its columns and input rows."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for C, H, S, dtype in ((384, 6, 256, torch.bfloat16),
                           (384, 6, 256, torch.float32),
                           (768, 12, 1024, torch.bfloat16),
                           (256, 2, 64, torch.float32)):
        plan = dec.fused_decode_plan(C, H, S, dtype, "cuda")
        isz = dtype.itemsize
        assert plan["grid"] >= sms
        assert plan["smem"] == dec.fused_smem_bytes(C, S, C // H, isz)
        tc = 128 // isz
        for name, K, N in (("qkv", C, 3 * C), ("proj", C, C),
                           ("up", C, 4 * C), ("down", 4 * C, C)):
            assert plan[f"{name}_tiles"] * tc >= N
            assert plan[f"{name}_splits"] * plan[f"{name}_rows"] >= K
        assert (C // H) % plan["proj_rows"] == 0


@pytest.mark.cuda
def test_decode_kernels_reject_what_they_do_not_take(card):
    x0, blocks, cache, cfg = _fused_inputs("packed", 64, torch.bfloat16, 5)
    with pytest.raises(TypeError):    # f32 weights beside a bf16 row
        dec.fused_decode_layers(x0, {**blocks, "qkv_bias":
                                     blocks["qkv_bias"].float()}, 5, cache,
                                cfg)
    strided = {"k": cache["k"].transpose(2, 3).contiguous().transpose(2, 3),
               "v": cache["v"]}
    assert not strided["k"].is_contiguous()
    with pytest.raises(ValueError):
        dec.fused_decode_layers(x0, blocks, 5, strided, cfg)
    with pytest.raises(IndexError):
        dec.fused_decode_layers(x0, blocks, 64, cache, cfg)
    q = torch.randn(2, 256, device="cuda")
    kc = torch.randn(2, 16, 256, device="cuda")
    with pytest.raises(TypeError):
        dec.packed_decode_attention(q.half(), q.half(), q.half(), kc.half(),
                                    kc.half(), 3, n_head=4)
    wide = torch.randn(2, 512, device="cuda")[:, ::2]
    assert wide.stride(1) != 1
    with pytest.raises(ValueError):
        dec.packed_decode_attention(wide, q, q, kc, kc, 3, n_head=4)


def _fused_paged_inputs(dtype, kv_dtype, gran, D=64, C=256, L=2, psz=8,
                        N=40, seed=0, pos=(5, 0, 17, 47, 8, 0), mp=6):
    """Ragged positions (two slots at 0, one of them inactive), a
    permuted table with ids past the pool beyond each live frontier, and
    NaN in every pool row (or, quantized, every scale) at or past a
    slot's position: the kernel must not read them."""
    from replicatinggpt_tpu_torch.config import ModelConfig
    from replicatinggpt_tpu_torch.models.gpt import BLOCK_SHAPES
    from replicatinggpt_tpu_torch.quant.kv import quantize_rows
    H = C // D
    cfg = ModelConfig(vocab_size=64, block_size=mp * psz, n_layer=L,
                      n_head=H, n_embd=C, activation="gelu",
                      dtype="float32" if dtype == torch.float32
                      else "bfloat16", decode_cache_layout="packed")
    rng = np.random.default_rng(seed)
    pos = np.array(pos, np.int32)
    B = pos.size
    N = max(N, B * mp)
    tables = rng.permutation(N)[:B * mp].reshape(B, mp).astype(np.int32)
    live = (pos + psz - 1) // psz
    tables[np.arange(mp)[None, :] >= live[:, None]] = N + 3
    blocks = {}
    for name, shape in BLOCK_SHAPES.items():
        a = rng.standard_normal((L, *shape(C))).astype(np.float32)
        a = 1 + 0.1 * a if name.endswith("_scale") else (
            0.02 * a if name.endswith("_kernel") else 0.1 * a)
        blocks[name] = torch.from_numpy(a).cuda()
    blocks = dec.fused_weights(blocks, dtype)
    kv = [torch.from_numpy(rng.standard_normal((L, N, psz, C)).astype(
        np.float32)).cuda() for _ in range(2)]
    if kv_dtype == "none":
        cache = {"k": kv[0].to(dtype), "v": kv[1].to(dtype)}
        dirty = ("k", "v")
    else:
        (kq, ks), (vq, vs) = (quantize_rows(t, kv_dtype, H, gran) for t in kv)
        cache = {"k": kq, "v": vq, "ks": ks, "vs": vs}
        dirty = ("ks", "vs")
    for b, p in enumerate(pos):
        for g in range(p, live[b] * psz):
            for n in dirty:
                cache[n][:, tables[b, g // psz], g % psz] = float("nan")
    x0 = torch.from_numpy(0.5 * rng.standard_normal((B, C)).astype(
        np.float32)).cuda().to(dtype)
    return (x0, blocks, torch.from_numpy(pos).cuda(),
            torch.from_numpy(tables).cuda(), cache, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("kv_dtype,gran", [("none", "page"), ("int8", "page"),
                                           ("int8", "head"), ("fp8", "page"),
                                           ("fp8", "head")])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_fused_paged_decode_kernel_matches_ref(card, D, kv_dtype, gran,
                                               dtype, tol):
    args = _fused_paged_inputs(dtype, kv_dtype, gran, D=D)
    before = dec.fused_paged_decode_layers.launches
    got = dec.fused_paged_decode_layers(*args)
    torch.cuda.synchronize()
    assert dec.fused_paged_decode_layers.launches == before + 1
    ref = dec.fused_paged_decode_layers_ref(*args)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol)


#: slots over a 24-page table of 8 rows: 0 (inactive too), 1, page
#: edges, the table's last row; 11 slots walk two groups of 8
PAGED_POS = (5, 0, 17, 191, 64, 0, 128, 63, 1, 129, 100)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,D", [(1, 256, 64), (3, 256, 64),
                                   (8, 256, 64), (11, 256, 64),
                                   (11, 512, 32)])
@pytest.mark.parametrize("kv_dtype,gran", [("none", "page"), ("int8", "page"),
                                           ("int8", "head"), ("fp8", "page"),
                                           ("fp8", "head")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_paged_decode_kernel_over_slots_and_splits(card, B, C, D,
                                                         kv_dtype, gran,
                                                         dtype):
    """Row #2 at B in {1, 3, 8, 11} (the groups of 8 slots), with its
    history split sized from the caller's max_pos (the longest position,
    a bound below it, none: the whole table), over every pool type; at
    C=512, D=32 the 176 (slot, head) pairs outnumber the grid. NaN past
    every pos, table entries past the frontier past the pool; a second
    launch is bit for bit the first. bf16 through fp8 at 5e-2 (a one-ulp
    bf16 difference crossing an e4m3 boundary of the fresh column)."""
    tol = (5e-2 if kv_dtype == "fp8" and dtype == torch.bfloat16
           else 1e-4 if dtype == torch.float32 else 2e-2)
    args = _fused_paged_inputs(dtype, kv_dtype, gran, D=D, C=C, mp=24,
                               pos=PAGED_POS[:B])
    ref = dec.fused_paged_decode_layers_ref(*args)
    longest = int(args[2].max())
    for max_pos in (longest, 1, None):
        before = dec.fused_paged_decode_layers.launches
        got = dec.fused_paged_decode_layers(*args, max_pos=max_pos)
        again = dec.fused_paged_decode_layers(*args, max_pos=max_pos)
        torch.cuda.synchronize()
        assert dec.fused_paged_decode_layers.launches == before + 2
        for g, a, r in zip(got, again, ref):
            assert g.shape == r.shape and g.dtype == r.dtype
            assert torch.isfinite(g).all(), max_pos
            assert torch.equal(g, a), max_pos
            torch.testing.assert_close(g.float(), r.float(), atol=tol,
                                       rtol=tol, msg=f"max_pos={max_pos}")


@pytest.mark.cuda
def test_fused_paged_plan_fills_the_card(card):
    """The paged kernel's grid covers every SM, its shared memory is the
    mirror's, every product's items cover its columns and input rows,
    and the attention split follows the mirror."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for C, H, rows, dtype, pool in (
            (384, 6, 256, torch.bfloat16, torch.bfloat16),
            (384, 6, 256, torch.float32, torch.int8),
            (384, 6, 256, torch.bfloat16, torch.float8_e4m3fn),
            (768, 12, 1024, torch.bfloat16, torch.bfloat16),
            (256, 4, 48, torch.float32, torch.float32)):
        plan = dec.fused_paged_decode_plan(C, H, rows, dtype, pool, "cuda")
        isz = dtype.itemsize
        assert plan["grid"] >= sms
        assert plan["smem"] == dec.fused_paged_smem_bytes(C, C // H, 1, isz)
        tc = 128 // isz
        for name, K, N in (("qkv", C, 3 * C), ("proj", C, C),
                           ("up", C, 4 * C), ("down", 4 * C, C)):
            assert plan[f"{name}_tiles"] * tc >= N
            assert plan[f"{name}_splits"] * plan[f"{name}_rows"] >= K
        assert (C // H) % plan["proj_rows"] == 0
        assert 0 < plan["kv_rows"] <= rows
        for B in (1, 8, 32):
            ns = dec.fused_paged_attn_splits(rows, B, H, plan["grid"])
            assert 1 <= ns <= plan["attn_splits_max"]
            assert B * H * ns <= max(plan["grid"], B * H)


@pytest.mark.cuda
def test_fused_paged_decode_kernel_rejects_what_it_does_not_take(card):
    x0, blocks, pos, tables, cache, cfg = _fused_paged_inputs(
        torch.bfloat16, "int8", "page")
    with pytest.raises(TypeError):          # int64 tables
        dec.fused_paged_decode_layers(x0, blocks, pos, tables.long(), cache,
                                      cfg)
    with pytest.raises(TypeError):          # f32 scales expected
        dec.fused_paged_decode_layers(x0, blocks, pos, tables, {
            **cache, "ks": cache["ks"].double()}, cfg)
    with pytest.raises(TypeError):          # f32 row beside bf16 weights
        dec.fused_paged_decode_layers(x0.float(), blocks, pos, tables, cache,
                                      cfg)
    with pytest.raises(ValueError):         # head scales on a page pool
        dec.fused_paged_decode_layers(x0, blocks, pos, tables, {
            **cache, "ks": cache["ks"][..., None]}, cfg)
    strided = cache["k"].transpose(2, 3).contiguous().transpose(2, 3)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError):
        dec.fused_paged_decode_layers(x0, blocks, pos, tables,
                                      {**cache, "k": strided}, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("gran", ["page", "head"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_quantized_paged_attention_kernel_matches_ref(card, W, kv_dtype, gran,
                                                      dtype, tol):
    from replicatinggpt_tpu_torch.quant.kv import (fake_quantize_rows,
                                                   quantize_rows)
    q, kn, vn, kp, vp, tables, pos = _inputs(W, torch.float32)
    kq, ks = quantize_rows(kp, kv_dtype, H, gran)
    vq, vs = quantize_rows(vp, kv_dtype, H, gran)
    kn, vn = (fake_quantize_rows(t, kv_dtype, H, gran) for t in (kn, vn))
    args = (q.to(dtype), kn.to(dtype), vn.to(dtype), kq, vq, tables, pos)
    before = pa.paged_window_attention.launches
    got = pa.paged_window_attention(*args, n_head=H, k_scales=ks,
                                    v_scales=vs)
    torch.cuda.synchronize()
    assert pa.paged_window_attention.launches == before + 1
    ref = pa.paged_window_attention_ref(*args, n_head=H, k_scales=ks,
                                        v_scales=vs)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    with pytest.raises(TypeError):          # int8 pages without scales
        pa.paged_window_attention(*args, n_head=H)


def _ckpt_state(device, steps=2, rng=True, optimizer=True):
    """A small training state on ``device``, trained ``steps`` steps with
    dropout (each block's masks from a device generator seeded from the
    state's CPU ``seeds`` stream)."""
    import dataclasses

    from replicatinggpt_tpu_torch.config import get_config
    from replicatinggpt_tpu_torch.train import state as st
    from replicatinggpt_tpu_torch.train.steps import make_train_step
    cfg = get_config("test-tiny")
    mcfg = dataclasses.replace(cfg.model, dropout=0.2, attn_dropout=0.2)
    state = st.create_train_state(mcfg, cfg.train, device)
    x = torch.randint(0, 65, (8, 32), generator=torch.Generator()
                      .manual_seed(1)).to(device)
    step = make_train_step(mcfg, cfg.train)
    for _ in range(steps):
        step(state, (x, x))
    if not rng:
        state.rng = None
    if not optimizer:
        state.optimizer = None
    return state


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card_is_bitwise(card, tmp_path):
    """The whole state, the card's dropout generator included, restores
    into a fresh card state bit for bit."""
    from replicatinggpt_tpu_torch.train.checkpoint import CheckpointManager
    state = _ckpt_state("cuda")
    ck = CheckpointManager(str(tmp_path))
    ck.save(state)
    fresh = _ckpt_state("cuda", steps=0)
    ck.restore_latest(fresh)
    a, b = state.state_dict(), fresh.state_dict()
    assert sorted(a) == sorted(b) and "rng/bits/cuda" in a
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k
        assert a[k].device == b[k].device, k


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [("cuda", "cpu"), ("cpu", "cuda")])
def test_checkpoint_crosses_devices(card, tmp_path, src, dst):
    """Written on one device, the weights, AdamW's moments and count
    restore onto the other (on the template's device); the device dropout
    stream cannot continue there, and says so."""
    from replicatinggpt_tpu_torch.train.checkpoint import CheckpointManager
    state = _ckpt_state(src)
    ck = CheckpointManager(str(tmp_path))
    ck.save(state)
    fresh = _ckpt_state(dst, steps=0, rng=False)
    ck.restore_latest(fresh)
    a, b = state.state_dict(), fresh.state_dict()
    assert {k for k in a if not k.startswith("rng/")} == set(b)
    for k in b:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k
    assert fresh.model.wte.device.type == dst
    assert fresh.optimizer.count == state.optimizer.count == 2
    with pytest.raises(ValueError, match="cannot continue"):
        ck.restore_latest(_ckpt_state(dst, steps=0))


@pytest.mark.cuda
@pytest.mark.parametrize("fsdp", [False, True])
def test_local_data_group_step_equals_the_plain_step_on_the_card(card, fsdp):
    """``LocalDataGroup(2)`` (each shard's rows through the packed flash
    kernels in turn, the gradients summed in shard order), with and
    without FSDP (the masters as 2 shards, each layer gathered and its
    gradients reduce-scattered on the card), against the plain step: f32,
    3 steps of 2 accumulated micro-batches, clip 1.0."""
    from replicatinggpt_tpu_torch.config import ModelConfig, TrainConfig
    from replicatinggpt_tpu_torch.parallel.mesh import LocalDataGroup
    from replicatinggpt_tpu_torch.train import state as st
    from replicatinggpt_tpu_torch.train.steps import make_train_step
    mcfg = ModelConfig(vocab_size=256, block_size=64, n_layer=2, n_head=4,
                       n_embd=128, dropout=0.0, attn_dropout=0.0,
                       dtype="float32")
    tcfg = TrainConfig(batch_size=4, lr=3e-4, grad_clip=1.0,
                       grad_accum_steps=2)
    g = torch.Generator().manual_seed(3)
    batches = [torch.randint(0, 256, (2, 4, 65), generator=g).cuda()
               for _ in range(3)]
    out = {}
    for group in (None, LocalDataGroup(2, fsdp=fsdp)):
        state = st.create_train_state(mcfg, tcfg, "cuda", group=group)
        step = make_train_step(mcfg, tcfg, None, group)
        fp.flash_packed_fwd.launches = 0
        losses = [float(step(state, (b[..., :-1], b[..., 1:])))
                  for b in batches]
        assert fp.flash_packed_fwd.launches == 2 * 2 * 3 * (
            1 if group is None else 2)
        out[group is None] = (losses, state.state_dict())
    (lg, got), (lp, want) = out[False], out[True]
    np.testing.assert_allclose(lg, lp, rtol=1e-5)
    for k in want:
        if k.startswith(("params/", "opt/exp")):
            torch.testing.assert_close(got[k], want[k], atol=1e-5,
                                       rtol=1e-5, msg=k)


def _fleet_run(route, tmp_path, kill):
    """Greedy and sampled requests over 2 prefixes through a 2-replica
    fleet on ``route`` (per-layer kernel, or gather), f32, with journals,
    clean or with replica 0 killed at router step 4; returns each id's
    delivered stream and tokens, and the kernel launches."""
    from replicatinggpt_tpu_torch.config import ModelConfig
    from replicatinggpt_tpu_torch.faults import Fault, FaultPlan, installed
    from replicatinggpt_tpu_torch.models.gpt import init_params
    from replicatinggpt_tpu_torch.serve import (EngineConfig, Request,
                                                Router, RouterConfig,
                                                SamplingParams)
    cfg = ModelConfig(vocab_size=65, block_size=64, n_layer=2, n_head=2,
                      n_embd=64, dtype="float32",
                      decode_cache_layout="packed")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    faults = (Fault(site="fleet/step", kind="replica_kill", at=4, arg=0),
              ) if kill else ()
    rng = np.random.default_rng(1)
    prefixes = [rng.integers(0, 65, (16,)) for _ in range(2)]
    reqs = [Request(id=f"r{i}", prompt=np.concatenate(
        [prefixes[i % 2], rng.integers(0, 65, (3 + i % 5,))]),
        max_new_tokens=12, rng_seed=i,
        sampling=SamplingParams(greedy=i % 3 != 0, top_k=10))
        for i in range(10)]
    launches = pa.paged_window_attention.launches
    with installed(FaultPlan(*faults)):
        r = Router(model, cfg, RouterConfig(n_replicas=2,
                                            journal_dir=str(tmp_path)),
                   EngineConfig(pool_size=4, page_size=8,
                                paged_kernel=route == "kernel"),
                   device="cuda")
        for rep in r.replicas:
            if route == "kernel":
                rep.engine._use_fused, rep.engine._use_kernel = False, True
        for q in reqs:
            assert r.submit(q) is None
        streams, results = {q.id: [] for q in reqs}, {}
        while not r.idle:
            results.update({x.id: x for x in r.step()})
            for rid in streams:
                streams[rid].extend(r.take_new_tokens(rid))
    r.close()
    assert r.metrics.counters.get("fleet_replica_kills", 0) == int(kill)
    return ({k: list(v.tokens) for k, v in results.items()}, streams,
            pa.paged_window_attention.launches - launches)


@pytest.mark.cuda
def test_fleet_on_the_kernel_route_equals_the_plain_route(card, tmp_path):
    """The in-process fleet's streams on the per-layer kernel route equal
    the gather route's, clean and after a replica kill (the sampled ones
    included); each delivered stream is its request's tokens once."""
    want, wstreams, none = _fleet_run("gather", tmp_path / "g", False)
    assert none == 0 and wstreams == want
    for kill in (False, True):
        got, streams, launched = _fleet_run("kernel", tmp_path / f"k{kill}",
                                            kill)
        assert launched > 0
        assert got == want, kill
        assert streams == want, kill
