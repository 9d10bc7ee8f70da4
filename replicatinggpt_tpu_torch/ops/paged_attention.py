"""Windowed paged attention for one layer of a packed page pool.

The port of ``replicatinggpt_tpu/ops/paged_pallas.py``
``paged_window_attention`` (quantized or not): per slot, a
(W, C) window of fresh query rows attends the STALE pool pages its page
table maps, masked to positions < ``pos``, and then the fresh (W, W)
K/V block causally. Row j of slot b sits at logical position
``pos[b] + j``; the caller scatters the fresh rows into the pool
afterwards (attend-stale-then-write == write-then-attend). A quantized
pool (int8 or fp8 pages, ``k_scales``/``v_scales`` f32 per row or per
row and head) is dequantized in f32, ``f32(q) * scale``; the caller
hands the fresh rows already fake-quantized (``quant.kv``).

The partials mode (the JAX kernel's ``owned=``, ``fold=False``) reads
only the pages an owned mask marks and returns the raw f32 (acc, m, l)
state without the fresh window: what one data shard of a serving mesh
contributes, merged across the shards and folded once by
``sharded_paged_window_attention``.

- ``paged_window_attention_ref``: the plain PyTorch version (the CPU
  path and the card's yardstick of correctness);
- ``paged_window_attention``: the wrapper. A CPU tensor takes the plain
  version; a CUDA tensor launches ``csrc/paged_window_attention.cu`` or
  raises. ``paged_window_attention.launches`` and ``.partials_launches``
  count the kernel's launches in each mode, ``.launches_by_window`` the
  fold mode's by window width W;
- ``fold_fresh_window``, ``localize_tables`` and
  ``sharded_paged_window_attention``: the shard_map wrapper's pieces;
- ``cluster_ranks`` / ``smem_bytes``: the kernel's split of a history
  over a thread-block cluster, and its shared-memory carve-up;
- ``paged_attention_envelope``: which shapes the kernel takes, with the
  failed checks named (the engine's route export reports them).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quant.kv import dequant_gathered
from . import _build

NEG_INF = -1e30   # large-negative instead of -inf: NaN-free masked rows

#: kernel constants (csrc/paged_window_attention.cu: kStages, kMaxTile,
#: kMinTile, kStageBytes, kMaxRanks, kWarps, kMaxSmem)
_STAGES, _MAX_TILE, _MIN_TILE, _STAGE_BYTES = 4, 64, 8, 16384
_MAX_RANKS, _WARPS = 8, 8
_MAX_SMEM = 232_448
_KERNEL = "paged_window_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: pool element codes beside a compute dtype: the same dtype (0), int8,
#: fp8 (csrc/paged_window_attention.cu, csrc/fused_paged_decode_layers.cu)
POOL_CODE = {torch.int8: 1, torch.float8_e4m3fn: 2}


def _pass_rows(window: int) -> int:
    return 1 if window == 1 else 4


def _carve(W: int, D: int, mp: int, isz: int, quantized: bool, tile: int,
           stages: int) -> int:
    ring = stages * 2 * tile * D * isz + (
        stages * 2 * tile * 4 if quantized else 0)
    warps = _WARPS * _pass_rows(W) * (D + 2) * 4
    return max(ring, warps) + 3 * W * D * 4 + W * (D + 2) * 4 + mp * 4


@functools.lru_cache(maxsize=None)
def tile_rows(window: int, head_dim: int, max_pages: int, itemsize: int = 2,
              quantized: bool = False) -> int:
    """History rows of one ring stage (mirrors ``tile_rows`` in the
    kernel): 64, halved while a stage's K+V passes 16 KiB or the CTA, at
    4 stages, the card's shared memory, down to 8."""
    tile = _MAX_TILE
    while tile > _MIN_TILE and (
            2 * tile * head_dim * itemsize > _STAGE_BYTES
            or _carve(window, head_dim, max_pages, itemsize, quantized,
                      tile, _STAGES) > _MAX_SMEM):
        tile //= 2
    return tile


def _span_tiles(window, head_dim, max_pages, page_size, itemsize,
                quantized, span) -> int:
    cap = max_pages * page_size
    span = cap if span is None else min(max(span, 1), cap)
    tile = tile_rows(window, head_dim, max_pages, itemsize, quantized)
    return -(-span // tile)


@functools.lru_cache(maxsize=None)
def cluster_ranks(window: int, head_dim: int, max_pages: int,
                  page_size: int, itemsize: int = 2,
                  quantized: bool = False, span=None) -> int:
    """CTAs of the cluster that serves one (slot, head) (mirrors ``plan``
    in the kernel): the fewest, at most 8, that hold all of their tiles
    of a ``span``-row history in flight at once (4 stages each), times
    the passes over it a wide window makes. ``span``: a bound on every
    slot's pos that the caller holds on the host, the whole table's
    ``max_pages * page_size`` when None; the host never reads ``pos``
    back."""
    tiles = _span_tiles(window, head_dim, max_pages, page_size, itemsize,
                        quantized, span)
    passes = -(-window // _pass_rows(window))
    return max(1, min(_MAX_RANKS, -(-(tiles * passes) // _STAGES)))


@functools.lru_cache(maxsize=None)
def ring_stages(window: int, head_dim: int, max_pages: int, page_size: int,
                itemsize: int = 2, quantized: bool = False,
                span=None) -> int:
    """Stages of a CTA's ring: a rank's tiles of one pass, 2 to 4, fewer
    while the CTA would pass the card's shared memory."""
    tiles = _span_tiles(window, head_dim, max_pages, page_size, itemsize,
                        quantized, span)
    ranks = cluster_ranks(window, head_dim, max_pages, page_size, itemsize,
                          quantized, span)
    stages = min(_STAGES, max(2, -(-tiles // ranks)))
    args = (window, head_dim, max_pages, itemsize, quantized)
    while stages > 2 and _carve(*args, tile_rows(*args), stages) > _MAX_SMEM:
        stages -= 1
    return stages


@functools.lru_cache(maxsize=None)
def smem_bytes(window: int, head_dim: int, max_pages: int, page_size: int,
               itemsize: int = 2, quantized: bool = False,
               span=None) -> int:
    """Dynamic shared memory of one kernel CTA (mirrors ``carve`` at the
    top of the kernel); ``itemsize`` is the pool's element size. No span
    needs more than the whole table's, ``span=None``."""
    args = (window, head_dim, max_pages, itemsize, quantized)
    return _carve(*args, tile_rows(*args),
                  ring_stages(window, head_dim, max_pages, page_size,
                              itemsize, quantized, span))


@functools.lru_cache(maxsize=None)
def paged_attention_envelope(n_head: int, head_dim: int, page_size: int,
                             *, itemsize: int = 2, window: int = 1,
                             max_pages: int = 64, kv_quant: str = "none",
                             granularity: str = "page") -> tuple:
    """``(ok, reasons)`` for the CUDA kernel at these shapes; ``itemsize``
    is the pool's element size (1 for an int8 or fp8 pool). The reasons
    use the JAX envelope's vocabulary where a check has a counterpart."""
    reasons = []
    if kv_quant not in ("none", "int8", "fp8"):
        reasons.append("kv_quant_unknown")
    if granularity not in ("page", "head"):
        reasons.append("granularity_unknown")
    if itemsize not in ((2, 4) if kv_quant == "none" else (1,)):
        reasons.append("dtype")
    vec = 8 if kv_quant == "none" else 16   # elements of a 16-byte load
    if head_dim % vec or not vec <= head_dim <= 256:
        reasons.append("head_dim")
    if smem_bytes(window, head_dim, max_pages, page_size, itemsize,
                  kv_quant != "none") > _MAX_SMEM:
        reasons.append("smem_budget")
    return (not reasons), tuple(reasons)


def paged_kernel_mesh_ok(data: int, model: int, n_pages: int, n_embd: int,
                         n_head: int) -> bool:
    """The JAX package's ``paged_kernel_mesh_ok``: on a mesh larger than
    1x1 the per-layer kernel runs per data shard only where the pages
    divide over 'data' and the channels and heads over 'model' (else the
    engine takes the gather route). The fused all-layers kernel stays
    1x1-only, as in JAX: TP splits the weight matrices it streams."""
    if data * model == 1:
        return True
    return n_pages % data == 0 and n_embd % model == 0 \
        and n_head % model == 0


def gather_history(pages, scales, tab, n_head: int) -> torch.Tensor:
    """The (B, max_pages, page, C) pages of each slot's table as f32,
    dequantized (``f32(q) * scale``) for a quantized pool."""
    g = pages[tab]
    if scales is None:
        return g.float()
    return dequant_gathered(g, scales[tab], True, n_head, torch.float32)


def paged_window_attention_ref(q, k_new, v_new, k_pages, v_pages, tables,
                               pos, *, n_head: int, k_scales=None,
                               v_scales=None, owned=None, fold: bool = True):
    """Plain version. q/k_new/v_new: (B, W, C); k_pages/v_pages:
    (N, page, C); tables: (B, max_pages) int32; pos: (B,) int32; a
    quantized pool's k_scales/v_scales: (N, page) or (N, page, H) f32.
    Returns (B, W, C) in q's dtype; softmax in f32.

    Table entries past a slot's live frontier (page index >= ceil(pos /
    page)) may hold stale ids; they are replaced by page 0 before the
    gather and every position they cover is masked. ``owned`` (B,
    max_pages), bool or int: of the live pages, only those it marks are
    read (one data shard's pages of a sharded pool, whose ids ``tables``
    then holds local to the shard's block; unmarked entries are never
    read). ``fold=False`` attends the history alone and returns the raw
    f32 partials ``(acc (B, W, C), m (B, W, H), l (B, W, H))``: the
    running max, the denominator and the unnormalized sum of the owned
    rows < pos, m = -1e30 and l = acc = 0 where a row owns none."""
    B, W, C = q.shape
    N, psz, _ = k_pages.shape
    mp = tables.shape[1]
    H, D = n_head, C // n_head
    dev = q.device
    pos = pos.to(dev, torch.int64)
    tables = tables.to(dev, torch.int64)
    live = (pos + psz - 1) // psz
    read = torch.arange(mp, device=dev)[None, :] < live[:, None]
    if owned is not None:
        read = read & owned.to(dev).bool()
    tab = torch.where(read, tables, torch.zeros_like(tables))
    S = mp * psz
    kpos = torch.arange(S, device=dev)
    hist = (kpos[None, :] < pos[:, None]) & read.repeat_interleave(psz, 1)

    def heads(x, T):  # (B, T, C) f32 -> (B, H, T, D)
        return x.reshape(B, T, H, D).transpose(1, 2)

    def history(pages, scales):
        return gather_history(pages, scales, tab, H).reshape(B, S, C)

    k_hist, v_hist = history(k_pages, k_scales), history(v_pages, v_scales)
    qh = heads(q.float(), W)
    if not fold:
        mask = hist[:, None, None, :]                         # (B,1,1,S)
        s = (qh @ heads(k_hist, S).transpose(-1, -2)) * D ** -0.5
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = s.amax(-1)                                        # (B, H, W)
        p = torch.where(mask, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        acc = p @ heads(v_hist, S)                            # (B,H,W,D)
        return (acc.transpose(1, 2).reshape(B, W, C), m.transpose(1, 2),
                p.sum(-1).transpose(1, 2))
    k_all = torch.cat([k_hist, k_new.float()], dim=1)
    v_all = torch.cat([v_hist, v_new.float()], dim=1)
    s = (qh @ heads(k_all, S + W).transpose(-1, -2)) * D ** -0.5
    kpos = torch.arange(S + W, device=dev)
    fresh = (kpos[None, :] - S) <= torch.arange(W, device=dev)[:, None]
    fresh = fresh & (kpos >= S)
    mask = torch.cat([hist, torch.zeros((B, W), dtype=torch.bool,
                                        device=dev)], 1)[:, None, :] \
        | fresh[None]                                         # (B, W, S+W)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = p @ heads(v_all, S + W)                             # (B, H, W, D)
    return out.transpose(1, 2).reshape(B, W, C).to(q.dtype)


def fold_fresh_window(acc, m, l, q, k_new, v_new, n_head: int
                      ) -> torch.Tensor:
    """Fold the fresh causal (W, W) window into raw partials (the JAX
    package's ``_fold_fresh_window``, run after the shards' partials are
    merged: the fresh rows are the same on every data shard, so folding
    them per shard would count them twice). acc: (B, W, C) f32; m, l:
    (B, W, H) f32. Returns (B, W, C) f32."""
    B, W, C = q.shape
    H, D = n_head, C // n_head
    qh, knh, vnh = (t.float().reshape(B, W, H, D) for t in (q, k_new, v_new))
    s_new = torch.einsum("bwhd,bjhd->bhwj", qh, knh) * D ** -0.5
    causal = (torch.arange(W, device=q.device)[None, :]
              <= torch.arange(W, device=q.device)[:, None])   # col <= row
    s_new = torch.where(causal, s_new, torch.full_like(s_new, NEG_INF))
    m_h, l_h = m.transpose(1, 2), l.transpose(1, 2)          # (B, H, W)
    m2 = torch.maximum(m_h, s_new.amax(-1))
    alpha = torch.exp(m_h - m2)
    p_new = torch.where(causal, torch.exp(s_new - m2[..., None]),
                        torch.zeros_like(s_new))
    # denom >= the diagonal term > 0 (row j attends itself)
    denom = l_h * alpha + p_new.sum(-1)
    acch = acc.reshape(B, W, H, D).transpose(1, 2)
    out = (acch * alpha[..., None]
           + torch.einsum("bhwj,bjhd->bhwd", p_new, vnh)) / denom[..., None]
    return out.transpose(1, 2).reshape(B, W, C)


def localize_tables(tables, pos, page_size: int, block: int, shards):
    """Per data shard d of ``shards`` (block ``block`` pages, starting at
    ``d * block``): (the table in ids local to the block, the owned mask
    of the live pages that lie in it), both (B, max_pages) int32 (the
    JAX package's ``sharded_paged_window_attention``, ``:499-505``)."""
    tab = tables.to(torch.int64)
    live = (pos.to(torch.int64) + page_size - 1) // page_size
    p_idx = torch.arange(tab.shape[1], device=tab.device)[None, :]
    out = []
    for d in shards:
        lo = d * block
        own = (p_idx < live[:, None]) & (tab >= lo) & (tab < lo + block)
        out.append((torch.where(own, tab - lo, torch.zeros_like(tab))
                    .to(torch.int32).contiguous(),
                    own.to(torch.int32).contiguous()))
    return out


def sharded_paged_window_attention(q, k_new, v_new, k_blocks, v_blocks,
                                   tables, pos, group, *, n_head: int,
                                   k_scales=None, v_scales=None,
                                   local=None, spans=None) -> torch.Tensor:
    """:func:`paged_window_attention` of one model shard over the data
    shards of a serve group (the JAX package's
    ``sharded_paged_window_attention``): each data shard this process
    holds (``group.data_shards``) runs the partials mode over the pages
    it owns, ``group.merge_data`` merges them exactly, and the fresh
    window folds once on the merged state.

    q, k_new, v_new: (B, W, C_loc), the model shard's heads (``n_head``
    of them); k_blocks/v_blocks (and a quantized pool's k_scales/
    v_scales): the shard's page block per held data shard, each (N_loc,
    page, C_loc); tables: (B, max_pages) global page ids; pos: (B,).
    ``local``: ``localize_tables`` of these tables, when the caller made
    it once for every layer; ``spans``: per held data shard, a bound on
    the rows any slot owns there (sizes the kernel's split; None: the
    whole table). Returns (B, W, C_loc) in q's dtype."""
    block, psz = k_blocks[0].shape[:2]
    if local is None:
        local = localize_tables(tables, pos, psz, block, group.data_shards)
    n = len(k_blocks)
    ks = k_scales if k_scales is not None else [None] * n
    vs = v_scales if v_scales is not None else [None] * n
    parts = [paged_window_attention(
        q, k_new, v_new, k_blocks[i], v_blocks[i], local[i][0], pos,
        n_head=n_head, k_scales=ks[i], v_scales=vs[i], owned=local[i][1],
        fold=False, max_pos=None if spans is None else spans[i])
        for i in range(n)]
    acc, m, l = group.merge_data(parts)
    return fold_fresh_window(acc, m, l, q, k_new, v_new,
                             n_head).to(q.dtype)


def _check(q, k_new, v_new, k_pages, v_pages, tables, pos, n_head,
           k_scales, v_scales):
    B, W, C = q.shape
    if C % n_head:
        raise ValueError(f"C={C} not divisible by n_head={n_head}")
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError(f"window shapes differ: q {tuple(q.shape)}, "
                         f"k_new {tuple(k_new.shape)}, v_new "
                         f"{tuple(v_new.shape)}")
    if k_pages.dim() != 3 or k_pages.shape != v_pages.shape \
            or k_pages.shape[2] != C:
        raise ValueError(f"page pools must be (N, page, {C}); got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if tables.dim() != 2 or tables.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"tables must be ({B}, max_pages) and pos "
                         f"({B},); got {tuple(tables.shape)} / "
                         f"{tuple(pos.shape)}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if k_scales is not None:
        N, psz = k_pages.shape[:2]
        if k_scales.shape != v_scales.shape or tuple(k_scales.shape) not in (
                (N, psz), (N, psz, n_head)):
            raise ValueError(f"scales must be ({N}, {psz}) or ({N}, {psz}, "
                             f"{n_head}); got {tuple(k_scales.shape)} / "
                             f"{tuple(v_scales.shape)}")
    scales = () if k_scales is None else (k_scales, v_scales)
    devs = {t.device for t in (q, k_new, v_new, k_pages, v_pages, tables,
                               pos, *scales)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted(map(str, devs))}")


def paged_window_attention(q, k_new, v_new, k_pages, v_pages, tables, pos,
                           *, n_head: int, k_scales=None, v_scales=None,
                           max_pos=None, owned=None, fold: bool = True):
    """Windowed paged attention (see the module docstring for shapes;
    ``owned`` and ``fold=False``, the partials mode, as in the plain
    version). CPU tensors run the plain version; CUDA tensors run the
    kernel, which takes bf16 or f32 contiguous window rows, pages in that
    dtype or (with contiguous f32 scales) int8 / fp8 e4m3, int32 tables,
    pos and owned mask, and shapes inside ``paged_attention_envelope``;
    anything else raises. ``max_pos``: a bound on the history rows any
    slot reads (its pos; with ``owned``, the rows it owns) that the
    caller already holds on the host; it sizes the kernel's split
    (``cluster_ranks``) and never changes the result. None sizes it for
    the whole table. ``launches`` counts the fold mode's launches,
    ``launches_by_window`` the same launches by their W,
    ``partials_launches`` the partials mode's."""
    _check(q, k_new, v_new, k_pages, v_pages, tables, pos, n_head, k_scales,
           v_scales)
    B, W, C = q.shape
    mp = tables.shape[1]
    if owned is not None and (owned.shape != (B, mp)
                              or owned.device != q.device):
        raise ValueError(f"owned must be ({B}, {mp}) on {q.device}; got "
                         f"{tuple(owned.shape)} on {owned.device}")
    if q.device.type == "cpu":
        return paged_window_attention_ref(q, k_new, v_new, k_pages, v_pages,
                                          tables, pos, n_head=n_head,
                                          k_scales=k_scales,
                                          v_scales=v_scales, owned=owned,
                                          fold=fold)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    psz = k_pages.shape[1]
    D = C // n_head
    quantized = k_scales is not None
    pages_ok = (k_pages.dtype in POOL_CODE if quantized
                else k_pages.dtype == q.dtype)
    if q.dtype not in _DTYPE_CODE or k_new.dtype != q.dtype \
            or v_new.dtype != q.dtype or v_pages.dtype != k_pages.dtype \
            or not pages_ok:
        raise TypeError(f"kernel takes bf16 or f32 window rows of one dtype "
                        f"and pages in that dtype, or int8/fp8 pages with "
                        f"scales; got {q.dtype}, {k_new.dtype}, "
                        f"{v_new.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    owned_t = () if owned is None else (owned,)
    if any(t.dtype != torch.int32 for t in (tables, pos, *owned_t)):
        raise TypeError(f"tables, pos and owned must be int32; got "
                        f"{tables.dtype} / {pos.dtype} / "
                        f"{owned.dtype if owned_t else None}")
    scales = (k_scales, v_scales) if quantized else ()
    if any(s.dtype != torch.float32 for s in scales):
        raise TypeError("scales must be float32")
    ts = (q, k_new, v_new, k_pages, v_pages, tables, pos, *scales, *owned_t)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("kernel inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in ts[:5]):
        raise ValueError("q/k/v/page pointers must be 16-byte aligned")
    ok, reasons = paged_attention_envelope(
        n_head, D, psz, itemsize=k_pages.element_size(), window=W,
        max_pages=mp, kv_quant=("none" if not quantized else
                                "int8" if k_pages.dtype == torch.int8
                                else "fp8"))
    if not ok:
        raise ValueError(f"shapes outside the kernel envelope: {reasons}")
    if fold:
        out, parts = torch.empty_like(q), ()
    else:
        f32 = {"dtype": torch.float32, "device": q.device}
        out = None
        parts = (torch.empty((B, W, C), **f32),
                 torch.empty((B, W, n_head), **f32),
                 torch.empty((B, W, n_head), **f32))
    if B == 0:
        return out if fold else parts
    lib = _lib()
    ptr = [t.data_ptr() for t in parts] if parts else [None] * 3
    err = lib.paged_window_attention_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        int(quantized and k_scales.dim() == 3), tables.data_ptr(),
        pos.data_ptr(), owned.data_ptr() if owned is not None else None,
        out.data_ptr() if fold else None, *ptr, B, W, psz, mp, n_head, D,
        mp * psz if max_pos is None else min(max(int(max_pos), 1), mp * psz),
        _DTYPE_CODE[q.dtype], POOL_CODE.get(k_pages.dtype, 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_window_attention launch failed: CUDA "
                           f"error {err}")
    if fold:
        paged_window_attention.launches += 1
        by_w = paged_window_attention.launches_by_window
        by_w[W] = by_w.get(W, 0) + 1
        return out
    paged_window_attention.partials_launches += 1
    return parts


paged_window_attention.launches = 0
paged_window_attention.launches_by_window = {}
paged_window_attention.partials_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(_KERNEL)
    fn = lib.paged_window_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, p, p, p, p, p, p, p, i, i, i,
                       i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib
