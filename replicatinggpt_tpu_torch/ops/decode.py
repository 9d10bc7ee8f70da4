"""The decode kernels of ``generate()`` and of the serving engine, with
their plain versions.

Ports of ``replicatinggpt_tpu/ops/decode_pallas.py``:

- ``fused_decode_supported`` / ``packed_decode_supported``: the JAX
  envelopes, kept as this port's route rule for ``models.gpt.
  decode_step`` (which shapes take which kernel);
- ``packed_decode_attention``: decode attention over a packed (B, S, C)
  STALE cache plus the fresh column, at one shared ``pos``; a CPU tensor
  takes ``packed_decode_attention_ref``, a CUDA tensor launches
  ``csrc/packed_decode_attention.cu`` or raises;
- ``fused_decode_layers``: every layer of one B=1 decode token, from the
  embedded row to the last residual, with every layer's fresh K/V row;
  a CPU tensor takes ``fused_decode_layers_ref`` (which mirrors
  ``_decode_kernel``, ``_ln_row`` and ``_row_matmul`` step by step), a
  CUDA tensor launches ``csrc/fused_decode_layers.cu`` or raises;
- ``fused_paged_decode_supported``: the JAX envelope of the paged
  kernel, the serving engine's route rule;
- ``fused_paged_decode_layers``: every layer of one multi-slot PAGED
  decode step (B slots, per-slot positions, page tables, a pool in the
  compute dtype or int8/fp8 with scales); a CPU tensor takes
  ``fused_paged_decode_layers_ref`` (which mirrors ``_paged_fused_kernel``),
  a CUDA tensor launches ``csrc/fused_paged_decode_layers.cu`` or raises.

The kernels read only the cache rows at positions < ``pos`` and leave
the cache untouched; the caller writes the fresh rows at ``pos``
afterwards (attend-stale-then-write == write-then-attend). ``pos`` is a
host int for the contiguous-cache kernels and a (B,) int32 tensor for
the paged one. Each wrapper counts its kernel launches in ``.launches``.

Numerics, as the TPU kernels: scores and softmax in f32, the
probabilities rounded to the cache dtype before the value product; the
fused kernel casts EVERY block tensor to the compute dtype (layernorm
scales and biases included), and adds each product's bias in f32 before
one rounding (the unfused ``h @ W + b`` rounds twice in bf16), so in
bf16 the fused and unfused routes differ by design. The paged fused
kernel keeps its probabilities in f32 (``_paged_fused_kernel`` does not
round them).
"""

from __future__ import annotations

import ctypes
import operator
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..quant import GRANULARITIES, QUANT_DTYPES
from ..quant.kv import fake_quantize_row_body, pool_quant_mode
from . import _build
from .paged_attention import NEG_INF, POOL_CODE, gather_history

#: the JAX envelopes' budgets (decode_pallas.py FUSED_LAYER_BYTES,
#: PACKED_DECODE_BYTES): TPU VMEM sizes, kept only as the route rule
FUSED_LAYER_BYTES = 6 * 1024 * 1024
PACKED_DECODE_BYTES = 8 * 1024 * 1024
#: the JAX paged kernels' (page, C) K+V block budget and lane count
#: (paged_pallas.py PAGED_DECODE_BYTES, flash_pallas.py LANES)
PAGED_DECODE_BYTES = 4 * 1024 * 1024
_LANES = 128

#: kernel constants (csrc/decode_attention.cuh kThreads, kWarps; the
#: fused kernels' kTileVecs; the card's shared-memory limit)
_THREADS = 256
_WARPS = _THREADS // 32
_TILE_VECS = 8
_MAX_SMEM = 232_448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the paged fused kernel's slots per weight pass, history splits of one
#: (slot, head) at most and rows that earn one (csrc/
#: fused_paged_decode_layers.cu kRB, kMaxAttn, kAttnRows), and the floats
#: of one input row of a product in its shared memory (kInStride)
_RB, _MAX_ATTN, _ATTN_ROWS = 8, 8, 64
_IN_STRIDE = _RB + 4
#: the packed decode kernel's rows that earn a rank, and its cluster's
#: largest size (csrc/packed_decode_attention.cu kRankRows, kMaxRanks)
_RANK_ROWS, _MAX_RANKS = 128, 8
BLOCK_NAMES = ("ln1_scale", "ln1_bias", "qkv_kernel", "qkv_bias",
               "attn_out_kernel", "attn_out_bias", "ln2_scale", "ln2_bias",
               "mlp_up_kernel", "mlp_up_bias", "mlp_down_kernel",
               "mlp_down_bias")


def fused_decode_supported(cfg, batch: int, itemsize: int = 2,
                           seq_len: int = 0) -> bool:
    """The JAX envelope: single stream, head dim in {32, 64, 128, 256},
    S a multiple of 8, one layer's weights + cache within
    FUSED_LAYER_BYTES. ``seq_len`` 0 means cfg.block_size."""
    C, H = cfg.n_embd, cfg.n_head
    S = seq_len or cfg.block_size
    if batch != 1 or C % H != 0:
        return False
    D = C // H
    if D not in (32, 64, 128, 256) or S % 8 != 0:
        return False
    weights = (C * 3 * C + C * C + 2 * C * 4 * C) * itemsize
    cache = 2 * H * S * D * itemsize
    return weights + cache <= FUSED_LAYER_BYTES


def packed_decode_supported(cfg, itemsize: int = 2, seq_len: int = 0) -> bool:
    """The JAX envelope of the packed decode attention: head dim in {32,
    64, 128, 256}, S a multiple of 8, both (S, C) cache blocks within
    PACKED_DECODE_BYTES."""
    C, H = cfg.n_embd, cfg.n_head
    S = seq_len or cfg.block_size
    if C % H != 0:
        return False
    D = C // H
    if D not in (32, 64, 128, 256) or S % 8 != 0:
        return False
    return 2 * S * C * itemsize <= PACKED_DECODE_BYTES


def fused_paged_smem_bytes(n_embd: int, head_dim: int, max_pages: int,
                           itemsize: int) -> int:
    """Shared memory of one paged fused-kernel block (mirrors
    ``smem_total`` in csrc/fused_paged_decode_layers.cu): an mbarrier, the
    reductions, a slot group's layernorm statistics, scale and bias, the
    attention merge's factors, a product's row quarters, a slot group's
    rows (8 C) and a product's inputs (12 C: 8 slots and 4 of padding a
    row): 2 + 2 x 8 + 4 + 16 + 2 C + 160 + 32 x tile columns + 20 C floats;
    and, when they fit, a ring of whatever the card leaves, in whole
    16-byte units. The head dim and the table's width no longer size it
    (kept for the callers)."""
    tile_cols = _TILE_VECS * (16 // itemsize)
    fixed = 4 * (2 + 2 * _WARPS + 4 + 2 * _RB + 2 * n_embd
                 + 2 * _RB * (_MAX_ATTN + 2) + 4 * _RB * tile_cols
                 + (_RB + _IN_STRIDE) * n_embd)
    if fixed > _MAX_SMEM:
        return fixed
    return fixed + ((_MAX_SMEM - fixed) & ~15)


def fused_paged_decode_supported(cfg, n_slots: int, page_size: int,
                                 itemsize: int = 2, kv_quant: str = "none",
                                 granularity: str = "page",
                                 max_pages: int = 0) -> bool:
    """The JAX envelope (``decode_pallas.fused_paged_decode_supported``
    with the shared ``paged_attention_envelope`` checks it calls), kept as
    the serving engine's route rule: packed layout, a known quant mode,
    head dim in {32, 64, 128, 256}, at most 128 heads, pages a multiple
    of 8 rows within the 4 MiB block budget, and one layer's weights + a
    page pair + the (n_slots, C) scratch within FUSED_LAYER_BYTES.
    ``itemsize`` is the POOL's element size (1 for int8/fp8), as the JAX
    engine passes it. On top, the CUDA kernel's own envelope at the
    compute dtype (``max_pages`` 0 means ceil(block_size / page))."""
    if cfg.decode_cache_layout != "packed":
        return False
    C, H = cfg.n_embd, cfg.n_head
    if C % H != 0:
        return False
    D = C // H
    if kv_quant not in QUANT_DTYPES or granularity not in GRANULARITIES:
        return False
    if D not in (32, 64, 128, 256) or H > _LANES or page_size % 8:
        return False
    pages = 2 * page_size * C * itemsize
    if pages > PAGED_DECODE_BYTES:
        return False
    weights = (C * 3 * C + C * C + 2 * C * 4 * C) * itemsize
    scratch = (n_slots + 3) * C * itemsize + C * 4 + 2 * _LANES * 4
    if weights + pages + scratch > FUSED_LAYER_BYTES:
        return False
    cd = torch.empty((), dtype=cfg.compute_dtype).element_size()
    mp = max_pages or -(-cfg.block_size // page_size)
    ok, _ = kernel_envelope(D, cd, fused_paged_smem_bytes(C, D, mp, cd))
    return ok


def _packed_fixed_bytes(rows: int, head_dim: int) -> int:
    return 4 * (rows + 2 * _WARPS + 6 + (_WARPS + _MAX_RANKS) * head_dim)


def packed_decode_split(head_dim: int, itemsize: int, pos: int
                        ) -> Dict[str, int]:
    """The packed decode kernel's split at ``pos`` (mirrors ``split`` in
    csrc/packed_decode_attention.cu): ``ranks`` CTAs of a cluster per
    (row, head), one per 128 history rows, at most 8 (1: a plain grid);
    ``rows`` a rank (contiguous); ``held`` of them in shared memory (the
    rest read in place); ``smem`` bytes of the CTA. ``pos`` is a host int,
    so the split costs no device read."""
    ranks = min(_MAX_RANKS, max(1, -(-pos // _RANK_ROWS)))
    rows = -(-pos // ranks)
    fixed = _packed_fixed_bytes(rows, head_dim)
    row = 2 * head_dim * itemsize
    held = min(rows, max(0, (_MAX_SMEM - fixed) // row))
    return {"ranks": ranks, "rows": rows, "held": held,
            "smem": held * row + fixed}


def attend_smem_bytes(seq_len: int, head_dim: int) -> int:
    """The packed decode kernel's shared memory without its K/V rows, at
    the longest rank that any pos < ``seq_len`` gives (its K/V rows take
    what the card leaves, none at worst): the envelope's figure."""
    worst = max(min(max(seq_len - 1, 0), _RANK_ROWS),
                -(-max(seq_len - 1, 0) // _MAX_RANKS))
    return _packed_fixed_bytes(worst, head_dim)


def fused_smem_bytes(n_embd: int, seq_len: int, head_dim: int,
                     itemsize: int) -> int:
    """Shared memory of one fused-kernel block (mirrors ``smem_total``
    in csrc/fused_decode_layers.cu): an mbarrier and the rows (2 + 3C +
    32 x tile columns + 20 + 2D + S floats) and, when they fit, a ring of
    whatever the card leaves, in whole 16-byte units."""
    tile_cols = _TILE_VECS * (16 // itemsize)
    row_groups = _THREADS // _TILE_VECS
    fixed = 4 * (2 + 3 * n_embd + row_groups * tile_cols
                 + 2 * (_THREADS // 32) + 4 + 2 * head_dim + seq_len)
    if fixed > _MAX_SMEM:
        return fixed
    return fixed + ((_MAX_SMEM - fixed) & ~15)


_PLAN_KEYS = ("grid", "qkv_tiles", "qkv_splits", "qkv_rows", "proj_tiles",
              "proj_splits", "proj_rows", "up_tiles", "up_splits", "up_rows",
              "down_tiles", "down_splits", "down_rows", "part_floats",
              "weight_slots", "kv_rows", "smem", "slot_bytes")
_PLANS: Dict[tuple, Dict[str, int]] = {}


def fused_decode_plan(n_embd: int, n_head: int, seq_len: int,
                      dtype: torch.dtype, device) -> Dict[str, int]:
    """The fused kernel's split on ``device`` at these shapes (built at
    first use): its grid (every block the card holds resident), each
    product's column tiles x input slices of ``*_rows`` rows, the f32
    partials its scratch holds, the weight slots and K/V rows its ring
    holds, and its shared memory."""
    dev = torch.device(device)
    key = (n_embd, n_head, seq_len, dtype, dev.index)
    plan = _PLANS.get(key)
    if plan is None:
        out = (ctypes.c_long * len(_PLAN_KEYS))()
        lib = _lib("fused_decode_layers")
        with torch.cuda.device(dev):
            err = lib.fused_decode_layers_plan(n_embd, n_head, seq_len,
                                               _DTYPE_CODE[dtype], out)
        if err != 0:
            raise RuntimeError(f"fused_decode_layers plan failed: CUDA "
                               f"error {err}")
        plan = _PLANS[key] = dict(zip(_PLAN_KEYS, out))
    return plan


_PAGED_PLAN_KEYS = ("grid", "qkv_tiles", "qkv_splits", "qkv_rows",
                    "proj_tiles", "proj_splits", "proj_rows", "up_tiles",
                    "up_splits", "up_rows", "down_tiles", "down_splits",
                    "down_rows", "part_row", "weight_slots", "kv_rows",
                    "smem", "slot_bytes", "attn_split_rows",
                    "attn_splits_max")


def fused_paged_decode_plan(n_embd: int, n_head: int, table_rows: int,
                            dtype: torch.dtype, pool: torch.dtype,
                            device) -> Dict[str, int]:
    """The paged fused kernel's split on ``device`` at these shapes
    (built at first use, cached per shape, dtype, pool type and device):
    its grid (every block the card holds resident), each product's column
    tiles x input slices of ``*_rows`` rows, the partial floats a slot,
    the weight slots and history rows its ring holds, its shared memory.
    ``table_rows``: max_pages x page size; ``pool``: the pool's dtype."""
    dev = torch.device(device)
    key = ("paged", n_embd, n_head, table_rows, dtype, pool, dev.index)
    plan = _PLANS.get(key)
    if plan is None:
        out = (ctypes.c_long * len(_PAGED_PLAN_KEYS))()
        lib = _lib("fused_paged_decode_layers")
        with torch.cuda.device(dev):
            err = lib.fused_paged_decode_layers_plan(
                n_embd, n_head, table_rows, _DTYPE_CODE[dtype],
                POOL_CODE.get(pool, 0), out)
        if err != 0:
            raise RuntimeError(f"fused_paged_decode_layers plan failed: "
                               f"CUDA error {err}")
        plan = _PLANS[key] = dict(zip(_PAGED_PLAN_KEYS, out))
    return plan


def fused_paged_attn_splits(span: int, n_slots: int, n_head: int,
                            grid: int) -> int:
    """History splits of one (slot, head) in the paged fused kernel
    (mirrors ``attn_splits``): one per 64 rows of ``span`` (the caller's
    bound on every slot's pos), at most 8, and no more attention items
    than the grid where that allows."""
    ns = min(_MAX_ATTN, -(-max(span, 1) // _ATTN_ROWS),
             grid // (n_slots * n_head))
    return max(1, ns)


def fused_paged_scratch_floats(plan: Dict[str, int], n_slots: int,
                               n_layer: int, n_embd: int, n_head: int,
                               itemsize: int) -> int:
    """The paged fused kernel's f32 scratch (``run`` in the kernel): the
    products' partials, the attention records ((D + 4) floats, 9 a
    (slot, head)), the residual after attention; then the heads' counters
    and the product tiles' (one slot per 128-byte column tile of the
    widest product, four products)."""
    C, D = n_embd, n_embd // n_head
    tiles = -(-4 * C // (_TILE_VECS * 16 // itemsize))
    return (n_slots * (plan["part_row"] + n_head * (_MAX_ATTN + 1) * (D + 4)
                       + C) + n_layer * n_head + 4 * tiles)


def kernel_envelope(head_dim: int, itemsize: int, smem: int) -> tuple:
    """``(ok, reasons)`` for either kernel: bf16 or f32, a head dim of
    whole 16-byte vectors that divides the block's 256 threads, and the
    block's shared memory within the card's limit."""
    reasons = []
    if itemsize not in (2, 4):
        reasons.append("dtype")
    if head_dim % (16 // max(itemsize, 1)) or _THREADS % head_dim \
            or head_dim > _THREADS:
        reasons.append("head_dim")
    if smem > _MAX_SMEM:
        reasons.append("smem_budget")
    return (not reasons), tuple(reasons)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _attend_stale(q, k_new, v_new, kc, vc, n_head: int) -> torch.Tensor:
    """One decode row per batch entry against its stale rows and the
    fresh column. q/k_new/v_new: (B, C); kc/vc: (B, H, pos, D) (only the
    rows < pos). Returns (B, C) f32, before the caller's cast."""
    B, C = q.shape
    H, D = n_head, C // n_head
    scale = D ** -0.5
    qh = q.float().reshape(B, H, D)
    s = (kc.float() @ qh[..., None])[..., 0] * scale          # (B, H, pos)
    s_new = (k_new.float().reshape(B, H, D) * qh).sum(-1) * scale
    m = torch.maximum(s.amax(-1), s_new) if s.shape[-1] else s_new
    p = torch.exp(s - m[..., None])
    p_new = torch.exp(s_new - m)
    denom = p.sum(-1) + p_new
    w = (p / denom[..., None]).to(vc.dtype).float()
    pv = (w[..., None, :] @ vc.float())[..., 0, :]             # (B, H, D)
    w_new = (p_new / denom).to(v_new.dtype).float()
    out = pv + w_new[..., None] * v_new.float().reshape(B, H, D)
    return out.reshape(B, C)


def packed_decode_attention_ref(q, k_new, v_new, k_cache, v_cache, pos: int,
                                *, n_head: int) -> torch.Tensor:
    """Plain version. q/k_new/v_new: (B, C); caches (B, S, C), stale at
    ``pos``; only rows < pos are read. Returns (B, C) in q's dtype."""
    B, _, C = k_cache.shape
    H, D = n_head, C // n_head

    def heads(c):
        return c[:, :pos].reshape(B, pos, H, D).transpose(1, 2)

    return _attend_stale(q, k_new, v_new, heads(k_cache), heads(v_cache),
                         H).to(q.dtype)


def _ln_row(x, scale, bias, eps: float):
    """(1, C) layernorm, f32 statistics, result in x's dtype (``_ln_row``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _row_matmul(h, w, b):
    """``h @ w + b`` accumulated in f32 with the bias added before the
    one rounding to h's dtype (``_row_matmul``)."""
    return (h.float() @ w.float() + b.float()).to(h.dtype)


def _stale_layer(c_layer, pos: int, packed: bool, n_head: int):
    """One layer's cache, (1, S, C) packed or (1, H, S, D) heads, as its
    (1, H, pos, D) stale rows."""
    if packed:
        B, _, C = c_layer.shape
        return c_layer[:, :pos].reshape(B, pos, n_head,
                                        C // n_head).transpose(1, 2)
    return c_layer[:, :, :pos]


def fused_decode_layers_ref(x0, blocks: Dict[str, torch.Tensor], pos: int,
                            cache: Dict[str, torch.Tensor], cfg
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the fused kernel. x0: (1, C) embedded row in the
    compute dtype; blocks: the layer-stacked block tensors (cast to
    x0's dtype here, layernorm parameters included); cache: (L, 1, H,
    S, D) heads or (L, 1, S, C) packed, per ``cfg.decode_cache_layout``,
    read only at rows < pos. Returns (x (1, C), newk (L, 1, C), newv (L,
    1, C)), all in x0's dtype."""
    cd = x0.dtype
    w = {n: blocks[n].to(cd) for n in BLOCK_NAMES}
    packed = cfg.decode_cache_layout == "packed"
    L = w["qkv_kernel"].shape[0]
    C = x0.shape[-1]
    H = cfg.n_head
    eps = cfg.layernorm_eps
    x = x0
    newk, newv = [], []
    for i in range(L):
        h = _ln_row(x, w["ln1_scale"][i], w["ln1_bias"][i], eps)
        qkv = _row_matmul(h, w["qkv_kernel"][i], w["qkv_bias"][i])
        q, k_new, v_new = qkv.split(C, dim=-1)
        kc = _stale_layer(cache["k"][i], pos, packed, H)
        vc = _stale_layer(cache["v"][i], pos, packed, H)
        attn = _attend_stale(q, k_new, v_new, kc, vc, H).to(cd)
        newk.append(k_new)
        newv.append(v_new)
        attn = _row_matmul(attn, w["attn_out_kernel"][i],
                           w["attn_out_bias"][i])
        x_mid = x + attn
        h = _ln_row(x_mid, w["ln2_scale"][i], w["ln2_bias"][i], eps)
        h = _row_matmul(h, w["mlp_up_kernel"][i], w["mlp_up_bias"][i])
        h = (F.gelu(h.float(), approximate="tanh") if cfg.activation == "gelu"
             else F.relu(h.float())).to(cd)
        h = _row_matmul(h, w["mlp_down_kernel"][i], w["mlp_down_bias"][i])
        x = x_mid + h
    return x, torch.stack(newk), torch.stack(newv)


def fused_paged_decode_layers_ref(x0, blocks: Dict[str, torch.Tensor],
                                  pos, tables,
                                  cache: Dict[str, torch.Tensor], cfg
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain version of the paged fused kernel. x0: (B, C) embedded rows
    in the compute dtype; blocks: the layer-stacked block tensors (cast
    to x0's dtype here); pos: (B,) positions (inactive slots at 0);
    tables: (B, max_pages); cache: a packed pool (L, N, page, C), with
    ``ks``/``vs`` scales when quantized, read only at rows < pos of each
    slot. Returns (x (B, C), newk (L, B, C), newv (L, B, C)), the raw
    fresh rows, all in x0's dtype."""
    cd = x0.dtype
    dev = x0.device
    w = {n: blocks[n].to(cd) for n in BLOCK_NAMES}
    kv_dtype, gran = pool_quant_mode(cache)
    L, N, psz, C = cache["k"].shape
    B, mp = tables.shape
    H = cfg.n_head
    D = C // H
    S = mp * psz
    eps = cfg.layernorm_eps
    scale = D ** -0.5
    pos = pos.to(dev, torch.int64)
    live = (pos + psz - 1) // psz
    owned = torch.arange(mp, device=dev)[None, :] < live[:, None]
    tab = torch.where(owned, tables.to(dev, torch.int64), 0)
    valid = torch.arange(S, device=dev)[None, :] < pos[:, None]   # (B, S)

    def history(name, i):   # (B, S, H, D) f32; rows >= pos never read
        sc = cache[name + "s"][i] if kv_dtype is not None else None
        g = gather_history(cache[name][i], sc, tab, H).reshape(B, S, C)
        return torch.where(valid[..., None], g, 0.0).reshape(B, S, H, D)

    x = x0
    newk, newv = [], []
    for i in range(L):
        h = _ln_row(x, w["ln1_scale"][i], w["ln1_bias"][i], eps)
        qkv = _row_matmul(h, w["qkv_kernel"][i], w["qkv_bias"][i])
        q, k_row, v_row = qkv.split(C, dim=-1)
        newk.append(k_row)
        newv.append(v_row)
        if kv_dtype is not None:    # attend what the write will store
            k_row, v_row = (fake_quantize_row_body(t, kv_dtype, H, gran)
                            .to(cd) for t in (k_row, v_row))
        qh = q.float().reshape(B, H, D)
        s = torch.einsum("bhd,bshd->bhs", qh, history("k", i)) * scale
        s = torch.where(valid[:, None, :], s, NEG_INF)
        s_new = (k_row.float().reshape(B, H, D) * qh).sum(-1) * scale
        m = torch.maximum(s.amax(-1), s_new)
        p = torch.where(valid[:, None, :], torch.exp(s - m[..., None]), 0.0)
        p_new = torch.exp(s_new - m)
        denom = p.sum(-1) + p_new
        out = (torch.einsum("bhs,bshd->bhd", p, history("v", i))
               + p_new[..., None] * v_row.float().reshape(B, H, D))
        attn = (out / denom[..., None]).reshape(B, C).to(cd)
        attn = _row_matmul(attn, w["attn_out_kernel"][i],
                           w["attn_out_bias"][i])
        x_mid = x + attn
        h = _ln_row(x_mid, w["ln2_scale"][i], w["ln2_bias"][i], eps)
        h = _row_matmul(h, w["mlp_up_kernel"][i], w["mlp_up_bias"][i])
        h = (F.gelu(h.float(), approximate="tanh") if cfg.activation == "gelu"
             else F.relu(h.float())).to(cd)
        h = _row_matmul(h, w["mlp_down_kernel"][i], w["mlp_down_bias"][i])
        x = x_mid + h
    return x, torch.stack(newk), torch.stack(newv)


def fused_weights(blocks: Dict[str, torch.Tensor], dtype: torch.dtype
                  ) -> Dict[str, torch.Tensor]:
    """The block tensors as the fused kernel takes them: every one in
    ``dtype`` (the TPU kernel's cast, layernorm parameters included) and
    contiguous. Callers make this once per set of weights."""
    return {n: blocks[n].to(dtype).contiguous() for n in BLOCK_NAMES}


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_dtype(what: str, ref: torch.dtype, *ts) -> None:
    if ref not in _DTYPE_CODE or any(t.dtype != ref for t in ts):
        raise TypeError(f"{what} takes bf16 or f32 tensors of one dtype; "
                        f"got {sorted({str(t.dtype) for t in ts})}")


def _check_aligned(what: str, *ts) -> None:
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: tensor pointers must be 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def packed_decode_attention(q, k_new, v_new, k_cache, v_cache, pos: int,
                            *, n_head: int) -> torch.Tensor:
    """Decode attention for the packed cache (see the module docstring).
    q/k_new/v_new: (B, C) rows with unit column stride sharing one row
    stride (slices of the (B, 3C) fused projection are taken as they
    are); caches: contiguous (B, S, C); 0 <= pos < S. CPU tensors run the
    plain version; CUDA tensors run the kernel or raise."""
    pos = operator.index(pos)
    if q.dim() != 2 or k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError(f"q/k_new/v_new must be one (B, C) shape; got "
                         f"{tuple(q.shape)}, {tuple(k_new.shape)}, "
                         f"{tuple(v_new.shape)}")
    B, C = q.shape
    if C % n_head:
        raise ValueError(f"C={C} not divisible by n_head={n_head}")
    if k_cache.dim() != 3 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[2] != C:
        raise ValueError(f"caches must be ({B}, S, {C}); got "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    S = k_cache.shape[1]
    if not 0 <= pos < S:
        raise IndexError(f"pos {pos} outside [0, {S})")
    if len({t.device for t in (q, k_new, v_new, k_cache, v_cache)}) != 1:
        raise ValueError("inputs on several devices")
    if q.device.type == "cpu":
        return packed_decode_attention_ref(q, k_new, v_new, k_cache, v_cache,
                                           pos, n_head=n_head)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_dtype("packed_decode_attention", q.dtype, q, k_new, v_new,
                 k_cache, v_cache)
    rows = (q, k_new, v_new)
    ld = q.stride(0)
    if any(t.stride(1) != 1 or t.stride(0) != ld for t in rows) \
            or (ld * q.element_size()) % 16 \
            or not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("packed_decode_attention takes q/k_new/v_new with "
                         "unit column stride and one 16-byte-multiple row "
                         "stride, and contiguous caches")
    _check_aligned("packed_decode_attention", *rows, k_cache, v_cache)
    D = C // n_head
    ok, reasons = kernel_envelope(D, q.element_size(),
                                  attend_smem_bytes(S, D))
    if not ok:
        raise ValueError(f"shapes outside the kernel envelope: {reasons}")
    out = torch.empty((B, C), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    lib = _lib("packed_decode_attention")
    err = lib.packed_decode_attention_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), B, ld, S, n_head, D, pos,
        _DTYPE_CODE[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"packed_decode_attention launch failed: CUDA "
                           f"error {err}")
    packed_decode_attention.launches += 1
    return out


packed_decode_attention.launches = 0


def fused_decode_layers(x0, blocks: Dict[str, torch.Tensor], pos: int,
                        cache: Dict[str, torch.Tensor], cfg
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All layers of one B=1 decode token (see the module docstring):
    returns (x (1, C), newk (L, 1, C), newv (L, 1, C)); the cache is
    read at rows < pos and not written. CPU tensors run the plain
    version. On CUDA tensors every block tensor and the cache must
    already be contiguous in x0's dtype (``fused_weights`` makes them
    so); the kernel launches or the call raises."""
    pos = operator.index(pos)
    packed = cfg.decode_cache_layout == "packed"
    H = cfg.n_head
    if x0.dim() != 2 or x0.shape[0] != 1:
        raise ValueError(f"x0 must be (1, C); got {tuple(x0.shape)}")
    C = x0.shape[1]
    if C % H:
        raise ValueError(f"C={C} not divisible by n_head={H}")
    D = C // H
    L = blocks["qkv_kernel"].shape[0]
    S = cache["k"].shape[2 if packed else 3]
    want = (L, 1, S, C) if packed else (L, 1, H, S, D)
    if tuple(cache["k"].shape) != want or tuple(cache["v"].shape) != want:
        raise ValueError(f"cache must be {want} ({cfg.decode_cache_layout} "
                         f"layout); got {tuple(cache['k'].shape)} / "
                         f"{tuple(cache['v'].shape)}")
    if not 0 <= pos < S:
        raise IndexError(f"pos {pos} outside [0, {S})")
    if x0.device.type == "cpu":
        return fused_decode_layers_ref(x0, blocks, pos, cache, cfg)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    ws = [blocks[n] for n in BLOCK_NAMES]
    shapes = _block_shapes(L, C)
    bad = [n for n in BLOCK_NAMES if tuple(blocks[n].shape) != shapes[n]]
    if bad:
        raise ValueError(f"block tensors of the wrong shape: {bad}")
    ts = [x0, *ws, cache["k"], cache["v"]]
    _check_dtype("fused_decode_layers", x0.dtype, *ts)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_decode_layers takes contiguous tensors "
                         "(see fused_weights)")
    if len({t.device for t in ts}) != 1:
        raise ValueError("inputs on several devices")
    _check_aligned("fused_decode_layers", *ts)
    isz = x0.element_size()
    ok, reasons = kernel_envelope(D, isz, fused_smem_bytes(C, S, D, isz))
    if not ok:
        raise ValueError(f"shapes outside the kernel envelope: {reasons}")
    dev, dt = x0.device, x0.dtype
    xout = torch.empty((1, C), dtype=dt, device=dev)
    newk = torch.empty((L, 1, C), dtype=dt, device=dev)
    newv = torch.empty((L, 1, C), dtype=dt, device=dev)
    plan = fused_decode_plan(C, H, S, dt, dev)
    partials = torch.empty(plan["part_floats"], dtype=torch.float32,
                           device=dev)
    ptrs = (ctypes.c_void_p * 19)(*(t.data_ptr() for t in (
        *ts, xout, newk, newv, partials)))
    lib = _lib("fused_decode_layers")
    err = lib.fused_decode_layers_launch(
        ptrs, L, C, H, S, pos, int(packed), int(cfg.activation == "gelu"),
        cfg.layernorm_eps, _DTYPE_CODE[dt], plan["grid"], _stream(x0))
    if err != 0:
        raise RuntimeError(f"fused_decode_layers launch failed: CUDA error "
                           f"{err}")
    fused_decode_layers.launches += 1
    return xout, newk, newv


fused_decode_layers.launches = 0


def _block_shapes(L: int, C: int) -> Dict[str, tuple]:
    return {"ln1_scale": (L, C), "ln1_bias": (L, C),
            "qkv_kernel": (L, C, 3 * C), "qkv_bias": (L, 3 * C),
            "attn_out_kernel": (L, C, C), "attn_out_bias": (L, C),
            "ln2_scale": (L, C), "ln2_bias": (L, C),
            "mlp_up_kernel": (L, C, 4 * C), "mlp_up_bias": (L, 4 * C),
            "mlp_down_kernel": (L, 4 * C, C), "mlp_down_bias": (L, C)}


def fused_paged_decode_layers(x0, blocks: Dict[str, torch.Tensor], pos,
                              tables, cache: Dict[str, torch.Tensor], cfg,
                              *, max_pos=None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """All layers of one multi-slot paged decode step (see the module
    docstring and ``fused_paged_decode_layers_ref`` for shapes): returns
    (x (B, C), newk (L, B, C), newv (L, B, C)); the pool is read at each
    slot's rows < pos and not written. CPU tensors run the plain
    version. On CUDA tensors every block tensor must already be
    contiguous in x0's dtype (``fused_weights``), the pool contiguous in
    that dtype or int8 / fp8 e4m3 with contiguous f32 scales, tables and
    pos int32; the kernel launches or the call raises. ``max_pos``: a
    bound on every slot's pos that the caller holds on the host (the
    engine's step has it); it sizes the kernel's split of each history
    (any value gives the right result), the whole table's rows when
    None."""
    H = cfg.n_head
    if x0.dim() != 2:
        raise ValueError(f"x0 must be (B, C); got {tuple(x0.shape)}")
    B, C = x0.shape
    if C % H:
        raise ValueError(f"C={C} not divisible by n_head={H}")
    D = C // H
    L = blocks["qkv_kernel"].shape[0]
    kc, vc = cache["k"], cache["v"]
    if kc.dim() != 4 or kc.shape != vc.shape or kc.shape[0] != L \
            or kc.shape[3] != C:
        raise ValueError(f"pool must be packed ({L}, N, page, {C}); got "
                         f"{tuple(kc.shape)} / {tuple(vc.shape)}")
    _, N, psz, _ = kc.shape
    if tables.dim() != 2 or tables.shape[0] != B or tuple(pos.shape) != (B,):
        raise ValueError(f"tables must be ({B}, max_pages) and pos ({B},); "
                         f"got {tuple(tables.shape)} / {tuple(pos.shape)}")
    kv_dtype, gran = pool_quant_mode(cache)
    scales = ()
    if kv_dtype is not None:
        want = (L, N, psz, H) if gran == "head" else (L, N, psz)
        scales = (cache["ks"], cache["vs"])
        if any(tuple(t.shape) != want for t in scales):
            raise ValueError(f"scales must be {want}; got "
                             f"{[tuple(t.shape) for t in scales]}")
    if x0.device.type == "cpu":
        return fused_paged_decode_layers_ref(x0, blocks, pos, tables, cache,
                                             cfg)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    shapes = _block_shapes(L, C)
    bad = [n for n in BLOCK_NAMES if tuple(blocks[n].shape) != shapes[n]]
    if bad:
        raise ValueError(f"block tensors of the wrong shape: {bad}")
    ws = [blocks[n] for n in BLOCK_NAMES]
    _check_dtype("fused_paged_decode_layers", x0.dtype, x0, *ws)
    if kv_dtype is None:
        _check_dtype("fused_paged_decode_layers", x0.dtype, kc, vc)
    elif kc.dtype not in POOL_CODE or vc.dtype != kc.dtype \
            or any(t.dtype != torch.float32 for t in scales):
        raise TypeError(f"a quantized pool takes int8 or fp8 pages and f32 "
                        f"scales; got {kc.dtype}, {vc.dtype}, "
                        f"{[t.dtype for t in scales]}")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"tables and pos must be int32; got {tables.dtype} "
                        f"/ {pos.dtype}")
    ts = [x0, *ws, kc, vc, *scales, tables, pos]
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_paged_decode_layers takes contiguous tensors "
                         "(see fused_weights)")
    if len({t.device for t in ts}) != 1:
        raise ValueError("inputs on several devices")
    _check_aligned("fused_paged_decode_layers", x0, *ws, kc, vc)
    isz = x0.element_size()
    mp = tables.shape[1]
    ok, reasons = kernel_envelope(D, isz, fused_paged_smem_bytes(C, D, mp,
                                                                 isz))
    if D % 16 and kv_dtype is not None:
        reasons, ok = reasons + ("head_dim",), False
    if not ok:
        raise ValueError(f"shapes outside the kernel envelope: {reasons}")
    dev, dt = x0.device, x0.dtype
    xout = torch.empty((B, C), dtype=dt, device=dev)
    newk = torch.empty((L, B, C), dtype=dt, device=dev)
    newv = torch.empty((L, B, C), dtype=dt, device=dev)
    if B == 0:
        return xout, newk, newv
    plan = fused_paged_decode_plan(C, H, mp * psz, dt, kc.dtype, dev)
    scratch = torch.empty(fused_paged_scratch_floats(plan, B, L, C, H,
                                                     x0.element_size()),
                          dtype=torch.float32, device=dev)
    span = mp * psz if max_pos is None else operator.index(max_pos)
    sp = [t.data_ptr() for t in scales] or [None, None]
    ptrs = (ctypes.c_void_p * 23)(
        *(t.data_ptr() for t in (x0, *ws, kc, vc)), *sp, tables.data_ptr(),
        pos.data_ptr(), *(t.data_ptr() for t in (xout, newk, newv, scratch)))
    lib = _lib("fused_paged_decode_layers")
    err = lib.fused_paged_decode_layers_launch(
        ptrs, L, B, C, H, N, psz, mp, span, int(cfg.activation == "gelu"),
        int(gran == "head"), cfg.layernorm_eps, _DTYPE_CODE[dt],
        POOL_CODE.get(kc.dtype, 0), plan["grid"], _stream(x0))
    if err != 0:
        raise RuntimeError(f"fused_paged_decode_layers launch failed: CUDA "
                           f"error {err}")
    fused_paged_decode_layers.launches += 1
    return xout, newk, newv


fused_paged_decode_layers.launches = 0


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        longs = ctypes.POINTER(ctypes.c_long)
        if name == "packed_decode_attention":
            fn.argtypes = [p, p, p, p, p, p, i, ctypes.c_long, i, i, i, i, i,
                           p]
            split = lib.packed_decode_attention_split
            split.argtypes = [i, i, i, longs]
            split.restype = ctypes.c_int
        elif name == "fused_paged_decode_layers":
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), i, i, i, i, i, i,
                           i, i, i, i, ctypes.c_float, i, i, i, p]
            plan = lib.fused_paged_decode_layers_plan
            plan.argtypes = [i, i, i, i, i, longs]
            plan.restype = ctypes.c_int
        else:
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), i, i, i, i, i, i,
                           i, ctypes.c_float, i, i, p]
            plan = lib.fused_decode_layers_plan
            plan.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_long)]
            plan.restype = ctypes.c_int
            probe = lib.fused_decode_barrier_probe
            probe.argtypes = [i, i, i, i, i, p]
            probe.restype = ctypes.c_int
        fn.restype = ctypes.c_int
    return lib
