"""KV page quantization: quantize-on-write, dequant-on-gather.

The port of ``replicatinggpt_tpu/quant/kv.py``. The paged pool's write
sites (``models.gpt._scatter_kv`` and the fused decode route) hand each
fresh K/V row here and write the returned (quantized row, scale) pair
at the SAME (layer, physical page, offset) coordinates: the scales are
two more pool tensors (``ks``/``vs``) in the cache dict, so copy-on-write
page copies, eviction and radix prefix sharing carry them with the rows.
Gathers dequantize right after the page gather (``dequant_gathered``);
the CUDA paged kernels do the same multiply inside their loops.

Numerics, as the JAX package's: quantization math runs in float32
whatever the compute dtype. ``scale = max(amax / qmax, SCALE_EPS)``,
then ``q = clip(round_half_even(x / scale), -qmax, qmax)`` for int8, or
``x / scale`` clipped to +-448 and cast ONCE from float32 to
``torch.float8_e4m3fn`` for fp8 (a detour through bf16 or f16 would
round twice). Dequantization is ``f32(q) * scale``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

#: floor on a row's scale: an all-zero row (pool init, padding) must
#: dequantize to exactly zero, never divide by zero
SCALE_EPS = 1e-8

_STORE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_QMAX = {"int8": 127.0, "fp8": 448.0}


def kv_store_dtype(kv_dtype: str) -> torch.dtype:
    """Storage dtype of a quantized pool's K/V tensors."""
    return _STORE[kv_dtype]


def kv_qmax(kv_dtype: str) -> float:
    """Largest magnitude the storage dtype holds (int8 symmetric 127;
    fp8 e4m3 448)."""
    return _QMAX[kv_dtype]


def kv_itemsize(kv_dtype: str, cfg=None) -> int:
    """Bytes per stored K/V element ("none" = the compute dtype's)."""
    if kv_dtype == "none":
        if cfg is None:
            return 2
        return torch.empty((), dtype=cfg.compute_dtype).element_size()
    return 1


def scale_bytes_per_token(kv_dtype: str, granularity: str,
                          n_head: int) -> int:
    """Scale bytes per token position per layer (K + V): 2 x f32 at page
    granularity, 2 x H x f32 at head granularity."""
    if kv_dtype == "none":
        return 0
    return 2 * 4 * (n_head if granularity == "head" else 1)


def pool_quant_mode(cache: Dict[str, torch.Tensor]
                    ) -> Tuple[Optional[str], Optional[str]]:
    """(kv_dtype, granularity) of a paged pool, read off its tensors;
    ``(None, None)`` for an unquantized pool."""
    if "ks" not in cache:
        return None, None
    kv_dtype = "int8" if cache["k"].dtype == torch.int8 else "fp8"
    # packed pool (L,N,psz,C) / heads pool (L,N,H,psz,D); page-granularity
    # scales are (L,N,psz) either way, head granularity adds the H axis
    gran = "head" if cache["ks"].dim() == 4 else "page"
    return kv_dtype, gran


def init_scales(cfg, n_pages: int, page_size: int, granularity: str,
                device=None) -> Dict[str, torch.Tensor]:
    """Zero scale tensors for a fresh pool (an unwritten row dequantizes
    to exactly zero). Two distinct tensors, as the JAX package keeps
    two distinct arrays."""
    if granularity == "head":
        if cfg.decode_cache_layout == "packed":
            shape = (cfg.n_layer, n_pages, page_size, cfg.n_head)
        else:
            shape = (cfg.n_layer, n_pages, cfg.n_head, page_size)
    else:
        shape = (cfg.n_layer, n_pages, page_size)
    return {"ks": torch.zeros(shape, dtype=torch.float32, device=device),
            "vs": torch.zeros(shape, dtype=torch.float32, device=device)}


def _cast(q: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """Clip the scaled f32 values and cast them to the storage dtype."""
    qmax = kv_qmax(kv_dtype)
    if kv_dtype == "int8":
        return torch.clamp(torch.round(q), -qmax, qmax).to(torch.int8)
    return torch.clamp(q, -qmax, qmax).to(torch.float8_e4m3fn)


def row_amax(rows: torch.Tensor) -> torch.Tensor:
    """|x| max of each (..., C) row in f32: a page-granularity scale's
    input, which model shards holding columns of one row take the max
    of (``quantize_rows(..., amax=)``)."""
    return rows.float().abs().amax(-1)


def quantize_rows(rows: torch.Tensor, kv_dtype: str, n_head: int,
                  granularity: str, amax=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize merged K or V rows (..., C) for a pool write.

    Returns ``(q, scale)``: ``q`` (..., C) in the storage dtype and
    ``scale`` (...,) float32 at page granularity or (..., H) at head
    granularity. An all-zero row gets ``SCALE_EPS`` and round-trips to
    exact zero. ``amax`` (page granularity): the whole row's ``row_amax``
    where ``rows`` holds one model shard's columns of it."""
    qmax = kv_qmax(kv_dtype)
    f = rows.float()
    if granularity == "head":
        fh = f.reshape(*f.shape[:-1], n_head, f.shape[-1] // n_head)
        scale = torch.clamp(fh.abs().amax(-1) / qmax, min=SCALE_EPS)
        q = (fh / scale[..., None]).reshape(f.shape)
    else:
        amax = row_amax(f) if amax is None else amax
        scale = torch.clamp(amax / qmax, min=SCALE_EPS)
        q = f / scale[..., None]
    return _cast(q, kv_dtype), scale


def fake_quantize_rows(rows: torch.Tensor, kv_dtype: str, n_head: int,
                       granularity: str, amax=None) -> torch.Tensor:
    """Quantize then dequantize (f32 out): what a fresh row is worth once
    it lands in the pool. The kernel routes attend this for the fresh
    column, so that attending the stale pool plus the fresh column equals
    writing first and attending after. ``amax`` as in ``quantize_rows``."""
    q, scale = quantize_rows(rows, kv_dtype, n_head, granularity, amax)
    if granularity == "head":
        qh = q.float().reshape(*q.shape[:-1], n_head, q.shape[-1] // n_head)
        return (qh * scale[..., None]).reshape(q.shape)
    return q.float() * scale[..., None]


def _fake_quantize_span_f32(f: torch.Tensor, kv_dtype: str,
                            eps: float = SCALE_EPS) -> torch.Tensor:
    """One scale span per last-axis row (a whole row at page granularity,
    one head's lanes at head granularity) through quantize -> dequantize
    in f32. int8 values are integers within +-qmax, exact in f32, so the
    int cast is skipped; fp8 keeps the real e4m3 cast."""
    qmax = kv_qmax(kv_dtype)
    s = torch.clamp(f.abs().amax(-1, keepdim=True) / qmax, min=eps)
    if kv_dtype == "int8":
        return torch.clamp(torch.round(f / s), -qmax, qmax) * s
    q = torch.clamp(f / s, -qmax, qmax).to(torch.float8_e4m3fn)
    return q.float() * s


def fake_quantize_row_body(rows: torch.Tensor, kv_dtype: str, n_head: int,
                           granularity: str,
                           eps: float = SCALE_EPS) -> torch.Tensor:
    """The kernel-body form of :func:`fake_quantize_rows` for merged rows
    (..., C): the span math per row, or per head's D lanes at head
    granularity (what the fused paged decode kernel applies to its fresh
    K/V column). Value-identical to :func:`fake_quantize_rows`."""
    f = rows.float()
    if granularity == "head":
        D = f.shape[-1] // n_head
        fh = f.reshape(*f.shape[:-1], n_head, D)
        return _fake_quantize_span_f32(fh, kv_dtype, eps).reshape(f.shape)
    return _fake_quantize_span_f32(f, kv_dtype, eps)


def dequant_gathered(g: torch.Tensor, s: torch.Tensor, packed: bool,
                     n_head: int, cd: torch.dtype) -> torch.Tensor:
    """Dequantize a page-gathered view back to the compute dtype.

    ``g``: (B, mp, psz, C) packed or (B, mp, H, psz, D) heads layout,
    fresh off ``pool[tables]``; ``s``: the same-gathered scales, (B, mp,
    psz) at page granularity, or head granularity's (B, mp, psz, H)
    packed / (B, mp, H, psz) heads."""
    gf = g.float()
    if packed:
        if s.dim() == 4:     # head granularity: per (row, head) scale
            B, mp, psz, C = g.shape
            gh = gf.reshape(B, mp, psz, n_head, C // n_head)
            gf = (gh * s[..., None]).reshape(B, mp, psz, C)
        else:
            gf = gf * s[..., None]
    else:
        if s.dim() == 4:     # (B, mp, H, psz)
            gf = gf * s[..., None]
        else:                # (B, mp, psz): broadcast over H and D
            gf = gf * s[:, :, None, :, None]
    return gf.to(cd)
