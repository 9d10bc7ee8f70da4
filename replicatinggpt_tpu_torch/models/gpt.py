"""GPT for the paged serving path, in PyTorch.

The cached/paged half of ``replicatinggpt_tpu/models/gpt.py``:

- ``GPT``: an ``nn.Module`` holding the f32 master weights in the JAX
  package's layout (per-layer tensors stacked on a leading L axis, each
  matrix (in, out) so the code computes ``h @ W`` as JAX does);
  ``init_params`` draws them from a ``torch.Generator`` and
  ``params_from_numpy`` carries the JAX ``init_params`` tree across;
- ``compute_params``: the tensors the steps read, cast once to the
  compute dtype (layernorm scales and biases stay f32, as JAX reads
  them);
- the paged pool (``init_paged_kv_pool``, ``_gather_pages``,
  ``_scatter_kv``) and the two serving steps, ``decode_step_paged`` and
  ``prefill_chunk_paged``.

JAX's pool updates are functional; here the pool is updated IN PLACE
(one allocation for the engine's lifetime) and the steps return it for
symmetry with the JAX signatures.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.attention import cached_attention, windowed_cached_attention
from ..ops.paged_attention import paged_window_attention

Params = Dict[str, Any]

BLOCK_SHAPES = {   # per-layer parameter shapes, C = n_embd
    "ln1_scale": lambda C: (C,), "ln1_bias": lambda C: (C,),
    "qkv_kernel": lambda C: (C, 3 * C), "qkv_bias": lambda C: (3 * C,),
    "attn_out_kernel": lambda C: (C, C), "attn_out_bias": lambda C: (C,),
    "ln2_scale": lambda C: (C,), "ln2_bias": lambda C: (C,),
    "mlp_up_kernel": lambda C: (C, 4 * C), "mlp_up_bias": lambda C: (4 * C,),
    "mlp_down_kernel": lambda C: (4 * C, C), "mlp_down_bias": lambda C: (C,),
}


class GPT(nn.Module):
    """Master weights of a GPT in the JAX tree's names and layout."""

    def __init__(self, cfg: ModelConfig, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        C, L, V = cfg.n_embd, cfg.n_layer, cfg.vocab_size
        kw = {"device": device, "dtype": dtype}

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, **kw), requires_grad=False)

        self.wte = empty(V, C)
        self.wpe = empty(cfg.block_size, C)
        self.blocks = nn.ParameterDict(
            {n: empty(L, *s(C)) for n, s in BLOCK_SHAPES.items()})
        self.ln_f_scale = empty(C)
        self.ln_f_bias = empty(C)
        self.lm_head = None if cfg.tied_head else empty(C, V)

    def tree(self) -> Params:
        """The weights as the JAX-shaped dict (no copies)."""
        t = {"wte": self.wte, "wpe": self.wpe,
             "blocks": dict(self.blocks.items()),
             "ln_f_scale": self.ln_f_scale, "ln_f_bias": self.ln_f_bias}
        if self.lm_head is not None:
            t["lm_head"] = self.lm_head
        return t


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> GPT:
    """Random init with the JAX package's distributions: N(0, 0.02) for
    embeddings and matrices, std/sqrt(2L) for the residual projections,
    unit layernorm scales, zero biases. Draws from ``generator`` (which
    must live on ``device``)."""
    model = GPT(cfg, device=device)
    std = cfg.init_std
    resid = std * (2 * cfg.n_layer) ** -0.5
    with torch.no_grad():
        for name, p in model.tree()["blocks"].items():
            if name.endswith("_kernel"):
                s = resid if name in ("attn_out_kernel",
                                      "mlp_down_kernel") else std
                p.normal_(0.0, s, generator=generator)
            elif name.endswith("_scale"):
                p.fill_(1.0)
            else:
                p.zero_()
        model.wte.normal_(0.0, std, generator=generator)
        model.wpe.normal_(0.0, std, generator=generator)
        model.ln_f_scale.fill_(1.0)
        model.ln_f_bias.zero_()
        if model.lm_head is not None:
            model.lm_head.normal_(0.0, std, generator=generator)
    return model


def params_from_numpy(tree: Params, cfg: ModelConfig, device=None,
                      dtype: torch.dtype = torch.float32) -> GPT:
    """A ``GPT`` holding the JAX ``init_params`` tree (numpy arrays:
    ``wte``, ``wpe``, stacked ``blocks/*``, ``ln_f_*``, optional
    ``lm_head``) as ``dtype`` master weights on ``device``."""
    model = GPT(cfg, device=device, dtype=dtype)
    want = model.tree()
    with torch.no_grad():
        for name, p in want.items():
            if name == "blocks":
                for bn, bp in p.items():
                    _copy_leaf(bp, tree["blocks"][bn], f"blocks/{bn}")
            else:
                _copy_leaf(p, tree[name], name)
    return model


def _copy_leaf(dst: torch.Tensor, src, name: str) -> None:
    arr = np.array(src, np.float32)   # a writable copy
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: tree has {arr.shape}, model wants "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr))


def compute_params(model: GPT, device=None) -> Params:
    """The step functions' view of the weights on ``device``: matrices,
    biases and embeddings cast ONCE to the compute dtype (JAX casts on
    every use, which gives the same values); layernorm parameters stay
    in the master dtype, as JAX's ``_layer_norm`` reads them in f32."""
    cd = model.cfg.compute_dtype

    def cast(name, t):
        return t.detach().to(device, None if "ln" in name else cd)

    out = {n: cast(n, t) for n, t in model.tree().items() if n != "blocks"}
    out["blocks"] = {n: cast(n, t) for n, t in model.blocks.items()}
    return out


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _layer_norm(x, scale, bias, eps: float):
    """LN statistics in f32; result back in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _activation(x, kind: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.relu(x)


def _wmm(h, lp, name: str):
    """``h @ lp[name]`` (unquantized weights only in this port)."""
    return h @ lp[name]


def _split_heads(x, n_head: int):
    B, T, C = x.shape
    return x.reshape(B, T, n_head, C // n_head).transpose(1, 2)


def _merge_heads(x):
    B, H, T, D = x.shape
    return x.transpose(1, 2).reshape(B, T, H * D)


def _layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    return {n: t[i] for n, t in params["blocks"].items()}


def _cached_qkv_merged(h_in, lp, cfg: ModelConfig):
    """ln1 + fused QKV projection, heads still merged: (B, T, C) q/k/v."""
    h = _layer_norm(h_in, lp["ln1_scale"], lp["ln1_bias"], cfg.layernorm_eps)
    qkv = _wmm(h, lp, "qkv_kernel") + lp["qkv_bias"]
    return qkv.split(cfg.n_embd, dim=-1)


def _cached_block_tail(h_in, attn_merged, lp, cfg: ModelConfig):
    """Output projection + residual + ln2 + MLP + residual."""
    attn = _wmm(attn_merged, lp, "attn_out_kernel") + lp["attn_out_bias"]
    h_mid = h_in + attn
    h = _layer_norm(h_mid, lp["ln2_scale"], lp["ln2_bias"], cfg.layernorm_eps)
    h = _activation(_wmm(h, lp, "mlp_up_kernel") + lp["mlp_up_bias"],
                    cfg.activation)
    h = _wmm(h, lp, "mlp_down_kernel") + lp["mlp_down_bias"]
    return h_mid + h


def _decode_head(x, params: Params, cfg: ModelConfig):
    """Final layernorm + (tied/untied) head over a (B, 1, C) state ->
    (B, V) f32 logits (the compute-dtype product, cast)."""
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"],
                    cfg.layernorm_eps)
    head = params["wte"].T if cfg.tied_head else params["lm_head"]
    return (x[:, 0, :] @ head).float()


# ---------------------------------------------------------------------------
# paged KV pool
# ---------------------------------------------------------------------------

def init_paged_kv_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                       device=None, dtype: Optional[torch.dtype] = None
                       ) -> Dict[str, torch.Tensor]:
    """(L, n_pages, page, C) packed or (L, n_pages, H, page, D) heads,
    zero-filled, for K and V."""
    dt = dtype or cfg.compute_dtype
    if cfg.decode_cache_layout == "packed":
        shape = (cfg.n_layer, n_pages, page_size, cfg.n_embd)
    else:
        shape = (cfg.n_layer, n_pages, cfg.n_head, page_size, cfg.head_dim)
    return {"k": torch.zeros(shape, device=device, dtype=dt),
            "v": torch.zeros(shape, device=device, dtype=dt)}


def paged_page_size(cfg: ModelConfig, cache: Dict[str, torch.Tensor]) -> int:
    return int(cache["k"].shape[
        2 if cfg.decode_cache_layout == "packed" else 3])


def _gather_pages(c_layer, tables, packed: bool, n_head: int):
    """One layer's logical (B, H, max_pages*page, D) view through the page
    tables (unmapped entries hold page 0; the positions they cover are
    masked by every caller)."""
    g = c_layer[tables.long()]
    if packed:
        B, mp, psz, C = g.shape
        return _split_heads(g.reshape(B, mp * psz, C), n_head)
    B, mp, H, psz, D = g.shape
    return g.transpose(1, 2).reshape(B, H, mp * psz, D)


def _gather_kv(cc, layer_idx: int, tables, packed: bool, n_head: int):
    return (_gather_pages(cc["k"][layer_idx], tables, packed, n_head),
            _gather_pages(cc["v"][layer_idx], tables, packed, n_head))


def _scatter_kv(cc, layer_idx: int, phys, woff, k_m, v_m, packed: bool,
                n_head: int):
    """Write merged fresh K/V rows (``phys.shape + (C,)``) into one layer
    of the pool at (phys, woff), in place. Callers pass only the rows
    that land: JAX's ``mode='drop'`` rows (inactive slots, padding past
    ``limit``) are filtered out before this call, since an out-of-range
    index raises here."""
    ck, cv = cc["k"][layer_idx], cc["v"][layer_idx]
    phys, woff = phys.long(), woff.long()
    if packed:
        ck[phys, woff] = k_m.to(ck.dtype)
        cv[phys, woff] = v_m.to(cv.dtype)
    else:
        shp = phys.shape + (n_head, k_m.shape[-1] // n_head)
        ck[phys, :, woff] = k_m.reshape(shp).to(ck.dtype)
        cv[phys, :, woff] = v_m.reshape(shp).to(cv.dtype)
    return cc


def _check_in_bounds(lo: int, hi_plus_len: int, size: int, what: str):
    if lo < 0 or hi_plus_len > size:
        raise IndexError(f"{what}: [{lo}, {hi_plus_len}) outside "
                         f"[0, {size})")


def decode_step_paged(params: Params, idx_t, pos, active, tables, cache,
                      cfg: ModelConfig, *, use_kernel: bool = False
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One multi-slot decode step over the paged pool.

    idx_t/pos: (B,) tokens and logical positions; active: (B,) bool;
    tables: (B, max_pages) int32. The fresh K/V row of an active slot
    lands at page ``tables[b, pos // page]``, offset ``pos % page``;
    inactive slots run at position 0 and write nothing. ``use_kernel``
    attends through ``paged_window_attention`` (stale pool + fresh row,
    packed layout only) and writes afterwards; otherwise the row is
    written first and the gathered view attends it (the gather route).
    Returns ((B, V) f32 logits, the pool)."""
    B = idx_t.shape[0]
    packed = cfg.decode_cache_layout == "packed"
    if use_kernel and not packed:
        raise ValueError("the paged attention kernel needs the packed "
                         "cache layout")
    psz = paged_page_size(cfg, cache)
    mp = tables.shape[1]
    H = cfg.n_head
    pos_eff = torch.where(active, pos, torch.zeros_like(pos))
    # one host read per step: the bounds check and the rows that write
    pe_host = pos_eff.cpu()
    _check_in_bounds(int(pe_host.min()), int(pe_host.max()) + 1, mp * psz,
                     "paged decode write")
    rows = torch.nonzero(active.cpu()).squeeze(1).to(idx_t.device)
    x = params["wte"][idx_t.long()] + params["wpe"][pos_eff.long()]
    x = x[:, None, :]                                           # (B, 1, C)
    lpage = torch.clamp(pos_eff // psz, max=mp - 1).long()
    phys = tables[torch.arange(B, device=tables.device), lpage][rows]
    woff = (pos_eff % psz)[rows]
    pos32 = pos_eff.to(torch.int32)
    for i in range(cfg.n_layer):
        lp = _layer(params, i)
        q_m, k_m, v_m = _cached_qkv_merged(x, lp, cfg)
        if use_kernel:
            q_m, k_m, v_m = (t.contiguous() for t in (q_m, k_m, v_m))
            attn = paged_window_attention(
                q_m, k_m, v_m, cache["k"][i], cache["v"][i], tables, pos32,
                n_head=H)
            _scatter_kv(cache, i, phys, woff, k_m[rows, 0], v_m[rows, 0],
                        packed, H)
        else:
            _scatter_kv(cache, i, phys, woff, k_m[rows, 0], v_m[rows, 0],
                        packed, H)
            k_all, v_all = _gather_kv(cache, i, tables, packed, H)
            attn = _merge_heads(cached_attention(
                _split_heads(q_m, H), k_all, v_all, pos_eff))
        x = _cached_block_tail(x, attn, lp, cfg)
    return _decode_head(x, params, cfg), cache


def prefill_chunk_paged(params: Params, idx, offset: int, limit: int,
                        table_row, cache, cfg: ModelConfig
                        ) -> Dict[str, torch.Tensor]:
    """Chunked prefill of ONE slot's prompt through its page table.

    idx: (1, Pc) chunk of the prompt; ``offset``: its first absolute
    position; ``limit``: the true prompt length — positions >= limit (a
    padded final chunk's tail) write nothing. Queries attend the
    gathered logical view masked to k <= offset + i (write-then-attend
    across chunks). Returns the pool (updated in place)."""
    offset, limit = int(offset), int(limit)
    _, Pc = idx.shape
    packed = cfg.decode_cache_layout == "packed"
    psz = paged_page_size(cfg, cache)
    mp = table_row.shape[0]
    H = cfg.n_head
    _check_in_bounds(offset, offset + 1, cfg.block_size,
                     "paged prefill chunk")
    dev = idx.device
    positions = offset + torch.arange(Pc, device=dev)
    x = (params["wte"][idx.long()]
         + params["wpe"][positions.clamp(max=cfg.block_size - 1)][None])
    n_write = max(0, min(Pc, min(limit, mp * psz) - offset))
    wpos = positions[:n_write]
    phys = table_row.long()[wpos // psz]
    woff = wpos % psz
    base = torch.tensor([offset], device=dev)
    tables = table_row[None]
    for i in range(cfg.n_layer):
        lp = _layer(params, i)
        q_m, k_m, v_m = _cached_qkv_merged(x, lp, cfg)           # (1, Pc, C)
        _scatter_kv(cache, i, phys, woff, k_m[0, :n_write], v_m[0, :n_write],
                    packed, H)
        k_all, v_all = _gather_kv(cache, i, tables, packed, H)
        attn = windowed_cached_attention(_split_heads(q_m, H), k_all, v_all,
                                         base)
        x = _cached_block_tail(x, _merge_heads(attn), lp, cfg)
    return cache
