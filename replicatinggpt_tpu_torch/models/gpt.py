"""GPT in PyTorch: the training forward and the paged serving steps.

A port of ``replicatinggpt_tpu/models/gpt.py``:

- ``GPT``: an ``nn.Module`` holding the f32 master weights (trainable
  parameters) in the JAX package's layout (per-layer tensors stacked on
  a leading L axis, each matrix (in, out) so the code computes ``h @ W``
  as JAX does); ``init_params`` draws them from a ``torch.Generator`` and
  ``params_from_numpy`` carries the JAX ``init_params`` tree across;
- ``forward``: the full-sequence training forward and its loss. It casts
  the masters to the compute dtype inside every call (JAX's
  ``.astype(cd)``), so autograd leaves f32 gradients on the masters;
  attention takes the packed flash kernel or split heads through the
  (B, H, T, D) flash kernel or the plain core (``ops/flash_attention.py``
  states the rule); with ``cfg.remat`` each block is recomputed in the
  backward (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``);
- ``compute_params``: the serving steps' detached view of the weights,
  cast once to the compute dtype (layernorm scales and biases stay f32,
  as JAX reads them);
- the paged pool (``init_paged_kv_pool``, ``_gather_pages``,
  ``_scatter_kv``; unquantized, or int8/fp8 pages with f32 scales that
  are quantized on write and dequantized on gather; rows that must not
  land are dropped on the device, ``_drop_plan``) and the serving
  steps, ``decode_step_paged`` (fused, per-layer kernel and gather
  routes), ``verify_step_paged`` (a window of W rows a slot) and
  ``prefill_chunk_paged``, also on the shards of a (data, model) serve
  mesh (``init_sharded_kv_pool``: a block of pages per data shard in
  each model shard's columns; Megatron TP over the heads);
- the serving windows, k steps enqueued with no host read:
  ``decode_window_paged`` (k decode steps) and ``mixed_window_paged``
  (chunked prefill of new slots while the others decode);
- the contiguous cache of ``generate()`` (``init_kv_cache``,
  ``cache_seq_axis``), ``decode_step`` with its three routes (the fused
  all-layers kernel at B=1, the packed decode attention kernel, the
  plain heads route) and ``prefill``;
- the multi-slot steps on a contiguous pool of per-slot buffers (the
  speculative model drafter's cache, ``serve/speculative.py``), in plain
  PyTorch as JAX runs them without a kernel: ``decode_step_multi``
  (per-slot positions), ``verify_step_multi`` (a window a slot) and
  ``prefill_chunk_into_slot``.

JAX's cache and pool updates are functional; here they are updated IN
PLACE (one allocation per pool or generation segment) and the steps
return them for symmetry with the JAX signatures.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..config import ModelConfig
from ..ops.attention import (DropoutRNG, cached_attention,
                             full_causal_attention, uint8_inverted_dropout,
                             windowed_cached_attention)
from ..ops.decode import (fused_decode_layers, fused_decode_supported,
                          fused_paged_decode_layers, fused_weights,
                          packed_decode_attention, packed_decode_supported)
from ..ops.flash_attention import packed_qkv_attention, packed_route
from ..ops.paged_attention import (paged_window_attention,
                                   sharded_paged_window_attention)
from ..quant.kv import (dequant_gathered, fake_quantize_rows, init_scales,
                        kv_store_dtype, pool_quant_mode, quantize_rows,
                        row_amax)

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
            return nn.Parameter(torch.empty(shape, **kw))

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


def reference_state_dict(model: GPT) -> Dict[str, torch.Tensor]:
    """The weights in the JAX package's torch reference layout
    (``RefGPT``'s ``state_dict``: ``wte``, ``wpe``, ``ln_f_scale``,
    ``ln_f_bias``, ``lm_head`` when the head is untied, then
    ``blocks.<i>.<name>`` for each name of ``BLOCK_SHAPES``): f32 CPU
    tensors, kernels (in, out), applied as ``x @ W``."""
    def f32(t):
        return t.detach().to("cpu", torch.float32).clone()

    tree = model.tree()
    out = {n: f32(tree[n]) for n in ("wte", "wpe", "ln_f_scale",
                                     "ln_f_bias", "lm_head") if n in tree}
    for i in range(model.cfg.n_layer):
        for name in BLOCK_SHAPES:
            out[f"blocks.{i}.{name}"] = f32(tree["blocks"][name][i])
    return out


def _copy_leaf(dst: torch.Tensor, src, name: str) -> None:
    arr = np.array(src, np.float32)   # a writable copy
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: tree has {arr.shape}, model wants "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr))


def param_count(model: GPT) -> int:
    return sum(p.numel() for p in model.parameters())


def leaf_dtype(name: str, cd: torch.dtype) -> Optional[torch.dtype]:
    """The dtype the forward reads leaf ``name`` in: ``cd`` for matrices,
    biases and embeddings; None (the master dtype) for layernorm
    parameters, as JAX's ``_layer_norm`` reads them in f32."""
    return None if "ln" in name else cd


def _cast_tree(tree: Params, cd: torch.dtype, device=None) -> Params:
    """Each leaf in its ``leaf_dtype``. Differentiable: the casts carry
    gradients back to ``tree``."""
    def cast(name, t):
        return t.to(device, leaf_dtype(name, cd))

    out = {n: cast(n, t) for n, t in tree.items() if n != "blocks"}
    out["blocks"] = {n: cast(n, t) for n, t in tree["blocks"].items()}
    return out


def compute_params(model: GPT, device=None) -> Params:
    """The serving steps' view of the weights on ``device``, detached and
    cast ONCE to the compute dtype (JAX casts on every use, which gives
    the same values)."""
    tree = model.tree()
    detached = {n: t.detach() for n, t in tree.items() if n != "blocks"}
    detached["blocks"] = {n: t.detach() for n, t in tree["blocks"].items()}
    return _cast_tree(detached, model.cfg.compute_dtype, device)


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


def _layers(params: Params, n_layer: int):
    """Every layer's weights, split once: unlike L ``select``s, whose
    backwards each write a zero-filled copy of the whole stacked
    tensor, ``unbind``'s backward stacks the L gradients once."""
    names = list(params["blocks"])
    parts = [params["blocks"][n].unbind(0) for n in names]
    return [{n: parts[j][i] for j, n in enumerate(names)}
            for i in range(n_layer)]


def _qkv(h_in, lp, cfg: ModelConfig):
    """ln1 + fused QKV projection: the packed (B, T, 3C) rows."""
    h = _layer_norm(h_in, lp["ln1_scale"], lp["ln1_bias"], cfg.layernorm_eps)
    return _wmm(h, lp, "qkv_kernel") + lp["qkv_bias"]


def _cached_qkv_merged(h_in, lp, cfg: ModelConfig):
    """ln1 + fused QKV projection, heads still merged: (B, T, C) q/k/v."""
    return _qkv(h_in, lp, cfg).split(cfg.n_embd, dim=-1)


def _block_tail(h_in, attn_merged, lp, cfg: ModelConfig,
                drop: Callable = lambda t: t):
    """Output projection + residual + ln2 + MLP + residual, with ``drop``
    (residual dropout when training) on both branches."""
    attn = _wmm(attn_merged, lp, "attn_out_kernel") + lp["attn_out_bias"]
    h_mid = h_in + drop(attn)
    h = _layer_norm(h_mid, lp["ln2_scale"], lp["ln2_bias"], cfg.layernorm_eps)
    h = _activation(_wmm(h, lp, "mlp_up_kernel") + lp["mlp_up_bias"],
                    cfg.activation)
    h = _wmm(h, lp, "mlp_down_kernel") + lp["mlp_down_bias"]
    return h_mid + drop(h)


# ---------------------------------------------------------------------------
# training forward (full sequence)
# ---------------------------------------------------------------------------

AttentionFn = Callable[..., torch.Tensor]


def split_attention(qkv, cfg: ModelConfig, rng: Optional[DropoutRNG],
                    train: bool):
    """The split-heads route: (B, H, T, D) heads through
    ``full_causal_attention(impl="flash")``, the flash kernel inside its
    envelope and the plain core outside it."""
    q, k, v = (_split_heads(t, cfg.n_head)
               for t in qkv.split(cfg.n_embd, dim=-1))
    return _merge_heads(full_causal_attention(
        q, k, v, dropout_rate=cfg.attn_dropout, rng=rng, train=train,
        impl="flash"))


def attention_for(cfg: ModelConfig, seq_len: int) -> AttentionFn:
    return (packed_qkv_attention if packed_route(cfg, seq_len)[0]
            else split_attention)


def _dropout(x, rate: float, rng: Optional[DropoutRNG], train: bool):
    if not train or rate <= 0.0 or rng is None:
        return x
    return uint8_inverted_dropout(x, rate, rng.bits)


def _block(x, lp, cfg: ModelConfig, *, rng: Optional[DropoutRNG],
           train: bool, attention_fn: AttentionFn):
    """One pre-LN block over a full (B, T, C) sequence."""
    attn = attention_fn(_qkv(x, lp, cfg), cfg, rng, train)
    return _block_tail(x, attn, lp, cfg,
                       lambda t: _dropout(t, cfg.dropout, rng, train))


def _seeded_block(x, lp, cfg: ModelConfig, seed: Optional[int],
                  train: bool, attention_fn: AttentionFn, stream: int = 0):
    """``_block`` with its own dropout streams, built from ``seed`` (and
    the run's ``stream``): a recompute under checkpointing builds the same
    streams again, so it draws the forward's masks and kernel seeds."""
    rng = None if seed is None else DropoutRNG(seed, x.device, stream)
    return _block(x, lp, cfg, rng=rng, train=train,
                  attention_fn=attention_fn)


# the matrix products a selective policy keeps: 'dots' all of them (JAX's
# dots_saveable), 'dots_no_batch' those with no batch dimensions
# (dots_with_no_batch_dims_saveable): the weight products, not the plain
# attention core's batched ones
_SAVED_PRODUCTS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default),
    "dots_no_batch": (torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default),
}


def _save_products(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(policy: str):
    """The ``context_fn`` of ``checkpoint`` for ``cfg.remat_policy``
    (JAX's ``_remat_policy``): none for 'full' (save nothing, recompute
    the whole block), else selective checkpointing of the products."""
    if policy == "full":
        return noop_context_fn
    if policy not in _SAVED_PRODUCTS:
        raise ValueError(f"remat_policy must be 'full', 'dots' or "
                         f"'dots_no_batch', got {policy!r}")
    fn = functools.partial(_save_products, _SAVED_PRODUCTS[policy])
    return functools.partial(create_selective_checkpoint_contexts, fn)


class CastWeights:
    """The forward's weights from a master dict (``GPT.tree()``): each
    leaf in its ``leaf_dtype``, cast once a forward, and the stacked block
    leaves split once (``_layers``). The weight providers of
    ``parallel.data_parallel`` have the same three methods: ``top()`` (the
    non-block leaves), ``layer(i)`` (block i's, called inside the block,
    so a recompute under checkpointing calls it again) and ``scope(i)``
    (a context around block i's forward)."""

    def __init__(self, tree: Params, cd: torch.dtype, n_layer: int):
        self.p = _cast_tree(tree, cd)
        self.layers = _layers(self.p, n_layer)

    def top(self) -> Params:
        return self.p

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        return self.layers[i]

    def scope(self, i: int):
        return contextlib.nullcontext()


def _provided_block(x, weights, i: int, cfg: ModelConfig,
                    seed: Optional[int], train: bool,
                    attention_fn: AttentionFn, stream: int = 0):
    """``_seeded_block`` over block i's weights from ``weights``."""
    return _seeded_block(x, weights.layer(i), cfg, seed, train, attention_fn,
                         stream)


def _run_blocks(x, weights, cfg: ModelConfig, *,
                rng: Optional[DropoutRNG], train: bool,
                attention_fn: AttentionFn):
    """The L blocks over ``weights`` (a ``CastWeights`` or a provider
    like it), each recomputed in the backward when ``cfg.remat``. Each
    block's dropout seed is drawn from ``rng`` before the block runs
    (JAX's ``fold_in(rng, layer_idx)``), with or without remat, so both
    give the same masks."""
    context = _remat_context(cfg.remat_policy) if cfg.remat else None
    stream = rng.stream if rng is not None else 0
    for i in range(cfg.n_layer):
        seed = rng.kernel_seed() if rng is not None else None
        args = (x, weights, i, cfg, seed, train, attention_fn, stream)
        with weights.scope(i):
            if cfg.remat:
                x = checkpoint(_provided_block, *args, use_reentrant=False,
                               preserve_rng_state=False, context_fn=context)
            else:
                x = _provided_block(*args)
    return x


def forward(params: Params, idx: torch.Tensor, cfg: ModelConfig, *,
            targets: Optional[torch.Tensor] = None,
            rng: Optional[DropoutRNG] = None, train: bool = False,
            attention_fn: Optional[AttentionFn] = None, pos_offset: int = 0
            ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Full-sequence forward over the master weights ``params`` (the
    ``GPT.tree()`` dict, or a provider of them like ``CastWeights``, as
    ``parallel.data_parallel``'s are). idx: (B, T) token ids of any
    integer dtype, at global positions ``pos_offset ... pos_offset + T -
    1`` (a sequence shard of a process group starts past 0).

    Returns ``(logits, loss)``: (B, T, V) f32 logits (the compute-dtype
    product, cast) and the mean f32 cross-entropy, or None without
    targets. With ``cfg.loss_chunk`` and targets the chunked head returns
    ``(None, loss)``. ``attention_fn(qkv, cfg, rng, train)`` replaces the
    attention core (default: ``attention_for``'s route)."""
    B, T = idx.shape
    weights = CastWeights(params, cfg.compute_dtype, cfg.n_layer) \
        if isinstance(params, dict) else params
    p = weights.top()
    attend = attention_fn or attention_for(cfg, T)
    if pos_offset + T > cfg.block_size:
        raise ValueError(f"positions {pos_offset}..{pos_offset + T - 1} "
                         f"past block_size={cfg.block_size}")
    x = p["wte"][idx.long()] + p["wpe"][pos_offset:pos_offset + T]
    x = _run_blocks(x, weights, cfg, rng=rng, train=train,
                    attention_fn=attend)
    x = _layer_norm(x, p["ln_f_scale"], p["ln_f_bias"], cfg.layernorm_eps)
    head = p["wte"].T if cfg.tied_head else p["lm_head"]
    if targets is not None and cfg.loss_chunk:
        if (B * T) % cfg.loss_chunk:
            raise ValueError(f"loss_chunk={cfg.loss_chunk} must divide "
                             f"B*T={B * T}; pick a divisor or set "
                             f"loss_chunk=0")
        return None, _chunked_ce_loss(x, head, targets, cfg.loss_chunk)
    logits = (x @ head).float()
    if targets is None:
        return logits, None
    return logits, F.cross_entropy(logits.reshape(B * T, -1),
                                   targets.reshape(B * T).long())


def _chunk_ce_sum(xc, head, tc):
    return F.cross_entropy((xc @ head).float(), tc, reduction="sum")


def _chunked_ce_loss(x, head, targets, chunk: int) -> torch.Tensor:
    """Cross-entropy without the full (B*T, V) f32 logits: ``chunk`` rows
    at a time, each chunk recomputed in the backward (activation
    checkpointing, as JAX's ``jax.checkpoint`` body) instead of stored."""
    N, C = x.shape[0] * x.shape[1], x.shape[-1]
    xf, tf = x.reshape(N, C), targets.reshape(N).long()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, N, chunk):
        total = total + checkpoint(_chunk_ce_sum, xf[i:i + chunk], head,
                                   tf[i:i + chunk], use_reentrant=False)
    return total / N


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
                       device=None, dtype: Optional[torch.dtype] = None,
                       quant=None) -> Dict[str, torch.Tensor]:
    """(L, n_pages, page, C) packed or (L, n_pages, H, page, D) heads,
    zero-filled, for K and V. ``quant`` (a ``quant.QuantConfig`` with
    ``kv_dtype`` set) stores the pages in int8/fp8 and adds the ``ks``/
    ``vs`` f32 scale tensors, indexed by the same (layer, page, offset)
    coordinates; the paged steps read the mode off the dict
    (``quant.kv.pool_quant_mode``)."""
    if cfg.decode_cache_layout == "packed":
        shape = (cfg.n_layer, n_pages, page_size, cfg.n_embd)
    else:
        shape = (cfg.n_layer, n_pages, cfg.n_head, page_size, cfg.head_dim)
    quantized = quant is not None and quant.kv_enabled
    dt = (kv_store_dtype(quant.kv_dtype) if quantized
          else dtype or cfg.compute_dtype)
    pool = {"k": torch.zeros(shape, device=device, dtype=dt),
            "v": torch.zeros(shape, device=device, dtype=dt)}
    if quantized:
        pool.update(init_scales(cfg, n_pages, page_size, quant.granularity,
                                device=device))
    return pool


def paged_page_size(cfg: ModelConfig, cache: Dict[str, torch.Tensor]) -> int:
    return int(cache["k"].shape[
        2 if cfg.decode_cache_layout == "packed" else 3])


def _gather_pages(c_layer, tables, packed: bool, n_head: int,
                  s_layer=None, cd: Optional[torch.dtype] = None):
    """One layer's logical (B, H, max_pages*page, D) view through the page
    tables (unmapped entries hold page 0; the positions they cover are
    masked by every caller). ``s_layer`` (one layer of a quantized pool's
    scales) dequantizes the gathered view to ``cd``."""
    tl = tables.long()
    g = c_layer[tl]
    if s_layer is not None:
        g = dequant_gathered(g, s_layer[tl], packed, n_head, cd)
    if packed:
        B, mp, psz, C = g.shape
        return _split_heads(g.reshape(B, mp * psz, C), n_head)
    B, mp, H, psz, D = g.shape
    return g.transpose(1, 2).reshape(B, H, mp * psz, D)


def _gather_kv(cc, layer_idx: int, tables, packed: bool, n_head: int,
               cd: Optional[torch.dtype] = None):
    quantized = "ks" in cc
    return tuple(
        _gather_pages(cc[n][layer_idx], tables, packed, n_head,
                      s_layer=cc[n + "s"][layer_idx] if quantized else None,
                      cd=cd) for n in ("k", "v"))


class _DropPlan(NamedTuple):
    """Where a step's fresh rows write when some must write nothing
    (JAX's ``mode='drop'``), made once a step (``_drop_plan``) for every
    layer, with no host read and no two values racing for one index."""

    phys: torch.Tensor       # (R,) the rows' pages, dropped rows redirected
    woff: torch.Tensor       # (R,) their offsets
    src: torch.Tensor        # (R,) the row whose value each row writes
    any_valid: torch.Tensor  # () whether any row lands
    old: Dict[str, torch.Tensor]   # per pool tensor, every layer's row at
                                   # row 0's place: (L, 1, ...)


def _mid_axis(name: str, packed: bool, gran) -> bool:
    """Whether pool tensor ``name`` keeps a head axis between its page and
    offset axes: the heads layout's K/V and head-granularity scales."""
    return not packed and (name in ("k", "v") or gran == "head")


def _coords(name: str, packed: bool, gran, phys, woff) -> tuple:
    """The index of rows (phys, woff) in one layer of pool tensor
    ``name``."""
    return ((phys, slice(None), woff) if _mid_axis(name, packed, gran)
            else (phys, woff))


def _drop_plan(cache, phys, woff, valid, packed: bool) -> _DropPlan:
    """The step's ``_DropPlan`` for rows at (phys, woff) of which
    ``valid`` land. A valid row writes itself. A dropped row (an inactive
    slot, whose stale table may name pages a live slot now writes, or a
    padding row) goes to the FIRST valid row's place with that row's
    value, so every repeated index carries one value; when no row is
    valid, every row rewrites row 0's place with what it holds."""
    _, gran = pool_quant_mode(cache)
    valid = valid.reshape(-1)
    first = torch.argmax(valid.to(torch.int32))
    src = torch.where(valid, torch.arange(valid.numel(), device=valid.device),
                      first)
    phys = phys.reshape(-1).long()[src]
    woff = woff.reshape(-1).long()[src]
    old = {}
    for name, t in cache.items():
        row = t[(slice(None),) + _coords(name, packed, gran, phys[:1],
                                         woff[:1])]
        old[name] = (row.movedim(0, 1) if _mid_axis(name, packed, gran)
                     else row)
    return _DropPlan(phys, woff, src, valid.any(), old)


def _kept_rows(vals, old, drop: _DropPlan, dim: int = 0):
    """``vals`` (rows along ``dim``) as ``drop``'s writes carry them: row
    ``src[r]``, or ``old`` when no row lands."""
    return torch.where(drop.any_valid, vals.index_select(dim, drop.src), old)


def _scatter_kv(cc, layer_idx: int, phys, woff, k_m, v_m, packed: bool,
                n_head: int, amax=(None, None), drop=None):
    """Write merged fresh K/V rows (``phys.shape + (C,)``) into one layer
    of the pool at (phys, woff), in place. ``drop``: the step's
    ``_drop_plan`` of these rows, under which the rows outside its valid
    mask write nothing (``phys``/``woff`` are then the plan's). Without
    it every row lands, and callers filter the rows on the host first,
    since an out-of-range index raises here. On a quantized pool the
    rows are quantized on write and their scales land at the same
    coordinates of ``ks``/``vs``; ``amax``: the K and V rows' whole-row
    maxima where these are one model shard's columns (page granularity,
    ``quant.kv.quantize_rows``).
    """
    kv_dtype, gran = pool_quant_mode(cc)
    if drop is not None:
        phys, woff = drop.phys, drop.woff
        k_m, v_m = (t.reshape(phys.numel(), -1) for t in (k_m, v_m))
    phys, woff = phys.long(), woff.long()
    for name, rows, mx in (("k", k_m, amax[0]), ("v", v_m, amax[1])):
        c = cc[name][layer_idx]
        if kv_dtype is not None:
            rows, sc = quantize_rows(rows, kv_dtype, n_head, gran, mx)
            if drop is not None:
                sc = _kept_rows(sc, drop.old[name + "s"][layer_idx], drop)
            cc[name + "s"][layer_idx][_coords(name + "s", packed, gran,
                                               phys, woff)] = sc
        rows = rows.to(c.dtype)
        if not packed:
            rows = rows.reshape(phys.shape + (n_head, -1))
        if drop is not None:
            rows = _kept_rows(rows, drop.old[name][layer_idx], drop)
        c[_coords(name, packed, gran, phys, woff)] = rows
    return cc


def _check_in_bounds(lo: int, hi_plus_len: int, size: int, what: str):
    if lo < 0 or hi_plus_len > size:
        raise IndexError(f"{what}: [{lo}, {hi_plus_len}) outside "
                         f"[0, {size})")


def decode_step_paged(params: Params, idx_t, pos, active, tables, cache,
                      cfg: ModelConfig, *, use_kernel: bool = False,
                      use_fused: bool = False,
                      fused_blocks: Optional[Dict[str, torch.Tensor]] = None,
                      group=None, host_tables=None, max_pos=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One multi-slot decode step over the paged pool.

    idx_t/pos: (B,) tokens and logical positions; active: (B,) bool;
    tables: (B, max_pages) int32. The fresh K/V row of an active slot
    lands at page ``tables[b, pos // page]``, offset ``pos % page``;
    inactive slots run at position 0 and write nothing (dropped on the
    device, ``_drop_plan``). Three routes (packed layout for the two
    kernel routes):

    - ``use_fused``: ``fused_paged_decode_layers`` runs every layer in
      one call on the STALE pool plus the fresh column, and then every
      layer's fresh K/V row is written (quantized on write for a
      quantized pool). ``fused_blocks``: the blocks as ``fused_weights``
      casts them, made once by callers that step many times;
    - ``use_kernel``: per layer, ``paged_window_attention`` on the stale
      pool plus the fresh row, written afterwards; a quantized pool hands
      the kernel its scales and a fresh row fake-quantized to exactly
      what the write stores;
    - otherwise the gather route: write the row, gather the logical view
      (dequantized for a quantized pool) and attend.

    The last two are ``verify_step_paged`` over a window of one row.

    ``max_pos``: a bound on every active slot's position that the caller
    holds on the host, having checked that the writes lie inside the
    pool's ``max_pages * page`` positions; it sizes the kernels' split
    and changes no result. With None the step reads the positions back
    (one host sync) and checks them itself.

    With a serve ``group`` (``parallel.serve_group``) the step runs on
    the shards the group holds: ``params`` is ``parallel.mesh.
    shard_serve_params``'s split, ``cache`` the ``{(d, m): pool}`` blocks
    of ``init_sharded_kv_pool`` (``_sharded_decode_step``, which reads
    the positions back to plan each step); the fused route is not taken
    there. ``host_tables``: the tables as the caller holds them on the
    host (read back from ``tables`` if not given).

    Returns ((B, V) f32 logits, the pool)."""
    if group is not None:
        if use_fused:
            raise ValueError("the fused all-layers route runs on a 1x1 "
                             "mesh only")
        return _sharded_decode_step(params, idx_t, pos, active, tables,
                                    cache, cfg, group, use_kernel,
                                    host_tables)
    packed = cfg.decode_cache_layout == "packed"
    if (use_kernel or use_fused) and not packed:
        raise ValueError("the paged attention kernels need the packed "
                         "cache layout")
    pos_eff = torch.where(active, pos, torch.zeros_like(pos))
    if max_pos is None:
        pe_host = pos_eff.cpu()
        _check_in_bounds(int(pe_host.min()), int(pe_host.max()) + 1,
                         tables.shape[1] * paged_page_size(cfg, cache),
                         "paged decode write")
        max_pos = int(pe_host.max())
    if not use_fused:
        # a window of one row a slot: verify_step_paged's per-layer routes
        logits, cache = verify_step_paged(
            params, idx_t[:, None], pos, torch.zeros_like(pos), active,
            tables, cache, cfg, use_kernel=use_kernel, max_pos=max_pos)
        return logits[:, 0], cache
    B = idx_t.shape[0]
    psz = paged_page_size(cfg, cache)
    mp = tables.shape[1]
    H = cfg.n_head
    kv_dtype, gran = pool_quant_mode(cache)
    x = params["wte"][idx_t.long()] + params["wpe"][pos_eff.long()]
    lpage = torch.clamp(pos_eff // psz, max=mp - 1).long()
    phys = tables[torch.arange(B, device=tables.device), lpage]
    blocks = fused_blocks or fused_weights(params["blocks"], x.dtype)
    x_row, newk, newv = fused_paged_decode_layers(
        x, blocks, pos_eff.to(torch.int32), tables, cache, cfg,
        max_pos=max_pos)
    drop = _drop_plan(cache, phys, pos_eff % psz, active, packed)
    at = (slice(None), drop.phys, drop.woff)
    for name, new in (("k", newk), ("v", newv)):               # (L, B, C)
        if kv_dtype is not None:
            new, sc = quantize_rows(new, kv_dtype, H, gran)
            cache[name + "s"][at] = _kept_rows(sc, drop.old[name + "s"],
                                               drop, dim=1)
        cache[name][at] = _kept_rows(new.to(cache[name].dtype),
                                     drop.old[name], drop, dim=1)
    return _decode_head(x_row[:, None, :], params, cfg), cache


def verify_step_paged(params: Params, window, pos, n_valid, active, tables,
                      cache, cfg: ModelConfig, *,
                      logits_rows: Optional[int] = None,
                      use_kernel: bool = False, max_pos=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A (B, W) token window per slot through the paged pool: window
    token j of slot b sits at logical position ``pos[b] + j``, its K/V
    at page ``tables[b, (pos + j) // page]``, offset ``(pos + j) %
    page``. Rows j > ``n_valid[b]``, rows past the pool's positions and
    every row of an inactive slot (run at position 0) write nothing
    (``_drop_plan``); callers discard their outputs. Two routes:

    - ``use_kernel`` (packed layout): per layer, ``paged_window_attention``
      attends the stale pool plus the causal fresh window (a quantized
      pool: its scales, and the fresh rows fake-quantized to what the
      write stores), and the rows are written afterwards;
    - otherwise: write the rows, gather the logical view and attend it
      through ``windowed_cached_attention`` (query j to positions <= pos
      + j).

    ``logits_rows``: the final layernorm and head over the first that
    many rows only (the mixed window samples row 0); None keeps all W.
    ``max_pos`` as in ``decode_step_paged``: the caller's bound on every
    active slot's ``pos`` (the kernel's split), None for the whole
    table. The caller bounds the valid rows' positions on the host.
    Returns ((B, rows, V) f32 logits, the pool)."""
    B, W = window.shape
    packed = cfg.decode_cache_layout == "packed"
    if use_kernel and not packed:
        raise ValueError("the paged attention kernels need the packed "
                         "cache layout")
    psz = paged_page_size(cfg, cache)
    mp = tables.shape[1]
    H, C = cfg.n_head, cfg.n_embd
    kv_dtype, gran = pool_quant_mode(cache)
    dev = window.device
    offs = torch.arange(W, device=dev)[None, :]                 # (1, W)
    pos_eff = torch.where(active, pos, torch.zeros_like(pos))
    m_eff = torch.where(active, n_valid, torch.zeros_like(n_valid))
    abs_pos = pos_eff[:, None] + offs                           # (B, W)
    # the position table clamps padding rows past the block
    x = (params["wte"][window.long()]
         + params["wpe"][abs_pos.clamp(max=cfg.block_size - 1).long()])
    cd = x.dtype
    valid = ((offs <= m_eff[:, None]) & active[:, None]
             & (abs_pos < mp * psz))
    lpage = torch.clamp(abs_pos // psz, max=mp - 1).long()
    phys = torch.gather(tables.long(), 1, lpage)
    woff = abs_pos % psz
    pos32 = pos_eff.to(torch.int32)
    drop = _drop_plan(cache, phys, woff, valid, packed)
    for i in range(cfg.n_layer):
        lp = _layer(params, i)
        q_m, k_m, v_m = _cached_qkv_merged(x, lp, cfg)          # (B, W, C)
        k_rows, v_rows = k_m.reshape(B * W, C), v_m.reshape(B * W, C)
        if use_kernel:
            q_m, k_new, v_new = (t.contiguous() for t in (q_m, k_m, v_m))
            scales = {}
            if kv_dtype is not None:
                k_new, v_new = (fake_quantize_rows(t, kv_dtype, H, gran)
                                .to(cd) for t in (k_new, v_new))
                scales = {"k_scales": cache["ks"][i],
                          "v_scales": cache["vs"][i]}
            attn = paged_window_attention(
                q_m, k_new, v_new, cache["k"][i], cache["v"][i], tables,
                pos32, n_head=H, max_pos=max_pos, **scales)
            _scatter_kv(cache, i, phys, woff, k_rows, v_rows, packed, H,
                        drop=drop)
        else:
            _scatter_kv(cache, i, phys, woff, k_rows, v_rows, packed, H,
                        drop=drop)
            k_all, v_all = _gather_kv(cache, i, tables, packed, H, cd)
            attn = _merge_heads(windowed_cached_attention(
                _split_heads(q_m, H), k_all, v_all, pos_eff))
        x = _block_tail(x, attn, lp, cfg)
    if logits_rows is not None:
        x = x[:, :logits_rows]
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"],
                    cfg.layernorm_eps)
    head = params["wte"].T if cfg.tied_head else params["lm_head"]
    return (x @ head).float(), cache


#: ``sample_fn(t, logits)`` of the windows: step ``t``'s (B, V) f32
#: logits -> (B,) int32 tokens (the caller knows which slots draw at t)
SampleFn = Callable[[int, torch.Tensor], torch.Tensor]


def _window_bookkeeping(nxt, live, tok, pos, budget, eos):
    """One window step's per-slot state update for the slots ``live``
    (decoding, so emitting) at it: their budget is spent and their
    position advanced; a slot whose budget runs out or whose token is its
    ``eos`` (>= 0) stops. Returns (nxt, 0 where not live, tok, pos,
    budget, stopped)."""
    nxt = torch.where(live, nxt, torch.zeros_like(nxt))
    budget = torch.where(live, budget - 1, budget)
    hit_eos = live & (eos >= 0) & (nxt == eos)
    pos = torch.where(live, pos + 1, pos)
    tok = torch.where(live, nxt, tok)
    return nxt, tok, pos, budget, live & ((budget <= 0) | hit_eos)


def decode_window_paged(params: Params, tok, pos, active, budget, eos,
                        tables, cache, cfg: ModelConfig, *,
                        sample_fn: SampleFn, length: int,
                        use_kernel: bool = False, use_fused: bool = False,
                        fused_blocks: Optional[Dict[str, torch.Tensor]] = None,
                        max_pos=None):
    """``length`` decode steps with the per-slot state on the device
    (JAX ``decode_window_paged``): per step, ``decode_step_paged`` and
    ``sample_fn``, then every active slot emits its token, spends one of
    its ``budget`` and advances; a slot stops (inactive, its writes
    dropped, its emissions masked) once its budget is spent or it
    samples its ``eos`` (< 0: none), and idles for the rest of the
    window. Nothing is read back to the host. ``max_pos``: per step, the
    caller's host bound on every active slot's position (a sequence of
    ``length`` ints), or None (each step then reads the positions back).

    Returns ``(toks, emitted, tok, pos, active, budget)``: toks and
    emitted (length, B), the sampled tokens (0 where not emitted) and
    whether each slot was live at each step; the rest is the state the
    next window starts from. The pool is updated in place."""
    toks, emitted = [], []
    for t in range(length):
        logits, cache = decode_step_paged(
            params, tok, pos, active, tables, cache, cfg,
            use_kernel=use_kernel, use_fused=use_fused,
            fused_blocks=fused_blocks,
            max_pos=None if max_pos is None else max_pos[t])
        emitted.append(active)
        nxt, tok, pos, budget, stop = _window_bookkeeping(
            sample_fn(t, logits), active, tok, pos, budget, eos)
        active = active & ~stop
        toks.append(nxt)
    return torch.stack(toks), torch.stack(emitted), tok, pos, active, budget


def mixed_window_paged(params: Params, tok, pos, active, budget, eos,
                       pf_left, pf_off, pf_limit, pf_toks, tables, cache,
                       cfg: ModelConfig, *, sample_fn: SampleFn,
                       length: int, use_kernel: bool = False, max_pos=None):
    """``decode_window_paged`` with chunked prefill inside the window
    (JAX ``mixed_window_paged``). At step t a slot PREFILLS while ``t <
    pf_left[b]`` (the chunks this window writes for it) and decodes
    after. Each step is one ``verify_step_paged`` over a (B, W) window,
    W = ``pf_toks.shape[-1]`` (the prefill chunk):

    - a prefilling slot's row is its chunk ``pf_toks[t, b]`` at
      positions ``pf_off + t*W + j``; positions >= ``pf_limit`` (the
      prompt's length) write nothing. It emits nothing, its budget and
      position stay, and ``sample_fn`` must not draw for it (its random
      stream does not advance);
    - a decoding slot's row is its token at window column 0, position
      ``pos`` (the other columns are dropped padding), with
      ``decode_window_paged``'s bookkeeping.

    A slot flips from prefill to decode with no transition: ``pos`` and
    ``tok`` were set at admission to the prompt's last position and
    token. ``max_pos``: per step, a host bound on every active slot's
    row base (``pf_off + t*W`` while prefilling, else ``pos``), or None
    for the whole table. Returns what ``decode_window_paged`` returns;
    ``emitted[:, b]`` is False through b's prefill steps."""
    W = pf_toks.shape[-1]
    B = tok.shape[0]
    col = torch.arange(W, device=tok.device)[None, :]
    toks, emitted = [], []
    for t in range(length):
        prefilling = active & (t < pf_left)
        cur = pf_off + t * W
        n_tok = torch.where(prefilling, torch.clamp(pf_limit - cur, 1, W),
                            torch.ones_like(cur))
        base = torch.where(prefilling, cur, pos)
        col0 = torch.where(col == 0, tok[:, None],
                           torch.zeros((B, W), dtype=tok.dtype,
                                       device=tok.device))
        window = torch.where(prefilling[:, None], pf_toks[t].to(tok.dtype),
                             col0)
        logits, cache = verify_step_paged(
            params, window, base, n_tok - 1, active, tables, cache, cfg,
            logits_rows=1, use_kernel=use_kernel,
            max_pos=None if max_pos is None else max_pos[t])
        decoding = active & ~prefilling
        emitted.append(decoding)
        nxt, tok, pos, budget, stop = _window_bookkeeping(
            sample_fn(t, logits[:, 0]), decoding, tok, pos, budget, eos)
        active = active & ~stop
        toks.append(nxt)
    return torch.stack(toks), torch.stack(emitted), tok, pos, active, budget


def prefill_chunk_paged(params: Params, idx, offset: int, limit: int,
                        table_row, cache, cfg: ModelConfig, *, group=None,
                        host_row=None) -> Dict[str, torch.Tensor]:
    """Chunked prefill of ONE slot's prompt through its page table.

    idx: (1, Pc) chunk of the prompt; ``offset``: its first absolute
    position; ``limit``: the true prompt length — positions >= limit (a
    padded final chunk's tail) write nothing. Queries attend the
    gathered logical view masked to k <= offset + i (write-then-attend
    across chunks). With a serve ``group``, as ``decode_step_paged``
    (``host_row``: the table row on the host): the view spans every data
    shard's pages, since a prefix hit may sit on any of them. Returns
    the pool (updated in place)."""
    if group is not None:
        return _sharded_prefill_chunk(params, idx, offset, limit, table_row,
                                      cache, cfg, group, host_row)
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
        k_all, v_all = _gather_kv(cache, i, tables, packed, H, q_m.dtype)
        attn = windowed_cached_attention(_split_heads(q_m, H), k_all, v_all,
                                         base)
        x = _block_tail(x, _merge_heads(attn), lp, cfg)
    return cache


# ---------------------------------------------------------------------------
# the paged serving steps on a (data, model) serve mesh
# ---------------------------------------------------------------------------

def shard_config(cfg: ModelConfig, model_size: int) -> ModelConfig:
    """The configuration one model shard's pool block and heads see:
    ``n_head / model_size`` heads, ``n_embd / model_size`` channels."""
    return dataclasses.replace(cfg, n_head=cfg.n_head // model_size,
                               n_embd=cfg.n_embd // model_size)


def init_sharded_kv_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                         group, device=None, quant=None) -> Dict:
    """``{(d, m): pool}`` for every shard the serve ``group`` holds: data
    shard d's block of ``n_pages / group.data_size`` physical pages (page
    d * block + i is its local page i), in model shard m's columns (its
    heads' K/V; a quantized pool's scales per row of the block, per row
    and local head at head granularity), as ``init_paged_kv_pool`` lays
    out a whole pool."""
    block = n_pages // group.data_size
    scfg = shard_config(cfg, group.model_size)
    return {(d, m): init_paged_kv_pool(scfg, block, page_size,
                                       device=device, quant=quant)
            for d in group.data_shards for m in group.model_shards}


def _block_plan(tab: np.ndarray, shards, block: int, device) -> list:
    """Per data shard d of ``shards``: (the (B, mp) table in ids local to
    d's block, the bool mask of the entries that lie in it) on
    ``device``; entries outside it read as local page 0 and are masked."""
    out = []
    for d in shards:
        lo = d * block
        inblk = (tab >= lo) & (tab < lo + block)
        loc = np.where(inblk, tab - lo, 0).astype(np.int32)
        out.append((torch.from_numpy(loc).to(device),
                    torch.from_numpy(inblk).to(device)))
    return out


def _write_plan(phys: np.ndarray, woff: np.ndarray, rows: np.ndarray,
                shards, block: int, device) -> list:
    """Per data shard: (rows, local pages, offsets) of the fresh K/V rows
    (row ``rows[j]`` lands at global page ``phys[j]``) that it stores."""
    out = []
    for d in shards:
        sel = (phys >= d * block) & (phys < (d + 1) * block)
        out.append(tuple(torch.from_numpy(a[sel].astype(np.int64))
                         .to(device) for a in (rows, phys - d * block,
                                               woff)))
    return out


def _row_amax(cache, k_rows, v_rows, group) -> tuple:
    """The fresh K and V rows' whole-row maxima over the model shards
    (``k_rows[j]``: (R, C_loc) of model shard ``group.model_shards[j]``),
    which a page-granularity scale needs; (None, None) otherwise."""
    kv_dtype, gran = pool_quant_mode(next(iter(cache.values())))
    if kv_dtype is None or gran != "page":
        return None, None
    return tuple(group.max_model([row_amax(r) for r in rows])
                 for rows in (k_rows, v_rows))


def _shard_write(cache, i: int, writes, k_rows, v_rows, group, cfg,
                 amax=None):
    """Store each model shard's fresh K/V columns (``k_rows[j]``: (R,
    C_loc) of model shard ``group.model_shards[j]``) in the data blocks
    that own their pages, quantized on write with ``amax`` (default:
    ``_row_amax``) for page-granularity scales."""
    packed = cfg.decode_cache_layout == "packed"
    hl = cfg.n_head // group.model_size
    if amax is None:
        amax = _row_amax(cache, k_rows, v_rows, group)
    for j, m in enumerate(group.model_shards):
        for d, (rows, phys, woff) in zip(group.data_shards, writes):
            if rows.numel():
                _scatter_kv(cache[(d, m)], i, phys, woff, k_rows[j][rows],
                            v_rows[j][rows], packed, hl,
                            tuple(a if a is None else a[rows]
                                  for a in amax))


def _shard_view(cache, i: int, m: int, blocks, group, cfg, cd):
    """One layer's logical (B, H_loc, S, D) K and V views of model shard
    m: each held data block read through its local table, the entries
    outside it zeroed, summed over the data shards (exact: each logical
    page lies in one block)."""
    packed = cfg.decode_cache_layout == "packed"
    hl = cfg.n_head // group.model_size
    views = []
    for name in ("k", "v"):
        parts = []
        for d, (loc, inblk) in zip(group.data_shards, blocks):
            pool = cache[(d, m)]
            g = _gather_pages(pool[name][i], loc, packed, hl,
                              s_layer=pool[name + "s"][i] if "ks" in pool
                              else None, cd=cd)
            mask = inblk.repeat_interleave(g.shape[2] // inblk.shape[1], 1)
            parts.append(torch.where(mask[:, None, :, None], g,
                                     torch.zeros_like(g)))
        views.append(group.sum_data(parts))
    return views


def _embed_sharded(sp, idx, positions, group):
    """Token + position embedding; a vocab-parallel ``wte`` looks each id
    up in the shard whose rows hold it and sums over 'model'."""
    wte = sp["wte"]
    if not isinstance(wte, dict):
        return wte[idx.long()] + sp["wpe"][positions]
    parts = []
    for m in group.model_shards:
        vl = wte[m].shape[0]
        loc = idx.long() - m * vl
        hit = (loc >= 0) & (loc < vl)
        rows = wte[m][loc.clamp(0, vl - 1)]
        parts.append(torch.where(hit[..., None], rows,
                                 torch.zeros_like(rows)))
    return group.sum_model(parts) + sp["wpe"][positions]


def _head_sharded(x, sp, cfg: ModelConfig, group):
    """Final layernorm and head over (B, 1, C) -> (B, V) f32 logits; a
    vocab-parallel head gathers its shards' columns over 'model'."""
    x = _layer_norm(x, sp["ln_f_scale"], sp["ln_f_bias"],
                    cfg.layernorm_eps)[:, 0, :]
    head = sp["wte"] if cfg.tied_head else sp["lm_head"]
    if not isinstance(head, dict):
        return (x @ (head.T if cfg.tied_head else head)).float()
    return group.gather_model([
        x @ (head[m].T if cfg.tied_head else head[m])
        for m in group.model_shards]).float()


def _sharded_block(x, i: int, sp, cfg: ModelConfig, group, attend):
    """One pre-LN block with Megatron TP over the model shards: q/k/v
    of each shard's heads (column-parallel), ``attend(qkv)`` -> each
    shard's (B, T, C_loc) attention, the projection (row-parallel) summed
    over 'model' before its bias, the MLP up (column) and down (row,
    summed, then its bias)."""
    rep, tp = sp["blocks"], sp["tp"]
    eps = cfg.layernorm_eps
    cl = cfg.n_embd // sp["tp_size"]
    shards = group.model_shards
    h = _layer_norm(x, rep["ln1_scale"][i], rep["ln1_bias"][i], eps)
    qkv = [(h @ tp[m]["qkv_kernel"][i] + tp[m]["qkv_bias"][i]).split(cl, -1)
           for m in shards]
    attn = attend(qkv)
    h_mid = x + (group.sum_model([a @ tp[m]["attn_out_kernel"][i]
                                  for a, m in zip(attn, shards)])
                 + rep["attn_out_bias"][i])
    h = _layer_norm(h_mid, rep["ln2_scale"][i], rep["ln2_bias"][i], eps)
    parts = [_activation(h @ tp[m]["mlp_up_kernel"][i]
                         + tp[m]["mlp_up_bias"][i], cfg.activation)
             @ tp[m]["mlp_down_kernel"][i] for m in shards]
    return h_mid + (group.sum_model(parts) + rep["mlp_down_bias"][i])


def _sharded_decode_step(sp, idx_t, pos, active, tables, cache,
                         cfg: ModelConfig, group, use_kernel: bool,
                         host_tables):
    """``decode_step_paged`` on a serve group's shards. Per layer and
    model shard: the kernel route runs ``sharded_paged_window_attention``
    (each held data block's partials over the pages it owns, merged
    over 'data', the fresh row folded once) and then stores the row in
    the block that owns its page; the gather route stores it first and
    attends the view summed over the data blocks."""
    B = idx_t.shape[0]
    packed = cfg.decode_cache_layout == "packed"
    if use_kernel and not packed:
        raise ValueError("the paged attention kernels need the packed "
                         "cache layout")
    pool0 = next(iter(cache.values()))
    psz = paged_page_size(cfg, pool0)
    block = pool0["k"].shape[1]
    mp = tables.shape[1]
    hl = cfg.n_head // group.model_size
    kv_dtype, gran = pool_quant_mode(pool0)
    dev = idx_t.device
    pos_eff = torch.where(active, pos, torch.zeros_like(pos))
    # one host read per step, as on one device: the bounds check, the
    # rows that write, the blocks' owned pages and their row counts
    pe = pos_eff.cpu().numpy().astype(np.int64)
    act = active.cpu().numpy()
    _check_in_bounds(int(pe.min()), int(pe.max()) + 1, mp * psz,
                     "paged decode write")
    tab = (np.asarray(host_tables) if host_tables is not None
           else tables.cpu().numpy()).astype(np.int64)
    rows = np.flatnonzero(act)
    phys = tab[rows, np.minimum(pe[rows] // psz, mp - 1)]
    writes = _write_plan(phys, pe[rows] % psz, rows, group.data_shards,
                         block, dev)
    blocks = _block_plan(tab, group.data_shards, block, dev)
    x = _embed_sharded(sp, idx_t, pos_eff.long(), group)[:, None, :]
    cd = x.dtype
    pos32 = pos_eff.to(torch.int32)
    if use_kernel:
        live = (pe + psz - 1) // psz
        p_idx = np.arange(mp)[None, :]
        page_rows = np.clip(pe[:, None] - p_idx * psz, 0, psz)
        local, spans = [], []
        for d, (loc, _) in zip(group.data_shards, blocks):
            own = ((p_idx < live[:, None]) & (tab >= d * block)
                   & (tab < (d + 1) * block))
            spans.append(int((page_rows * own).sum(1).max()))
            local.append((loc, torch.from_numpy(own.astype(np.int32))
                          .to(dev)))

    def attend_kernel(i, qkv):
        k_rows = [t[1][:, 0] for t in qkv]
        v_rows = [t[2][:, 0] for t in qkv]
        amax = _row_amax(cache, k_rows, v_rows, group)
        k_new = [t[1] for t in qkv]
        v_new = [t[2] for t in qkv]
        if kv_dtype is not None:
            # the fresh rows as the write below stores them
            k_new, v_new = ([fake_quantize_rows(
                t, kv_dtype, hl, gran, None if a is None else a[:, None])
                .to(cd) for t in ts] for ts, a in zip((k_new, v_new), amax))
        out = []
        for j, m in enumerate(group.model_shards):
            pools = [cache[(d, m)] for d in group.data_shards]
            sc = {}
            if kv_dtype is not None:
                sc = {"k_scales": [p["ks"][i] for p in pools],
                      "v_scales": [p["vs"][i] for p in pools]}
            out.append(sharded_paged_window_attention(
                qkv[j][0].contiguous(), k_new[j].contiguous(),
                v_new[j].contiguous(), [p["k"][i] for p in pools],
                [p["v"][i] for p in pools], tables, pos32, group,
                n_head=hl, local=local, spans=spans, **sc))
        _shard_write(cache, i, writes, k_rows, v_rows, group, cfg, amax)
        return out

    def attend_gather(i, qkv):
        _shard_write(cache, i, writes, [t[1][:, 0] for t in qkv],
                     [t[2][:, 0] for t in qkv], group, cfg)
        out = []
        for j, m in enumerate(group.model_shards):
            k_all, v_all = _shard_view(cache, i, m, blocks, group, cfg, cd)
            out.append(_merge_heads(cached_attention(
                _split_heads(qkv[j][0], hl), k_all, v_all, pos_eff)))
        return out

    attend = attend_kernel if use_kernel else attend_gather
    for i in range(cfg.n_layer):
        x = _sharded_block(x, i, sp, cfg, group,
                           functools.partial(attend, i))
    return _head_sharded(x, sp, cfg, group), cache


def _sharded_prefill_chunk(sp, idx, offset: int, limit: int, table_row,
                           cache, cfg: ModelConfig, group, host_row):
    """``prefill_chunk_paged`` on a serve group's shards (the JAX gather
    route): each chunk row is stored in the block that owns its page,
    and the queries attend the view summed over the data blocks."""
    offset, limit = int(offset), int(limit)
    _, Pc = idx.shape
    pool0 = next(iter(cache.values()))
    psz = paged_page_size(cfg, pool0)
    block = pool0["k"].shape[1]
    mp = table_row.shape[0]
    hl = cfg.n_head // group.model_size
    _check_in_bounds(offset, offset + 1, cfg.block_size,
                     "paged prefill chunk")
    dev = idx.device
    row = (np.asarray(host_row) if host_row is not None
           else table_row.cpu().numpy()).astype(np.int64)
    positions = offset + torch.arange(Pc, device=dev)
    x = _embed_sharded(sp, idx, positions.clamp(max=cfg.block_size - 1)
                       [None], group)
    cd = x.dtype
    n_write = max(0, min(Pc, min(limit, mp * psz) - offset))
    wpos = offset + np.arange(n_write)
    writes = _write_plan(row[wpos // psz], wpos % psz, np.arange(n_write),
                         group.data_shards, block, dev)
    blocks = _block_plan(row[None], group.data_shards, block, dev)
    base = torch.tensor([offset], device=dev)

    def attend(i, qkv):
        _shard_write(cache, i, writes, [t[1][0] for t in qkv],
                     [t[2][0] for t in qkv], group, cfg)
        out = []
        for j, m in enumerate(group.model_shards):
            k_all, v_all = _shard_view(cache, i, m, blocks, group, cfg, cd)
            out.append(_merge_heads(windowed_cached_attention(
                _split_heads(qkv[j][0], hl), k_all, v_all, base)))
        return out

    for i in range(cfg.n_layer):
        x = _sharded_block(x, i, sp, cfg, group,
                           functools.partial(attend, i))
    return cache


# ---------------------------------------------------------------------------
# contiguous KV cache: generate()'s decode and prefill
# ---------------------------------------------------------------------------

def cache_seq_axis(cfg: ModelConfig) -> int:
    """Axis of the sequence dimension in the stacked KV cache."""
    return 2 if cfg.decode_cache_layout == "packed" else 3


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: Optional[int] = None,
                  dtype: Optional[torch.dtype] = None, device=None
                  ) -> Dict[str, torch.Tensor]:
    """(L, B, H, S, D) for the 'heads' layout or (L, B, S, C) for
    'packed', zero-filled, for K and V."""
    S = max_len or cfg.block_size
    dt = dtype or cfg.compute_dtype
    if cfg.decode_cache_layout == "packed":
        shape = (cfg.n_layer, batch, S, cfg.n_embd)
    else:
        shape = (cfg.n_layer, batch, cfg.n_head, S, cfg.head_dim)
    return {"k": torch.zeros(shape, device=device, dtype=dt),
            "v": torch.zeros(shape, device=device, dtype=dt)}


def decode_route(cfg: ModelConfig, batch: int, cache_dtype: torch.dtype,
                 seq_len: int, allow_kernels: bool = True) -> str:
    """Which route ``decode_step`` takes: 'fused' (all layers in one
    kernel, B=1), 'packed' (the packed decode attention kernel per
    layer) or 'plain'. The JAX envelopes decide, as in JAX's
    ``decode_step`` with its kernel gate open; the kernels need the cache
    in the compute dtype."""
    cd = cfg.compute_dtype
    if not allow_kernels or cache_dtype != cd:
        return "plain"
    isz = torch.empty((), dtype=cd).element_size()
    if fused_decode_supported(cfg, batch, isz, seq_len=seq_len):
        return "fused"
    if cfg.decode_cache_layout == "packed" and packed_decode_supported(
            cfg, isz, seq_len=seq_len):
        return "packed"
    return "plain"


def write_fresh_kv(cache: Dict[str, torch.Tensor], newk, newv, pos: int,
                   cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Write every layer's fresh (L, B, C) K/V rows into the cache at
    ``pos``, in place (the fused route's one write per array)."""
    L, B, C = newk.shape
    if cfg.decode_cache_layout == "packed":
        cache["k"][:, :, pos] = newk.to(cache["k"].dtype)
        cache["v"][:, :, pos] = newv.to(cache["v"].dtype)
    else:
        shp = (L, B, cfg.n_head, C // cfg.n_head)
        cache["k"][:, :, :, pos] = newk.reshape(shp).to(cache["k"].dtype)
        cache["v"][:, :, :, pos] = newv.reshape(shp).to(cache["v"].dtype)
    return cache


def decode_step(params: Params, idx_t: torch.Tensor, pos: int,
                cache: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                allow_kernels: bool = True,
                fused_blocks: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One autoregressive step of B rows at the shared host position
    ``pos``. params: the ``compute_params`` view; idx_t: (B,) current
    tokens. Returns ((B, V) f32 logits, the cache, updated in place).

    Routes (``decode_route``): 'fused' runs ``fused_decode_layers`` and
    then writes every layer's fresh K/V at pos; 'packed' attends the
    stale layer cache plus the fresh column through
    ``packed_decode_attention`` and writes afterwards; 'plain' writes
    and then attends through ``cached_attention``. ``allow_kernels``
    False forces 'plain' (JAX's ``allow_pallas``). ``fused_blocks``:
    the blocks as ``fused_weights`` casts them, made once by callers
    that step many times (else cast here)."""
    pos = int(pos)
    B = idx_t.shape[0]
    S = cache["k"].shape[cache_seq_axis(cfg)]
    _check_in_bounds(pos, pos + 1, S, "decode_step cache write")
    x = params["wte"][idx_t.long()] + params["wpe"][pos]         # (B, C)
    route = decode_route(cfg, B, cache["k"].dtype, S, allow_kernels)
    if route == "fused":
        blocks = fused_blocks or fused_weights(params["blocks"],
                                               x.dtype)
        x_row, newk, newv = fused_decode_layers(x, blocks, pos, cache, cfg)
        write_fresh_kv(cache, newk, newv, pos, cfg)
        return _decode_head(x_row[:, None, :], params, cfg), cache
    x = x[:, None, :]                                           # (B, 1, C)
    H = cfg.n_head
    packed = cfg.decode_cache_layout == "packed"
    for i in range(cfg.n_layer):
        lp = _layer(params, i)
        q_m, k_m, v_m = _cached_qkv_merged(x, lp, cfg)          # (B, 1, C)
        ck, cv = cache["k"][i], cache["v"][i]
        if route == "packed":
            attn = packed_decode_attention(
                q_m[:, 0], k_m[:, 0], v_m[:, 0], ck, cv, pos,
                n_head=H)[:, None]
            ck[:, pos] = k_m[:, 0].to(ck.dtype)
            cv[:, pos] = v_m[:, 0].to(cv.dtype)
        elif packed:
            ck[:, pos] = k_m[:, 0].to(ck.dtype)
            cv[:, pos] = v_m[:, 0].to(cv.dtype)
            attn = _merge_heads(cached_attention(
                _split_heads(q_m, H), _split_heads(ck, H),
                _split_heads(cv, H), pos))
        else:
            k, v = _split_heads(k_m, H), _split_heads(v_m, H)  # (B, H, 1, D)
            ck[:, :, pos] = k[:, :, 0].to(ck.dtype)
            cv[:, :, pos] = v[:, :, 0].to(cv.dtype)
            attn = _merge_heads(cached_attention(_split_heads(q_m, H), ck,
                                                 cv, pos))
        x = _block_tail(x, attn, lp, cfg)
    return _decode_head(x, params, cfg), cache


def prefill(params: Params, idx: torch.Tensor, cache: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Fill cache positions [0, P) from the (B, P) prompt in one
    full-sequence causal forward (JAX ``prefill``). Positions at or past
    the true prompt length may hold padding-derived values; each decode
    step overwrites its position before attending it. Returns the cache,
    updated in place."""
    B, P = idx.shape
    _check_in_bounds(0, P, cache["k"].shape[cache_seq_axis(cfg)],
                     "prefill prompt write")
    H = cfg.n_head
    packed = cfg.decode_cache_layout == "packed"
    x = params["wte"][idx.long()] + params["wpe"][:P]
    for i in range(cfg.n_layer):
        lp = _layer(params, i)
        q_m, k_m, v_m = _cached_qkv_merged(x, lp, cfg)           # (B, P, C)
        q, k, v = (_split_heads(t, H) for t in (q_m, k_m, v_m))
        ck, cv = cache["k"][i], cache["v"][i]
        if packed:
            ck[:, :P] = k_m.to(ck.dtype)
            cv[:, :P] = v_m.to(cv.dtype)
        else:
            ck[:, :, :P] = k.to(ck.dtype)
            cv[:, :, :P] = v.to(cv.dtype)
        attn = full_causal_attention(q, k, v)
        x = _block_tail(x, _merge_heads(attn), lp, cfg)
    return cache


# ---------------------------------------------------------------------------
# multi-slot steps on the contiguous pool (the model drafter's cache)
# ---------------------------------------------------------------------------

def _slot_drop(cache, rows, woff, valid, packed: bool) -> _DropPlan:
    """``_drop_plan`` over a contiguous (L, B, S, ...) pool: a slot's
    buffer is one page of S rows, so the page of row (b, s) is b and its
    offset s. Rows outside ``valid`` write nothing (JAX's ``mode='drop'``
    for positions at or past S)."""
    S = cache["k"].shape[2 if packed else 3]
    return _drop_plan(cache, rows, woff.clamp(0, S - 1), valid, packed)


def decode_step_multi(params: Params, idx_t: torch.Tensor, pos: torch.Tensor,
                      cache: Dict[str, torch.Tensor], cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step of B cache slots at PER-SLOT positions (JAX
    ``decode_step_multi``): idx_t, pos (B,). Slot b's K/V lands at (b,
    pos[b]) and its query attends positions <= pos[b]
    (``cached_attention`` with a (B,) position). A slot at a position
    past the buffer writes nothing (dropped on the device, as JAX's
    scatter drops an out-of-bounds update) and reads its position
    embedding at the last row (JAX's clamped gather). The plain PyTorch
    path: JAX runs no kernel here, since its decode kernels assume one
    shared position. Returns ((B, V) f32 logits, the cache, updated in
    place)."""
    B = idx_t.shape[0]
    packed = cfg.decode_cache_layout == "packed"
    H, C = cfg.n_head, cfg.n_embd
    S = cache["k"].shape[cache_seq_axis(cfg)]
    pos = pos.long()
    x = (params["wte"][idx_t.long()]
         + params["wpe"][pos.clamp(0, cfg.block_size - 1)])[:, None, :]
    rows = torch.arange(B, device=pos.device)
    drop = _slot_drop(cache, rows, pos, pos < S, packed)
    for i in range(cfg.n_layer):
        lp = _layer(params, i)
        q_m, k_m, v_m = _cached_qkv_merged(x, lp, cfg)          # (B, 1, C)
        _scatter_kv(cache, i, rows, pos, k_m.reshape(B, C),
                    v_m.reshape(B, C), packed, H, drop=drop)
        ck, cv = cache["k"][i], cache["v"][i]
        if packed:
            ck, cv = _split_heads(ck, H), _split_heads(cv, H)
        attn = cached_attention(_split_heads(q_m, H), ck, cv, pos)
        x = _block_tail(x, _merge_heads(attn), lp, cfg)
    return _decode_head(x, params, cfg), cache


def verify_step_multi(params: Params, window: torch.Tensor, pos: torch.Tensor,
                      n_valid: torch.Tensor, cache: Dict[str, torch.Tensor],
                      cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A (B, W) token window per slot in one pass over the contiguous pool
    (JAX ``verify_step_multi``): window token j of slot b sits at position
    ``pos[b] + j`` and attends positions <= its own
    (``windowed_cached_attention``, write-then-attend). Rows j >
    ``n_valid[b]`` and rows at or past the buffer write nothing (dropped
    on the device, JAX's writes to position S under ``mode='drop'``);
    their logits are garbage the caller discards. Returns ((B, W, V) f32
    logits, the cache, updated in place)."""
    B, W = window.shape
    packed = cfg.decode_cache_layout == "packed"
    H, C = cfg.n_head, cfg.n_embd
    S = cache["k"].shape[cache_seq_axis(cfg)]
    pos = pos.long()
    offs = torch.arange(W, device=pos.device)[None, :]
    abs_pos = pos[:, None] + offs                               # (B, W)
    x = (params["wte"][window.long()]
         + params["wpe"][abs_pos.clamp(0, min(S, cfg.block_size) - 1)])
    valid = (offs <= n_valid.long()[:, None]) & (abs_pos < S)
    rows = torch.arange(B, device=pos.device)[:, None].expand(B, W)
    drop = _slot_drop(cache, rows, abs_pos, valid, packed)
    for i in range(cfg.n_layer):
        lp = _layer(params, i)
        q_m, k_m, v_m = _cached_qkv_merged(x, lp, cfg)          # (B, W, C)
        _scatter_kv(cache, i, rows, abs_pos, k_m.reshape(B * W, C),
                    v_m.reshape(B * W, C), packed, H, drop=drop)
        ck, cv = cache["k"][i], cache["v"][i]
        if packed:
            ck, cv = _split_heads(ck, H), _split_heads(cv, H)
        attn = windowed_cached_attention(_split_heads(q_m, H), ck, cv, pos)
        x = _block_tail(x, _merge_heads(attn), lp, cfg)
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"],
                    cfg.layernorm_eps)
    head = params["wte"].T if cfg.tied_head else params["lm_head"]
    return (x @ head).float(), cache


def prefill_chunk_into_slot(params: Params, idx: torch.Tensor, offset: int,
                            slot: int, cache: Dict[str, torch.Tensor],
                            cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Chunked prefill into ONE slot of the contiguous pool (JAX
    ``prefill_chunk_into_slot``): idx (1, Pc) is a prompt chunk whose
    first position is the host int ``offset``. Writes its K/V at
    ``cache[:, slot, offset:offset + Pc]`` and runs the blocks with query
    i attending the slot's buffer at positions <= offset + i, so chunk 2
    sees chunk 1's K/V. Positions of a right-padded final chunk past the
    prompt hold padding K/V, which a decode step overwrites before it
    attends them. Returns the cache, updated in place."""
    Pc = idx.shape[1]
    packed = cfg.decode_cache_layout == "packed"
    H = cfg.n_head
    S = cache["k"].shape[cache_seq_axis(cfg)]
    _check_in_bounds(offset, offset + Pc, S, "prefill chunk write")
    _check_in_bounds(slot, slot + 1, cache["k"].shape[1],
                     "prefill slot index")
    x = params["wte"][idx.long()] + params["wpe"][offset:offset + Pc]
    base = torch.tensor([offset], device=idx.device)
    for i in range(cfg.n_layer):
        lp = _layer(params, i)
        q_m, k_m, v_m = _cached_qkv_merged(x, lp, cfg)          # (1, Pc, C)
        ck, cv = cache["k"][i][slot], cache["v"][i][slot]
        if packed:
            ck[offset:offset + Pc] = k_m[0].to(ck.dtype)
            cv[offset:offset + Pc] = v_m[0].to(cv.dtype)
            k_h, v_h = _split_heads(ck[None], H), _split_heads(cv[None], H)
        else:
            ck[:, offset:offset + Pc] = _split_heads(k_m, H)[0].to(ck.dtype)
            cv[:, offset:offset + Pc] = _split_heads(v_m, H)[0].to(cv.dtype)
            k_h, v_h = ck[None], cv[None]
        attn = windowed_cached_attention(_split_heads(q_m, H), k_h, v_h,
                                         base)
        x = _block_tail(x, _merge_heads(attn), lp, cfg)
    return cache
