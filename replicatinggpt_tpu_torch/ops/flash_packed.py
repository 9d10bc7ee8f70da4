"""Packed causal flash attention off the fused (B, T, 3C) QKV output.

The port of ``replicatinggpt_tpu/ops/flash_pallas.py``'s packed resident
family (``pallas_flash_attention_packed(family="resident")``, custom VJP
``_flash_packed``): head h's q, k and v are the column strips
``[h*D, (h+1)*D)``, ``C + ...`` and ``2C + ...`` of each row. The forward
gives the merged (B, T, C) output in qkv's dtype and the f32 lse
(B, T, H); the backward gives the packed d(qkv) from lse and delta =
rowsum(dO * O) per head. Causal, scale D**-0.5, f32 softmax; with a rate
the attention weights get the JAX kernels' hashed dropout mask (the
normalizer sees no dropout), bit for bit for the same int32 seed.

- ``fmix32`` / ``dropout_mult``: the mask (``_fmix32``, ``_dropout_mult``)
  in int64 tensor arithmetic;
- ``attention_ref`` / ``attention_bwd_ref``: the plain math on
  (B, H, T, D) heads, causal or not, at any scale and global offsets,
  shared with ``ops/flash_heads.py`` and ``ops/flash_chunk.py``: f32
  scores and softmax over 64-key tiles, with the probabilities and the
  score gradients rounded to the input dtype before their products,
  where the kernels and the JAX kernels round them;
- ``flash_packed_fwd_ref`` / ``flash_packed_bwd_ref``: the plain PyTorch
  versions (the CPU path and the card's yardstick of correctness);
- ``flash_packed_fwd`` / ``flash_packed_bwd``: the wrappers. A CPU tensor
  takes the plain version; a CUDA tensor launches
  ``csrc/flash_packed.cu`` or raises. Each has a ``.launches`` counter;
- ``FlashPacked``: the ``torch.autograd.Function`` over the two;
- ``flash_packed_envelope``: the shapes the kernels take.

One kernel stands for all of the JAX packed families: the resident one
(``_packed_fwd`` / ``_packed_bwd``, the char-GPT shapes), the head-group
one (``_group_fwd`` / ``_group_bwd``, which the JAX package takes at
GPT-2 124M, T=1024) and its streamed and triangular variants
(``_group_fwd_stream``, ``_group_bwd_stream``, ``_group_fwd_tri``,
``_group_bwd_tri``, long T). They compute the same function and differ
only in what the TPU keeps resident in VMEM; the kernels here walk K/V
tiles through shared memory at any T that is a multiple of 64, at
D in {32, 64, 128, 256}: bf16 on the tensor cores, f32 on the CUDA cores
(the f32 D=256 backward on 32-row tiles). The same kernel body serves
the (B, H, T, D) layout (``ops/flash_heads.py``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build
from .attention import NEG_INF, quantize_dropout_rate

_KERNEL = "flash_packed"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)   # csrc/flash_packed.cu instantiations
# csrc/flash_packed.cu kTile: the rows of a kernel tile, T's granule,
# and the key tile over which the kernels and the plain forward round p
# from the running max (the JAX kernels' block_k at the tests' blocks)
TILE = 64
MASK32 = 0xFFFFFFFF
LOG2E = float(np.float32(1.4426950408889634))   # csrc/flash_packed.cu kLog2e


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the product is split
    in 16-bit halves so no intermediate leaves int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values
    (the CPU has no ``>>`` for ``torch.uint32``)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_params(rate: float) -> Tuple[int, float]:
    """(threshold, keep): keep a weight iff its hash > threshold and
    scale it by keep = (float32)(1/(1-q)), q the quantized rate."""
    q = quantize_dropout_rate(rate)
    return int(q * 256) * 2 ** 24, float(np.float32(1.0 / (1.0 - q)))


def dropout_mult(seed: int, bh: torch.Tensor, q_pos: torch.Tensor,
                 k_pos: torch.Tensor, rate: float) -> torch.Tensor:
    """(N, Tq, Tk) f32 tile of {0, 1/(1-q)} for the N (batch*head) ids
    ``bh`` at absolute positions ``q_pos`` x ``k_pos``."""
    threshold, keep = dropout_params(rate)
    h = fmix32((seed & MASK32) ^ _mul32(bh.long(), 0x9E3779B9))
    a = fmix32(h[:, None] ^ q_pos.long()[None, :])
    y = fmix32(a[:, :, None] ^ k_pos.long()[None, None, :])
    return torch.where(y > threshold, keep, 0.0).float()


def flash_packed_envelope(seq_len: int, n_embd: int, n_head: int,
                          itemsize: int) -> Tuple[bool, Tuple[str, ...]]:
    """``(ok, reasons)`` for the CUDA kernels at these shapes."""
    reasons = []
    if n_embd % n_head or n_embd // n_head not in HEAD_DIMS:
        reasons.append("head_dim")
    if seq_len <= 0 or seq_len % TILE:
        reasons.append("seq_len")
    if itemsize not in (2, 4):
        reasons.append("dtype")
    return (not reasons), tuple(reasons)


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, C) -> (B, H, T, D), in x's dtype."""
    B, T, C = x.shape
    return x.reshape(B, T, n_head, C // n_head).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, C)."""
    B, H, T, D = x.shape
    return x.transpose(1, 2).reshape(B, T, H * D)


def _split(qkv: torch.Tensor, n_head: int):
    C = qkv.shape[-1] // 3
    return tuple(_heads(qkv[..., i * C:(i + 1) * C], n_head)
                 for i in range(3))


def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) as the bf16 kernels take it (``exp_``): exp2(x log2 e) in
    f32, the product rounded first, so that on the card the two agree
    bit for bit."""
    return torch.exp2(x * LOG2E)


def _positions(offset: int, n: int, device) -> torch.Tensor:
    """Global positions offset, ..., offset + n - 1 as the kernels hash
    them (uint32 wrap-around)."""
    return (offset + torch.arange(n, device=device)) & MASK32


def _mult(B: int, H: int, T: int, seed: int, rate: float,
          device) -> torch.Tensor:
    """(B, H, T, T) dropout multipliers at offsets 0."""
    return chunk_mult(B, H, T, T, 0, 0, 0, seed, rate, device)


def chunk_mult(B: int, H: int, Tq: int, Tk: int, q_offset: int,
               k_offset: int, bh_offset: int, seed: int, rate: float,
               device) -> torch.Tensor:
    """(B, H, Tq, Tk) dropout multipliers of q rows at q_offset + r
    against keys at k_offset + c, head (b, h) keyed by bh_offset + b * H
    + h."""
    return dropout_mult(seed, _positions(bh_offset, B * H, device),
                        _positions(q_offset, Tq, device),
                        _positions(k_offset, Tk, device),
                        rate).reshape(B, H, Tq, Tk)


def visible(Tq: int, Tk: int, q_offset: int, k_offset: int,
            device) -> torch.Tensor:
    """(Tq, Tk) bool: key c at or before row r in global positions."""
    qpos = q_offset + torch.arange(Tq, device=device)
    kpos = k_offset + torch.arange(Tk, device=device)
    return kpos[None, :] <= qpos[:, None]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, scale: float, seed: int = 0,
                  rate: float = 0.0, q_offset: int = 0, k_offset: int = 0,
                  bh_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward as the kernels and the JAX kernels compute it, on
    (B, H, Tq, D) q and (B, H, Tk, D) k, v in their input dtype: f32
    scores, a walk over TILE-key tiles with a running max m and a
    dropout-free normalizer l, and each tile's p * z rounded to the
    input dtype before its product with v (``flash_pallas._fwd_tile``;
    a no-op for f32). q row r sits at global position q_offset + r, key
    c at k_offset + c; causal hides key c from row r iff it is past it.
    Only visible keys count (selected, never masked: no 0 x NaN), and a
    row with none gets o = 0, lse = NEG_INF. Returns (o f32, lse
    (B, H, Tq) f32)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    vis = visible(Tq, Tk, q_offset, k_offset, q.device) if causal else None
    m = torch.full((B, H, Tq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Tq, D), device=q.device)
    for c0 in range(0, Tk, TILE):
        c1 = min(c0 + TILE, Tk)
        s = (qf @ kf[:, :, c0:c1].transpose(-1, -2)) * scale
        if causal:
            s = torch.where(vis[:, c0:c1], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = _exp(s - m_new)
        if causal:
            p = torch.where(vis[:, c0:c1], p, 0.0)
        alpha = _exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if rate > 0.0:
            p = p * chunk_mult(B, H, Tq, c1 - c0, q_offset, k_offset + c0,
                               bh_offset, seed, rate, q.device)
        acc = acc * alpha + p.to(q.dtype).float() @ vf[:, :, c0:c1]
        m = m_new
    seen = l > 0
    o = torch.where(seen, acc / l.clamp(min=1e-30), 0.0)
    lse = torch.where(seen, m + torch.log(l.clamp(min=1e-30)), NEG_INF)
    return o, lse.squeeze(-1)


def attention_bwd_ref(q, k, v, g, lse, delta, *, causal: bool,
                      scale: float, seed: int = 0, rate: float = 0.0,
                      q_offset: int = 0, k_offset: int = 0,
                      bh_offset: int = 0):
    """Plain backward in the lse/delta form, positions as
    ``attention_ref``: p = exp(s - lse) over the visible keys, dp = (dO
    V^T) z, ds = p (dp - delta) scale, then p z and ds rounded to the
    input dtype before dV = (p z)^T dO, dK = ds^T Q and dQ = ds K, as the
    JAX kernels round them (``_dkv_tile``, ``_dq_tile``). q, k, v, g in
    their input dtype; lse, delta (B, H, Tq) f32. Returns f32 (dq, dk,
    dv)."""
    B, H, Tq, _ = q.shape
    Tk = k.shape[2]
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        vis = visible(Tq, Tk, q_offset, k_offset, q.device)
        s = torch.where(vis, s, NEG_INF)
    p = _exp(s - lse[..., None])
    if causal:
        p = torch.where(vis, p, 0.0)
    dp = gf @ vf.transpose(-1, -2)
    pz = p
    if rate > 0.0:
        z = chunk_mult(B, H, Tq, Tk, q_offset, k_offset, bh_offset, seed,
                       rate, q.device)
        dp = dp * z
        pz = p * z
    ds = p * (dp - delta[..., None]) * scale
    pz, ds = pz.to(q.dtype).float(), ds.to(q.dtype).float()
    return ds @ kf, ds.transpose(-1, -2) @ qf, pz.transpose(-1, -2) @ gf


def flash_packed_fwd_ref(qkv: torch.Tensor, n_head: int, *, seed: int = 0,
                         rate: float = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward. qkv: (B, T, 3C). Returns (o (B, T, C) in qkv's
    dtype, lse (B, T, H) f32)."""
    q, k, v = _split(qkv, n_head)
    o, lse = attention_ref(q, k, v, causal=True,
                           scale=q.shape[-1] ** -0.5, seed=seed, rate=rate)
    return _merge(o).to(qkv.dtype), lse.transpose(1, 2).contiguous()


def packed_delta(do: torch.Tensor, o: torch.Tensor,
                 n_head: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head: (B, T, H) f32 (dropout's mask is
    already inside O)."""
    B, T, C = o.shape
    return (do.float() * o.float()).reshape(B, T, n_head, C // n_head).sum(-1)


def flash_packed_bwd_ref(qkv: torch.Tensor, do: torch.Tensor,
                         lse: torch.Tensor, delta: torch.Tensor,
                         n_head: int, *, seed: int = 0,
                         rate: float = 0.0) -> torch.Tensor:
    """Plain backward (``attention_bwd_ref`` on the packed strips).
    Returns d(qkv) (B, T, 3C) in qkv's dtype."""
    q, k, v = _split(qkv, n_head)
    parts = attention_bwd_ref(
        q, k, v, _heads(do, n_head), lse.transpose(1, 2),
        delta.transpose(1, 2), causal=True, scale=q.shape[-1] ** -0.5,
        seed=seed, rate=rate)
    return torch.cat([_merge(t) for t in parts], dim=-1).to(qkv.dtype)


def _check_kernel_inputs(qkv: torch.Tensor, n_head: int, *extra) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes bf16 or f32 qkv; got {qkv.dtype}")
    B, T, C3 = qkv.shape
    ok, reasons = flash_packed_envelope(T, C3 // 3, n_head,
                                        qkv.element_size())
    if not ok:
        raise ValueError(f"shapes outside the kernel envelope: {reasons}")
    check_placement(qkv, *extra)


def check_placement(first: torch.Tensor, *rest: torch.Tensor) -> None:
    """Every kernel input on ``first``'s device, contiguous and 16-byte
    aligned (the kernels load 16 bytes a thread)."""
    for t in (first, *rest):
        if t.device != first.device:
            raise ValueError(f"inputs on several devices: {t.device}, "
                             f"{first.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel inputs must be contiguous and 16-byte "
                             "aligned")


def _check_packed(qkv: torch.Tensor, n_head: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % n_head:
        raise ValueError(f"qkv must be (B, T, 3C) with C divisible by "
                         f"n_head={n_head}; got {tuple(qkv.shape)}")


def dropout_args(seed: int, rate: float):
    """(seed, threshold, keep, on) as the kernels take them."""
    if rate <= 0.0:
        return 0, 0, 0.0, 0
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not a non-negative int32")
    threshold, keep = dropout_params(rate)
    return seed, threshold, keep, 1


def flash_packed_fwd(qkv: torch.Tensor, n_head: int, *, seed: int = 0,
                     rate: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward (shapes as ``flash_packed_fwd_ref``). CPU tensors run the
    plain version; CUDA tensors run the kernel, which takes contiguous
    bf16 or f32 qkv inside ``flash_packed_envelope``; anything else
    raises."""
    _check_packed(qkv, n_head)
    if qkv.device.type == "cpu":
        return flash_packed_fwd_ref(qkv, n_head, seed=seed, rate=rate)
    _check_kernel_inputs(qkv, n_head)
    B, T, C3 = qkv.shape
    C = C3 // 3
    o = torch.empty((B, T, C), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, T, n_head), dtype=torch.float32,
                      device=qkv.device)
    if B == 0:
        return o, lse
    D = C // n_head
    err = _lib().flash_packed_fwd_launch(
        qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), B, T, n_head, D,
        D ** -0.5, *dropout_args(seed, rate), _DTYPE_CODE[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_packed_fwd launch failed: CUDA error "
                           f"{err}")
    flash_packed_fwd.launches += 1
    return o, lse


def flash_packed_bwd(qkv: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, n_head: int, *, seed: int = 0,
                     rate: float = 0.0) -> torch.Tensor:
    """Backward (shapes as ``flash_packed_bwd_ref``; ``do`` in qkv's
    dtype, lse and delta f32). CPU tensors run the plain version; CUDA
    tensors run the two backward kernels or raise."""
    _check_packed(qkv, n_head)
    B, T, C3 = qkv.shape
    if do.shape != (B, T, C3 // 3) or lse.shape != (B, T, n_head) \
            or delta.shape != lse.shape:
        raise ValueError(f"do/lse/delta shapes {tuple(do.shape)}, "
                         f"{tuple(lse.shape)}, {tuple(delta.shape)} do not "
                         f"fit qkv {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return flash_packed_bwd_ref(qkv, do, lse, delta, n_head, seed=seed,
                                    rate=rate)
    _check_kernel_inputs(qkv, n_head, do, lse, delta)
    if do.dtype != qkv.dtype or lse.dtype != torch.float32 \
            or delta.dtype != torch.float32:
        raise TypeError(f"do must be {qkv.dtype} and lse/delta f32; got "
                        f"{do.dtype}, {lse.dtype}, {delta.dtype}")
    dqkv = torch.empty_like(qkv)
    if B == 0:
        return dqkv
    D = C3 // 3 // n_head
    err = _lib().flash_packed_bwd_launch(
        qkv.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), B, T, n_head, D, D ** -0.5,
        *dropout_args(seed, rate), _DTYPE_CODE[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_packed_bwd launch failed: CUDA error "
                           f"{err}")
    flash_packed_bwd.launches += 1
    return dqkv


flash_packed_fwd.launches = 0
flash_packed_bwd.launches = 0


class FlashPacked(torch.autograd.Function):
    """o = attention(qkv); saves qkv, o, lse and the seed, and its
    backward runs ``flash_packed_bwd`` (the kernel on CUDA tensors, the
    plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, qkv, n_head: int, seed: int, rate: float):
        o, lse = flash_packed_fwd(qkv, n_head, seed=seed, rate=rate)
        ctx.save_for_backward(qkv, o, lse)
        ctx.n_head, ctx.seed, ctx.rate = n_head, seed, rate
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        do = do.to(qkv.dtype).contiguous()
        delta = packed_delta(do, o, ctx.n_head)
        dqkv = flash_packed_bwd(qkv, do, lse, delta, ctx.n_head,
                                seed=ctx.seed, rate=ctx.rate)
        return dqkv, None, None, None


def flash_packed_attention(qkv: torch.Tensor, n_head: int, *, seed: int = 0,
                           rate: float = 0.0) -> torch.Tensor:
    """Differentiable packed attention: merged (B, T, C) output."""
    return FlashPacked.apply(qkv.contiguous(), n_head, seed, rate)


def _lib() -> ctypes.CDLL:
    """The kernels' library, its six entry points typed: the packed
    (qkv, ...) pair, the (B, H, T, D) pair of ``ops/flash_heads.py``,
    which take ``causal`` after the scale, and the chunk pair of
    ``ops/flash_chunk.py``, which take (B, Tq, Tk, H, D) and, after
    ``causal``, the q, k and (batch * head) offsets."""
    lib = _build.load(_KERNEL)
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    dims, chunk_dims = [i, i, i, i, f], [i, i, i, i, i, f]
    for name, ptrs, shape, after in (
            ("flash_packed_fwd_launch", 3, dims, []),
            ("flash_packed_bwd_launch", 5, dims, []),
            ("flash_heads_fwd_launch", 5, dims, [i]),
            ("flash_heads_bwd_launch", 9, dims, [i]),
            ("flash_chunk_fwd_launch", 5, chunk_dims, [i, i, i, i]),
            ("flash_chunk_bwd_launch", 9, chunk_dims, [i, i, i, i])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [p] * ptrs + shape + after + [u, u, f, i, i, p]
            fn.restype = ctypes.c_int
    return lib
