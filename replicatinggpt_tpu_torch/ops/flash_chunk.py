"""Flash attention of a q-chunk against a kv-chunk at global offsets.

The port of ``replicatinggpt_tpu/ops/flash_pallas.py``'s
``pallas_flash_chunk`` and its custom VJP ``_flash_chunk`` (TPU rows
#21-#24): the resident kernels ``_chunk_fwd_kernel`` (via
``_chunk_fwd``), ``_chunk_bwd_dq_kernel`` / ``_chunk_bwd_dkv_kernel``
(via ``_flash_chunk_bwd_rule``) and the kv-major
``_chunk_bwd_fused_kernel`` (via ``_fused_kv_major_bwd``), and the
streamed ``_chunk_fwd_stream`` / ``_chunk_bwd_stream``. They compute one
function and differ only in what the TPU keeps in VMEM, so one kernel
pair stands for them all: ``csrc/flash_packed.cu``'s chunk entry points,
the body of the packed and heads kernels with global positions.

q is (B, H, Tq, D), k and v (B, H, Tk, D); q row r sits at global
position ``q_offset + r`` and k row c at ``k_offset + c``. The forward
gives o (B, H, Tq, D) in q's dtype and the f32 lse (B, H, Tq) over this
chunk's keys only; causal hides key c from row r iff ``k_offset + c >
q_offset + r``. A row with no visible key gets o = 0 and lse = NEG_INF
(-1e30, ``ops.attention.NEG_INF``), and gradients 0. With a rate, the
attention weights get the JAX kernels' hashed dropout mask at global
positions for head ``bh_offset + b * H + h``, so a (q, k) pair draws the
same mask wherever a ring computes it, and at offsets 0 the mask of the
(B, H, T, D) kernel bit for bit. The result is differentiable in q, k
and v through o and lse: the backward folds the lse cotangent into
delta' = rowsum(dO * O) - dlse and clamps lse to NEG_INF / 2, as
``_flash_chunk_bwd_rule`` does.

- ``flash_chunk_fwd_ref`` / ``flash_chunk_bwd_ref``: the plain PyTorch
  versions (they select the visible keys by global position);
- ``flash_chunk_fwd`` / ``flash_chunk_bwd``: the wrappers. A CPU tensor
  takes the plain version; a CUDA tensor launches the kernel or raises.
  Each has a ``.launches`` counter;
- ``FlashChunk``: the ``torch.autograd.Function`` over the two, and
  ``flash_chunk``, its entry point;
- ``flash_chunk_envelope``: the shapes the kernel takes.

One difference from the JAX kernel, invisible to a ring: where a
processed kv tile masks a whole row (a chunk that starts past the row,
at an offset that is not tile-aligned), the JAX kernel leaves that row's
o at the mean of the tile's values (each masked score counts
exp(0) while the running max is still NEG_INF) beside lse = NEG_INF;
here o is 0. Any merge weighs such a row by exp(NEG_INF) = 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import NEG_INF
from .flash_packed import (HEAD_DIMS, TILE, _DTYPE_CODE, _lib,
                           attention_bwd_ref, attention_ref,
                           check_placement, dropout_args)

INT32_MAX = 2 ** 31 - 1


def flash_chunk_envelope(q_len: int, k_len: int, head_dim: int,
                         itemsize: int) -> Tuple[bool, Tuple[str, ...]]:
    """``(ok, reasons)`` for the kernel: D in {32, 64, 128, 256}, both
    chunk lengths multiples of the 64-row tile, bf16 or f32."""
    reasons = []
    if head_dim not in HEAD_DIMS:
        reasons.append("head_dim")
    for name, n in (("q_len", q_len), ("k_len", k_len)):
        if n <= 0 or n % TILE:
            reasons.append(name)
    if itemsize not in (2, 4):
        reasons.append("dtype")
    return (not reasons), tuple(reasons)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def flash_chunk_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: Optional[float] = None, causal: bool = True,
                        q_offset: int = 0, k_offset: int = 0, seed: int = 0,
                        rate: float = 0.0, bh_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward (``flash_packed.attention_ref`` at the offsets):
    (o (B, H, Tq, D) in q's dtype, lse (B, H, Tq) f32). Only the visible
    keys enter the softmax (no exp of a masked score)."""
    o, lse = attention_ref(q, k, v, causal=causal, scale=_scale(q, scale),
                           seed=seed, rate=rate, q_offset=q_offset,
                           k_offset=k_offset, bh_offset=bh_offset)
    return o.to(q.dtype), lse


def flash_chunk_bwd_ref(q, k, v, do, lse, deltap, *,
                        scale: Optional[float] = None, causal: bool = True,
                        q_offset: int = 0, k_offset: int = 0, seed: int = 0,
                        rate: float = 0.0, bh_offset: int = 0):
    """Plain backward (``flash_packed.attention_bwd_ref`` at the offsets)
    from lse (clamped, as ``FlashChunk`` passes it) and delta' =
    rowsum(dO * O) - dlse. Returns (dq, dk, dv) in q's dtype."""
    grads = attention_bwd_ref(q, k, v, do, lse, deltap, causal=causal,
                              scale=_scale(q, scale), seed=seed, rate=rate,
                              q_offset=q_offset, k_offset=k_offset,
                              bh_offset=bh_offset)
    return tuple(g.to(q.dtype) for g in grads)


def _check_chunk(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q must be (B, H, Tq, D) and k, v one (B, H, Tk, "
                         f"D) shape; got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")


def _offsets(q_offset: int, k_offset: int, bh_offset: int) -> tuple:
    offs = tuple(int(x) for x in (q_offset, k_offset, bh_offset))
    if not all(-INT32_MAX <= x <= INT32_MAX for x in offs):
        raise ValueError(f"offsets {offs} do not fit int32")
    return offs


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                         *rest: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes bf16 or f32 q/k/v; got {q.dtype}")
    ok, reasons = flash_chunk_envelope(q.shape[2], k.shape[2], q.shape[3],
                                       q.element_size())
    if not ok:
        raise ValueError(f"shapes outside the kernel envelope: {reasons}")
    check_placement(q, k, *rest)


def flash_chunk_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = True,
                    q_offset: int = 0, k_offset: int = 0, seed: int = 0,
                    rate: float = 0.0, bh_offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward (shapes as ``flash_chunk_fwd_ref``). CPU tensors run the
    plain version; CUDA tensors run the kernel, which takes contiguous
    bf16 or f32 q, k, v of one dtype inside ``flash_chunk_envelope``;
    anything else raises."""
    _check_chunk(q, k, v)
    kw = dict(scale=scale, causal=causal, seed=seed, rate=rate)
    q_off, k_off, bh_off = _offsets(q_offset, k_offset, bh_offset)
    if q.device.type == "cpu":
        return flash_chunk_fwd_ref(q, k, v, q_offset=q_off, k_offset=k_off,
                                   bh_offset=bh_off, **kw)
    _check_kernel_inputs(q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Tq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if B == 0:
        return o, lse
    err = _lib().flash_chunk_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Tq, k.shape[2], H, D, _scale(q, scale),
        int(causal), q_off, k_off, bh_off, *dropout_args(seed, rate),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_chunk_fwd launch failed: CUDA error "
                           f"{err}")
    flash_chunk_fwd.launches += 1
    return o, lse


def flash_chunk_bwd(q, k, v, do, lse, deltap, *,
                    scale: Optional[float] = None, causal: bool = True,
                    q_offset: int = 0, k_offset: int = 0, seed: int = 0,
                    rate: float = 0.0, bh_offset: int = 0):
    """Backward (shapes as ``flash_chunk_bwd_ref``; ``do`` in q's dtype,
    the clamped lse and delta' f32 (B, H, Tq)). CPU tensors run the plain
    version; CUDA tensors run the two backward kernels or raise."""
    _check_chunk(q, k, v)
    if do.shape != q.shape or lse.shape != q.shape[:3] \
            or deltap.shape != lse.shape:
        raise ValueError(f"do/lse/delta' shapes {tuple(do.shape)}, "
                         f"{tuple(lse.shape)}, {tuple(deltap.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    kw = dict(scale=scale, causal=causal, seed=seed, rate=rate)
    q_off, k_off, bh_off = _offsets(q_offset, k_offset, bh_offset)
    if q.device.type == "cpu":
        return flash_chunk_bwd_ref(q, k, v, do, lse, deltap, q_offset=q_off,
                                   k_offset=k_off, bh_offset=bh_off, **kw)
    _check_kernel_inputs(q, k, v, do, lse, deltap)
    if any(t.dtype != q.dtype for t in (k, v, do)) \
            or lse.dtype != torch.float32 or deltap.dtype != torch.float32:
        raise TypeError(f"k, v, do must be {q.dtype} and lse/delta' f32; "
                        f"got {k.dtype}, {v.dtype}, {do.dtype}, {lse.dtype}, "
                        f"{deltap.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    B, H, Tq, D = q.shape
    if B == 0:
        return dq, dk, dv
    err = _lib().flash_chunk_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), deltap.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, Tq, k.shape[2], H, D, _scale(q, scale),
        int(causal), q_off, k_off, bh_off, *dropout_args(seed, rate),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_chunk_bwd launch failed: CUDA error "
                           f"{err}")
    flash_chunk_bwd.launches += 1
    return dq, dk, dv


flash_chunk_fwd.launches = 0
flash_chunk_bwd.launches = 0


def chunk_bwd_inputs(o: torch.Tensor, lse: torch.Tensor,
                     do: Optional[torch.Tensor],
                     dlse: Optional[torch.Tensor]) -> tuple:
    """(dO, clamped lse, delta') for the backward from the cotangents of
    o and lse (None = zeros): delta' = rowsum(dO * O) - dlse folds the
    lse cotangent into the flash backward, and lse >= NEG_INF / 2 keeps
    exp(s - lse) of a masked row's scores at 0 (``_flash_chunk_bwd_rule``)."""
    do = torch.zeros_like(o) if do is None else do.to(o.dtype).contiguous()
    deltap = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        deltap = deltap - dlse.float()
    return do, lse.clamp(min=NEG_INF / 2), deltap


class FlashChunk(torch.autograd.Function):
    """(o, lse) = chunk attention(q, k, v); saves q, k, v, o, lse, and its
    backward takes the cotangents of both (either may be None) into
    ``flash_chunk_bwd`` (the kernel on CUDA tensors, the plain version on
    CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: Optional[float], causal: bool,
                q_offset: int, k_offset: int, seed: int, rate: float,
                bh_offset: int):
        o, lse = flash_chunk_fwd(q, k, v, scale=scale, causal=causal,
                                 q_offset=q_offset, k_offset=k_offset,
                                 seed=seed, rate=rate, bh_offset=bh_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(scale=scale, causal=causal, q_offset=q_offset,
                      k_offset=k_offset, seed=seed, rate=rate,
                      bh_offset=bh_offset)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None and dlse is None:
            return (None,) * 10
        do, lse_c, deltap = chunk_bwd_inputs(o, lse, do, dlse)
        dq, dk, dv = flash_chunk_bwd(q, k, v, do, lse_c, deltap, **ctx.kw)
        return (dq, dk, dv) + (None,) * 7


def flash_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                scale: Optional[float] = None, causal: bool = True,
                q_offset: int = 0, k_offset: int = 0, seed: int = 0,
                rate: float = 0.0, bh_offset: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable chunk attention: (o (B, H, Tq, D), lse (B, H, Tq))."""
    return FlashChunk.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            scale, causal, int(q_offset), int(k_offset),
                            seed, rate, int(bh_offset))
