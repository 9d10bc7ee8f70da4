"""Flash attention on (B, H, T, D) heads: the split-heads kernel route.

The port of ``replicatinggpt_tpu/ops/flash_pallas.py``'s
``pallas_flash_attention`` and its custom VJPs ``_flash`` (the resident
forward ``_flash_fwd`` and the backwards ``_flash_bwd``,
``_flash_bwd_fused``, ``_fused_kv_major_bwd``) and ``_flash_stream``
(``_flash_fwd_stream`` / ``_flash_bwd_stream`` and the triangular
``_flash_fwd_tri`` / ``_flash_bwd_tri``). Those families compute one
function and differ only in what the TPU keeps in VMEM, so one kernel
pair stands for them all: ``csrc/flash_packed.cu``'s heads entry points,
the packed kernels' body on (batch, head, row) strides. q, k, v are
(B, H, T, D); the forward gives o (B, H, T, D) in q's dtype and the f32
lse (B, H, T); the backward gives dq, dk, dv from lse and delta =
rowsum(dO * O). Causal or not, any scale (default D**-0.5), f32 softmax;
with a rate the attention weights get the JAX kernels' hashed dropout
mask for head bh = b * H + h, bit for bit for the same int32 seed.

- ``flash_heads_fwd_ref`` / ``flash_heads_bwd_ref``: the plain PyTorch
  versions (``flash_packed.attention_ref`` / ``attention_bwd_ref``);
- ``flash_heads_fwd`` / ``flash_heads_bwd``: the wrappers. A CPU tensor
  takes the plain version; a CUDA tensor launches the kernel or raises.
  Each has a ``.launches`` counter;
- ``FlashHeads``: the ``torch.autograd.Function`` over the two;
- ``flash_heads_envelope``: the shapes the kernel takes.

The JAX block sizes, its ``stream=`` switch and its VMEM thresholds
(``STREAM_KV_BYTES``, ``FUSED_DQ_SCRATCH_BYTES``) choose between TPU
residency plans of the same function and have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_packed import (HEAD_DIMS, TILE, _DTYPE_CODE, _lib,
                           attention_bwd_ref, attention_ref,
                           check_placement, dropout_args)


def flash_heads_envelope(seq_len: int, head_dim: int,
                         itemsize: int) -> Tuple[bool, Tuple[str, ...]]:
    """``(ok, reasons)`` for the kernel: D in {32, 64, 128, 256}, T a
    multiple of the 64-row tile, bf16 or f32."""
    reasons = []
    if head_dim not in HEAD_DIMS:
        reasons.append("head_dim")
    if seq_len <= 0 or seq_len % TILE:
        reasons.append("seq_len")
    if itemsize not in (2, 4):
        reasons.append("dtype")
    return (not reasons), tuple(reasons)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def flash_heads_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: Optional[float] = None,
                        seed: int = 0, rate: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: (o (B, H, T, D) in q's dtype, lse (B, H, T) f32)."""
    o, lse = attention_ref(q, k, v, causal=causal, scale=_scale(q, scale),
                           seed=seed, rate=rate)
    return o.to(q.dtype), lse


def heads_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O): (B, H, T) f32 (dropout's mask is already
    inside O)."""
    return (do.float() * o.float()).sum(-1)


def flash_heads_bwd_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                        scale: Optional[float] = None, seed: int = 0,
                        rate: float = 0.0):
    """Plain backward in the lse/delta form: (dq, dk, dv) in q's dtype."""
    grads = attention_bwd_ref(q, k, v, do, lse, delta, causal=causal,
                              scale=_scale(q, scale), seed=seed, rate=rate)
    return tuple(g.to(q.dtype) for g in grads)


def _check_heads(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one (B, H, T, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _check_kernel_inputs(q: torch.Tensor, *rest: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes bf16 or f32 q/k/v; got {q.dtype}")
    ok, reasons = flash_heads_envelope(q.shape[2], q.shape[3],
                                       q.element_size())
    if not ok:
        raise ValueError(f"shapes outside the kernel envelope: {reasons}")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check_placement(q, *rest)


def flash_heads_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    seed: int = 0, rate: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward (shapes as ``flash_heads_fwd_ref``). CPU tensors run the
    plain version; CUDA tensors run the kernel, which takes contiguous
    bf16 or f32 q, k, v of one dtype inside ``flash_heads_envelope``;
    anything else raises."""
    _check_heads(q, k, v)
    if q.device.type == "cpu":
        return flash_heads_fwd_ref(q, k, v, causal=causal, scale=scale,
                                   seed=seed, rate=rate)
    _check_kernel_inputs(q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if B == 0:
        return o, lse
    err = _lib().flash_heads_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, T, H, D, _scale(q, scale), int(causal),
        *dropout_args(seed, rate), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_heads_fwd launch failed: CUDA error "
                           f"{err}")
    flash_heads_fwd.launches += 1
    return o, lse


def flash_heads_bwd(q, k, v, do, lse, delta, *, causal: bool = True,
                    scale: Optional[float] = None, seed: int = 0,
                    rate: float = 0.0):
    """Backward (shapes as ``flash_heads_bwd_ref``; ``do`` in q's dtype,
    lse and delta f32). CPU tensors run the plain version; CUDA tensors
    run the two backward kernels or raise."""
    _check_heads(q, k, v)
    if do.shape != q.shape or lse.shape != q.shape[:3] \
            or delta.shape != lse.shape:
        raise ValueError(f"do/lse/delta shapes {tuple(do.shape)}, "
                         f"{tuple(lse.shape)}, {tuple(delta.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_heads_bwd_ref(q, k, v, do, lse, delta, causal=causal,
                                   scale=scale, seed=seed, rate=rate)
    _check_kernel_inputs(q, k, v, do, lse, delta)
    if any(t.dtype != q.dtype for t in (k, v, do)) \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"k, v, do must be {q.dtype} and lse/delta f32; got "
                        f"{k.dtype}, {v.dtype}, {do.dtype}, {lse.dtype}, "
                        f"{delta.dtype}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    B, H, T, D = q.shape
    if B == 0:
        return dq, dk, dv
    err = _lib().flash_heads_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, T, H, D, _scale(q, scale), int(causal),
        *dropout_args(seed, rate), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_heads_bwd launch failed: CUDA error "
                           f"{err}")
    flash_heads_bwd.launches += 1
    return dq, dk, dv


flash_heads_fwd.launches = 0
flash_heads_bwd.launches = 0


class FlashHeads(torch.autograd.Function):
    """o = attention(q, k, v); saves q, k, v, o, lse and the seed, and
    its backward runs ``flash_heads_bwd`` (the kernel on CUDA tensors,
    the plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float],
                seed: int, rate: float):
        o, lse = flash_heads_fwd(q, k, v, causal=causal, scale=scale,
                                 seed=seed, rate=rate)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.seed, ctx.rate = causal, scale, seed, rate
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        dq, dk, dv = flash_heads_bwd(q, k, v, do, lse, heads_delta(do, o),
                                     causal=ctx.causal, scale=ctx.scale,
                                     seed=ctx.seed, rate=ctx.rate)
        return dq, dk, dv, None, None, None, None


def flash_heads_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None, seed: int = 0,
                          rate: float = 0.0) -> torch.Tensor:
    """Differentiable attention on (B, H, T, D) heads: o (B, H, T, D)."""
    return FlashHeads.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal, scale, seed, rate)
