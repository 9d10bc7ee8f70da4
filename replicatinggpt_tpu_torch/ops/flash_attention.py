"""The training block's attention routes: the packed flash kernel, or
split heads through the (B, H, T, D) flash kernel or the plain core.

The port of ``replicatinggpt_tpu/ops/flash_attention.py``
(``packed_envelope_ok`` / ``packed_qkv_attention``, ``flash_attention``,
``supports_dropout``). The route rule, ``packed_route``, is the one
predicate both ``models.gpt.attention_for`` and ``describe_route`` read:

- the packed route (``FlashPacked`` straight off the fused (B, T, 3C)
  QKV projection) where the JAX package's packed families can lay out
  the heads, which is ``_group_geometry``'s layout test: D in {32, 64,
  128, 256} and ``n_head % max(1, 128 // D) == 0``; and where the packed
  kernel takes the shapes (``flash_packed_envelope``: T a multiple of
  64, bf16 or f32);
- the split-heads route elsewhere: (B, H, T, D) heads through
  ``flash_attention``, which takes ``FlashHeads`` inside
  ``flash_heads_envelope`` and the plain core outside it (where the JAX
  package runs XLA's SDPA or einsum, not a Pallas kernel).

So char-gpt, gpt2-shakespeare, gpt2-small (any T), gpt2-medium and
gpt2-large take the packed kernel; gpt2-xl's 25 heads of D=64 form no
head pair and take the split-heads kernel, as in the reference;
char-gpt1-ref (D=21) and test-tiny (D=16) take the plain core. The JAX
VMEM budgets that also gate its packed families (``PACKED_QKV_BYTES``,
``GROUP_STRIP_BYTES``, ``GROUP_STREAM_AUTOROUTE``) are TPU residency
limits and are left out. Both layouts run one body of
``csrc/flash_packed.cu``: bf16 on the tensor cores (``mma.sync``, p z
and ds rounded to bf16 where the JAX kernels round them), f32 on the
CUDA cores; at gpt2-xl's shapes its forward is bound by bytes (~0.063
ms on an H100) and its backward by operations (~0.136 ms). A later
route PR may move the line on H100 timings, which ``chip_smoke.py``
prints for both layouts at gpt2-xl's shapes. Kernels
run on CUDA tensors, their plain versions on CPU tensors; the route
depends only on the configuration and the sequence length, and the
training runner logs it once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import ModelConfig
from .attention import DropoutRNG, _masked_softmax_pv
from .flash_heads import flash_heads_attention, flash_heads_envelope
from .flash_packed import (HEAD_DIMS, flash_packed_attention,
                           flash_packed_envelope)


def packed_route(cfg: ModelConfig, seq_len: int
                 ) -> Tuple[bool, Tuple[str, ...]]:
    """``(ok, reasons)``: whether ``cfg`` at ``seq_len`` takes the packed
    route (the rule in the module docstring)."""
    itemsize = cfg.compute_dtype.itemsize
    ok, reasons = flash_packed_envelope(seq_len, cfg.n_embd, cfg.n_head,
                                        itemsize)
    D = cfg.head_dim
    if D in HEAD_DIMS and cfg.n_head % max(1, 128 // D):
        reasons += ("head_layout",)
    return (not reasons), reasons


def describe_route(cfg: ModelConfig, seq_len: int) -> str:
    ok, reasons = packed_route(cfg, seq_len)
    if ok:
        return (f"packed flash attention (csrc/flash_packed.cu on CUDA "
                f"tensors, its plain version on CPU tensors) at T={seq_len}")
    why = f"off the packed route: {', '.join(reasons)}"
    if flash_heads_envelope(seq_len, cfg.head_dim,
                            cfg.compute_dtype.itemsize)[0]:
        return (f"split-heads flash attention (csrc/flash_packed.cu's "
                f"(B, H, T, D) kernel on CUDA tensors, its plain version on "
                f"CPU tensors) at T={seq_len} ({why})")
    return (f"split-heads attention, plain core, at T={seq_len} ({why}; "
            f"outside the (B, H, T, D) kernel's envelope too)")


def packed_qkv_attention(qkv, cfg: ModelConfig, rng, train: bool, *,
                         core=flash_packed_attention):
    """Merged (B, T, C) attention straight off ``qkv`` (B, T, 3C) through
    ``core(qkv, n_head, seed=, rate=)``: the kernel route by default.
    When training with attention dropout, each call draws a fresh int32
    kernel seed from ``rng`` (``ops.attention.DropoutRNG``)."""
    rate = cfg.attn_dropout if (train and rng is not None) else 0.0
    seed = rng.kernel_seed() if rate > 0 else 0
    return core(qkv, cfg.n_head, seed=seed, rate=rate)


def supports_dropout(q: torch.Tensor) -> bool:
    """Whether ``flash_attention`` applies attention-weight dropout to
    (B, H, T, D) ``q``: inside the kernel's envelope (the hashed mask, in
    the kernel on the card and in its plain version on the CPU)."""
    return flash_heads_envelope(q.shape[-2], q.shape[-1],
                                q.element_size())[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = True,
                    dropout_rate: float = 0.0,
                    rng: Optional[DropoutRNG] = None) -> torch.Tensor:
    """q, k, v: (B, H, T, D). Returns (B, H, T, D): ``FlashHeads``
    inside ``flash_heads_envelope`` (a kernel seed drawn from ``rng``
    when ``dropout_rate`` > 0), the plain core outside it, where dropout
    raises, as in the JAX package."""
    D = q.shape[-1]
    scale = D ** -0.5 if scale is None else float(scale)
    if dropout_rate > 0.0 and rng is None:
        raise ValueError("dropout_rate > 0 requires rng")
    if supports_dropout(q):
        seed = rng.kernel_seed() if dropout_rate > 0.0 else 0
        return flash_heads_attention(q, k, v, causal=causal, scale=scale,
                                     seed=seed, rate=dropout_rate)
    if dropout_rate > 0.0:
        raise ValueError("attention-weight dropout needs the flash kernel "
                         "(D in {32, 64, 128, 256}, T a multiple of 64); "
                         "use the einsum path here")
    T = q.shape[-2]
    pos = torch.arange(T, device=q.device)
    keep = (pos[None, :] <= pos[:, None] if causal
            else torch.ones(T, T, dtype=torch.bool, device=q.device))
    return _masked_softmax_pv(q, k, v, keep, scale)
