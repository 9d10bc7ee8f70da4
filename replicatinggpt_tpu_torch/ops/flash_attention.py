"""The training block's attention route: the packed flash kernel or the
split-heads core.

The port of ``replicatinggpt_tpu/ops/flash_attention.py``
``packed_envelope_ok`` / ``packed_qkv_attention``. Inside the kernel's
envelope (``ops/flash_packed.flash_packed_envelope``: D in {32, 64, 128},
T a multiple of 64, bf16 or f32) attention runs straight off the fused
(B, T, 3C) QKV projection through ``FlashPacked``: the CUDA kernels on
CUDA tensors, their plain versions on CPU tensors. Outside it the block
takes the split-heads route (``ops/attention.full_causal_attention``).
The route depends only on the configuration and the sequence length;
the training runner logs it once.
"""

from __future__ import annotations

from typing import Tuple

from ..config import ModelConfig
from .flash_packed import flash_packed_attention, flash_packed_envelope


def packed_envelope(cfg: ModelConfig, seq_len: int
                    ) -> Tuple[bool, Tuple[str, ...]]:
    """``(ok, reasons)`` of the packed kernel for ``cfg`` at ``seq_len``
    in its compute dtype."""
    itemsize = cfg.compute_dtype.itemsize
    return flash_packed_envelope(seq_len, cfg.n_embd, cfg.n_head, itemsize)


def describe_route(cfg: ModelConfig, seq_len: int) -> str:
    ok, reasons = packed_envelope(cfg, seq_len)
    if ok:
        return (f"packed flash attention (csrc/flash_packed.cu on CUDA "
                f"tensors, its plain version on CPU tensors) at T={seq_len}")
    return (f"split-heads attention at T={seq_len} (outside the packed "
            f"kernel's envelope: {', '.join(reasons)})")


def packed_qkv_attention(qkv, cfg: ModelConfig, rng, train: bool, *,
                         core=flash_packed_attention):
    """Merged (B, T, C) attention straight off ``qkv`` (B, T, 3C) through
    ``core(qkv, n_head, seed=, rate=)``: the kernel route by default.
    When training with attention dropout, each call draws a fresh int32
    kernel seed from ``rng`` (``models.gpt.DropoutRNG``)."""
    rate = cfg.attn_dropout if (train and rng is not None) else 0.0
    seed = rng.kernel_seed() if rate > 0 else 0
    return core(qkv, cfg.n_head, seed=seed, rate=rate)
