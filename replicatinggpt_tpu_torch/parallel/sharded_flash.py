"""The attention of a data shard (the port of
``replicatinggpt_tpu/parallel/sharded_flash.py``).

On a mesh without a seq axis attention is embarrassingly parallel over
the batch: JAX wraps its local core in ``shard_map`` over 'data' so the
Pallas kernel runs on each device's (B/data, H, T, D) block. The port's
data shards already run their rows as separate forwards
(``train/steps.py``), so the local core is the forward's own route
(``ops/flash_attention.py``: the packed kernel, or split heads through
the (B, H, T, D) kernel or the plain core) at a rank's shapes, and no
wrapper stands in front of it (``describe_sharded_route`` names it).

What the JAX wrapper adds besides is dropout: ``_local_attention`` folds
the data shard index into the key, so every shard draws its own masks,
and a shard's masks do not depend on where it runs. The port's
counterpart is ``shard_dropout_rng``: data shard d's kernel seeds and
residual ``bits`` stream come from the run's seed folded with d (shard 0
keeps the run's own, so ``--dp 1`` is the plain run), and a seq rank's
``bits`` from its rank as before. One process holding both shards and two
processes holding one each so draw the same masks bit for bit.
"""

from __future__ import annotations

from ..config import ModelConfig
from ..ops.attention import DropoutRNG
from ..ops.flash_attention import describe_route

#: an odd 64-bit constant (PCG's multiplier) that spaces the data shards'
#: seeds apart from each other and from the seq streams'
_SHARD_STRIDE = 0x5851F42D4C957F2D


def shard_seed(seed: int, shard: int) -> int:
    """The seed of data shard ``shard``: ``seed`` folded with the index
    (shard 0's is ``seed`` itself)."""
    return seed if shard == 0 else (seed + shard * _SHARD_STRIDE) % 2 ** 63


def shard_dropout_rng(seed: int, shard: int, seq_rank: int,
                      device) -> DropoutRNG:
    """The dropout streams of data shard ``shard``, seq rank ``seq_rank``:
    kernel seeds per data shard (the same on every seq rank of it, so a
    ring's (q, k) pair draws one mask wherever it is computed), residual
    bits per (shard, seq rank)."""
    return DropoutRNG(shard_seed(seed, shard), device, seq_rank)


def describe_sharded_route(mcfg: ModelConfig, seq_len: int,
                           data: int) -> str:
    """The mesh attention line of the run's log (JAX's form)."""
    return (f"mesh attention: {mcfg.attention_impl!r} per data shard over "
            f"('data',) ({data} shards); local core "
            f"{describe_route(mcfg, seq_len)}")
