"""Prefill chunk sizing (from ``replicatinggpt_tpu/serve/cache_pool.py``).

The contiguous slot pool of the JAX package is not ported: the engine
serves from the paged pool (serve/pages.py).
"""

from __future__ import annotations


def prefill_chunk_size(requested: int, block_size: int) -> int:
    """Effective prefill chunk: the requested (or 0 = auto
    min(64, block_size)) size rounded DOWN to a divisor of block_size,
    so that a P-token prompt's padded final chunk, dispatched at offset
    (ceil(P/c)-1)*c, ends inside the block (ceil(P/c)*c <= block_size
    for every admissible P)."""
    c = min(requested or min(64, block_size), block_size)
    while block_size % c:
        c -= 1
    return c
