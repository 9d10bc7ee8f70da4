"""The contiguous slot pool and the prefill chunk rule (from
``replicatinggpt_tpu/serve/cache_pool.py``).

The engine serves from the paged pool (serve/pages.py). ``CachePool`` is
the contiguous one: ONE stacked cache (``models.gpt.init_kv_cache`` with
batch = n_slots, either layout) whose batch axis is the slot axis,
allocated once. Slot assignment is host bookkeeping (a free list and
per-slot positions); the buffer is never resized or zeroed again (stale
K/V in a freed slot is harmless: the next occupant writes every position
before attending it). The model drafter of speculative decoding
(serve/speculative.py) keeps its cache in one, slot for slot with the
engine's pool.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.gpt import cache_seq_axis, init_kv_cache


def prefill_chunk_size(requested: int, block_size: int) -> int:
    """Effective prefill chunk: the requested (or 0 = auto
    min(64, block_size)) size rounded DOWN to a divisor of block_size,
    so that a P-token prompt's padded final chunk, dispatched at offset
    (ceil(P/c)-1)*c, ends inside the block (ceil(P/c)*c <= block_size
    for every admissible P). One rule for the engine's prefill and the
    model drafter's."""
    c = min(requested or min(64, block_size), block_size)
    while block_size % c:
        c -= 1
    return c


class CachePool:
    """Fixed-size slot pool over one pre-allocated multi-slot KV cache."""

    def __init__(self, cfg: ModelConfig, n_slots: int,
                 max_len: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, device=None):
        assert n_slots >= 1, n_slots
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len or cfg.block_size
        self.cache: Dict[str, torch.Tensor] = init_kv_cache(
            cfg, n_slots, max_len=self.max_len, dtype=dtype, device=device)
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self._owner: Dict[int, str] = {}            # slot -> request id
        self._slot_by_request: Dict[str, int] = {}  # request id -> slot
        # host-side per-slot positions, advanced by the owner in place
        self.positions = np.zeros((n_slots,), np.int32)

    @property
    def seq_len(self) -> int:
        return self.cache["k"].shape[cache_seq_axis(self.cfg)]

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.n_used / self.n_slots

    def acquire(self, request_id: str,
                position: int = 0) -> Optional[int]:
        """Assign a free slot to ``request_id`` starting at ``position``
        (the last prompt index: decode rewrites it first); None when the
        pool is exhausted."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._owner[slot] = request_id
        self._slot_by_request[request_id] = slot
        self.positions[slot] = position
        return slot

    def release(self, slot: int) -> None:
        owner = self._owner.pop(slot, None)
        assert owner is not None, f"slot {slot} double-free"
        if self._slot_by_request.get(owner) == slot:
            del self._slot_by_request[owner]
        self._free.append(slot)

    def owner(self, slot: int) -> Optional[str]:
        return self._owner.get(slot)

    def slot_of(self, request_id: str) -> Optional[int]:
        return self._slot_by_request.get(request_id)
