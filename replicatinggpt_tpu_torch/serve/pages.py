"""Paged KV cache with radix prefix reuse: the serving engine's memory
model (port of ``replicatinggpt_tpu/serve/pages.py``; the host
allocator and radix logic are copied, the device pool is a torch
tensor).

The contiguous ``CachePool`` gives every slot a full ``block_size`` KV
buffer for its whole lifetime, so HBM — not compute — caps concurrent
occupancy, and every request pays full prefill even when thousands share
one system prompt. Here device KV storage is a pool of fixed-size PAGES
(``models.gpt.init_paged_kv_pool``) and each slot holds a fixed-shape
``(max_pages,)`` int32 page table, host-mirrored and uploaded to the
device when it changes.

Three host-side pieces:

- :class:`PageAllocator` — refcounted acquire/release of physical
  pages. A page's refcount counts SLOT references; pages referenced by
  the radix index alone (refcount 0) are the prefix cache, reclaimed
  LRU when allocation runs dry.
- :class:`RadixIndex` — a prefix tree over FULL pages of prompt tokens
  (node key = (parent, page-token bytes), so lookups are exact, not
  hash-collision-prone). Admission walks it to claim the longest cached
  prefix; chunked prefill then starts at the first uncached token.
- :class:`PagedCachePool` — the engine-facing pool: slot bookkeeping
  + page tables + the device page tensors.

Sharing discipline (what makes copy-on-write rare and safe): a full
prompt page is registered into the radix only once its owner's next
write position is PAST the page — the first decode step rewrites prompt
position P-1, so the page containing it is deferred until that write
lands. Shared pages are therefore never written through... with ONE
exception: a claimer whose ENTIRE prompt is cached starts decoding at
P-1, inside the last claimed page. That admission gets a copy-on-write
split — a fresh page, a device page copy, a remapped table entry — and
the shared original stays intact for the next claimer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ModelConfig
from ..models.gpt import init_paged_kv_pool, init_sharded_kv_pool
from ..quant.kv import kv_itemsize, scale_bytes_per_token


def default_page_size(requested: int, block_size: int) -> int:
    """Effective page size: the requested (0 = the vLLM-conventional 16)
    clamped to block_size. No divisibility requirement — the paged
    programs route every write per-position and drop out-of-range
    padding, so a ragged last logical page just holds fewer usable
    positions."""
    return min(requested or 16, block_size)


def pool_geometry(cfg: ModelConfig, n_slots: int, page_size: int = 0,
                  max_pages: int = 0,
                  n_pages: int = 0) -> Tuple[int, int, int]:
    """Resolve the (page_size, max_pages_per_slot, n_pages) triple from
    the EngineConfig knobs."""
    psz = default_page_size(page_size, cfg.block_size)
    mp = max_pages or -(-cfg.block_size // psz)
    return psz, mp, (n_pages or n_slots * mp)


def page_bytes(cfg: ModelConfig, page_size: int, kv_quant: str = "none",
               granularity: str = "page") -> int:
    """Device bytes ONE physical page occupies across all layers: K + V
    rows at the storage dtype, plus the f32 scales a quantized pool keeps
    per row (quant/kv.py). At a fixed memory budget page count is the
    admission currency, so int8/fp8 storage roughly doubles the pool."""
    per_tok = (2 * cfg.n_embd * kv_itemsize(kv_quant, cfg)
               + scale_bytes_per_token(kv_quant, granularity, cfg.n_head))
    return cfg.n_layer * page_size * per_tok


def n_pages_for_hbm(hbm_bytes: int, cfg: ModelConfig, page_size: int,
                    kv_quant: str = "none",
                    granularity: str = "page") -> int:
    """Physical pages a fixed device-memory budget holds at the given KV
    storage mode (at least 1)."""
    return max(int(hbm_bytes) // page_bytes(cfg, page_size, kv_quant,
                                            granularity), 1)


class _RadixNode:
    __slots__ = ("id", "page", "parent", "key", "n_children", "last_use")

    def __init__(self, nid: int, page: int, parent: int,
                 key: Tuple[int, bytes]):
        self.id = nid
        self.page = page
        self.parent = parent
        self.key = key
        self.n_children = 0
        self.last_use = 0


class RadixIndex:
    """Prefix tree over full-page token runs -> physical pages.

    Every node is one FULL page of prompt tokens hanging off its
    parent's chain; edges are keyed by the page's exact token bytes
    (prefix identity, not a lossy hash). ``lookup`` walks the longest
    cached chain; eviction removes childless nodes only, so a surviving
    node's whole ancestry stays reachable.
    """

    ROOT = 0

    def __init__(self):
        self.nodes: Dict[int, _RadixNode] = {}
        self._edges: Dict[Tuple[int, bytes], int] = {}
        self._next_id = 1
        self._tick = 0

    def __len__(self) -> int:
        return len(self.nodes)

    def _touch(self, node: _RadixNode) -> None:
        self._tick += 1
        node.last_use = self._tick

    def lookup(self, prompt: np.ndarray, page_size: int,
               touch: bool = True) -> List[_RadixNode]:
        """Longest chain of cached full pages prefixing ``prompt`` (in
        order). ``touch`` refreshes LRU stamps — peeks (admission
        gating) pass False so a queued-but-unadmittable request cannot
        pin pages it never claims."""
        out: List[_RadixNode] = []
        parent = self.ROOT
        for g in range(int(prompt.size) // page_size):
            key = (parent, prompt[g * page_size:(g + 1) * page_size]
                   .tobytes())
            nid = self._edges.get(key)
            if nid is None:
                break
            node = self.nodes[nid]
            if touch:
                self._touch(node)
            out.append(node)
            parent = nid
        return out

    def insert(self, parent: int, tok_bytes: bytes,
               page: int) -> Tuple[_RadixNode, bool]:
        """Insert a full page under ``parent``; returns (node, inserted).
        An existing identical chain wins (two slots racing to register
        the same prompt): the caller's physical copy simply stays
        private and frees with its slot."""
        key = (parent, tok_bytes)
        nid = self._edges.get(key)
        if nid is not None:
            node = self.nodes[nid]
            self._touch(node)
            return node, False
        node = _RadixNode(self._next_id, page, parent, key)
        self._next_id += 1
        self.nodes[node.id] = node
        self._edges[key] = node.id
        if parent != self.ROOT:
            self.nodes[parent].n_children += 1
        self._touch(node)
        return node, True

    def remove(self, node: _RadixNode) -> None:
        assert node.n_children == 0, "evicting a non-leaf radix node"
        del self.nodes[node.id]
        del self._edges[node.key]
        if node.parent != self.ROOT and node.parent in self.nodes:
            self.nodes[node.parent].n_children -= 1


@dataclass
class PageClaim:
    """One slot's page reservation: the physical page per logical page
    (claimed prefix pages first, then fresh pages covering the prompt
    tail and the whole decode budget — reserved eagerly so an admitted
    request can never strand mid-decode on an empty pool)."""

    pages: List[int]
    claimed_tokens: int
    chain: List[int]                 # radix node ids along the prefix
    cow: List[Tuple[int, int]]       # (src, dst) device copies to apply
    prompt: np.ndarray
    next_reg: int                    # next full prompt page to register


class PageAllocator:
    """Refcounted physical-page allocator + radix prefix cache + LRU
    eviction. Pure host state — the device pool is the pool's concern.
    """

    def __init__(self, n_pages: int, page_size: int,
                 prefix_cache: bool = True):
        assert n_pages >= 1 and page_size >= 1
        self.n_pages = n_pages
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self.ref = np.zeros((n_pages,), np.int32)
        self.radix = RadixIndex()
        self.page_node: Dict[int, _RadixNode] = {}   # phys -> radix node
        # counters surfaced through Engine.metrics_summary()["pages"]
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        self.evictions = 0
        self.cow_copies = 0

    # ------------------------------------------------------------ sizing

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def in_use_by_block(self, n_blocks: int) -> List[int]:
        """Pages in use per contiguous block of the physical page axis:
        each data shard's occupancy when the pool's pages split over
        'data' ('in use' as ``pages_in_use``: slot-referenced and
        radix-held pages alike)."""
        free = np.zeros((self.n_pages,), bool)
        free[np.fromiter(self._free, np.int64, len(self._free))] = True
        blk = -(-self.n_pages // n_blocks)
        return [int((~free[i * blk:(i + 1) * blk]).sum())
                for i in range(n_blocks)]

    def n_pages_for(self, n_prompt: int, cap: int) -> int:
        """Logical pages a request needs END TO END: the last write
        position is P-1 + cap-1 (decode rewrites the last prompt index
        first), so reserve ceil((P + cap - 1) / page)."""
        return -(-(n_prompt + cap - 1) // self.page_size)

    def _reclaimable(self, protect) -> int:
        """Pages reclaimable by cascaded LRU eviction: every refcount-0
        radix page not protected. (Claims cover whole prefixes, so
        ref[parent] >= ref[child] along any chain — a refcount-0 node
        heads a fully refcount-0 subtree and leaf-first eviction always
        reaches it.)"""
        return sum(1 for page in self.page_node
                   if self.ref[page] == 0 and page not in protect)

    def _evict_one(self, protect) -> Optional[int]:
        best: Optional[Tuple[int, _RadixNode]] = None
        for page, node in self.page_node.items():
            if node.n_children or self.ref[page] or page in protect:
                continue
            if best is None or node.last_use < best[1].last_use:
                best = (page, node)
        if best is None:
            return None
        page, node = best
        self.radix.remove(node)
        del self.page_node[page]
        self._free.append(page)
        self.evictions += 1
        return page

    # ----------------------------------------------------------- acquire

    def _plan(self, prompt: np.ndarray, cap: int, touch: bool):
        chain = (self.radix.lookup(prompt, self.page_size, touch=touch)
                 if self.prefix_cache else [])
        need = self.n_pages_for(int(prompt.size), cap) - len(chain)
        # full-prompt hit: the first decode write (position P-1) lands
        # inside the last claimed page -> copy-on-write needs one more
        cow = bool(chain) and len(chain) * self.page_size == prompt.size
        if cow:
            need += 1
        return chain, need, cow

    def can_acquire(self, prompt: np.ndarray, cap: int) -> bool:
        chain, need, _ = self._plan(prompt, cap, touch=False)
        claimed = {n.page for n in chain}
        return need <= len(self._free) + self._reclaimable(claimed)

    def acquire(self, prompt: np.ndarray, cap: int) -> Optional[PageClaim]:
        """Claim the longest cached prefix + fresh pages for the rest of
        the request's lifetime; None when even LRU eviction cannot free
        enough pages. A failed acquire refreshes NO LRU stamps (the plan
        walks untouched; touching happens only on commit) — a caller
        probing with acquire() directly cannot pin prefix pages it never
        claims."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        chain, need, cow_needed = self._plan(prompt, cap, touch=False)
        protect = {n.page for n in chain}
        while len(self._free) < need:
            if self._evict_one(protect) is None:
                return None
        for node in chain:
            self.radix._touch(node)
        self.prefix_lookups += 1
        self.prompt_tokens += int(prompt.size)
        pages = [n.page for n in chain]
        for p in pages:
            self.ref[p] += 1
        cow: List[Tuple[int, int]] = []
        if cow_needed:
            dst = self._free.pop()
            src = pages[-1]
            self.ref[src] -= 1
            self.ref[dst] = 1
            pages[-1] = dst
            cow.append((src, dst))
            self.cow_copies += 1
        n_total = self.n_pages_for(int(prompt.size), cap)
        for _ in range(n_total - len(pages)):
            p = self._free.pop()
            self.ref[p] = 1
            pages.append(p)
        claimed_tokens = len(chain) * self.page_size
        if chain:
            self.prefix_hits += 1
        self.prefix_hit_tokens += claimed_tokens
        return PageClaim(pages=pages, claimed_tokens=claimed_tokens,
                         chain=[n.id for n in chain], cow=cow,
                         prompt=prompt.copy(), next_reg=len(chain))

    # ------------------------------------------------- register / release

    def register(self, claim: PageClaim, next_write_pos: int) -> None:
        """Insert the claim's FINALIZED full prompt pages into the radix.
        A page is final once the slot's next write position is past it —
        which defers exactly the page containing prompt position P-1
        (rewritten by the first decode step) until that write lands, so
        no registered page is ever written by its owner again."""
        if not self.prefix_cache:
            return
        psz = self.page_size
        n_full = int(claim.prompt.size) // psz
        while (claim.next_reg < n_full
               and (claim.next_reg + 1) * psz <= next_write_pos):
            g = claim.next_reg
            parent = claim.chain[-1] if claim.chain else RadixIndex.ROOT
            node, inserted = self.radix.insert(
                parent, claim.prompt[g * psz:(g + 1) * psz].tobytes(),
                claim.pages[g])
            if inserted:
                self.page_node[claim.pages[g]] = node
            claim.chain.append(node.id)
            claim.next_reg += 1

    def pending_registration(self, claim: PageClaim) -> bool:
        return (self.prefix_cache
                and claim.next_reg < int(claim.prompt.size)
                // self.page_size)

    def release(self, claim: PageClaim) -> None:
        """Drop the claim's references; refcount-0 pages return to the
        free list unless the radix holds them (then they ARE the prefix
        cache, reclaimed later by LRU eviction)."""
        for p in claim.pages:
            self.ref[p] -= 1
            assert self.ref[p] >= 0, f"page {p} refcount underflow"
            if self.ref[p] == 0 and p not in self.page_node:
                self._free.append(p)


@dataclass
class Admission:
    """What the engine needs from a successful ``acquire``: the slot,
    how many prompt tokens the prefix cache already holds (prefill
    starts there), and the device page copies to apply before any
    compute touches the slot (copy-on-write splits)."""

    slot: int
    claimed: int
    cow: List[Tuple[int, int]]


class PagedCachePool:
    """Slot bookkeeping + page tables over one device page pool."""

    def __init__(self, cfg: ModelConfig, n_slots: int, *,
                 page_size: int = 0, max_pages: int = 0, n_pages: int = 0,
                 prefix_cache: bool = True, device=None, quant=None,
                 mesh_shape: Tuple[int, int] = (1, 1), group=None):
        """``quant`` (a ``quant.QuantConfig`` with ``kv_dtype`` set)
        stores the pages in int8/fp8 with f32 scales beside them. With a
        serve ``group`` (``parallel.serve_group``), the device pool is the
        group's shards, ``{(d, m): pool}`` (``init_sharded_kv_pool``):
        data shard d holds the block of pages ``[d * block, (d + 1) *
        block)``, in model shard m's columns; the allocator, the radix
        and the tables stay whole, as in the JAX engine. ``mesh_shape``:
        the requested (data, model) mesh, reported by ``stats()``."""
        assert n_slots >= 1, n_slots
        self.cfg = cfg
        self.quant = quant
        self.n_slots = n_slots
        self.page_size, self.max_pages, self.n_pages = pool_geometry(
            cfg, n_slots, page_size, max_pages, n_pages)
        assert self.max_pages * self.page_size >= cfg.block_size, (
            f"max_pages={self.max_pages} x page_size={self.page_size} "
            f"cannot hold block_size={cfg.block_size}")
        assert self.n_pages >= self.max_pages, (
            "pool smaller than one slot's worst case")
        self.alloc = PageAllocator(self.n_pages, self.page_size,
                                   prefix_cache=prefix_cache)
        self.mesh_shape = (int(mesh_shape[0]), int(mesh_shape[1]))
        self.group = group
        if group is None:
            self.page_shards, self.model_shards = 1, 1
            self.cache = init_paged_kv_pool(
                cfg, self.n_pages, self.page_size, device=device,
                quant=quant)
        else:
            self.page_shards = group.data_size
            self.model_shards = group.model_size
            self.cache = init_sharded_kv_pool(
                cfg, self.n_pages, self.page_size, group, device=device,
                quant=quant)
        self.block = self.n_pages // self.page_shards
        # host-mirrored page tables, uploaded by the engine on change
        self.tables = np.zeros((n_slots, self.max_pages), np.int32)
        self.positions = np.zeros((n_slots,), np.int32)
        self._free_slots: List[int] = list(range(n_slots - 1, -1, -1))
        self._owner: Dict[int, str] = {}
        self._slot_by_request: Dict[str, int] = {}   # reverse index: O(1)
        self._claims: Dict[int, PageClaim] = {}
        # slots admitted with defer_commit=True (in-window prefill): out
        # of radix registration, flush_pending's included, until
        # commit_admission, which the engine calls once the writes landed
        self._deferred: set = set()

    # ---------------------------------------------------------- geometry

    @property
    def itemsize(self) -> int:
        """Bytes of one stored K/V element (1 for an int8/fp8 pool)."""
        pool = (self.cache if self.group is None
                else next(iter(self.cache.values())))
        return pool["k"].element_size()

    @property
    def seq_len(self) -> int:
        """LOGICAL per-slot capacity (positions are bounded by the
        learned positional table regardless of page count)."""
        return self.cfg.block_size

    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def n_used(self) -> int:
        return self.n_slots - len(self._free_slots)

    @property
    def occupancy(self) -> float:
        return self.n_used / self.n_slots

    # ------------------------------------------------------ slot lifecycle

    def can_admit(self, prompt: np.ndarray, cap: int) -> bool:
        return bool(self._free_slots) and self.alloc.can_acquire(
            np.asarray(prompt, np.int32), cap)

    def cached_prefix_tokens(self, prompt: np.ndarray) -> int:
        """Longest radix-cached prefix of ``prompt`` in tokens, a pure
        peek (no LRU stamp refreshed, nothing claimed): the fleet
        router's affinity probe. 0 with the prefix cache off."""
        if not self.alloc.prefix_cache:
            return 0
        chain = self.alloc.radix.lookup(
            np.asarray(prompt, np.int32).reshape(-1), self.page_size,
            touch=False)
        return len(chain) * self.page_size

    def acquire(self, request_id: str, prompt: np.ndarray,
                cap: int, defer_commit: bool = False
                ) -> Optional[Admission]:
        """``defer_commit=True`` (the engine's windowed admission) holds
        the slot out of radix registration, ``flush_pending`` included,
        until ``commit_admission``: a window in flight is still writing
        its prompt pages, and a prefix hit must never claim a page before
        its writes have landed in stream order."""
        if not self._free_slots:
            return None
        claim = self.alloc.acquire(prompt, cap)
        if claim is None:
            return None
        slot = self._free_slots.pop()
        if defer_commit:
            self._deferred.add(slot)
        self._owner[slot] = request_id
        self._slot_by_request[request_id] = slot
        self._claims[slot] = claim
        row = self.tables[slot]
        row[:] = 0
        row[:len(claim.pages)] = claim.pages
        self.positions[slot] = int(prompt.size) - 1
        return Admission(slot=slot, claimed=claim.claimed_tokens,
                         cow=list(claim.cow))

    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write split on the device: physical page ``src`` into
        ``dst`` across all layers of every pool tensor (K, V and, for a
        quantized pool, their scales), in place; on a serve mesh from one
        data shard's block into another's where they differ."""
        if self.group is not None:
            self.group.copy_page(self.cache, divmod(src, self.block),
                                 divmod(dst, self.block))
            return
        for arr in self.cache.values():
            arr[:, dst].copy_(arr[:, src])

    def commit_admission(self, slot: int) -> None:
        """Register the slot's already-final full prompt pages (called
        after prefill wrote them — registration order is what lets a
        same-step neighbor claim them safely). Lifts a ``defer_commit``
        hold."""
        self._deferred.discard(slot)
        self.alloc.register(self._claims[slot], int(self.positions[slot]))

    def flush_pending(self) -> None:
        """Advance deferred registrations (the page containing prompt
        position P-1 becomes shareable once the first decode write
        passed it). Called once per engine step — cheap: at most one
        page per slot ever waits. Slots under a ``defer_commit`` hold
        are skipped: their prompt writes may still be in flight."""
        for slot, claim in self._claims.items():
            if slot in self._deferred:
                continue
            if self.alloc.pending_registration(claim):
                self.alloc.register(claim, int(self.positions[slot]))

    def release(self, slot: int) -> None:
        self._deferred.discard(slot)
        owner = self._owner.pop(slot, None)
        assert owner is not None, f"slot {slot} double-free"
        if self._slot_by_request.get(owner) == slot:
            del self._slot_by_request[owner]
        self.alloc.release(self._claims.pop(slot))
        self.tables[slot, :] = 0
        self._free_slots.append(slot)

    def owner(self, slot: int) -> Optional[str]:
        return self._owner.get(slot)

    def slot_of(self, request_id: str) -> Optional[int]:
        return self._slot_by_request.get(request_id)

    # ----------------------------------------------------------- metrics

    def stats(self) -> dict:
        """The JAX pool's ``stats()`` keys, with its quantization gauges
        and its mesh accounting: ``n_pages`` (``aggregate_pages``) is the
        admission currency, each data shard stores ``pages_per_chip`` of
        it, and ``effective_mesh_shape`` is the (data, model) split the
        pool and weights really took (an axis that does not divide is 1
        there)."""
        a = self.alloc
        d = self.page_shards
        by_chip = a.in_use_by_block(d)
        per_chip = -(-self.n_pages // d)
        kv_quant = (self.quant.kv_dtype
                    if self.quant is not None and self.quant.kv_enabled
                    else "none")
        gran = self.quant.granularity if kv_quant != "none" else "page"
        return {
            "page_size": self.page_size,
            "max_pages_per_slot": self.max_pages,
            "n_pages": self.n_pages,
            "kv_quant": kv_quant,
            "quant_granularity": gran,
            "bytes_per_page": page_bytes(self.cfg, self.page_size, kv_quant,
                                         gran),
            "kv_quant_bits": 8 * self.itemsize,
            "pages_in_use": a.pages_in_use,
            "pages_free": a.pages_free,
            "page_utilization": round(a.pages_in_use / self.n_pages, 4),
            "mesh_shape": list(self.mesh_shape),
            "effective_mesh_shape": [self.page_shards, self.model_shards],
            "aggregate_pages": self.n_pages,
            "pages_per_chip": per_chip,
            "pages_in_use_by_chip": by_chip,
            "page_utilization_by_chip": [round(c / per_chip, 4)
                                         for c in by_chip],
            "radix_pages": len(a.page_node),
            "prefix_cache": a.prefix_cache,
            "prefix_lookups": a.prefix_lookups,
            "prefix_hits": a.prefix_hits,
            "prefix_hit_tokens": a.prefix_hit_tokens,
            "prefix_hit_rate": (round(a.prefix_hit_tokens
                                      / a.prompt_tokens, 4)
                                if a.prompt_tokens else 0.0),
            "evictions": a.evictions,
            "cow_copies": a.cow_copies,
        }
