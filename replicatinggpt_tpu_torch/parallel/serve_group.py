"""The serve group: where the shards of a (data, model) serving mesh live,
and how they meet.

The JAX engine (``replicatinggpt_tpu/serve/engine.py`` with
``mesh_data``/``mesh_model``) runs GSPMD over a (data, model) device
mesh: the paged pool's physical pages split over 'data', the heads, the
pool's channels and the weights (Megatron TP) over 'model'. Here the
shards are explicit, in the two forms of the sequence group
(``parallel/mesh.py``):

- ``LocalServeGroup``: all shards in this process, on its one device.
  Each shard holds its own page block, its heads' weights and its pool
  columns; a collective is a sum or a max over the shards' tensors, in
  shard order;
- ``ProcessServeGroup``: one shard per process of a ``torch.distributed``
  group (NCCL between cards, gloo on the CPU), rank ``d * model + m``
  holding data shard d and model shard m, with a data subgroup (the
  ranks of one m) and a model subgroup (the ranks of one d).

Both hold only the shards of an axis that divides (``data_size``,
``model_size``: 1 where the axis dropped, its shards then replicated and
no collective runs over it), and give the serving steps one interface:
``data_shards`` / ``model_shards`` (the shard indices this process
holds), ``sum_model`` (the row-parallel all-reduce), ``max_model``,
``gather_model`` (vocab-parallel logits), ``merge_data`` (the exact
logsumexp merge of paged attention partials), ``sum_data`` (a view built
from masked per-block reads), ``copy_page`` (a copy-on-write split that
may cross data shards), ``broadcast_`` and ``synced_clock`` (rank 0's
host decisions on every rank).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _merge(parts: Sequence[Partials]) -> Partials:
    """The logsumexp merge of per-shard (acc (B, W, C), m (B, W, H), l (B,
    W, H)) partials, in list order: ``m_g = max``, ``corr = exp(m -
    m_g)``, ``l_g = sum l corr``, ``acc_g = sum acc corr`` (a shard that
    owns nothing, m = -1e30 and l = 0, weighs exp(.) x 0)."""
    m_g = parts[0][1]
    for _, m, _ in parts[1:]:
        m_g = torch.maximum(m_g, m)
    acc_g = l_g = None
    for acc, m, l in parts:
        corr = torch.exp(m - m_g)
        D = acc.shape[-1] // m.shape[-1]
        a = acc * corr.repeat_interleave(D, dim=-1)
        acc_g = a if acc_g is None else acc_g + a
        l_g = l * corr if l_g is None else l_g + l * corr
    return acc_g, m_g, l_g


def _sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum in f32 in list order, back in the parts' dtype."""
    out = parts[0].float()
    for p in parts[1:]:
        out = out + p.float()
    return out.to(parts[0].dtype)


class LocalServeGroup:
    """Every shard of a ``data`` x ``model`` mesh in this process."""

    def __init__(self, data: int, model: int):
        if data < 1 or model < 1:
            raise ValueError(f"a serve mesh needs axes >= 1, got "
                             f"{data}x{model}")
        self.data_size, self.model_size = data, model
        self.data_shards = tuple(range(data))
        self.model_shards = tuple(range(model))
        self.is_main = True

    def describe(self) -> str:
        return (f"one process holding all {self.data_size}x"
                f"{self.model_size} shards")

    def sum_model(self, parts: List[torch.Tensor]) -> torch.Tensor:
        return _sum(parts)

    def max_model(self, parts: List[torch.Tensor]) -> torch.Tensor:
        out = parts[0]
        for p in parts[1:]:
            out = torch.maximum(out, p)
        return out

    def gather_model(self, parts: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat(parts, dim=-1)

    def merge_data(self, parts: List[Partials]) -> Partials:
        return _merge(parts)

    def sum_data(self, parts: List[torch.Tensor]) -> torch.Tensor:
        return _sum(parts)

    def copy_page(self, blocks, src: Tuple[int, int],
                  dst: Tuple[int, int]) -> None:
        """Copy page ``src`` = (data shard, local index) into ``dst`` in
        every model shard's pool block: ``blocks[(d, m)]`` is that shard's
        dict of (L, N_loc, ...) tensors."""
        for m in self.model_shards:
            for name, arr in blocks[(dst[0], m)].items():
                arr[:, dst[1]].copy_(blocks[(src[0], m)][name][:, src[1]])

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        pass

    def synced_clock(self, clock: Callable[[], float]
                     ) -> Callable[[], float]:
        return clock


class ProcessServeGroup:
    """One shard of a ``data`` x ``model`` mesh per process of the default
    ``torch.distributed`` group, whose size must be ``data * model``.
    ``data_size`` / ``model_size`` (default: the mesh's) are the axes'
    effective sizes: an axis that does not divide its dimension has size 1
    there, its ranks hold copies of the one shard and run no collective
    over it."""

    def __init__(self, data: int, model: int, data_size: int = 0,
                 model_size: int = 0):
        if not dist.is_initialized():
            raise RuntimeError("ProcessServeGroup needs an initialized "
                               "torch.distributed process group")
        n = dist.get_world_size()
        if n != data * model:
            raise ValueError(f"{n} processes for a {data}x{model} serve "
                             f"mesh: launch data * model = {data * model}")
        self.rank = dist.get_rank()
        self.is_main = self.rank == 0
        self.backend = dist.get_backend()
        self.data_size = data_size or data
        self.model_size = model_size or model
        d, m = divmod(self.rank, model)
        self.data_shards = (d if self.data_size > 1 else 0,)
        self.model_shards = (m if self.model_size > 1 else 0,)
        self._model = model
        # every rank creates every subgroup, in one order
        self._data_group = self._model_group = None
        for mm in range(model):
            g = dist.new_group([dd * model + mm for dd in range(data)])
            if mm == m:
                self._data_group = g
        for dd in range(data):
            g = dist.new_group([dd * model + mm for mm in range(model)])
            if dd == d:
                self._model_group = g

    def describe(self) -> str:
        return (f"{dist.get_world_size()} processes, one shard each "
                f"({self.backend})")

    def _check(self, t: torch.Tensor) -> None:
        cuda = t.device.type == "cuda"
        if self.backend == "nccl" and not cuda:
            raise ValueError(f"a {t.device} tensor on an NCCL group: NCCL "
                             f"moves CUDA tensors only")
        if self.backend == "gloo" and cuda:
            raise ValueError("a CUDA tensor on a gloo group: run the CPU "
                             "path (--device cpu) on gloo, or NCCL on cards")

    def _reduce(self, t: torch.Tensor, op, group, size: int
                ) -> torch.Tensor:
        if size == 1:
            return t
        self._check(t)
        t = t.contiguous().clone()
        dist.all_reduce(t, op=op, group=group)
        return t

    def sum_model(self, parts: List[torch.Tensor]) -> torch.Tensor:
        (p,) = parts
        return self._reduce(p.float(), dist.ReduceOp.SUM, self._model_group,
                            self.model_size).to(p.dtype)

    def max_model(self, parts: List[torch.Tensor]) -> torch.Tensor:
        (p,) = parts
        return self._reduce(p, dist.ReduceOp.MAX, self._model_group,
                            self.model_size)

    def gather_model(self, parts: List[torch.Tensor]) -> torch.Tensor:
        (p,) = parts
        if self.model_size == 1:
            return p
        self._check(p)
        out = [torch.empty_like(p) for _ in range(self.model_size)]
        dist.all_gather(out, p.contiguous(), group=self._model_group)
        return torch.cat(out, dim=-1)

    def merge_data(self, parts: List[Partials]) -> Partials:
        ((acc, m, l),) = parts
        if self.data_size == 1:
            return acc, m, l
        m_g = self._reduce(m, dist.ReduceOp.MAX, self._data_group,
                           self.data_size)
        corr = torch.exp(m - m_g)
        D = acc.shape[-1] // m.shape[-1]
        l_g = self._reduce(l * corr, dist.ReduceOp.SUM, self._data_group,
                           self.data_size)
        acc_g = self._reduce(acc * corr.repeat_interleave(D, dim=-1),
                             dist.ReduceOp.SUM, self._data_group,
                             self.data_size)
        return acc_g, m_g, l_g

    def sum_data(self, parts: List[torch.Tensor]) -> torch.Tensor:
        (p,) = parts
        return self._reduce(p.float(), dist.ReduceOp.SUM, self._data_group,
                            self.data_size).to(p.dtype)

    def copy_page(self, blocks, src: Tuple[int, int],
                  dst: Tuple[int, int]) -> None:
        """Copy page ``src`` = (data shard, local index) into ``dst`` on
        this rank's model shard: in place when both lie in this rank's
        block, else a send from the source shard's rank to the
        destination's (the ranks of one model shard)."""
        (d,), (m,) = self.data_shards, self.model_shards
        arrs = blocks[(d, m)]
        if src[0] == dst[0]:
            if d == src[0]:
                for arr in arrs.values():
                    arr[:, dst[1]].copy_(arr[:, src[1]])
            return
        peer = (dst[0] if d == src[0] else src[0]) * self._model + (
            self.rank % self._model)
        for arr in arrs.values():
            if d == src[0]:
                self._check(arr)
                dist.send(arr[:, src[1]].contiguous(), peer)
            elif d == dst[0]:
                buf = torch.empty_like(arr[:, dst[1]])
                dist.recv(buf, peer)
                arr[:, dst[1]].copy_(buf)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values into ``tensors`` on every rank."""
        with torch.no_grad():
            for t in tensors:
                self._check(t)
                dist.broadcast(t, 0)

    def synced_clock(self, clock: Callable[[], float]
                     ) -> Callable[[], float]:
        """``clock`` read on rank 0 and handed to every rank: each call is
        a broadcast, so the ranks take every host decision that reads the
        clock (arrivals, deadlines) on the same value, and call it at the
        same points."""
        dev = (torch.device("cuda", torch.cuda.current_device())
               if self.backend == "nccl" else torch.device("cpu"))

        def synced() -> float:
            t = torch.tensor([clock() if self.is_main else 0.0],
                             dtype=torch.float64, device=dev)
            dist.broadcast(t, 0)
            return float(t.item())

        return synced


def serve_group(data: int, model: int, data_size: int, model_size: int):
    """The group of a serving engine on a ``data`` x ``model`` mesh whose
    effective axes are ``data_size`` x ``model_size``: one shard a
    process when this process is part of a launch (an initialized
    ``torch.distributed`` group of more than one process), else all of
    them here."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return ProcessServeGroup(data, model, data_size, model_size)
    return LocalServeGroup(data_size, model_size)
