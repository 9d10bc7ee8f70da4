"""The data axis in the train step: gradient reduction for data
parallelism, and FSDP's sharded masters (ZeRO-3).

The JAX package gets both from GSPMD (``replicatinggpt_tpu/parallel/
mesh.py``: a batch sharded over 'data' makes XLA all-reduce the
gradients; ``fsdp`` shards every leaf and both AdamW moments over 'data'
by ``_leaf_spec``, and XLA gathers a weight before its use and
reduce-scatters its gradient). Here the same traffic is explicit, and
the forward reads its weights through a *source*, a weight provider of
``models.gpt.forward`` like its ``CastWeights`` (``top()``, ``layer(i)``
called inside block i, ``scope(i)`` around it). Both sources have the
step's interface too: ``begin`` before a step's first backward, ``last``
while a shard's last micro-batch runs, ``backward_pass()`` around each
backward, ``finish`` after the last.

- ``ReplicatedSource`` (DP): the full f32 masters on every process. Each
  unit of weights (the non-block leaves, or one layer's slices of the
  stacked block leaves) enters the forward as one autograd node whose
  backward hands the unit's f32 gradients to a ``GradReducer``: summed
  over a shard's micro-batches into the masters' ``.grad``, then, at its
  last one, summed over the data shards: in shard order in one process,
  else by ``all_reduce`` in ~25 MB buckets started as the backward
  produces each one (DDP's reducer, with accumulation as DDP's
  ``no_sync``).
- ``FSDPSource``: the masters as shards (``FSDPParams``, the shard dim of
  each leaf by ``parallel.mesh.fsdp_shard_dim``). A layer's weights are
  gathered in the compute dtype before its forward (one
  ``all_gather_into_tensor`` per unit and dtype, the next unit's
  prefetched), freed after it, and gathered again for its backward (the
  saved-tensor hooks of its ``scope``; under remat, the recompute
  gathers). A unit's gradients, summed over a shard's micro-batches, are
  reduce-scattered to their shards at the last one
  (``reduce_scatter_tensor``; over the seq ranks an ``all_reduce``
  follows), and the clip's norm sums the shards' squares over the data
  axis (optax's global norm).

In one process (``LocalDataGroup``) the collectives are in-process sums
and concatenations over the shards it holds, in shard order: with two
shards every sum is the one two processes compute, so the two forms
agree bit for bit.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.gpt import leaf_dtype
from .mesh import check_backend, fsdp_shard_dim

#: the gradient bytes one all_reduce carries (DDP's default bucket)
BUCKET_BYTES = 25 * 2 ** 20
#: the key of the non-block leaves' unit; a layer's unit is its index
TOP = "top"
# the flat-tensor collectives (renamed ``*_single`` in newer torch)
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def gather_dtype(name: str, cd: torch.dtype) -> torch.dtype:
    """The dtype the forward reads the f32 master ``name`` in."""
    return leaf_dtype(name, cd) or torch.float32


class _Unit(torch.autograd.Function):
    """One unit of weights in the compute dtypes, from ``source.fetch``;
    the backward hands the unit's gradients to ``source.reduce`` and
    gives the masters none through autograd (the source writes them)."""

    @staticmethod
    def forward(ctx, source, key, *inputs):
        ctx.source, ctx.key, ctx.n = source, key, len(inputs)
        return tuple(source.fetch(key))

    @staticmethod
    def backward(ctx, *grads):
        ctx.source.reduce(ctx.key, grads)
        return (None, None) + (None,) * ctx.n


class GradReducer:
    """The data shards' gradient sum of each unit, into the unit's f32
    gradient tensors ``dest(key)`` (zeroed before the step's first
    backward). ``add(..., last)``: holding one shard, a unit's
    micro-batches add straight into its tensors; holding several, each
    shard's micro-batch sum is kept apart and added at its last, so the
    shards sum in shard order, as two processes' ``all_reduce`` sums them.
    Across processes a unit's tensors join a bucket at its last
    micro-batch; each ~25 MB bucket is all-reduced as soon as the backward
    fills it (DDP's reducer, with accumulation as DDP's ``no_sync``) and
    copied back once two newer ones are in flight, so no more than three
    buckets (each ~25 MB, or one unit where that is larger) live beside
    the gradients."""

    def __init__(self, group, dest):
        self.group, self.dest = group, dest
        self.part: Dict = {}
        self.pending: List[torch.Tensor] = []
        self.pending_bytes = 0
        self.buckets: List = []

    def add(self, key, grads: List[torch.Tensor], last: bool) -> None:
        if len(self.group.shards) > 1:
            if key in self.part:
                grads = [p + g for p, g in zip(self.part.pop(key), grads)]
            if not last:
                self.part[key] = grads
                return
        dest = self.dest(key)
        for d, g in zip(dest, grads):
            d.add_(g)
        if not last or self.group.comm is None:
            return
        self.pending += dest
        self.pending_bytes += sum(d.numel() * 4 for d in dest)
        if self.pending_bytes >= BUCKET_BYTES:
            self._flush()

    def _flush(self) -> None:
        if not self.pending:
            return
        flat = torch.cat([d.reshape(-1) for d in self.pending])
        check_backend(self.group.backend, flat)
        work = dist.all_reduce(flat, group=self.group.comm, async_op=True)
        self.buckets.append((work, flat, self.pending))
        self.pending, self.pending_bytes = [], 0
        while len(self.buckets) > 2:
            self._land(*self.buckets.pop(0))

    @staticmethod
    def _land(work, flat: torch.Tensor, dest: List[torch.Tensor]) -> None:
        work.wait()
        off = 0
        for d in dest:
            d.copy_(flat[off:off + d.numel()].view_as(d))
            off += d.numel()

    def finish(self) -> None:
        """Every bucket summed over the processes and copied back."""
        self._flush()
        while self.buckets:
            self._land(*self.buckets.pop(0))


class ReplicatedSource:
    """The forward's weights from the full f32 masters (``model.tree()``):
    each unit in its compute dtypes (the f32 ones as views, not copies),
    its gradients summed by a ``GradReducer`` into the masters' ``.grad``,
    which ``begin`` zeroes and ``finish`` averages over the group's
    replicas. ``last`` is set while a shard's last micro-batch runs."""

    def __init__(self, tree, group, cd: torch.dtype):
        self.tree, self.group, self.cd = tree, group, cd
        self.top_names = [n for n in tree if n != "blocks"]
        self.block_names = list(tree["blocks"])
        self.reducer = GradReducer(group, self._dest)
        self.last = True

    def _leaves(self, key):
        if key == TOP:
            return [(n, self.tree[n]) for n in self.top_names]
        return [(n, self.tree["blocks"][n]) for n in self.block_names]

    def _masters(self) -> List[torch.Tensor]:
        return [t for _, t in self._leaves(TOP) + self._leaves(0)]

    def _dest(self, key) -> List[torch.Tensor]:
        return [t.grad if key == TOP else t.grad[key]
                for _, t in self._leaves(key)]

    def top(self) -> dict:
        leaves = self._leaves(TOP)
        out = _Unit.apply(self, TOP, *(t for _, t in leaves))
        return dict(zip((n for n, _ in leaves), out))

    def layer(self, i: int) -> dict:
        leaves = self._leaves(i)
        out = _Unit.apply(self, i, *(t for _, t in leaves))
        return dict(zip((n for n, _ in leaves), out))

    def scope(self, i: int):
        return contextlib.nullcontext()

    def backward_pass(self):
        return contextlib.nullcontext()

    def fetch(self, key) -> List[torch.Tensor]:
        out = []
        for n, t in self._leaves(key):
            x, dt = (t if key == TOP else t[key]), gather_dtype(n, self.cd)
            out.append(x.to(dt) if x.dtype != dt else x.view_as(x))
        return out

    def reduce(self, key, grads) -> None:
        self.reducer.add(key, [
            torch.zeros((t if key == TOP else t[key]).shape, device=t.device)
            if g is None else g.float()
            for g, (_, t) in zip(grads, self._leaves(key))], self.last)

    def begin(self) -> None:
        for t in self._masters():
            t.grad = torch.zeros_like(t)

    def finish(self) -> None:
        self.reducer.finish()
        for t in self._masters():
            t.grad.div_(self.group.replicas)


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LeafSpec:
    """A leaf of the train state: its name (``wte``, ``blocks/qkv_kernel``),
    full shape, shard dim (None: whole on every shard) and whether it is
    a layer-stacked block leaf (a layer's unit reads its slice)."""

    name: str
    shape: Tuple[int, ...]
    dim: Optional[int]
    stacked: bool

    @property
    def key(self) -> str:
        return self.name.split("/", 1)[-1]


class FSDPParams:
    """The f32 masters of ``leaves`` ((name, full tensor) in the JAX
    tree's names) as the shards ``held`` of ``data``: shard k of a leaf is
    its k-th chunk along its shard dim (a whole copy for a leaf with
    none). ``parameters()`` are what AdamW steps."""

    def __init__(self, leaves, data: int, held: Sequence[int]):
        self.data, self.held = data, tuple(held)
        self.specs: List[LeafSpec] = []
        self.shards: Dict[str, Dict[int, nn.Parameter]] = {}
        for name, t in leaves:
            dim = fsdp_shard_dim(name, t.shape, data)
            self.specs.append(LeafSpec(name, tuple(t.shape), dim,
                                       name.startswith("blocks/")))
            src = t.detach()
            self.shards[name] = {
                k: nn.Parameter((src if dim is None else
                                 src.chunk(data, dim)[k]).clone())
                for k in self.held}

    def parameters(self) -> List[nn.Parameter]:
        return [self.shards[s.name][k] for s in self.specs
                for k in self.held]

    def spec(self, name: str) -> LeafSpec:
        return next(s for s in self.specs if s.name == name)


def gather_full(spec: LeafSpec, pieces: Dict[int, torch.Tensor], group
                ) -> torch.Tensor:
    """The full leaf from this process's shards ``pieces`` ({shard index:
    tensor}) of ``spec``: concatenated in one process, all-gathered over
    the data axis across processes."""
    n = group.data
    if spec.dim is None:
        return pieces[min(pieces)]
    if group.data_comm is None:
        return torch.cat([pieces[k] for k in range(n)], spec.dim)
    mine = pieces[group.shards[0]].contiguous()
    check_backend(group.backend, mine)
    out = mine.new_empty(n * mine.numel())
    _all_gather(out, mine.reshape(-1), group=group.data_comm)
    return torch.cat(out.view(n, *mine.shape).unbind(0), spec.dim)


class _Saved(NamedTuple):
    """A saved tensor that was a gathered weight: regathered on use."""
    key: int
    leaf: int
    size: torch.Size
    stride: Tuple[int, ...]
    offset: int


class FSDPSource:
    """The forward's weights gathered from ``params`` (``FSDPParams``) over
    ``group``'s data axis; gradients reduce-scattered into the shards'
    ``.grad`` (zeroed by ``begin``)."""

    gathers = True

    def __init__(self, params: FSDPParams, group, cd: torch.dtype,
                 n_layer: int, remat: bool):
        self.p, self.group, self.cd = params, group, cd
        self.L, self.remat = n_layer, remat
        self.units = {TOP: [s for s in params.specs if not s.stacked]}
        blocks = [s for s in params.specs if s.stacked]
        for i in range(n_layer):
            self.units[i] = blocks
        self.last = True
        self.backward = False
        self.inflight: Dict = {}
        self.part: Dict = {}
        self.scatters: List = []
        self.cache: Dict = {}
        self.live: Dict = {}
        self.live_key = None

    # ----------------------------------------------------------- forward

    def top(self) -> dict:
        return self._unit(TOP)

    def layer(self, i: int) -> dict:
        return self._unit(i)

    def scope(self, i: int):
        """Around layer i's forward: without remat, its gathered weights
        are gathered again for the backward (``saving``)."""
        return contextlib.nullcontext() if self.remat else self.saving(i)

    def _unit(self, key) -> dict:
        specs = self.units[key]
        inputs = [self.p.shards[s.name][k] for s in specs
                  for k in self.p.held]
        out = _Unit.apply(self, key, *inputs)
        return dict(zip((s.key for s in specs), out))

    def _owner(self, key: int) -> int:
        """The shard that holds layer ``key`` of a leaf sharded over its
        layer axis."""
        return key // (self.L // self.p.data)

    def _piece(self, spec: LeafSpec, k: int, key) -> torch.Tensor:
        """What shard k contributes to unit ``key`` for ``spec``."""
        t = self.p.shards[spec.name][k]
        if not spec.stacked:
            return t
        if spec.dim == 0:
            per = self.L // self.p.data
            owner = self._owner(key)
            return t[key - k * per] if k == owner else t.new_zeros(
                t.shape[1:])
        return t[key]

    def _groups(self, key):
        """The unit's specs by gather dtype, in order."""
        out: Dict[torch.dtype, List[LeafSpec]] = {}
        for s in self.units[key]:
            out.setdefault(gather_dtype(s.name, self.cd), []).append(s)
        return out

    def _start(self, key):
        """Begin gathering unit ``key``: [(dtype, specs, work, (n, P))]."""
        handles = []
        n = self.p.data
        for dt, specs in self._groups(key).items():
            def row(k):
                return torch.cat([self._piece(s, k, key).to(dt).reshape(-1)
                                  for s in specs])
            if self.group.data_comm is None:
                handles.append((dt, specs, None,
                                torch.stack([row(k) for k in range(n)])))
                continue
            mine = row(self.p.held[0])
            check_backend(self.group.backend, mine)
            out = mine.new_empty(n * mine.numel())
            work = _all_gather(out, mine, group=self.group.data_comm,
                               async_op=True)
            handles.append((dt, specs, work, out.view(n, -1)))
        return handles

    def _assemble(self, key, handles) -> Dict[str, torch.Tensor]:
        full = {}
        for _, specs, work, buf in handles:
            if work is not None:
                work.wait()
            off = 0
            for s in specs:
                shape = self._piece_shape(s)
                size = shape.numel()
                pieces = [buf[r, off:off + size].view(shape)
                          for r in range(self.p.data)]
                off += size
                if s.dim is None:
                    t = pieces[0].clone()
                elif s.stacked and s.dim == 0:
                    t = pieces[self._owner(key)].clone()
                else:
                    t = torch.cat(pieces, s.dim - int(s.stacked))
                full[s.name] = t
        return full

    def _piece_shape(self, s: LeafSpec) -> torch.Size:
        t = self.p.shards[s.name][self.p.held[0]]
        return t.shape[1:] if s.stacked else t.shape

    def _next(self, key):
        if self.backward:
            return None if key == TOP or key == 0 else key - 1
        nxt = 0 if key == TOP else key + 1
        return nxt if nxt < self.L else None

    def fetch(self, key) -> List[torch.Tensor]:
        """Unit ``key``'s full weights (waiting on its prefetch when one
        is in flight), the next unit's gather started behind it."""
        handles = self.inflight.pop(key, None) or self._start(key)
        full = self._assemble(key, handles)
        nxt = self._next(key)
        if nxt is not None and nxt not in self.inflight:
            self.inflight[nxt] = self._start(nxt)
        out = [full[s.name] for s in self.units[key]]
        if key != TOP and not self.backward and not self.remat:
            self.live = {t.untyped_storage().data_ptr(): j
                         for j, t in enumerate(out)}
            self.live_key = key
        return out

    # ------------------------------------- gathered again for the backward

    @contextlib.contextmanager
    def saving(self, i: int):
        """Around layer i's forward without remat: a saved tensor that is
        one of its gathered weights is kept as a note and gathered again
        when the backward reads it, so the full weights of only a layer
        or two are alive at a time."""
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                yield
        finally:
            self.live = {}

    def _pack(self, t: torch.Tensor):
        j = self.live.get(t.untyped_storage().data_ptr())
        if j is None:
            return t
        return _Saved(self.live_key, j, t.size(), t.stride(),
                      t.storage_offset())

    def _unpack(self, x):
        if not isinstance(x, _Saved):
            return x
        if x.key not in self.cache:
            for k in [k for k in self.cache if k > x.key]:
                del self.cache[k]
            with torch.no_grad():
                self.cache[x.key] = self.fetch(x.key)
        return self.cache[x.key][x.leaf].as_strided(x.size, x.stride,
                                                    x.offset)

    # ---------------------------------------------------------- backward

    def begin(self) -> None:
        """Zero the shards' gradients before a step's first backward."""
        for p in self.p.parameters():
            p.grad = torch.zeros_like(p)

    @contextlib.contextmanager
    def backward_pass(self):
        """Around a backward: the regathers prefetch downwards, and
        nothing gathered stays alive after it."""
        self.backward = True
        try:
            yield
        finally:
            self.backward = False
            self.end_pass()

    def end_pass(self) -> None:
        """After a forward and backward: nothing gathered stays alive."""
        for handles in self.inflight.values():
            for _, _, work, _ in handles:
                if work is not None:
                    work.wait()
        self.inflight, self.cache, self.live = {}, {}, {}

    def reduce(self, key, grads) -> None:
        specs = self.units[key]
        g = [torch.zeros(s.shape[1:] if s.stacked else s.shape,
                         device=self.p.shards[s.name][self.p.held[0]].device)
             if x is None else x.float() for x, s in zip(grads, specs)]
        if key in self.part:
            g = [p + x for p, x in zip(self.part.pop(key), g)]
        if not self.last:
            self.part[key] = g
            return
        n = self.p.data
        segs = []
        for x, s in zip(g, specs):
            if s.dim is None:
                segs.append([x] * n)
            elif s.stacked and s.dim == 0:
                owner = self._owner(key)
                segs.append([x if r == owner else torch.zeros_like(x)
                             for r in range(n)])
            else:
                segs.append(list(x.chunk(n, s.dim - int(s.stacked))))
        rows = torch.stack([torch.cat([seg[r].reshape(-1) for seg in segs])
                            for r in range(n)])
        if self.group.data_comm is None:
            for r in self.p.held:
                self._accumulate(key, r, self._seq_sum(rows[r]))
            return
        check_backend(self.group.backend, rows)
        out = rows.new_empty(rows.shape[1])
        work = _reduce_scatter(out, rows.reshape(-1),
                               group=self.group.data_comm, async_op=True)
        self.scatters.append((key, work, out, rows))
        while len(self.scatters) > 2:
            self._land(*self.scatters.pop(0))

    def _land(self, key, work, out, rows) -> None:
        work.wait()
        self._accumulate(key, self.p.held[0], self._seq_sum(out))

    def _seq_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the seq ranks that are processes."""
        if self.group.seq_comm is not None:
            dist.all_reduce(t, group=self.group.seq_comm)
        return t

    def _accumulate(self, key, r: int, row: torch.Tensor) -> None:
        off = 0
        for s in self.units[key]:
            shape = self._piece_shape(s)
            size = shape.numel()
            seg = row[off:off + size].view(shape)
            off += size
            grad = self.p.shards[s.name][r].grad
            if not s.stacked:
                grad.add_(seg)
            elif s.dim == 0:
                if r == self._owner(key):
                    grad[key - r * (self.L // self.p.data)].add_(seg)
            else:
                grad[key].add_(seg)

    def finish(self) -> None:
        """Land every reduce-scatter; the shards' gradients become the
        average over the group's replicas."""
        while self.scatters:
            self._land(*self.scatters.pop(0))
        for p in self.p.parameters():
            p.grad.div_(self.group.replicas)


def fsdp_grad_sq_norm(params: FSDPParams, group) -> torch.Tensor:
    """The squared global norm of FSDP's gradients: each shard's squares
    once (a leaf with no shard dim counted on shard 0 only), summed over
    the data axis."""
    total = None
    for s in params.specs:
        for k in params.held:
            if s.dim is None and k != 0:
                continue
            x = params.shards[s.name][k].grad.float().square().sum()
            total = x if total is None else total + x
    if group.data_comm is not None:
        check_backend(group.backend, total)
        dist.all_reduce(total, group=group.data_comm)
    return total
