"""Train state: the model's f32 masters, the optimizer, the step and the
dropout streams (a port of ``replicatinggpt_tpu/train/state.py``).

``TrainState.state_dict`` / ``load_state_dict`` carry the resume state
as flat named arrays (what ``train/checkpoint.py`` writes): the
parameters in the JAX tree's names (``params/blocks/qkv_kernel``),
AdamW's moments and per-leaf step (``opt/exp_avg/<leaf>``, ...) and its
update ``count``, the states of both dropout generators and ``step``.
JAX draws a step's dropout from a key folded with the step; the port's
streams are stateful, so their states are part of the resume state.

On a data group (``parallel.mesh``) every data shard has its own dropout
streams (``rngs``, ``parallel.sharded_flash.shard_dropout_rng``), and
with FSDP the masters and moments live as shards (``fsdp``,
``parallel.data_parallel.FSDPParams``; ``model`` is None while it
trains). ``state_dict`` then gathers: the full arrays under the same
names, whatever the number of shards or processes (JAX's orbax restore
with new shardings), and every stream of the run, named by its data
shard and seq rank; ``load_state_dict`` keeps this process's shards.

The optimizer keeps optax's semantics: ``optax.chain(
clip_by_global_norm(grad_clip), adamw(schedule, b1, b2, weight_decay))``
with eps 1e-8, eps_root 0, weight decay on every leaf (layernorm and
biases included), and the schedule evaluated at the update count BEFORE
it increments (so a warmup's first update runs at lr 0).
``torch.optim.AdamW`` computes the same update as optax's adamw when it
is given that learning rate per step; the clip is written out in optax's
form (scale by max/norm only when norm >= max, no epsilon).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple, Union)

import torch
import torch.distributed as dist

from ..config import ModelConfig, TrainConfig
from ..models.gpt import GPT, DropoutRNG, init_params
from ..parallel.data_parallel import (FSDPParams, FSDPSource,
                                      fsdp_grad_sq_norm, gather_full)
from ..parallel.sharded_flash import shard_dropout_rng

Schedule = Union[float, Callable[[int], float]]


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def f(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine(init: float, decay_steps: int,
            alpha: float) -> Callable[[int], float]:
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def f(count: int) -> float:
        c = min(count, decay_steps)
        cos = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init * ((1 - alpha) * cos + alpha)
    return f


def lr_schedule_fn(tcfg: TrainConfig) -> Schedule:
    """A float for a constant rate with no warmup; otherwise count -> lr:
    ``optax.linear_schedule(0, lr, max(warmup, 1))`` or
    ``optax.warmup_cosine_decay_schedule``."""
    if tcfg.lr_schedule == "constant" and tcfg.warmup_iters == 0:
        return tcfg.lr
    warm_steps = max(tcfg.warmup_iters, 1)
    warm = _linear(0.0, tcfg.lr, warm_steps)
    if tcfg.lr_schedule != "cosine":
        return warm
    decay = _cosine(tcfg.lr,
                    max(tcfg.max_iters, tcfg.warmup_iters + 1) - warm_steps,
                    0.0 if tcfg.lr == 0 else tcfg.min_lr / tcfg.lr)
    return lambda c: warm(c) if c < warm_steps else decay(c - warm_steps)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sq_norm: Optional[torch.Tensor] = None) -> None:
    """In place: g <- g when ||g|| < max_norm, else (g / ||g||) * max_norm
    (optax's form; the norm stays on the device). ``sq_norm``: ||g||^2
    when ``grads`` are shards of the gradients (FSDP), else taken here."""
    if sq_norm is None:
        sq_norm = sum(g.float().square().sum() for g in grads)
    norm = torch.sqrt(sq_norm)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


class AdamW:
    """``make_optimizer``'s result: optional global-norm clip, then
    AdamW at the scheduled rate of the current update count."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 tcfg: TrainConfig):
        self.params = list(params)
        self.schedule = lr_schedule_fn(tcfg)
        self.grad_clip = tcfg.grad_clip
        self.count = 0
        #: () -> ||g||^2 over every shard of the gradients (FSDP)
        self.sq_norm: Optional[Callable[[], torch.Tensor]] = None
        self.opt = torch.optim.AdamW(
            self.params, lr=self.lr_at(0), betas=tcfg.betas, eps=1e-8,
            weight_decay=tcfg.weight_decay)

    def lr_at(self, count: int) -> float:
        s = self.schedule
        return s(count) if callable(s) else s

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip and self.grad_clip > 0:
            clip_by_global_norm_([p.grad for p in self.params],
                                 self.grad_clip,
                                 self.sq_norm() if self.sq_norm else None)
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.opt.step()
        self.count += 1


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   tcfg: TrainConfig) -> AdamW:
    return AdamW(params, tcfg)


def param_leaves(model: GPT) -> List[Tuple[str, torch.nn.Parameter]]:
    """(name, parameter) in the JAX tree's names: ``wte``, ...,
    ``blocks/<name>`` for the stacked per-layer leaves."""
    out = []
    for name, t in model.tree().items():
        if name == "blocks":
            out += [(f"blocks/{bn}", bt) for bn, bt in t.items()]
        else:
            out.append((name, t))
    return out


def _scalar(x: int) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int64)


Stream = Tuple[int, int]   # (data shard, seq rank) of a dropout stream


def _stream_names(key: Stream, single: bool, dev: str) -> Tuple[str, str]:
    """The resume state's names of a stream's bits and seeds generators:
    the plain names for a run of one stream, else suffixed ``/d.s``."""
    if single:
        return f"rng/bits/{dev}", "rng/seeds"
    d, s = key
    return f"rng/bits/{dev}/{d}.{s}", f"rng/seeds/{d}.{s}"


def _saved_streams(arrays) -> Dict[Stream, str]:
    """{stream: the device type its bits were drawn on} in ``arrays``."""
    out = {}
    for k in arrays:
        if k.startswith("rng/bits/"):
            parts = k.split("/")
            key = (0, 0) if len(parts) == 3 else tuple(
                int(v) for v in parts[3].split("."))
            out[key] = parts[2]
    return out


@dataclass
class TrainState:
    """The resume state. A template with no ``optimizer`` and no ``rng``
    (``weights_state``) restores the weights and the step only. On a
    data group: ``rngs`` ({held data shard: streams}) in place of
    ``rng``, ``fsdp`` (the sharded masters) in place of ``model`` with
    FSDP, and ``group``, over which ``state_dict`` gathers."""

    step: int
    model: Optional[GPT]
    optimizer: Optional[AdamW]
    rng: Optional[DropoutRNG]
    rngs: Optional[Dict[int, DropoutRNG]] = None
    fsdp: Optional[FSDPParams] = None
    group: Any = None

    def param_count(self) -> int:
        return sum(math.prod(shape) for shape, _ in
                   self._leaf_shapes().values())

    def shard_rng(self, shard: int) -> Optional[DropoutRNG]:
        return self.rng if self.rngs is None else self.rngs[shard]

    def eval_params(self, mcfg: ModelConfig):
        """What ``forward`` reads the weights from outside a train step:
        the masters' dict, or FSDP's gathering source."""
        if self.fsdp is None:
            return self.model.tree()
        return FSDPSource(self.fsdp, self.group, mcfg.compute_dtype,
                          mcfg.n_layer, mcfg.remat)

    def full_model(self, mcfg: ModelConfig, keep: bool = True
                   ) -> Optional[GPT]:
        """The full model (with FSDP, gathered leaf by leaf: a collective
        under a launch, so every rank calls it; a rank that does not
        ``keep`` it drops each leaf as it arrives and gets None)."""
        if self.fsdp is None:
            return self.model
        model = GPT(mcfg, device=self.fsdp.parameters()[0].device) \
            if keep else None
        dst = dict(param_leaves(model)) if keep else {}
        with torch.no_grad():
            for k, v in self._param_items():
                if keep:
                    dst[k].copy_(v)
        return model

    # ------------------------------------------------------------ arrays

    def _param_items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """(leaf name, full tensor), one leaf at a time: with FSDP each
        is gathered when it is reached."""
        if self.fsdp is None:
            for k, p in param_leaves(self.model):
                yield k, p.detach()
            return
        for s in self.fsdp.specs:
            yield s.name, gather_full(s, {k: p.detach() for k, p in
                                          self.fsdp.shards[s.name].items()},
                                      self.group)

    def _opt_items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        st = self.optimizer.opt.state
        if self.fsdp is None:
            for k, p in param_leaves(self.model):
                for slot, v in st.get(p, {}).items():
                    yield f"opt/{slot}/{k}", v
            return
        for s in self.fsdp.specs:
            shards = self.fsdp.shards[s.name]
            first = st.get(shards[self.fsdp.held[0]], {})
            for slot, v in first.items():
                yield f"opt/{slot}/{s.name}", v if v.dim() == 0 else \
                    gather_full(s, {k: st[p][slot] for k, p in
                                    shards.items()}, self.group)

    def _streams(self) -> Dict[Stream, DropoutRNG]:
        if self.rngs is None:
            return {(0, 0): self.rng}
        s = self.group.seq_rank
        return {(d, s): r for d, r in self.rngs.items()}

    def _stream_keys(self) -> List[Stream]:
        """Every stream of the run, over all its processes."""
        if self.rngs is None:
            return [(0, 0)]
        return [(d, s) for d in range(self.group.data)
                for s in range(self.group.seq_ranks)]

    def state_items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """``state_dict``'s arrays one at a time, in the same order on
        every process: a caller that keeps only some of them (a
        checkpoint's rank 0) holds one gathered leaf at a time."""
        yield from ((f"params/{k}", v) for k, v in self._param_items())
        if self.optimizer is not None:
            yield "opt/count", _scalar(self.optimizer.count)
            yield from self._opt_items()
        if self.rng is not None or self.rngs is not None:
            states = {key: (r.bits.device.type, r.bits.get_state(),
                            r.seeds.get_state())
                      for key, r in self._streams().items()}
            comm = None if self.group is None else self.group.comm
            if comm is not None:
                every = [None] * dist.get_world_size(comm)
                dist.all_gather_object(every, states, group=comm)
                states = {k: v for part in every for k, v in part.items()}
            single = list(states) == [(0, 0)]
            for key in sorted(states):
                dev, bits, seeds = states[key]
                nb, ns = _stream_names(key, single, dev)
                yield nb, bits
                yield ns, seeds
        yield "step", _scalar(self.step)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Every array of the state, flat and named: ``params/<leaf>``,
        ``opt/<slot>/<leaf>`` and ``opt/count``, each stream's
        ``rng/bits/<device type>`` and ``rng/seeds``
        (``Generator.get_state()``), ``step``. On a single device the
        arrays are the state's own (no copies); on a data group they are
        gathered, every stream included (a collective under a launch)."""
        return dict(self.state_items())

    def load_state_dict(self, arrays: Dict[str, torch.Tensor]) -> None:
        """Copy ``arrays`` (``state_dict``'s names, on any device) into
        this state in place, keeping this process's shards. The
        template's structure decides what is read; a leaf it has and
        ``arrays`` lacks, or of another shape, raises ValueError, and so
        do dropout streams of another layout (``--dp`` / ``--sp``) or
        drawn on another device type (their streams cannot continue
        there)."""
        leaves = self._leaf_shapes()
        want = {f"params/{k}" for k in leaves}
        have = {k for k in arrays if k.startswith("params/")}
        if want != have:
            raise ValueError(f"checkpoint parameters {sorted(have ^ want)} "
                             f"do not match this model's")
        for k, (shape, dtype) in leaves.items():
            src = arrays[f"params/{k}"]
            if tuple(src.shape) != shape or src.dtype != dtype:
                raise ValueError(
                    f"checkpoint leaf {k} is {src.dtype} "
                    f"{tuple(src.shape)}, this model's {dtype} {shape}")
        with torch.no_grad():
            for k, p in self._local_leaves():
                p.copy_(self._local(k, arrays[f"params/{k}"], p))
        if self.optimizer is not None:
            self._load_optimizer(arrays)
        if self.rng is not None or self.rngs is not None:
            saved = _saved_streams(arrays)
            mine = self._streams()
            dev = next(iter(mine.values())).bits.device.type
            if sorted(saved) != sorted(self._stream_keys()) or any(
                    v != dev for v in saved.values()):
                raise ValueError(
                    f"checkpoint dropout streams "
                    f"{sorted((k, v) for k, v in saved.items())} cannot "
                    f"continue as this run's {self._stream_keys()} on a "
                    f"{dev} device: resume on the device type and with the "
                    f"--dp / --sp it was written with (weights alone "
                    f"restore anywhere)")
            single = sorted(saved) == [(0, 0)]
            for key, r in mine.items():
                nb, ns = _stream_names(key, single, dev)
                r.bits.set_state(arrays[nb])
                r.seeds.set_state(arrays[ns])
        self.step = int(arrays["step"])

    def _leaf_shapes(self) -> Dict[str, Tuple[tuple, torch.dtype]]:
        if self.fsdp is None:
            return {k: (tuple(p.shape), p.dtype)
                    for k, p in param_leaves(self.model)}
        return {s.name: (s.shape, torch.float32) for s in self.fsdp.specs}

    def _local_leaves(self) -> List[Tuple[str, torch.Tensor]]:
        """(leaf name, this process's tensor of it): the masters, or each
        held FSDP shard."""
        if self.fsdp is None:
            return list(param_leaves(self.model))
        return [(s.name, p) for s in self.fsdp.specs
                for p in self.fsdp.shards[s.name].values()]

    def _local(self, name: str, full: torch.Tensor,
               like: torch.Tensor) -> torch.Tensor:
        """This process's part of a full array (for ``like``)."""
        if self.fsdp is None or full.dim() == 0:
            return full
        s = self.fsdp.spec(name)
        if s.dim is None:
            return full
        k = next(k for k, p in self.fsdp.shards[name].items() if p is like)
        return full.chunk(self.fsdp.data, s.dim)[k]

    def _load_optimizer(self, arrays) -> None:
        if "opt/count" not in arrays:
            raise ValueError("checkpoint holds no optimizer state")
        opt = self.optimizer
        index = {p: i for i, p in enumerate(opt.params)}
        state: Dict[int, Dict[str, torch.Tensor]] = {}
        for key, v in arrays.items():
            if key.startswith("opt/") and key != "opt/count":
                _, slot, leaf = key.split("/", 2)
                for name, p in self._local_leaves():
                    if name == leaf:
                        state.setdefault(index[p], {})[slot] = \
                            self._local(leaf, v, p).clone()
        # torch's own loader places each moment on its parameter's device
        # and keeps the per-leaf step where torch keeps it
        opt.opt.load_state_dict({"state": state,
                                 "param_groups": opt.opt.state_dict()[
                                     "param_groups"]})
        opt.count = int(arrays["opt/count"])


def create_train_state(mcfg: ModelConfig, tcfg: TrainConfig, device,
                       model: Optional[GPT] = None, stream: int = 0,
                       group=None) -> TrainState:
    """Fresh state on ``device``: weights from ``tcfg.seed`` (or the
    given ``model``), dropout streams from ``tcfg.seed + 1`` (another
    stream than the weights' on the same device), residual masks
    decorrelated by ``stream`` (a process's sequence shard). On a data
    ``group``: rank 0's weights on every process, each held data shard's
    streams (``shard_dropout_rng``), and with FSDP the masters and AdamW
    over this process's shards only."""
    dev = torch.device(device)
    if model is None:
        gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
        model = init_params(mcfg, gen, device=dev)
    if group is None:
        return TrainState(step=0, model=model,
                          optimizer=make_optimizer(model.parameters(), tcfg),
                          rng=DropoutRNG(tcfg.seed + 1, dev, stream))
    group.broadcast_(list(model.parameters()))
    rngs = {d: shard_dropout_rng(tcfg.seed + 1, d, group.seq_rank, dev)
            for d in group.shards}
    if not group.fsdp:
        return TrainState(step=0, model=model,
                          optimizer=make_optimizer(model.parameters(), tcfg),
                          rng=None, rngs=rngs, group=group)
    fsdp = FSDPParams(param_leaves(model), group.data, group.shards)
    del model
    opt = make_optimizer(fsdp.parameters(), tcfg)
    opt.sq_norm = lambda: fsdp_grad_sq_norm(fsdp, group)
    return TrainState(step=0, model=None, optimizer=opt, rng=None, rngs=rngs,
                      fsdp=fsdp, group=group)


def weights_state(mcfg: ModelConfig, seed: int, device) -> TrainState:
    """The random init from ``seed`` as a template that restores the
    weights and the step only (``eval``, ``generate``, ``serve-replay``,
    ``export-torch``): no optimizer moments in memory and no dropout
    streams, so a checkpoint written on the card restores on the CPU and
    the other way round."""
    dev = torch.device(device)
    model = init_params(mcfg, torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    return TrainState(step=0, model=model, optimizer=None, rng=None)
