"""Train state: the model's f32 masters, the optimizer, the step and the
dropout streams (a port of ``replicatinggpt_tpu/train/state.py``).

``TrainState.state_dict`` / ``load_state_dict`` carry the resume state
as flat named arrays (what ``train/checkpoint.py`` writes): the
parameters in the JAX tree's names (``params/blocks/qkv_kernel``),
AdamW's moments and per-leaf step (``opt/exp_avg/<leaf>``, ...) and its
update ``count``, the states of both dropout generators and ``step``.
JAX draws a step's dropout from a key folded with the step; the port's
streams are stateful, so their states are part of the resume state.

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
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from ..config import ModelConfig, TrainConfig
from ..models.gpt import GPT, DropoutRNG, init_params

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


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """In place: g <- g when ||g|| < max_norm, else (g / ||g||) * max_norm
    (optax's form; the norm stays on the device)."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
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
                                 self.grad_clip)
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


@dataclass
class TrainState:
    """The resume state. A template with no ``optimizer`` and no ``rng``
    (``weights_state``) restores the weights and the step only."""

    step: int
    model: GPT
    optimizer: Optional[AdamW]
    rng: Optional[DropoutRNG]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Every array of the state, flat and named, on the devices where
        it lives (no copies): ``params/<leaf>``, ``opt/<slot>/<leaf>`` and
        ``opt/count``, ``rng/bits/<device type>`` and ``rng/seeds``
        (``Generator.get_state()``), ``step``."""
        leaves = param_leaves(self.model)
        out = {f"params/{k}": p.detach() for k, p in leaves}
        if self.optimizer is not None:
            out["opt/count"] = _scalar(self.optimizer.count)
            st = self.optimizer.opt.state
            for k, p in leaves:
                for slot, v in st.get(p, {}).items():
                    out[f"opt/{slot}/{k}"] = v
        if self.rng is not None:
            bits = self.rng.bits
            out[f"rng/bits/{bits.device.type}"] = bits.get_state()
            out["rng/seeds"] = self.rng.seeds.get_state()
        out["step"] = _scalar(self.step)
        return out

    def load_state_dict(self, arrays: Dict[str, torch.Tensor]) -> None:
        """Copy ``arrays`` (``state_dict``'s names, on any device) into
        this state in place. The template's structure decides what is
        read; a leaf it has and ``arrays`` lacks, or of another shape,
        raises ValueError, and so does a device generator drawn on another
        device type (its stream cannot continue there)."""
        leaves = param_leaves(self.model)
        want = {f"params/{k}" for k, _ in leaves}
        have = {k for k in arrays if k.startswith("params/")}
        if want != have:
            raise ValueError(f"checkpoint parameters {sorted(have ^ want)} "
                             f"do not match this model's")
        with torch.no_grad():
            for k, p in leaves:
                src = arrays[f"params/{k}"]
                if src.shape != p.shape or src.dtype != p.dtype:
                    raise ValueError(
                        f"checkpoint leaf {k} is {src.dtype} "
                        f"{tuple(src.shape)}, this model's {p.dtype} "
                        f"{tuple(p.shape)}")
                p.copy_(src)
        if self.optimizer is not None:
            self._load_optimizer(arrays, leaves)
        if self.rng is not None:
            dev = self.rng.bits.device.type
            saved = [k for k in arrays if k.startswith("rng/bits/")]
            if saved != [f"rng/bits/{dev}"]:
                raise ValueError(
                    f"checkpoint dropout stream {saved} cannot continue on "
                    f"a {dev} device: resume on the device type it was "
                    f"written on (weights alone restore anywhere)")
            self.rng.bits.set_state(arrays[saved[0]])
            self.rng.seeds.set_state(arrays["rng/seeds"])
        self.step = int(arrays["step"])

    def _load_optimizer(self, arrays, leaves) -> None:
        if "opt/count" not in arrays:
            raise ValueError("checkpoint holds no optimizer state")
        opt = self.optimizer
        index = {p: i for i, p in enumerate(opt.params)}
        leaf_index = {k: index[p] for k, p in leaves}
        state: Dict[int, Dict[str, torch.Tensor]] = {}
        for key, v in arrays.items():
            if key.startswith("opt/") and key != "opt/count":
                _, slot, leaf = key.split("/", 2)
                state.setdefault(leaf_index[leaf], {})[slot] = v
        # torch's own loader places each moment on its parameter's device
        # and keeps the per-leaf step where torch keeps it
        opt.opt.load_state_dict({"state": state,
                                 "param_groups": opt.opt.state_dict()[
                                     "param_groups"]})
        opt.count = int(arrays["opt/count"])


def create_train_state(mcfg: ModelConfig, tcfg: TrainConfig, device,
                       model: Optional[GPT] = None,
                       stream: int = 0) -> TrainState:
    """Fresh state on ``device``: weights from ``tcfg.seed`` (or the
    given ``model``), dropout streams from ``tcfg.seed + 1`` (another
    stream than the weights' on the same device), residual masks
    decorrelated by ``stream`` (a process's sequence shard)."""
    dev = torch.device(device)
    if model is None:
        gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
        model = init_params(mcfg, gen, device=dev)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model.parameters(), tcfg),
                      rng=DropoutRNG(tcfg.seed + 1, dev, stream))


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
