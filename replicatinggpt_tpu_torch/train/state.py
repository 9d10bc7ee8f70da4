"""Train state: the model's f32 masters, the optimizer, the step and the
dropout streams (a port of ``replicatinggpt_tpu/train/state.py``).

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
from typing import Callable, Iterable, List, Optional, Union

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


@dataclass
class TrainState:
    step: int
    model: GPT
    optimizer: AdamW
    rng: DropoutRNG


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
