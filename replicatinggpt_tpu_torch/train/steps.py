"""Train and eval steps (a port of ``replicatinggpt_tpu/train/steps.py``).

PyTorch runs eagerly, so a step is a plain function over the
``TrainState``; the K-step scan dispatch of the JAX package
(``make_train_scan``/``make_eval_scan``) is TPU scaffolding and has no
counterpart. A step returns its loss as a device tensor: nothing here
waits on the card except ``estimate_loss``, once per split.

With a seq group (``parallel.mesh``, ``--sp``) a step takes the global
(B, T) batch, as every process draws it, and runs the model on the
group's columns at their global positions: all of them with all shards
in one process (then the step is the plain one with the ring
``attention_fn``); a rank's T / n in a process group, which averages the
loss and, before the clip and the optimizer step, the gradients over the
group (the JAX package's GSPMD reductions over its seq axis).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional

import torch

from ..config import ModelConfig, TrainConfig
from ..models.gpt import AttentionFn, DropoutRNG, Params, forward
from .state import TrainState


def loss_fn(params: Params, batch, cfg: ModelConfig,
            rng: Optional[DropoutRNG] = None, train: bool = False,
            attention_fn: Optional[AttentionFn] = None,
            group=None) -> torch.Tensor:
    """Mean cross-entropy over this process's columns of ``batch``."""
    x, y = batch   # narrow wire dtypes (uint8) widen inside forward
    pos = 0
    if group is not None:
        x, y = group.local_columns(x), group.local_columns(y)
        pos = group.pos_offset(x.shape[-1])
    _, loss = forward(params, x, cfg, targets=y, rng=rng, train=train,
                      attention_fn=attention_fn, pos_offset=pos)
    return loss


def _accum_grads(params: Params, batch, *, mcfg: ModelConfig, rng, train,
                 attention_fn, accum: int, group) -> torch.Tensor:
    """Mean loss over ``accum`` stacked microbatches (each array of
    ``batch`` is (accum, b, T)), with the mean of their gradients left
    in ``.grad``; one microbatch's activations live at a time."""
    xs, ys = batch
    total = None
    for j in range(accum):
        loss = loss_fn(params, (xs[j], ys[j]), mcfg, rng=rng, train=train,
                       attention_fn=attention_fn, group=group)
        (loss / accum).backward()
        total = loss.detach() if total is None else total + loss.detach()
    return total / accum


def _one_step(state: TrainState, batch, *, mcfg: ModelConfig, accum: int,
              attention_fn: Optional[AttentionFn], group) -> torch.Tensor:
    """One optimizer step; returns the loss (a device tensor)."""
    train = mcfg.dropout > 0 or mcfg.attn_dropout > 0
    rng = state.rng if train else None
    params = state.model.tree()
    state.optimizer.zero_grad()
    if accum > 1:
        loss = _accum_grads(params, batch, mcfg=mcfg, rng=rng, train=train,
                            attention_fn=attention_fn, accum=accum,
                            group=group)
    else:
        loss = loss_fn(params, batch, mcfg, rng=rng, train=train,
                       attention_fn=attention_fn, group=group)
        loss.backward()
        loss = loss.detach()
    if group is not None:
        group.average_grads([p.grad for p in state.model.parameters()])
        loss = group.mean(loss)
    state.optimizer.step()
    state.step += 1
    return loss


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig,
                    attention_fn: Optional[AttentionFn] = None,
                    group=None) -> Callable:
    """``step(state, batch) -> loss``. With ``tcfg.grad_accum_steps > 1``
    the batch arrays are stacked (accum, batch_size, T) microbatches."""
    return partial(_one_step, mcfg=mcfg, accum=tcfg.grad_accum_steps,
                   attention_fn=attention_fn, group=group)


def make_eval_step(mcfg: ModelConfig,
                   attention_fn: Optional[AttentionFn] = None,
                   group=None) -> Callable:
    """``eval_step(params, batch) -> loss`` with dropout off and no
    autograd graph (averaged over a seq group)."""

    @torch.no_grad()
    def eval_step(params: Params, batch) -> torch.Tensor:
        loss = loss_fn(params, batch, mcfg, train=False,
                       attention_fn=attention_fn, group=group)
        return loss if group is None else group.mean(loss)

    return eval_step


def estimate_loss(params: Params, batchers: Dict[str, object],
                  eval_step: Callable, eval_iters: int,
                  device) -> Dict[str, float]:
    """Mean loss over ``eval_iters`` fresh batches of each split; the sum
    stays on the device and is fetched once per split."""
    out = {}
    for split, batcher in batchers.items():
        total = None
        for _ in range(eval_iters):
            xb, yb = (torch.from_numpy(a).to(device)
                      for a in batcher.next_batch())
            loss = eval_step(params, (xb, yb))
            total = loss if total is None else total + loss
        out[split] = float(total) / eval_iters
    return out
