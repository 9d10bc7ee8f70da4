"""Train and eval steps (a port of ``replicatinggpt_tpu/train/steps.py``).

PyTorch runs eagerly, so a step is a plain function over the
``TrainState``; the K-step scan dispatch of the JAX package
(``make_train_scan``/``make_eval_scan``) is TPU scaffolding and has no
counterpart. A step returns its loss as a device tensor: nothing here
waits on the card except ``estimate_loss``, once per split.

With a data group (``parallel.mesh``, ``--dp``, its seq group with
``--sp``) a step takes this process's batch (the global one in one
process, a rank's B / data rows under a launch) and runs each data shard
it holds in turn: the shard's rows (``rows``), on the seq group's
columns at their global positions, its own dropout streams
(``parallel.sharded_flash``), its mean loss; the weights come through a
source (``parallel.data_parallel``: the replicated masters and a bucketed
gradient reducer, or FSDP's gathered shards) that sums the gradients
over the shards' micro-batches and then over the shards. Before the clip
and the optimizer step the loss and the gradients are averaged over
every shard of the step (the JAX package's GSPMD reductions over its data
and seq axes). A bare ``LocalSeqGroup`` is a data group of one shard.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional

import torch

from ..config import ModelConfig, TrainConfig
from ..models.gpt import AttentionFn, DropoutRNG, Params, forward
from ..parallel.data_parallel import FSDPSource, ReplicatedSource
from ..parallel.mesh import LocalDataGroup, LocalSeqGroup
from .state import TrainState


def as_data_group(group):
    """A data group: ``group`` itself, or a bare ``LocalSeqGroup`` as one
    data shard over it."""
    return LocalDataGroup(1, group) if isinstance(group, LocalSeqGroup) \
        else group


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


def _source(state: TrainState, g, mcfg: ModelConfig):
    """The step's source of weights, which also sums the gradients."""
    if state.fsdp is not None:
        return FSDPSource(state.fsdp, g, mcfg.compute_dtype, mcfg.n_layer,
                          mcfg.remat)
    return ReplicatedSource(state.model.tree(), g, mcfg.compute_dtype)


def _group_step(state: TrainState, batch, *, mcfg: ModelConfig, accum: int,
                train: bool, attention_fn, g) -> torch.Tensor:
    """The forwards and backwards of the data shards this process holds;
    leaves the averaged gradients in the masters' (or shards') ``.grad``
    and returns the loss averaged over the group."""
    src = _source(state, g, mcfg)
    src.begin()
    xs, ys = batch
    losses = []
    for d in g.shards:
        rng = state.shard_rng(d) if train else None
        total = None
        for j in range(accum):
            x, y = (xs[j], ys[j]) if accum > 1 else (xs, ys)
            src.last = j == accum - 1
            loss = loss_fn(src, (g.rows(x, d), g.rows(y, d)), mcfg, rng=rng,
                           train=train, attention_fn=attention_fn,
                           group=g.seq)
            with src.backward_pass():
                (loss / accum if accum > 1 else loss).backward()
            total = loss.detach() if total is None else total + loss.detach()
        losses.append(total / accum if accum > 1 else total)
    src.finish()
    return g.mean(losses)


def _one_step(state: TrainState, batch, *, mcfg: ModelConfig, accum: int,
              attention_fn: Optional[AttentionFn], group) -> torch.Tensor:
    """One optimizer step; returns the loss (a device tensor)."""
    train = mcfg.dropout > 0 or mcfg.attn_dropout > 0
    state.optimizer.zero_grad()
    g = None if group is None else as_data_group(group)
    if g is not None and (g.replicas > 1 or state.fsdp is not None):
        loss = _group_step(state, batch, mcfg=mcfg, accum=accum, train=train,
                           attention_fn=attention_fn, g=g)
    else:
        # one shard: the plain step (over the seq group's ring, if any)
        seq = None if g is None else g.seq
        rng = state.shard_rng(0) if train else None
        params = state.model.tree()
        if accum > 1:
            loss = _accum_grads(params, batch, mcfg=mcfg, rng=rng,
                                train=train, attention_fn=attention_fn,
                                accum=accum, group=seq)
        else:
            loss = loss_fn(params, batch, mcfg, rng=rng, train=train,
                           attention_fn=attention_fn, group=seq)
            loss.backward()
            loss = loss.detach()
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
    autograd graph; with a group, each held data shard's rows in turn,
    averaged over the group. ``params``: the weight dict, or FSDP's
    source (``TrainState.eval_params``)."""
    g = None if group is None else as_data_group(group)

    @torch.no_grad()
    def eval_step(params, batch) -> torch.Tensor:
        if g is None:
            return loss_fn(params, batch, mcfg, train=False,
                           attention_fn=attention_fn)
        x, y = batch
        losses = []
        for d in g.shards:
            losses.append(loss_fn(params, (g.rows(x, d), g.rows(y, d)), mcfg,
                                  train=False, attention_fn=attention_fn,
                                  group=g.seq))
            if isinstance(params, FSDPSource):
                params.end_pass()
        return g.mean(losses)

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
