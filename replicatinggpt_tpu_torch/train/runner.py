"""End-to-end training (a port of ``replicatinggpt_tpu/train/runner.py``).

Corpus -> the preset's tokenizer (char, or the byte-level BPE trained at
first use and cached) -> 90/10 split -> random or sequential windows
prefetched to the device -> the train loop with the periodic train/val
estimate and the reference's log lines -> a final estimate and the
tokens/s. On a mesh (``parallel/``) every global batch splits into data
shards (``--dp``; with ``--fsdp`` the masters and moments too) and every
sequence into seq shards whose attention is the ring (``--sp``): all of
them in this process, or one per ``torchrun`` process (data x seq
ranks), where each rank draws its data shard's rows (sequential windows
sliced from the global stream, random ones from a per-process seed),
only rank 0 logs, and tokens/s counts the global batch over the chips. A
preset's mesh that the launch cannot fill runs unsharded
(``config.resolve_mesh``). With a ``CheckpointManager`` the run saves
its whole state every ``checkpoint_every`` steps and at the end (under a
launch, gathered and written by rank 0), resumes from the newest step
that verifies (``resume=True``), stops at a step boundary on
``stop_event`` after saving (under a launch, at a checkpoint boundary, on
rank 0's flag), and under a ``SupervisionConfig`` reads the loss every
``check_every`` steps for ``faults.supervised_train``'s rollback. The
other mesh axes, the profiler and telemetry are not in this port yet
(ROADMAP.md queue A items 11 and 12).
"""

from __future__ import annotations

import dataclasses
import io
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, resolve_mesh
from ..data.dataset import TokenDataset, load_corpus
from ..data.loader import make_batcher, prefetch
from ..faults.inject import (apply_loss_fault, apply_train_state_fault,
                             fire as fault_fire)
from ..faults.supervise import (LossTracker, NonFiniteLossError,
                                SupervisionConfig)
from ..ops.flash_attention import describe_route
from ..parallel import (describe_ring_route, distributed,
                        select_attention_fn)
from ..parallel.sharded_flash import describe_sharded_route
from ..tokenizers import get_tokenizer
from ..utils.logging import StepLogger
from ..utils.profiling import StepTimes
from .state import TrainState, create_train_state
from .steps import estimate_loss, make_eval_step, make_train_step


@dataclass
class TrainResult:
    state: TrainState
    history: list          # [(step, train_loss, val_loss)]
    final_eval: Dict[str, float]
    tokenizer: Any
    tokens_per_sec: float
    step_times: Dict[str, float]   # StepTimes.summary() of the train steps
    main: bool = True              # rank 0, or the only process


def _resolve_vocab(cfg: Config, tokenizer) -> Config:
    """Grow the model's vocabulary to the tokenizer's (a configured vocab
    at least as large is kept)."""
    if cfg.model.vocab_size < tokenizer.vocab_size:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, vocab_size=tokenizer.vocab_size))
    return cfg


def _wire_dtype(vocab_size: int):
    """The narrowest dtype that carries the token ids host -> device."""
    return (np.uint8 if vocab_size <= 0xff
            else np.int16 if vocab_size <= 0x7fff else np.int32)


class _ConsumedCursor:
    """Batcher-shaped view of the snapshot taken with the last consumed
    batch: the prefetch thread draws ahead, so a checkpoint saves this,
    not the batcher's live state."""

    def __init__(self, snap: dict):
        self.snap = snap

    def state(self) -> dict:
        return self.snap


def train(cfg: Config, *, device=None,
          logger: Optional[StepLogger] = None, checkpoint_manager=None,
          resume: bool = False, stop_event=None,
          supervision: Optional[SupervisionConfig] = None,
          skip_data_steps: int = 0) -> TrainResult:
    """Train ``cfg`` on ``device`` (None = the card; raises without one;
    under ``torchrun``, the card of the process's ``LOCAL_RANK``).

    ``checkpoint_manager`` (``train.checkpoint.CheckpointManager``) saves
    every ``cfg.train.checkpoint_every`` steps and at the end; with
    ``resume`` the run first restores its newest verified step (weights,
    optimizer, dropout streams, data cursor) and trains on from there.
    ``stop_event`` (a ``threading.Event``) stops the run at the next step
    boundary: it saves, runs a short final estimate and returns. Under a
    launch across processes the ranks agree on rank 0's flag, and only at
    checkpoint boundaries (a signal reaches the ranks at different steps;
    a rank that left the loop alone would wait in the others'
    collectives); without ``checkpoint_every`` the stop is off (logged).
    ``supervision`` reads the loss every ``check_every`` steps and raises
    ``NonFiniteLossError`` / ``LossSpikeError`` for
    ``faults.supervised_train``; ``skip_data_steps`` (the supervisor's)
    draws and discards that many steps' batches after the restore."""
    joined = dist.is_initialized()

    def warn(msg: str) -> None:
        if os.environ.get("RANK", "0") == "0":
            print(f"warning: {msg}", file=sys.stderr)

    mesh = resolve_mesh(cfg.mesh.validate(), distributed.world_size(), warn)
    cfg = dataclasses.replace(cfg, mesh=mesh)
    dev, group = distributed.setup(mesh.data, mesh.seq, device, mesh.fsdp)
    try:
        return _train(cfg, dev, group, logger or StepLogger(),
                      checkpoint_manager, resume, stop_event, supervision,
                      skip_data_steps)
    finally:
        if dist.is_initialized() and not joined:
            dist.destroy_process_group()


def _agreed_stop(stop_event, it: int, start_step: int, every: int,
                 group) -> bool:
    """Whether the run stops before step ``it``: the event in one process;
    under a launch rank 0's flag, broadcast at checkpoint boundaries."""
    if stop_event is None:
        return False
    if group is None or group.comm is None:
        return stop_event.is_set()
    if not (every and it > start_step and it % every == 0):
        return False
    flag = torch.tensor([int(stop_event.is_set())],
                        device="cuda" if group.backend == "nccl" else "cpu")
    dist.broadcast(flag, 0, group=group.comm)
    return bool(flag.item())


def _train(cfg: Config, dev: torch.device, group, logger: StepLogger,
           checkpoint_manager, resume: bool, stop_event,
           supervision: Optional[SupervisionConfig],
           skip_data_steps: int) -> TrainResult:
    main = group is None or group.is_main
    if not main:
        logger = StepLogger(stream=io.StringIO())   # only rank 0 logs
    launched = group is not None and group.comm is not None
    if stop_event is not None and launched \
            and not cfg.train.checkpoint_every:
        logger.log("note: graceful stop disabled (a run launched across "
                   "processes without checkpoint_every: no agreed boundary "
                   "to stop at)")
        stop_event = None
    text = load_corpus(cfg.dataset)
    t0 = time.perf_counter()
    tokenizer = get_tokenizer(cfg.tokenizer, corpus_text=text)
    logger.log(f"tokenizer: {cfg.tokenizer}, {tokenizer.vocab_size} tokens, "
               f"ready in {time.perf_counter() - t0:.1f}s")
    cfg = _resolve_vocab(cfg, tokenizer)
    mcfg, tcfg = cfg.model, cfg.train
    B, T = tcfg.batch_size, mcfg.block_size

    ds = TokenDataset.from_text(text, tokenizer, tcfg.val_fraction)
    logger.log(f"dataset: {len(ds.train):,} train / {len(ds.val):,} val "
               f"tokens, vocab {tokenizer.vocab_size}")
    # each process draws its data shard's rows: a slice of the global
    # sequential stream, or random windows from its own seed (JAX's
    # local_batch_slice / per_process_seed); in one process the global
    # batch, whose rows the step splits
    n_data = cfg.mesh.data
    d = group.data_rank if launched and n_data > 1 else None
    rows = distributed.local_batch_slice(B, n_data, d or 0)  # B % data == 0
    shard, seed, local_bs = (0, 1), tcfg.seed, B
    if d is not None:
        local_bs = rows.stop - rows.start
        shard, seed = (d, n_data), distributed.per_process_seed(tcfg.seed, d)
    train_batcher = make_batcher(tcfg.sampling, ds.train, local_bs, T,
                                 seed=seed, shard=shard)
    eval_batchers = {
        "train": make_batcher("random", ds.train, local_bs, T,
                              seed=seed + 1),
        "val": make_batcher("random", ds.val, local_bs, T, seed=seed + 2),
    }
    state = create_train_state(mcfg, tcfg, dev, group=group)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    remat = f", remat={mcfg.remat_policy}" if mcfg.remat else ""
    logger.log(f"model: {state.param_count():,} params "
               f"({mcfg.n_layer}L/{mcfg.n_head}H/{mcfg.n_embd}C, "
               f"dtype={mcfg.dtype}{remat}) on {dev} ({name})")
    attention_fn = None
    if group is None:
        logger.log(f"attention: {describe_route(mcfg, T)}")
    else:
        if n_data > 1 or cfg.mesh.fsdp:
            where = ("one process holding all "
                     f"{n_data} shards" if not launched else
                     f"{group.processes} processes ({group.backend})")
            logger.log(f"data parallelism: data axis {n_data}, FSDP "
                       f"{'on' if cfg.mesh.fsdp else 'off'}, {where}")
        if cfg.mesh.seq > 1:
            attention_fn = select_attention_fn(mcfg, cfg.mesh, group.seq)
            logger.log(f"sequence parallelism: seq axis {cfg.mesh.seq}, "
                       f"impl {attention_fn.impl_name!r} (configured "
                       f"{mcfg.attention_impl!r}), {group.seq.describe()}")
            logger.log(f"attention: {describe_ring_route(T, group.seq)}")
        else:
            logger.log(describe_sharded_route(mcfg, T, n_data))
    train_step = make_train_step(mcfg, tcfg, attention_fn, group)
    eval_step = make_eval_step(mcfg, attention_fn, group)
    start_step = 0
    if checkpoint_manager is not None and resume:
        if checkpoint_manager.restore_latest(state,
                                             train_batcher) is not None:
            start_step = state.step
            logger.log(f"resumed from step {start_step}")

    accum = max(tcfg.grad_accum_steps, 1)
    if accum > 1:
        logger.log(f"gradient accumulation: {accum} x {B} rows/optimizer "
                   f"step (effective batch {accum * B})")
    tokens_per_batch = B * T * accum   # the global batch, on every rank
    chips = 1 if group is None else group.processes
    wire = _wire_dtype(mcfg.vocab_size)

    if skip_data_steps:
        # the supervisor's recovery: the same window failed twice, so the
        # resumed run trains past it
        for _ in range(skip_data_steps * accum):
            train_batcher.next_batch()
        logger.log(f"supervisor: data cursor advanced {skip_data_steps} "
                   f"optimizer step(s) past the offending window")

    def feed():
        # each item carries the batcher's state as of its draw, which a
        # checkpoint saves once the step has consumed it
        for _ in range(start_step, tcfg.max_iters):
            if accum == 1:
                x, y = train_batcher.next_batch()
            else:
                x, y = (np.stack(a) for a in zip(
                    *(train_batcher.next_batch() for _ in range(accum))))
            yield x.astype(wire), y.astype(wire), train_batcher.state()

    schedule = state.optimizer.schedule
    lr_at = schedule if callable(schedule) else (lambda step: None)
    params = state.eval_params(mcfg)
    history = []
    times = StepTimes(dev)
    tokens_seen = tokens_since_log = 0
    tracker = None
    if supervision is not None:
        tracker = LossTracker(supervision)
        logger.log(f"supervision: loss checked every "
                   f"{supervision.check_every} step(s)"
                   + (f", spike budget {supervision.spike_factor:.1f}x EMA"
                      if supervision.spike_factor else ""))
    cursor = _ConsumedCursor(train_batcher.state())
    stopped_early = False
    batches = prefetch(feed(), dev)
    t0 = time.perf_counter()
    logger.reset_timer()
    try:
        it = start_step
        while it < tcfg.max_iters:
            # chaos seam (no-op without an installed FaultPlan)
            flt = fault_fire("train/step", index=it)
            if flt is not None:
                apply_train_state_fault(flt, state)
            if _agreed_stop(stop_event, it, start_step,
                            tcfg.checkpoint_every, group):
                stopped_early = True
                logger.log(f"stop requested at step {it}; "
                           "checkpointing and exiting")
                if checkpoint_manager is not None:
                    checkpoint_manager.save(state, cursor)
                break
            if tcfg.eval_interval and it % tcfg.eval_interval == 0:
                losses = estimate_loss(params, eval_batchers, eval_step,
                                       tcfg.eval_iters, dev)
                logger.log_eval(it, losses["train"], losses["val"])
                history.append((it, losses["train"], losses["val"]))
                logger.reset_timer()
            *batch, cursor.snap = next(batches)
            times.start()
            loss = train_step(state, batch)
            times.stop()
            it += 1
            tokens_seen += tokens_per_batch
            tokens_since_log += tokens_per_batch
            if (tracker is not None
                    and (it - start_step) % supervision.check_every == 0):
                sup_loss = float(loss)   # one sync per supervised step
                flt = fault_fire("train/loss", index=it - 1)
                if flt is not None:
                    sup_loss = apply_loss_fault(flt, sup_loss)
                tracker.check(it - 1, sup_loss)
            if tcfg.log_interval and it % tcfg.log_interval == 0:
                loss_val = float(loss)   # one sync per log boundary
                if not np.isfinite(loss_val):
                    raise NonFiniteLossError(it - 1, loss_val)
                logger.log_step(it - 1, loss_val, tokens_since_log, chips,
                                lr=lr_at(it - 1))
                tokens_since_log = 0
            if (checkpoint_manager is not None and tcfg.checkpoint_every
                    and it % tcfg.checkpoint_every == 0):
                checkpoint_manager.save(state, cursor)
    finally:
        batches.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    # a stop keeps its epilogue short: the checkpoint is already written
    final_eval = estimate_loss(params, eval_batchers, eval_step,
                               min(tcfg.eval_iters, 8) if stopped_early
                               else tcfg.eval_iters, dev)
    logger.log_eval(state.step, final_eval["train"], final_eval["val"])
    history.append((state.step, final_eval["train"], final_eval["val"]))
    if checkpoint_manager is not None and not stopped_early:
        checkpoint_manager.save(state, cursor)
    if state.fsdp is not None:
        # the trained weights whole, for the rank that samples and
        # returns them (a collective under a launch: the others drop them)
        state.model = state.full_model(mcfg, keep=main)
    tps = tokens_seen / wall if wall > 0 else 0.0
    # the first step pays the kernels' build and first-launch costs
    step_times = times.summary(skip=1 if len(times.pairs) > 1 else 0)
    clock = "device events" if dev.type == "cuda" else "host clock"
    rate = (f"{tps:,.0f} tok/s/chip" if chips == 1 else
            f"{tps:,.0f} tok/s over {chips} chips, {tps / chips:,.0f} "
            f"tok/s/chip")
    logger.log(f"trained {tokens_seen:,} tokens in {wall:.1f}s ({rate})",
               tokens=tokens_seen, wall_s=wall, tokens_per_sec=tps)
    logger.log(f"train step p50 {step_times['p50_ms']:.3f} ms, mean "
               f"{step_times['mean_ms']:.3f} ms over {step_times['n']} "
               f"steps ({clock})",
               **step_times)
    return TrainResult(state=state, history=history, final_eval=final_eval,
                       tokenizer=tokenizer, tokens_per_sec=tps,
                       step_times=step_times, main=main)
