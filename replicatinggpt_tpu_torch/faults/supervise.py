"""Loss supervision with checkpoint rollback (a copy of
``replicatinggpt_tpu/faults/supervise.py``, without its telemetry marks:
telemetry is ROADMAP.md queue A item 12).

:func:`supervised_train` wraps ``train.runner.train``:

1. under a :class:`SupervisionConfig` the runner reads the loss every
   ``check_every`` steps and raises :class:`NonFiniteLossError` on a
   non-finite value or :class:`LossSpikeError` past ``spike_factor`` x the
   running EMA;
2. the supervisor counts a ``rollback`` and trains again with
   ``resume=True``: ``restore_latest`` lands on the newest checkpoint that
   verifies (a NaN-poisoned or corrupt save is skipped);
3. the same step failing twice implicates the data window, so the next
   attempt advances the data cursor past it (``data_skips``);
4. after ``max_rollbacks`` recoveries it raises
   :class:`SupervisionExhausted`.

A one-shot fault therefore resumes bit for bit as an uninterrupted run:
the rollback restores the weights, the optimizer, the dropout streams'
states and the data cursor, and the replay consumes the same batches.
The recovery counts land in a ``utils.logging.Metrics``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ..utils.logging import Metrics, StepLogger


class NonFiniteLossError(FloatingPointError):
    """The training loss went NaN or inf at ``step``."""

    def __init__(self, step: int, loss: float):
        super().__init__(f"train loss at step {step} is {loss} — "
                         f"non-finite")
        self.step = step
        self.loss = loss


class LossSpikeError(RuntimeError):
    """The training loss spiked past the supervisor's budget at ``step``."""

    def __init__(self, step: int, loss: float, ema: float, factor: float):
        super().__init__(
            f"train loss at step {step} spiked to {loss:.4f} "
            f"(> {factor:.1f} x running mean {ema:.4f})")
        self.step = step
        self.loss = loss
        self.ema = ema


class SupervisionExhausted(RuntimeError):
    """Recovery failed ``max_rollbacks`` times: the run is dead."""


@dataclass(frozen=True)
class SupervisionConfig:
    """The runner's detection settings: a check every ``check_every``
    steps (each one host sync); ``spike_factor`` 0 turns spike detection
    off (a non-finite loss always raises)."""

    check_every: int = 1
    spike_factor: float = 0.0
    ema_alpha: float = 0.1
    warmup_checks: int = 5


class LossTracker:
    """EMA and finiteness checks over the supervised loss reads, one per
    ``train()`` call (a rolled-back run learns its baseline again)."""

    def __init__(self, cfg: SupervisionConfig):
        self.cfg = cfg
        self.ema: Optional[float] = None
        self.checks = 0

    def check(self, step: int, loss: float) -> None:
        if not math.isfinite(loss):
            raise NonFiniteLossError(step, loss)
        self.checks += 1
        if self.ema is None:
            self.ema = loss
            return
        if (self.cfg.spike_factor > 0
                and self.checks > self.cfg.warmup_checks
                and loss > self.cfg.spike_factor * self.ema):
            raise LossSpikeError(step, loss, self.ema,
                                 self.cfg.spike_factor)
        a = self.cfg.ema_alpha
        self.ema = (1 - a) * self.ema + a * loss


@dataclass
class SupervisedResult:
    """``train()``'s result and the recovery that produced it."""

    result: Any                            # runner.TrainResult
    metrics: Metrics
    attempts: int = 1

    @property
    def counters(self) -> Dict[str, float]:
        return dict(self.metrics.counters)


def _merge_recovery(metrics: Metrics, checkpoint_manager) -> None:
    for k, v in checkpoint_manager.recovery.items():
        if v:
            metrics.inc(k, v)


def supervised_train(cfg, *, checkpoint_manager,
                     logger: Optional[StepLogger] = None,
                     supervision: SupervisionConfig = SupervisionConfig(),
                     max_rollbacks: int = 3, skip_window: int = 1,
                     metrics: Optional[Metrics] = None,
                     resume: bool = False, **train_kwargs) -> SupervisedResult:
    """Run ``train()`` under loss supervision with automatic rollback.
    ``skip_window``: optimizer steps the data cursor moves past a window
    that failed twice; ``max_rollbacks`` bounds the recoveries. Other
    keyword arguments (``device``, ``stop_event``) go to ``train()``."""
    from ..train.runner import train      # the runner imports this module

    logger = logger or StepLogger()
    metrics = metrics or Metrics()
    failures_at: Dict[int, int] = {}
    skip = 0
    for attempt in range(max_rollbacks + 1):
        try:
            res = train(cfg, logger=logger,
                        checkpoint_manager=checkpoint_manager,
                        resume=resume, supervision=supervision,
                        skip_data_steps=skip, **train_kwargs)
            _merge_recovery(metrics, checkpoint_manager)
            return SupervisedResult(result=res, metrics=metrics,
                                    attempts=attempt + 1)
        except (NonFiniteLossError, LossSpikeError) as e:
            metrics.inc("rollbacks")
            step = getattr(e, "step", -1)
            failures_at[step] = failures_at.get(step, 0) + 1
            logger.log(f"supervisor: {e} — rollback "
                       f"{attempt + 1}/{max_rollbacks} to last good "
                       f"checkpoint")
            if attempt == max_rollbacks:
                _merge_recovery(metrics, checkpoint_manager)
                raise SupervisionExhausted(
                    f"training failed {max_rollbacks + 1} times "
                    f"(last: {e}); no recovery path left") from e
            resume = True
            if failures_at[step] > 1 and skip_window > 0:
                # the skip applies at the restored checkpoint's cursor, so
                # it covers the distance from there through the window
                restored = checkpoint_manager.latest_step() or 0
                skip = max(step - restored, 0) + skip_window
                metrics.inc("data_skips")
                logger.log(f"supervisor: step {step} failed again after "
                           f"rollback; advancing data cursor {skip} "
                           f"step(s) (from checkpoint {restored} past "
                           f"the offending window)")
            else:
                skip = 0
    raise AssertionError("unreachable")
