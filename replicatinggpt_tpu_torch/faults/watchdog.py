"""Serve self-healing policies: stall watchdog, speculative auto-disable,
load shedding (a copy of ``replicatinggpt_tpu/faults/watchdog.py``,
host-side code).

Small host-side policy objects the serving engine (serve/engine.py)
consults once per step: bookkeeping over values the engine already has
(step wall time, queue depth, per-step draft/accept counts), so an
all-off :class:`ResilienceConfig` (the default) adds nothing to the step
path and changes no behaviour. Every recovery decision lands in the
engine's Metrics (``watchdog_stalls``, ``spec_disables``,
``spec_reprobes``, ``shed_requests``) and in its ``events`` log.
Disabling speculation moves the engine from its verify step to its plain
decode step; neither is a new shape. A policy decides and counts; it
never catches an exception: a drafter that raises, or a kernel launch
that fails, stops the step as it would without these policies.

The JAX policies also mark their decisions on a telemetry timeline; the
port has no telemetry yet (ROADMAP.md queue A item 12).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Tuple


@dataclass(frozen=True)
class ResilienceConfig:
    """Engine self-healing knobs; every subsystem is opt-in (0 = off).

    - watchdog: a step is a *stall* when its wall time exceeds
      ``max(stall_factor x running p99, stall_floor_s)`` after
      ``stall_min_steps`` samples. Detection and counters (a synchronous
      engine cannot preempt a wedged device call; the watchdog makes the
      stall visible);
    - speculative auto-disable: when the windowed accept rate over
      ``spec_window`` slot-steps drops below ``spec_disable_threshold``
      the drafter is a pure tax: disable it, re-probe after
      ``spec_reprobe_after`` steps (backing off ``spec_reprobe_backoff``x
      per consecutive failed probe, capped);
    - load shedding: queue depth above ``shed_watermark x max_queue``
      for ``shed_patience`` consecutive steps sheds the newest queued
      requests back down to the watermark (the oldest are closest to
      service; fresh arrivals are the cheapest to turn away).
    """

    stall_factor: float = 0.0
    stall_floor_s: float = 0.05
    stall_min_steps: int = 20
    stall_skip_steps: int = 2     # warmup laps excluded from the window
                                  # (the first steps build the kernels)
    spec_disable_threshold: float = 0.0
    spec_window: int = 16
    spec_reprobe_after: int = 32
    spec_reprobe_backoff: float = 2.0
    spec_reprobe_cap: int = 1024
    shed_watermark: float = 0.0
    shed_patience: int = 4

    @property
    def watchdog_on(self) -> bool:
        return self.stall_factor > 0

    @property
    def spec_guard_on(self) -> bool:
        return self.spec_disable_threshold > 0

    @property
    def shed_on(self) -> bool:
        return self.shed_watermark > 0


#: detection-only defaults for bench/replay runs: stall visibility and
#: speculative auto-disable on, shedding off (shedding changes the
#: workload a bench measures; enable it deliberately)
DEFAULT_SERVE_RESILIENCE = ResilienceConfig(stall_factor=4.0,
                                            spec_disable_threshold=0.125)


class StepWatchdog:
    """p99-budget stall detector over step wall times (bounded window)."""

    def __init__(self, cfg: ResilienceConfig, window: int = 512):
        self.cfg = cfg
        self.laps: Deque[float] = deque(maxlen=window)
        self._skip = cfg.stall_skip_steps

    def observe(self, dur_s: float) -> bool:
        """Record one step's wall time; True when it was a stall."""
        if self._skip > 0:
            # warmup laps carry one-time builds: seconds against a
            # millisecond steady state, which would blind the budget
            self._skip -= 1
            return False
        stall = False
        if len(self.laps) >= self.cfg.stall_min_steps:
            laps = sorted(self.laps)
            p99 = laps[min(int(0.99 * (len(laps) - 1) + 0.5),
                           len(laps) - 1)]
            budget = max(self.cfg.stall_factor * p99,
                         self.cfg.stall_floor_s)
            stall = dur_s > budget
        # the stalled lap still enters the window (a persistently slow
        # engine raises its own budget rather than alarming forever)
        self.laps.append(dur_s)
        return stall


class SpecHealth:
    """Windowed accept-rate monitor driving speculative auto-disable.

    The engine reports (drafted, accepted) after every verify step;
    :meth:`observe` returns True when the drafter should be disabled.
    While disabled, :meth:`tick_disabled` counts down to the next
    re-probe (exponential backoff across consecutive failed probes).
    Acceptance is exact, so a bad drafter never corrupts output: only
    throughput is at stake."""

    def __init__(self, cfg: ResilienceConfig):
        self.cfg = cfg
        self.window: Deque[Tuple[int, int]] = deque(maxlen=cfg.spec_window)
        self.cooldown = 0
        self._next_cooldown = cfg.spec_reprobe_after

    def observe(self, drafted: int, accepted: int) -> bool:
        self.window.append((drafted, accepted))
        if len(self.window) < self.cfg.spec_window:
            return False
        tot_d = sum(d for d, _ in self.window)
        if tot_d < self.cfg.spec_window:      # too few proposals to judge
            return False
        rate = sum(a for _, a in self.window) / tot_d
        return rate < self.cfg.spec_disable_threshold

    def on_disable(self) -> None:
        self.window.clear()
        self.cooldown = self._next_cooldown
        self._next_cooldown = min(
            int(self._next_cooldown * self.cfg.spec_reprobe_backoff),
            self.cfg.spec_reprobe_cap)

    def on_reenable(self) -> None:
        """A probe survived a full window: the drafter is healthy again,
        reset the backoff."""
        self._next_cooldown = self.cfg.spec_reprobe_after

    def tick_disabled(self) -> bool:
        """One disabled step; True when it is time to re-probe."""
        self.cooldown -= 1
        return self.cooldown <= 0


class LoadShedder:
    """Sustained-overload detector: queue depth over the watermark for
    ``shed_patience`` consecutive steps -> shed down to the watermark."""

    def __init__(self, cfg: ResilienceConfig):
        self.cfg = cfg
        self.streak = 0

    def observe(self, depth: int, max_queue: int) -> int:
        """How many queued requests to shed this step (0 almost always)."""
        watermark = int(self.cfg.shed_watermark * max_queue)
        if depth > watermark:
            self.streak += 1
        else:
            self.streak = 0
            return 0
        if self.streak < self.cfg.shed_patience:
            return 0
        return depth - watermark
