"""Step timing (the port of ``StepTimer`` from
``replicatinggpt_tpu/utils/profiling.py``).

PyTorch returns before the card finishes, so a lap on a CUDA device
ends with ``torch.cuda.synchronize()``: the lap then measures the
device work it covers, not only its enqueue.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch


class StepTimer:
    """Blocking wall-clock statistics of steps on one device."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.device = device
        self.laps: List[float] = []
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def lap(self) -> float:
        """End the current lap (after the device has finished its queued
        work) and start the next; returns the lap time."""
        self._sync()
        now = time.perf_counter()
        assert self._t0 is not None, "call start() before lap()"
        dt = now - self._t0
        self.laps.append(dt)
        self._t0 = now
        return dt

    @staticmethod
    def _pct(sorted_laps: List[float], q: float) -> float:
        if not sorted_laps:
            return 0.0
        i = min(int(q * (len(sorted_laps) - 1) + 0.5), len(sorted_laps) - 1)
        return sorted_laps[i]

    def summary(self, skip: int = 0) -> Dict[str, float]:
        """Stats over laps[skip:]."""
        laps = self.laps[skip:]
        if not laps:
            return {"n": 0, "mean_s": 0.0, "p50_s": 0.0, "p90_s": 0.0,
                    "p99_s": 0.0}
        s = sorted(laps)
        return {"n": float(len(laps)), "mean_s": sum(laps) / len(laps),
                "p50_s": self._pct(s, 0.50), "p90_s": self._pct(s, 0.90),
                "p99_s": self._pct(s, 0.99)}


class StepTimes:
    """Per-step times read after a run, without a sync inside it: on a
    CUDA device a pair of events brackets each step on the current
    stream, so a step's time is the device clock from the start of its
    first kernel's slot to the end of its last (host-induced idle gaps
    inside the step included); on the CPU, the host clock."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = torch.device(device).type == "cuda"
        self.pairs: List[tuple] = []
        self._open = None

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self) -> None:
        self._open = self._mark()

    def stop(self) -> None:
        self.pairs.append((self._open, self._mark()))
        self._open = None

    def summary(self, skip: int = 0) -> Dict[str, float]:
        """n, p50 and mean in ms over the steps after the first ``skip``
        (synchronizes the device once)."""
        pairs = self.pairs[skip:]
        if self.cuda and pairs:
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in pairs]
        else:
            ms = [(b - a) * 1e3 for a, b in pairs]
        if not ms:
            return {"n": 0, "p50_ms": 0.0, "mean_ms": 0.0}
        return {"n": len(ms), "p50_ms": StepTimer._pct(sorted(ms), 0.5),
                "mean_ms": sum(ms) / len(ms)}
