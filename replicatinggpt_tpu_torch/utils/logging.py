"""Process-local serving metrics (a copy of ``Metrics`` from
``replicatinggpt_tpu/utils/logging.py``; host-side code)."""

from __future__ import annotations

from typing import Dict, List


class Metrics:
    """Process-local serving metrics: monotone counters, point-in-time
    gauges, and bounded-reservoir histograms with percentile summaries.

    The serving engine (serve/engine.py) is the first consumer: request
    counters (admitted/completed/rejected/...), occupancy gauges, and
    TTFT / decode-throughput / batch-fill histograms all land here, and
    ``summary()`` is the dict ``serve-replay`` prints.
    Reservoirs keep the most recent ``reservoir`` observations (a soak
    run must not grow host memory without bound); percentiles use the
    same nearest-rank convention as profiling.StepTimer.
    """

    def __init__(self, reservoir: int = 8192):
        self.reservoir = reservoir
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, List[float]] = {}

    def inc(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self.hists.setdefault(name, [])
        h.append(float(value))
        if len(h) > self.reservoir:
            del h[: len(h) - self.reservoir]

    def percentile(self, name: str, q: float) -> float:
        h = sorted(self.hists.get(name, []))
        if not h:
            return 0.0
        i = min(int(q * (len(h) - 1) + 0.5), len(h) - 1)
        return h[i]

    def hist_summary(self, name: str) -> Dict[str, float]:
        h = self.hists.get(name, [])
        if not h:
            return {"n": 0, "mean": 0.0, "min": 0.0, "p50": 0.0,
                    "p90": 0.0, "p99": 0.0, "max": 0.0}
        return {"n": len(h), "mean": sum(h) / len(h), "min": min(h),
                "p50": self.percentile(name, 0.50),
                "p90": self.percentile(name, 0.90),
                "p99": self.percentile(name, 0.99), "max": max(h)}

    def summary(self) -> dict:
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: self.hist_summary(k) for k in self.hists}}
