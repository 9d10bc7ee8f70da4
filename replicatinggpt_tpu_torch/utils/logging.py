"""Step logging and serving metrics (copies of ``StepLogger`` and
``Metrics`` from ``replicatinggpt_tpu/utils/logging.py``; host-side
code).

``StepLogger`` keeps the reference's two line formats, ``Step {i},
Loss: L`` per logged step and ``step {i} : train loss X, val loss = Y``
per eval, and adds a JSONL stream of the same events.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional, TextIO


class StepLogger:
    """``stream`` None means the ``sys.stdout`` of each call, so a caller's
    ``contextlib.redirect_stdout`` takes the lines."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 stream: Optional[TextIO] = None):
        self._stream = stream
        self.jsonl = open(jsonl_path, "a") if jsonl_path else None
        self.t_last = time.perf_counter()

    @property
    def stream(self) -> TextIO:
        return self._stream or sys.stdout

    def log_step(self, step: int, loss: float, tokens: int,
                 n_chips: int = 1, lr: Optional[float] = None) -> None:
        now = time.perf_counter()
        dt = max(now - self.t_last, 1e-9)
        self.t_last = now
        tps = tokens / dt / max(n_chips, 1)
        print(f"Step {step}, Loss: {loss:.6f} | {tps:,.0f} tok/s/chip",
              file=self.stream)
        self._jsonl({"event": "step", "step": step, "loss": float(loss),
                     "tokens_per_sec_per_chip": tps, "lr": lr,
                     "time": time.time()})

    def log_eval(self, step: int, train_loss: float, val_loss: float) -> None:
        print(f"step {step} : train loss {train_loss:.4f}, "
              f"val loss = {val_loss:.4f}", file=self.stream)
        self._jsonl({"event": "eval", "step": step,
                     "train_loss": float(train_loss),
                     "val_loss": float(val_loss), "time": time.time()})

    def log(self, msg: str, **fields) -> None:
        print(msg, file=self.stream)
        if fields:
            self._jsonl({"event": "info", "msg": msg, **fields,
                         "time": time.time()})

    def _jsonl(self, obj: dict) -> None:
        if self.jsonl:
            self.jsonl.write(json.dumps(obj) + "\n")
            self.jsonl.flush()

    def reset_timer(self) -> None:
        self.t_last = time.perf_counter()

    def close(self) -> None:
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None


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
