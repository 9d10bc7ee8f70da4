"""Prometheus text exposition of a ``utils.logging.Metrics`` (the
``prometheus_text`` part of ``replicatinggpt_tpu/utils/telemetry.py``):
what the front door's ``/metrics`` serves. The trace recorder, its
tracks and the metrics timeline are ROADMAP.md queue A item 12.
"""

from __future__ import annotations

import json
import re
from typing import List

#: the fleet's counters a dashboard keys on: ``prometheus_text`` emits
#: each at 0 before its first increment, so that a fresh router scrapes
#: the whole series set (a counter that appears mid-run reads as a
#: restart to ``rate()``). The JAX package's names for the counters this
#: port's router and front door increment.
PROM_PINNED_COUNTERS = (
    "fleet_ledger_recovered", "fleet_requests_submitted",
    "fleet_dedup_rejects", "fleet_replica_downs", "fleet_replicas_added",
    "fleet_requeued_requests", "fleet_drains", "fleet_requests_routed",
    "fleet_route_fallbacks", "fleet_stale_finishes",
    "fleet_ghost_finishes", "fleet_requests_finished",
    "fleet_replica_rejoins", "fleet_replica_wedges", "fleet_replica_kills",
    "fleet_requeue_submits", "fleet_requeue_exhausted",
    "fleet_requeue_retries",
    "http_rate_limited",
)

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str) -> str:
    n = _PROM_BAD.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return f"{prefix}_{n}" if prefix else n


def _prom_value(v) -> str:
    """The shortest string that round-trips the number ('%g' would turn
    a 1,234,567-token counter into 1.23457e+06)."""
    if isinstance(v, bool):
        v = 1 if v else 0
    return json.dumps(v)


def prometheus_text(metrics, prefix: str = "tpu_gpt") -> str:
    """``metrics`` in the Prometheus text format v0.0.4: counters as
    ``counter``, gauges as ``gauge``, histograms as ``summary`` with the
    0.5/0.9/0.99 quantiles and ``_sum``/``_count``/``_min``/``_max``
    from the reservoir."""
    lines: List[str] = []
    counters = dict(metrics.counters)
    for name in PROM_PINNED_COUNTERS:
        counters.setdefault(name, 0)
    for name in sorted(counters):
        pn = _prom_name(name, prefix)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_prom_value(counters[name])}")
    gauges = metrics.gauges
    for name in sorted(gauges):
        pn = _prom_name(name, prefix)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_prom_value(gauges[name])}")
    for name in sorted(metrics.hists):
        pn = _prom_name(name, prefix)
        h = metrics.hist_summary(name)
        lines.append(f"# TYPE {pn} summary")
        for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            lines.append(f'{pn}{{quantile="{q}"}} {_prom_value(h[key])}')
        lines.append(f"{pn}_sum {_prom_value(h['mean'] * h['n'])}")
        lines.append(f"{pn}_count {_prom_value(h['n'])}")
        lines.append(f"{pn}_min {_prom_value(h['min'])}")
        lines.append(f"{pn}_max {_prom_value(h['max'])}")
    return "\n".join(lines) + "\n"
