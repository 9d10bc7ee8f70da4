"""Deterministic fault injection behind no-op-by-default seams (a copy of
the training, checkpoint, serving and in-process fleet part of
``replicatinggpt_tpu/faults/inject.py``).

A :class:`FaultPlan` says which fault fires at which site and index; the
seams in ``train/runner.py`` and ``train/checkpoint.py`` ask it, through
:func:`fire`, whether to misbehave. With no plan installed a seam is one
module attribute read. A fault fires on an explicit index (the step) or
the seam's call count, at most ``times`` times over the plan's life, so
a rolled-back run that replays the faulted step does not trip a one-shot
fault again. Injected faults are the real thing: the corruptor flips
bytes in the files the checkpoint wrote, the I/O fault raises a plain
``OSError``, the SIGTERM fault raises the signal through the installed
handler.

========================  ==============  ===============================
site                      kind            effect at the seam
========================  ==============  ===============================
``ckpt/save``             ``io``          ``OSError`` before the write
``ckpt/restore``          ``io``          ``OSError`` before the read
``ckpt/finalize``         ``corrupt``     flip bytes in the step's
                                          largest file
``ckpt/finalize``         ``truncate``    cut that file to half
``ckpt/finalize``         ``drop_manifest``  delete the integrity
                                          manifest
``train/step``            ``sigterm``     raise SIGTERM
``train/step``            ``nan_params``  scale one parameter by NaN
``train/loss``            ``nan``         the observed loss becomes NaN
``train/loss``            ``spike``       the observed loss times ``arg``
``serve/step``            ``delay``       sleep ``arg`` seconds in the
                                          engine step (the watchdog's
                                          stall)
``spec/draft``            ``collapse``    shift every drafted token by
                                          one, mod the vocabulary (the
                                          accept rate collapses)
``fleet/step``            ``replica_kill`` the router abandons replica
                                          ``arg`` (faults/fleet.py)
``fleet/step``            ``replica_wedge`` replica ``arg2``'s step
                                          stalls ``arg`` seconds
``fleet/session``         ``hot_key_skew`` a session joins prefix group
                                          0 with probability ``arg``
``fleet/step``            ``proc_kill``   SIGKILL worker ``arg``
                                          (faults/procsup.py)
``fleet/step``            ``proc_hang``   SIGSTOP worker ``arg2`` for
                                          ``arg`` ticks
``fleet/step``            ``host_loss``   SIGKILL worker ``arg`` and
                                          delete its directory
``net/{src}->{dst}/{op}`` ``net_*``       a message fault on the fleet's
                                          RPC (faults/netchaos.py:
                                          delay, drop, dup, reorder,
                                          trickle, corrupt, partition)
========================  ==============  ===============================
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Fault:
    """One planned fault: fires when its ``site`` is hit with an index in
    ``[at, at + times)`` (the seam's explicit index, else its call count)
    and it has fired fewer than ``times`` times."""

    site: str
    kind: str
    at: int = 0
    times: int = 1
    arg: float = 0.0
    arg2: float = 0.0      # second payload (fleet faults: replica index)


class FaultPlan:
    """Installed faults with per-site call counters, per-fault fire counts
    and the ``fired`` log of (site, kind, index)."""

    def __init__(self, *faults: Fault, seed: int = 0):
        self.faults: Tuple[Fault, ...] = faults
        self.seed = seed
        self._counts: Dict[str, int] = {}
        self._fired_counts: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, str, int]] = []

    def fire(self, site: str, index: Optional[int] = None) -> Optional[Fault]:
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            idx = n if index is None else index
            for i, f in enumerate(self.faults):
                if f.site != site or not (f.at <= idx < f.at + f.times):
                    continue
                if self._fired_counts.get(i, 0) >= f.times:
                    continue
                self._fired_counts[i] = self._fired_counts.get(i, 0) + 1
                self.fired.append((site, f.kind, idx))
                return f
            return None

    def rng(self, site: str) -> np.random.Generator:
        """Seeded payload generator, stable per (plan seed, site)."""
        return np.random.default_rng([self.seed, sum(site.encode())])

    def count(self, site: str, kind: Optional[str] = None) -> int:
        return sum(1 for s, k, _ in self.fired
                   if s == site and (kind is None or k == kind))


_PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    _PLAN = plan
    return plan


def clear() -> None:
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


@contextlib.contextmanager
def installed(plan: FaultPlan):
    """``with installed(FaultPlan(...)) as plan:``, cleared on exit."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


def fire(site: str, index: Optional[int] = None) -> Optional[Fault]:
    """The seam: None (with no plan, always) or the fault to apply."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.fire(site, index)


def corrupt_step_dir(directory: str, step: int, kind: str,
                     rng: np.random.Generator) -> str:
    """Corrupt a finalized step ``<directory>/<step>/`` on disk:
    ``corrupt`` flips 8 bytes at seeded offsets of its largest file (only
    a checksum sees that); ``truncate`` cuts the file to half (a crash
    mid-write). Returns the path touched; raises FileNotFoundError when
    the step holds no file."""
    step_dir = os.path.join(directory, str(step))
    candidates = []
    for root, _, files in os.walk(step_dir):
        for name in files:
            p = os.path.join(root, name)
            sz = os.path.getsize(p)
            if sz > 0:
                candidates.append((sz, p))
    if not candidates:
        raise FileNotFoundError(f"no files under {step_dir} to corrupt")
    _, target = max(candidates)
    size = os.path.getsize(target)
    if kind == "truncate":
        with open(target, "r+b") as f:
            f.truncate(max(size // 2, 1))
    else:
        offsets = rng.integers(0, size, size=min(8, size))
        with open(target, "r+b") as f:
            for off in offsets:
                f.seek(int(off))
                b = f.read(1)
                f.seek(int(off))
                f.write(bytes([b[0] ^ 0xFF]))
    return target


def apply_train_state_fault(fault: Fault, state):
    """Apply a ``train/step`` fault to the live ``TrainState`` between
    steps: ``sigterm`` raises the real signal (the CLI's handler turns it
    into a checkpoint and a clean exit); ``nan_params`` scales the first
    parameter (``wte``) by NaN in place, so the next loss is non-finite."""
    if fault.kind == "sigterm":
        import signal
        signal.raise_signal(signal.SIGTERM)
        return state
    if fault.kind == "nan_params":
        with torch.no_grad():
            state.model.wte.mul_(float("nan"))
        return state
    raise ValueError(f"unknown train/step fault kind {fault.kind!r}")


def apply_loss_fault(fault: Fault, loss: float) -> float:
    """Apply a ``train/loss`` fault to the observed (host) loss."""
    if fault.kind == "nan":
        return float("nan")
    if fault.kind == "spike":
        return loss * (fault.arg or 100.0)
    raise ValueError(f"unknown train/loss fault kind {fault.kind!r}")
