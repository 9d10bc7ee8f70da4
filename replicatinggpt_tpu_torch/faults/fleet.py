"""Fleet fault kinds (a copy of ``replicatinggpt_tpu/faults/fleet.py``
without the page-transfer seam): deterministic chaos for the serving
fleet, on the :class:`~.inject.FaultPlan` machinery (explicit step or
session indices, one-shot counting, no-op by default).

- ``fleet/step``, kind ``replica_kill``: the router abandons replica
  ``int(arg)`` at router step ``at``: it stops stepping it, closes its
  journal, and requeues its accepted-but-unfinished requests from that
  journal onto the surviving replicas.
- ``fleet/step``, kind ``replica_wedge``: replica ``int(arg2)``'s next
  ``times`` steps each stall ``arg`` seconds, inside the router's timing
  of that replica's step, so that its wedge probe sees what a wedged
  device looks like.
- ``fleet/session``, kind ``hot_key_skew``: the load generator puts each
  session on prefix group 0 with probability ``arg`` (seeded), which
  turns a uniform mix into hot-key traffic on one radix subtree and one
  affinity target.

- ``fleet/step``, kind ``proc_kill``: the supervisor (faults/procsup.py)
  SIGKILLs worker ``int(arg)``'s process at router step ``at``; recovery
  is a supervised restart and the worker's journal replay (past the
  restart budget, the router's requeue onto the survivors).
- ``fleet/step``, kind ``proc_hang``: SIGSTOP worker ``int(arg2)``'s
  process for ``int(arg)`` supervisor ticks, then SIGCONT. Its RPCs time
  out while it stays alive: the wedge probe and the hedged re-route see
  a wedged card.
- ``fleet/step``, kind ``host_loss``: SIGKILL worker ``int(arg)`` and
  delete its directory, journal included: the restarted worker replays
  nothing, and the router's own ledger recovers the work.

A router without a supervisor (the in-process fleet) logs the three
process kinds and ignores them, as the JAX router does. ``transfer_kill``
needs disaggregation (queue A item 9(e)) and is refused.
"""

from __future__ import annotations

from typing import Optional

from .inject import Fault, fire

#: the router's seam: fired once per Router.step with its step counter
FLEET_STEP = "fleet/step"
#: the load generator's seam: fired once per session with its index
FLEET_SESSION = "fleet/session"

KIND_REPLICA_KILL = "replica_kill"
KIND_REPLICA_WEDGE = "replica_wedge"
KIND_HOT_KEY_SKEW = "hot_key_skew"
KIND_PROC_KILL = "proc_kill"
KIND_PROC_HANG = "proc_hang"
KIND_HOST_LOSS = "host_loss"
KIND_TRANSFER_KILL = "transfer_kill"

#: the kinds the router refuses, with the ROADMAP.md item that brings each
REFUSED_KINDS = {
    KIND_TRANSFER_KILL: "queue A item 9(e) (disaggregation)",
}

def fleet_step_fault(step: int) -> Optional[Fault]:
    """The router's per-step seam: at most one fleet fault a step."""
    return fire(FLEET_STEP, index=step)


def session_skew(session_index: int) -> float:
    """The load generator's per-session seam: the hot-key probability
    for this session (0.0 when no skew fault is planned)."""
    f = fire(FLEET_SESSION, index=session_index)
    if f is not None and f.kind == KIND_HOT_KEY_SKEW:
        return float(f.arg)
    return 0.0
