"""Multi-turn session load generator and fleet replay (the port
of ``replicatinggpt_tpu/serve/loadgen.py``).

Front-door traffic is sessions: a user opens a conversation under one of
a few system prompts, and each turn re-enters the fleet with the whole
history as its prompt, the shape the radix prefix cache and the router's
prefix affinity exist for. This module makes that traffic and drives it
through a :class:`~.router.Router`:

- ``n_prefix_groups`` shared system prefixes; each session draws one and
  opens with it;
- turn ``k``'s prompt is the whole prior context (the previous prompt and
  its generated tokens) plus fresh user tokens, submitted only after turn
  ``k-1`` finished (closed loop a session, Poisson across session
  starts);
- the ``fleet/session`` seam (faults/fleet.py, ``hot_key_skew``) puts
  sessions on group 0 with the planned probability: hot-key traffic;
- the replay reads tokens through the router's delivery ledger
  (``take_new_tokens``) every step, so that a run with replica kills
  checks the exactly-once stream end to end.

Every draw is seeded, and with ``virtual_dt`` set the replay runs on a
virtual clock (arrivals and deadlines in virtual seconds, one tick a
router step), so that a chaos run's admission order does not move with
the host's load. Wall-clock mode is ``virtual_dt=0``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..config import ModelConfig
from ..faults.fleet import session_skew
from .engine import EngineConfig
from .requests import Request, RequestResult, SamplingParams
from .router import Router, RouterConfig


@dataclass(frozen=True)
class SessionLoadConfig:
    """Session-traffic shape. Sizing must fit the model's block_size:
    ``prefix_len + turns * (user_len_max + max_new_tokens)`` is the
    worst-case final context (validated in :func:`make_sessions`)."""

    n_sessions: int = 8
    turns: int = 3
    n_prefix_groups: int = 2
    prefix_len: int = 12
    user_len_min: int = 2
    user_len_max: int = 4
    max_new_tokens: int = 6
    rate: float = 100.0            # session-start arrivals/sec (Poisson)
    think_time_s: float = 0.0      # finish -> next-turn gap
    greedy: bool = True
    seed: int = 0
    #: the autoscaler's trace: session arrivals in thirds, the first at
    #: ``rate``, the second at 2x (a sustained backlog: scale up), the
    #: last at half (a sustained lull: scale down); the same seeded draws
    load_step: bool = False


@dataclass
class _Session:
    sid: int
    group: int
    context: np.ndarray            # tokens so far (prompt + generated)
    user_turns: List[np.ndarray]   # pre-drawn user tokens per turn
    next_turn: int = 0
    due_t: float = 0.0             # when the next turn submits
    waiting_on: Optional[str] = None


@dataclass(frozen=True)
class AdmissionStormConfig:
    """The admission-heavy saturating trace: arrivals outpace the pool,
    so that nearly every window boundary has an admissible head, prompts
    are short (admission cost dominates decode), and a slice of the
    traffic carries tight deadlines or mid-stream cancels."""

    n_requests: int = 96
    rate: float = 50_000.0         # arrivals/sec — saturating by design
    prompt_len_min: int = 2
    prompt_len_max: int = 8
    max_new_min: int = 6
    max_new_max: int = 14
    deadline_frac: float = 0.2     # fraction with a tight deadline
    deadline_s: float = 0.05       # relative deadline for that slice
    cancel_frac: float = 0.15      # fraction cancelled mid-flight
    cancel_after_s: float = 0.02   # cancel issued this long after arrival
    greedy: bool = True
    seed: int = 0


def admission_storm(mcfg: ModelConfig, scfg: AdmissionStormConfig
                    ) -> tuple:
    """Build the storm: returns ``(trace, cancels, deadlines)`` —
    ``trace`` is the (arrival_time, request) list ``run_replay`` takes,
    ``cancels`` a time-sorted [(t, request_id), ...] schedule the replay
    issues through ``engine.cancel``, and ``deadlines`` a
    {request_id: relative_deadline_s} map applied at submit. All draws
    seeded; the deadline/cancel slices are disjoint (a cancelled
    request's terminal reason must be unambiguous in the artifact)."""
    rng = np.random.default_rng(scfg.seed)
    hi = min(scfg.prompt_len_max, mcfg.block_size)
    lo = min(scfg.prompt_len_min, hi)
    sp = SamplingParams(greedy=scfg.greedy)
    n = scfg.n_requests
    # every scalar draw vectorized up front, converted once
    gaps = rng.exponential(1.0 / max(scfg.rate, 1e-9), n)
    arrivals = np.cumsum(gaps).tolist()
    lens = rng.integers(lo, hi + 1, n).tolist()
    budgets = rng.integers(scfg.max_new_min, scfg.max_new_max + 1,
                           n).tolist()
    lanes = rng.random(n).tolist() # [0, deadline_frac) -> deadline,
                                   # [deadline_frac, +cancel_frac) -> cancel
    trace, cancels, deadlines = [], [], {}
    for i in range(n):
        rid = f"storm{i:04d}"
        prompt = rng.integers(0, mcfg.vocab_size, (lens[i],),
                              dtype=np.int64).astype(np.int32)
        trace.append((arrivals[i], Request(
            id=rid, prompt=prompt, max_new_tokens=budgets[i],
            sampling=sp, rng_seed=scfg.seed * 100_003 + i)))
        if lanes[i] < scfg.deadline_frac:
            deadlines[rid] = scfg.deadline_s
        elif lanes[i] < scfg.deadline_frac + scfg.cancel_frac:
            cancels.append((arrivals[i] + scfg.cancel_after_s, rid))
    cancels.sort()
    return trace, cancels, deadlines


class StepClock:
    """Injectable virtual clock for deterministic fleet replays: the
    replay advances it one ``dt`` per router step, so arrival order,
    TTFT buckets and deadline math are identical run to run."""

    def __init__(self, t0: float = 0.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def make_sessions(mcfg: ModelConfig, lcfg: SessionLoadConfig
                  ) -> List[_Session]:
    """Seeded session population: group prefixes, per-session start
    times (Poisson), per-turn user token draws (the JAX package's draws
    from the same seed). The ``hot_key_skew`` seam is consulted per
    session: with a plan installed, a session joins group 0 with the
    planned probability."""
    worst = (lcfg.prefix_len
             + lcfg.turns * (lcfg.user_len_max + lcfg.max_new_tokens))
    assert worst <= mcfg.block_size, (
        f"session worst-case context {worst} exceeds block_size "
        f"{mcfg.block_size}: shrink turns/user_len/max_new_tokens")
    rng = np.random.default_rng(lcfg.seed)
    prefixes = [rng.integers(0, mcfg.vocab_size, (lcfg.prefix_len,),
                             dtype=np.int64).astype(np.int32)
                for _ in range(lcfg.n_prefix_groups)]
    # every scalar draw vectorized up front
    gaps = rng.exponential(1.0 / max(lcfg.rate, 1e-9), lcfg.n_sessions)
    if lcfg.load_step:
        # base -> 2x -> 0.5x the arrival rate by thirds: a gap at k times
        # the rate is the base gap over k
        third = max(lcfg.n_sessions // 3, 1)
        gaps[third:2 * third] /= 2.0
        gaps[2 * third:] *= 2.0
    starts = np.cumsum(gaps)
    groups = rng.integers(0, lcfg.n_prefix_groups, lcfg.n_sessions)
    skew_draws = rng.random(lcfg.n_sessions)
    out: List[_Session] = []
    for sid in range(lcfg.n_sessions):
        group = int(groups[sid])
        skew = session_skew(sid)
        if skew > 0 and skew_draws[sid] < skew:
            group = 0              # the hot key
        turns = []
        for _ in range(lcfg.turns):
            n = int(rng.integers(lcfg.user_len_min,
                                 lcfg.user_len_max + 1))
            turns.append(rng.integers(0, mcfg.vocab_size, (n,),
                                      dtype=np.int64).astype(np.int32))
        out.append(_Session(sid=sid, group=group,
                            context=prefixes[group].copy(),
                            user_turns=turns, due_t=starts[sid]))
    return out


def session_request(s: _Session, lcfg: SessionLoadConfig) -> Request:
    """Build turn ``s.next_turn``'s request: full context + this turn's
    user tokens, with a per-(session, turn) rng seed so regeneration
    after a requeue is exact."""
    prompt = np.concatenate([s.context, s.user_turns[s.next_turn]])
    return Request(
        id=f"s{s.sid:03d}t{s.next_turn}", prompt=prompt,
        max_new_tokens=lcfg.max_new_tokens,
        sampling=SamplingParams(greedy=lcfg.greedy),
        rng_seed=lcfg.seed * 1_000_003 + s.sid * 101 + s.next_turn)


def run_fleet_replay(model, mcfg: ModelConfig, lcfg: SessionLoadConfig,
                     rcfg: RouterConfig = RouterConfig(),
                     ecfg: EngineConfig = EngineConfig(),
                     warmup: bool = True, virtual_dt: float = 0.0,
                     collect_streams: bool = False,
                     max_steps: int = 1_000_000, device=None) -> dict:
    """Drive the session workload through a fleet; returns the fleet
    summary (per-replica blocks, requeue counters, fleet TTFT, aggregate
    prefix-hit rate) and the sessions' completion counts.

    ``warmup`` warms every replica first (``Router.warmup``; on the card
    it builds the kernels). ``virtual_dt > 0`` runs the replay on a
    :class:`StepClock`; 0 in wall-clock time. ``collect_streams`` returns
    every request's delivered token stream under ``"streams"`` and its
    result under ``"results"``."""
    clock = StepClock() if virtual_dt > 0 else time.monotonic
    router = Router(model, mcfg, rcfg, ecfg, clock=clock, device=device)
    sessions = make_sessions(mcfg, lcfg)
    streams: Dict[str, List[int]] = {}
    inflight_ids: List[str] = []
    results: Dict[str, RequestResult] = {}
    turns_done = 0
    try:
        if warmup:
            router.warmup()
        t0 = clock()
        steps = 0
        while True:
            # the runaway guard counts every iteration, idle ones too: a
            # stall where the router is idle but sessions wait must raise
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"fleet replay did not finish in {max_steps} steps")
            now = clock()
            for s in sessions:
                if (s.waiting_on is None and s.next_turn < lcfg.turns
                        and s.due_t <= now - t0):
                    req = session_request(s, lcfg)
                    s.waiting_on = req.id
                    streams.setdefault(req.id, [])
                    rej = router.submit(req)
                    if rej is not None:
                        results[req.id] = rej
                        s.waiting_on = None
                        s.next_turn = lcfg.turns    # session abandoned
                    else:
                        inflight_ids.append(req.id)
            if router.idle:
                if not any(s.next_turn < lcfg.turns for s in sessions):
                    break
                # nothing in flight: run the clock to the next arrival
                if virtual_dt > 0:
                    clock.advance(virtual_dt)
                else:
                    nxt = min((s.due_t for s in sessions
                               if s.waiting_on is None
                               and s.next_turn < lcfg.turns),
                              default=now - t0)
                    time.sleep(min(max(nxt - (now - t0), 0.0), 0.05))
                continue
            finished = router.step()
            # deliver: the one consumption path (the exactly-once ledger)
            inflight_ids = [rid for rid in inflight_ids
                            if rid not in results]
            for rid in inflight_ids:
                streams[rid].extend(router.take_new_tokens(rid))
            for res in finished:
                results[res.id] = res
                streams[res.id].extend(router.take_new_tokens(res.id))
                turns_done += 1
                for s in sessions:
                    if s.waiting_on == res.id:
                        s.waiting_on = None
                        if res.ok:
                            # the next turn re-enters with the whole
                            # history: prompt and generated tokens
                            prev = np.concatenate(
                                [s.context, s.user_turns[s.next_turn]])
                            s.context = np.concatenate(
                                [prev, np.fromiter(res.tokens, np.int32,
                                                   count=len(res.tokens))])
                            s.next_turn += 1
                            s.due_t = (clock() - t0) + lcfg.think_time_s
                        else:
                            # cancelled, shed, expired or rejected: no
                            # coherent history to continue, the session
                            # ends here
                            s.next_turn = lcfg.turns
                        break
            if virtual_dt > 0:
                clock.advance(virtual_dt)
        wall_s = clock() - t0
    finally:
        router.close()
    summary = router.fleet_summary()
    ok = [r for r in results.values() if r.ok]
    summary.update({
        "n_sessions": lcfg.n_sessions,
        "turns_per_session": lcfg.turns,
        "n_requests": len(results),
        "turns_finished": turns_done,
        "n_completed": len(ok),
        "n_rejected": sum(r.finish_reason.startswith("rejected")
                          for r in results.values()),
        "generated_tokens": sum(len(r.tokens) for r in results.values()),
        "wall_s": round(wall_s, 3),
    })
    if collect_streams:
        summary["streams"] = streams
        summary["results"] = results
    return summary
