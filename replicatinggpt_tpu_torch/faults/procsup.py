"""Process supervisor: registration over RPC, restarts with backoff,
quarantine, rolling restarts, autoscaling, and real process and host
chaos for the fleet's worker processes (the port of
``replicatinggpt_tpu/faults/procsup.py``).

The router (serve/router.py) decides what happens to requests; this
module decides what happens to processes:

- **Registration over RPC**: the supervisor polls an
  :class:`~..serve.rpc.RpcListener`; every worker it spawns gets
  ``--router-addr`` and, once warm, replayed and bound, sends one
  ``register`` frame. The frame carries the protocol version and the
  engine shape hash; a mismatched build is refused with a typed
  :class:`~..serve.rpc.RpcProtocolError` (the worker exits 3). The
  fleet's shape is ``SupervisorConfig.expect_shape_hash``, else the first
  registration's. A worker registering with ``worker_idx=-1`` joins as a
  new, unmanaged replica.
- **Death detection**: ``Popen.poll`` every tick, and ``health`` probes
  with short timeouts: two failed probes in a row, or a replica the
  router declared down while its process lingers, escalate to SIGKILL.
- **Restart on exit**: the router marks the replica down (its in-flight
  entries wait: the restarted worker replays its journal), and the
  worker respawns after ``backoff_s * backoff_mult^n`` with a fresh
  generation; only the registration of that generation attaches it.
- **Restart budget, then quarantine**: past ``restart_budget`` crash
  restarts (intentional stops are free), ``Router.abandon_replica``
  requeues the worker's in-flight work onto the survivors from the
  router's own ledger, and the replica leaves rotation for good.
- **Rolling restart**: worker by worker, drain (the router migrates its
  in-flight requests), stop (``shutdown`` RPC, SIGTERM fallback),
  respawn, wait for the next generation's attach. A fleet of two or more
  drops nothing, and ``/readyz`` stays 200 while a survivor serves.
- **Autoscaling** (:class:`AutoscaleConfig` and a ``spec_factory``): from
  ``Router.offered_load`` every tick, a sustained backlog spawns a worker
  and a sustained lull retires the highest-index one through the rolling
  restart's drain (``RETIRED``, not respawned), ``cooldown_ticks`` apart,
  within ``[min_workers, max_workers]``.
- **Chaos**: ``proc_kill`` (a real SIGKILL), ``proc_hang`` (SIGSTOP for N
  ticks, then SIGCONT) and ``host_loss`` (SIGKILL and the deletion of the
  worker's whole directory, journal included: the respawned worker
  replays nothing, and the router's ledger is the only recovery), from
  the ``fleet/step`` seam (faults/fleet.py) through ``Router.step``.

Everything is ticked from the loop that steps the router (the front
door's stepping task, the fleet replay): one :meth:`ProcSupervisor.tick`
after each ``router.step()`` and on idle turns. No threads; deaths are
observed, never raced; the listener is polled, never awaited.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, List, Optional

#: handle states
RUNNING = "running"
BACKOFF = "backoff"
SPAWNING = "spawning"       # launched, registration not seen yet
QUARANTINED = "quarantined"
STOPPED = "stopped"
RETIRED = "retired"         # scaled down: exited, not respawned


@dataclass(frozen=True)
class SupervisorConfig:
    """The restart policy's knobs."""

    #: crash restarts a worker before quarantine (intentional stops are
    #: free)
    restart_budget: int = 3
    backoff_s: float = 0.5
    backoff_mult: float = 2.0
    #: a spawned worker must register within this budget (imports, model
    #: build, kernel builds and warm-up) or the spawn counts as a crash
    ready_timeout_s: float = 180.0
    #: a health probe's budget; two failures in a row escalate to SIGKILL
    probe_timeout_s: float = 2.0
    #: probe every N ticks (0: off; the router's own RPC failures still
    #: catch deaths)
    probe_every: int = 8
    #: the engine shape hash workers must register with; None: the first
    #: registration's
    expect_shape_hash: Optional[str] = None


@dataclass(frozen=True)
class AutoscaleConfig:
    """Elastic fleet sizing from the router's gauges, in ticks (one tick a
    router step)."""

    min_workers: int = 1
    max_workers: int = 4
    #: queued work a routable worker that counts as backlog
    up_backlog_per_worker: float = 2.0
    up_patience: int = 4
    #: scale down only with empty queues and active slots the smaller
    #: fleet holds at this occupancy a worker
    down_active_per_worker: float = 1.0
    down_patience: int = 32
    #: least ticks between scale actions
    cooldown_ticks: int = 32


@dataclass
class WorkerSpec:
    """How to (re)launch one worker: ``cmd`` without the per-spawn
    ``--gen``, ``--worker-idx`` and ``--router-addr``. ``workdir`` is the
    worker's private directory (journal and log): nothing else reads it,
    and ``host_loss`` deletes it."""

    idx: int
    cmd: List[str]
    journal_path: str
    workdir: Optional[str] = None
    log_path: Optional[str] = None
    env: Optional[dict] = None


@dataclass
class WorkerHandle:
    spec: WorkerSpec
    proc: Optional[subprocess.Popen] = None
    state: str = STOPPED
    gen: int = -1
    pid: Optional[int] = None
    restarts: int = 0          # every respawn (rolling ones too)
    crash_restarts: int = 0    # the budget's
    backoff_until: float = 0.0
    spawn_t: float = 0.0
    hang_ticks: int = 0        # proc_hang: SIGCONT when it reaches 0
    probe_failures: int = 0
    intentional_stop: bool = False
    retiring: bool = False     # scale-down in progress: exit -> RETIRED
    #: seconds from each spawn to its registration
    ready_s: List[float] = field(default_factory=list)
    events: List[str] = field(default_factory=list)


class ProcSupervisor:
    """Owns the worker processes of one fleet. Tick it from the router's
    loop; it drives the router through ``mark_down``, ``attach_replica``,
    ``abandon_replica``, ``add_replica`` and ``offered_load``."""

    def __init__(self, specs: List[WorkerSpec],
                 cfg: SupervisorConfig = SupervisorConfig(),
                 autoscale: Optional[AutoscaleConfig] = None,
                 spec_factory: Optional[Callable[[int], WorkerSpec]] = None,
                 listen_host: str = "127.0.0.1"):
        from ..serve.rpc import RpcListener
        self.cfg = cfg
        self.autoscale = autoscale
        self.spec_factory = spec_factory
        self.handles = [WorkerHandle(spec=s) for s in specs]
        self.router = None
        self.ticks = 0
        self._rolling: List[int] = []
        self._rolling_phase = ""
        self._rolling_target_gen = -1
        self.events: List[str] = []
        self.listener = RpcListener(host=listen_host)
        self.expect_shape_hash = cfg.expect_shape_hash
        #: replica indices of unmanaged workers that registered from
        #: outside (their host owns their lifecycle)
        self.external: List[int] = []
        self.scale_ups = 0
        self.scale_downs = 0
        #: most workers provisioned at once
        self.peak_workers = len(specs)
        self._up_streak = 0
        self._down_streak = 0
        self._last_scale_tick = 0
        #: registration reply cache by the worker's idem key: a retried
        #: register frame gets the original attach's reply instead of a
        #: second reconciliation
        self._reg_replies: "OrderedDict[str, dict]" = OrderedDict()

    def attach_router(self, router) -> None:
        self.router = router
        router.supervisor = self

    @property
    def router_addr(self) -> str:
        """host:port workers register with (their ``--router-addr``)."""
        return self.listener.addr

    @property
    def reviving(self) -> bool:
        """Whether a worker is on its way back (spawning, backing off, or
        stopped for a rolling restart): the router's requeue ladder holds
        its retries meanwhile. A retiring worker leaves on purpose."""
        return any(h.state in (SPAWNING, BACKOFF)
                   or (h.intentional_stop and not h.retiring)
                   for h in self.handles)

    def _handle(self, idx: int) -> Optional[WorkerHandle]:
        """The handle of worker index (= router replica index) ``idx``."""
        for h in self.handles:
            if h.spec.idx == idx:
                return h
        return None

    def pids(self) -> List[int]:
        """The pids of the worker processes this supervisor launched that
        have not been reaped."""
        return [h.proc.pid for h in self.handles
                if h.proc is not None and h.proc.poll() is None]

    # ------------------------------------------------------------- spawn

    def _event(self, msg: str) -> None:
        self.events.append(msg)
        if len(self.events) > 256:
            del self.events[:len(self.events) - 256]
        if self.router is not None:
            self.router._event(f"supervisor: {msg}")

    def _spawn(self, h: WorkerHandle) -> None:
        h.gen += 1
        h.restarts += int(h.gen > 0)
        if h.spec.workdir:
            # a respawn after host_loss is the replacement host with an
            # empty disk
            os.makedirs(h.spec.workdir, exist_ok=True)
        out = subprocess.DEVNULL
        if h.spec.log_path:
            os.makedirs(os.path.dirname(h.spec.log_path) or ".",
                        exist_ok=True)
            out = open(h.spec.log_path, "a")
        env = {**os.environ, **(h.spec.env or {})}
        h.proc = subprocess.Popen(
            h.spec.cmd + ["--gen", str(h.gen),
                          "--worker-idx", str(h.spec.idx),
                          "--router-addr", self.router_addr],
            stdout=out, stderr=out, env=env)
        if out is not subprocess.DEVNULL:
            out.close()         # Popen holds its own descriptor
        h.pid = h.proc.pid
        h.state = SPAWNING
        h.spawn_t = time.monotonic()
        h.probe_failures = 0
        self._event(f"worker {h.spec.idx} spawned (pid {h.pid}, gen "
                    f"{h.gen})")

    # ------------------------------------------------------ registration

    def _handle_register(self, doc: dict, peer_host: str) -> dict:
        """The listener's handler: check the handshake and attach the
        router. A register frame is idempotent by its ``idem`` key;
        refusals are not cached (a retried bad handshake is checked
        again)."""
        idem = doc.get("idem")
        if idem is not None and idem in self._reg_replies:
            return {**self._reg_replies[idem], "idem_hit": True}
        resp = self._register_attach(doc, peer_host)
        if idem is not None:
            self._reg_replies[idem] = resp
            while len(self._reg_replies) > 64:
                self._reg_replies.popitem(last=False)
        return resp

    def _register_attach(self, doc: dict, peer_host: str) -> dict:
        from ..serve.rpc import DISAGG_ITEM, PROTO_VERSION, RpcProtocolError
        router = self.router
        assert router is not None, "attach_router first"
        proto = int(doc.get("proto", -1))
        if proto != PROTO_VERSION:
            raise RpcProtocolError(
                f"worker speaks protocol v{proto}, router v{PROTO_VERSION} "
                f"— rebuild the worker")
        shape = str(doc.get("shape_hash", ""))
        if self.expect_shape_hash is None:
            self.expect_shape_hash = shape
        elif shape != self.expect_shape_hash:
            raise RpcProtocolError(
                f"worker engine shape {shape} != fleet "
                f"{self.expect_shape_hash} — a different model or engine "
                f"build cannot join this fleet")
        tier = str(doc.get("tier", "mixed"))
        if tier != "mixed":
            raise RpcProtocolError(
                f"a {tier!r} tier worker is not implemented in "
                f"replicatinggpt_tpu_torch yet: ROADMAP.md {DISAGG_ITEM}")
        idx = int(doc.get("worker_idx", -1))
        gen = int(doc.get("gen", 0))
        port = int(doc["port"])
        pid = int(doc.get("pid", 0))
        h = self._handle(idx) if idx >= 0 else None
        if h is not None:
            if gen != h.gen:
                # a pre-restart straggler: the supervisor launched another
                raise ValueError(f"stale generation {gen} (current "
                                 f"{h.gen})")
            info = router.attach_replica(idx, port, pid=pid, gen=gen,
                                         host=peer_host)
            router.replicas[idx].restarts = h.restarts
            if h.state == SPAWNING:
                h.ready_s.append(time.monotonic() - h.spawn_t)
            h.state = RUNNING
            h.pid = pid
            h.probe_failures = 0
            self._event(f"worker {idx} registered+attached (gen {gen}, "
                        f"host {peer_host}, kept {info['kept']}, requeued "
                        f"{info['requeued']}, ghosts {info['ghosts']})")
            return {"idx": idx, **info}
        # an unmanaged worker joining from anywhere grows the fleet; the
        # router's RPC failures still mark it down if it vanishes
        from ..serve.router import RemoteReplica
        new_idx = len(router.replicas)
        router.add_replica(RemoteReplica(
            new_idx, host=peer_host,
            rpc_timeout_s=router.rcfg.step_timeout_s,
            step_timeout_s=router.rcfg.step_timeout_s))
        info = router.attach_replica(new_idx, port, pid=pid, gen=gen,
                                     host=peer_host)
        self.external.append(new_idx)
        self._event(f"external worker joined as replica {new_idx} (host "
                    f"{peer_host}, pid {pid})")
        return {"idx": new_idx, **info}

    def _poll_registrations(self) -> int:
        return self.listener.poll(self._handle_register)

    def start_all(self, wait: bool = True,
                  timeout_s: Optional[float] = None) -> None:
        """Spawn every worker and, with ``wait``, block until each one
        registered. A failed or interrupted start stops every spawned
        worker before it raises (an orphan would hold its journal's lock
        and crash-loop the next run's replacement)."""
        for h in self.handles:
            self._spawn(h)
        if not wait:
            return
        budget = timeout_s or self.cfg.ready_timeout_s
        deadline = time.monotonic() + budget
        try:
            while time.monotonic() < deadline:
                self._poll_registrations()
                for h in self.handles:
                    if h.state == SPAWNING:
                        self._check_spawn(h)
                    elif (h.state == BACKOFF
                          and time.monotonic() >= h.backoff_until):
                        self._spawn(h)
                if all(h.state == RUNNING for h in self.handles):
                    return
                if any(h.state == QUARANTINED for h in self.handles):
                    break          # crash-looped out of its budget
                time.sleep(0.05)
        except BaseException:      # Ctrl-C mid-warm-up included
            self.stop_all()
            raise
        bad = [h.spec.idx for h in self.handles if h.state != RUNNING]
        logs = [self._handle(i).spec.log_path for i in bad]
        self.stop_all()
        raise RuntimeError(f"workers {bad} not ready within {budget}s (see "
                           f"{logs})")

    def stop_all(self, timeout_s: float = 15.0) -> None:
        """Stop every worker: SIGCONT first to a stopped one (it cannot
        handle SIGTERM), SIGTERM, then SIGKILL past ``timeout_s``; every
        process is reaped, and the listener closed."""
        for h in self.handles:
            h.intentional_stop = True
            h.retiring = False
            h.state = STOPPED
            if h.proc is not None and h.proc.poll() is None:
                self._signal(h, signal.SIGCONT)
                h.hang_ticks = 0
                self._signal(h, signal.SIGTERM)
        deadline = time.monotonic() + timeout_s
        for h in self.handles:
            if h.proc is None:
                continue
            while h.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if h.proc.poll() is None:
                self._signal(h, signal.SIGKILL)
                h.proc.wait()
        self.listener.close()

    @staticmethod
    def _signal(h: WorkerHandle, sig) -> None:
        try:
            os.kill(h.proc.pid, sig)
        except (OSError, AttributeError):
            pass

    # -------------------------------------------------------------- tick

    def tick(self) -> None:
        """One supervision pass: serve pending registrations, end chaos
        hangs, observe deaths, advance backoffs and spawns, probe health,
        advance a rolling restart, and make the autoscale decision."""
        router = self.router
        assert router is not None, "attach_router first"
        self.ticks += 1
        self._poll_registrations()
        for h in self.handles:
            if h.hang_ticks > 0:
                h.hang_ticks -= 1
                if h.hang_ticks == 0:
                    self._signal(h, signal.SIGCONT)
                    self._event(f"worker {h.spec.idx} SIGCONT (hang over)")
            if h.state == RUNNING:
                if h.proc is not None and h.proc.poll() is not None:
                    self._on_exit(h, h.proc.returncode)
                    continue
                self._maybe_probe(h)
                # the router declared it down but the process lingers: a
                # zombie, killed so that the exit path owns recovery
                if (not router.replicas[h.spec.idx].alive
                        and h.hang_ticks == 0):
                    self._event(f"worker {h.spec.idx} unreachable but "
                                f"process alive — escalating SIGKILL")
                    self._signal(h, signal.SIGKILL)
            elif h.state == BACKOFF:
                if time.monotonic() >= h.backoff_until:
                    self._spawn(h)
            elif h.state == SPAWNING:
                self._check_spawn(h)
        self._tick_rolling()
        self._tick_autoscale()

    def _on_exit(self, h: WorkerHandle, rc) -> None:
        router = self.router
        router.mark_down(h.spec.idx, f"process exited rc={rc}")
        if h.intentional_stop:
            h.intentional_stop = False
            if h.retiring:
                h.retiring = False
                h.state = RETIRED
                self._event(f"worker {h.spec.idx} retired (scale-down "
                            f"complete)")
                return
            self._event(f"worker {h.spec.idx} stopped (intentional); "
                        f"respawning")
            self._spawn(h)
            return
        h.crash_restarts += 1
        if h.crash_restarts > self.cfg.restart_budget:
            h.state = QUARANTINED
            self._event(f"worker {h.spec.idx} exceeded restart budget "
                        f"({self.cfg.restart_budget}); quarantined — "
                        f"requeueing its in-flight work onto survivors")
            router.abandon_replica(h.spec.idx)
            return
        delay = (self.cfg.backoff_s
                 * self.cfg.backoff_mult ** (h.crash_restarts - 1))
        h.state = BACKOFF
        h.backoff_until = time.monotonic() + delay
        self._event(f"worker {h.spec.idx} died rc={rc}; restart "
                    f"{h.crash_restarts}/{self.cfg.restart_budget} in "
                    f"{delay:.2f}s")

    def _check_spawn(self, h: WorkerHandle) -> None:
        """A spawning worker registers (the handler makes it RUNNING),
        dies (the crash path), or misses the ready budget (SIGKILL)."""
        if h.proc is not None and h.proc.poll() is not None:
            h.state = RUNNING       # through the common exit path
            self._on_exit(h, h.proc.returncode)
            return
        if time.monotonic() - h.spawn_t > self.cfg.ready_timeout_s:
            self._event(f"worker {h.spec.idx} missed ready deadline; "
                        f"killing")
            self._signal(h, signal.SIGKILL)

    def _maybe_probe(self, h: WorkerHandle) -> None:
        if (self.cfg.probe_every <= 0
                or self.ticks % self.cfg.probe_every
                or h.hang_ticks > 0):   # a chaos-hung worker is meant
            return                      # to be unresponsive
        rep = self.router.replicas[h.spec.idx]
        try:
            rep.client.call("health", timeout_s=self.cfg.probe_timeout_s)
            h.probe_failures = 0
        except Exception:  # noqa: BLE001 — a timeout, a refusal, garbage:
            # the probe only counts; the escalation decides
            h.probe_failures += 1
            if h.probe_failures >= 2:
                self._event(f"worker {h.spec.idx} failed "
                            f"{h.probe_failures} health probes; "
                            f"escalating SIGKILL")
                self._signal(h, signal.SIGKILL)

    # --------------------------------------------------------- autoscale

    def _tick_autoscale(self) -> None:
        """One elasticity decision a tick, from the router's offered-load
        gauges, acted on at patience through the restarts' paths."""
        a = self.autoscale
        if a is None or self.spec_factory is None or self._rolling:
            return
        provisioned = [h for h in self.handles
                       if not h.retiring
                       and h.state in (RUNNING, SPAWNING, BACKOFF)]
        if any(h.state == SPAWNING for h in provisioned):
            return              # let the last scale-up land first
        load = self.router.offered_load()
        n_routable = load["n_routable"]
        if self.ticks - self._last_scale_tick < a.cooldown_ticks:
            return
        if load["queued"] > a.up_backlog_per_worker * max(n_routable, 1):
            self._down_streak = 0
            self._up_streak += 1
            if (self._up_streak >= a.up_patience
                    and len(provisioned) < a.max_workers):
                self.scale_up()
        elif (load["queued"] == 0 and n_routable > 1
              and len(provisioned) > a.min_workers
              and load["active"] <= (a.down_active_per_worker
                                     * (n_routable - 1))):
            self._up_streak = 0
            self._down_streak += 1
            if self._down_streak >= a.down_patience:
                self.scale_down()
        else:
            self._up_streak = self._down_streak = 0

    def scale_up(self) -> int:
        """Grow the fleet by one worker: a spec from the factory, a new
        router replica, a normal spawn (it warms, registers, attaches)."""
        assert self.spec_factory is not None, "no spec_factory"
        from ..serve.router import RemoteReplica
        router = self.router
        idx = len(router.replicas)
        spec = self.spec_factory(idx)
        spec.idx = idx
        h = WorkerHandle(spec=spec)
        self.handles.append(h)
        router.add_replica(RemoteReplica(
            idx, rpc_timeout_s=router.rcfg.step_timeout_s,
            step_timeout_s=router.rcfg.step_timeout_s))
        self.scale_ups += 1
        self._last_scale_tick = self.ticks
        self._up_streak = self._down_streak = 0
        router.metrics.inc("fleet_scale_ups")
        self._event(f"autoscale: scale-UP — spawning worker {idx} "
                    f"(sustained backlog)")
        self._spawn(h)
        self.peak_workers = max(self.peak_workers, sum(
            1 for x in self.handles
            if not x.retiring and x.state in (RUNNING, SPAWNING, BACKOFF)))
        return idx

    def scale_down(self) -> Optional[int]:
        """Shrink the fleet by one worker through the rolling restart's
        drain; the exit is terminal (RETIRED). Drops nothing."""
        victims = [h for h in self.handles
                   if h.state == RUNNING and not h.retiring
                   and not h.intentional_stop]
        if not victims:
            return None
        h = victims[-1]            # the highest index leaves first
        idx = h.spec.idx
        h.retiring = True
        h.intentional_stop = True
        self.scale_downs += 1
        self._last_scale_tick = self.ticks
        self._up_streak = self._down_streak = 0
        self.router.metrics.inc("fleet_scale_downs")
        self._stop_gracefully(h)
        self._event(f"autoscale: scale-DOWN — draining worker {idx} "
                    f"(sustained lull)")
        return idx

    def _stop_gracefully(self, h: WorkerHandle) -> None:
        """Drain the replica in the router and the worker, then shut the
        worker down (SIGTERM if the RPCs fail)."""
        idx = h.spec.idx
        self.router.drain_replica(idx)
        rep = self.router.replicas[idx]
        try:
            rep.client.call("drain", timeout_s=2.0)
            rep.client.call("shutdown", timeout_s=2.0)
        except Exception:  # noqa: BLE001 — the graceful path failed:
            # SIGTERM says the same thing louder
            self._signal(h, signal.SIGTERM)

    # ------------------------------------------------------------- chaos

    def chaos_kill(self, idx: int) -> None:
        """``proc_kill``: a real SIGKILL; no clean-up, no flushes."""
        h = self._handle(idx)
        if h is None:
            return
        self._event(f"CHAOS proc_kill worker {idx} (pid {h.pid})")
        self._signal(h, signal.SIGKILL)

    def chaos_hang(self, idx: int, ticks: int) -> None:
        """``proc_hang``: SIGSTOP now, SIGCONT after ``ticks`` ticks."""
        h = self._handle(idx)
        if h is None:
            return
        self._event(f"CHAOS proc_hang worker {idx} for {ticks} ticks")
        h.hang_ticks = max(int(ticks), 1)
        self._signal(h, signal.SIGSTOP)

    def chaos_host_loss(self, idx: int) -> None:
        """``host_loss``: SIGKILL the worker and delete its directory,
        journal included; the respawn replays nothing."""
        h = self._handle(idx)
        if h is None:
            return
        self._event(f"CHAOS host_loss worker {idx} (pid {h.pid}; journal "
                    f"+ workdir deleted)")
        h.hang_ticks = 0            # a SIGSTOPped process still dies
        self._signal(h, signal.SIGKILL)
        if h.proc is not None:
            try:
                h.proc.wait(timeout=10)
            except (subprocess.TimeoutExpired, OSError):
                pass
        if h.spec.workdir:
            shutil.rmtree(h.spec.workdir, ignore_errors=True)
        else:
            try:
                os.remove(h.spec.journal_path)
            except OSError:
                pass

    # --------------------------------------------------- rolling restart

    @property
    def rolling_active(self) -> bool:
        return bool(self._rolling)

    def start_rolling_restart(self) -> None:
        """Queue a drain -> stop -> respawn -> reattach cycle over every
        worker, one at a time (advanced by :meth:`tick`)."""
        if self._rolling:
            return
        self._rolling = [h.spec.idx for h in self.handles
                         if h.state not in (QUARANTINED, RETIRED)]
        self._rolling_phase = "drain"
        self._event(f"rolling restart of workers {self._rolling}")

    def _tick_rolling(self) -> None:
        if not self._rolling:
            return
        idx = self._rolling[0]
        h = self._handle(idx)
        if h is None:
            self._rolling.pop(0)
            return
        if self._rolling_phase == "drain":
            h.intentional_stop = True
            # advance only once this generation is gone and the next one
            # attached: "running and alive" holds in the instant after
            # the shutdown RPC too
            self._rolling_target_gen = h.gen + 1
            self._stop_gracefully(h)
            self._rolling_phase = "await_restart"
        elif self._rolling_phase == "await_restart":
            if (h.gen >= self._rolling_target_gen and h.state == RUNNING
                    and self.router.replicas[idx].alive):
                self._rolling.pop(0)
                self._rolling_phase = "drain"
                if not self._rolling:
                    self._event("rolling restart complete")
            elif h.state == QUARANTINED:
                self._rolling.pop(0)
                self._rolling_phase = "drain"


# -------------------------------------------------------------- builders

def _worker_env(env: Optional[dict]) -> dict:
    """The workers import this package whatever the caller's working
    directory (``python -m`` resolves against the child's path, and the
    repository need not be installed)."""
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(env or {})
    env.setdefault("PYTHONPATH", os.pathsep.join(
        p for p in (pkg_root, os.environ.get("PYTHONPATH")) if p))
    return env


def make_worker_spec(idx: int, workdir: str, config_args: List[str],
                     engine_args: Optional[List[str]] = None,
                     env: Optional[dict] = None) -> WorkerSpec:
    """One ``serve-worker`` spec with a private directory (journal.jsonl
    and worker.log inside it)."""
    os.makedirs(workdir, exist_ok=True)
    jpath = os.path.join(workdir, "journal.jsonl")
    cmd = [sys.executable, "-m", "replicatinggpt_tpu_torch", "serve-worker",
           *config_args, "--port", "0", "--journal", jpath,
           *(engine_args or [])]
    return WorkerSpec(idx=idx, cmd=cmd, journal_path=jpath,
                      workdir=workdir,
                      log_path=os.path.join(workdir, "worker.log"),
                      env=_worker_env(env))


def make_worker_specs(n_workers: int, base_dir: str, config_args: List[str],
                      engine_args: Optional[List[str]] = None,
                      env: Optional[dict] = None) -> List[WorkerSpec]:
    """Specs for N ``serve-worker`` processes, each in its own directory
    ``base_dir/worker{i}/`` (no journal directory is shared)."""
    return [make_worker_spec(i, os.path.join(base_dir, f"worker{i}"),
                             config_args, engine_args, env)
            for i in range(n_workers)]


def worker_spec_factory(base_dir: str, config_args: List[str],
                        engine_args: Optional[List[str]] = None,
                        env: Optional[dict] = None
                        ) -> Callable[[int], WorkerSpec]:
    """The autoscaler's spec source: ``factory(idx)`` is a spec in a new
    private directory, shaped as the first fleet's."""
    def factory(idx: int) -> WorkerSpec:
        return make_worker_spec(idx, os.path.join(base_dir, f"worker{idx}"),
                                config_args, engine_args, env)
    return factory


def spawn_fleet(specs: List[WorkerSpec], rcfg=None, scfg=None,
                clock=time.monotonic, wait: bool = True, autoscale=None,
                spec_factory=None, listen_host: str = "127.0.0.1"):
    """The fleet of worker processes: one supervisor over ``specs`` and a
    ``Router`` over :class:`~..serve.router.RemoteReplica` backends, wired
    together (``router.supervisor`` set). Returns ``(router,
    supervisor)``; the caller shuts down (``supervisor.stop_all()``, then
    ``router.close()``)."""
    from ..serve.router import RemoteReplica, Router, RouterConfig
    rcfg = rcfg or RouterConfig(n_replicas=len(specs))
    backends = [RemoteReplica(s.idx, rpc_timeout_s=rcfg.step_timeout_s,
                              step_timeout_s=rcfg.step_timeout_s)
                for s in specs]
    router = Router(rcfg=rcfg, backends=backends, clock=clock)
    sup = ProcSupervisor(specs, scfg or SupervisorConfig(),
                         autoscale=autoscale, spec_factory=spec_factory,
                         listen_host=listen_host)
    sup.attach_router(router)
    try:
        sup.start_all(wait=wait)
    except BaseException:
        router.close()
        raise
    return router, sup
