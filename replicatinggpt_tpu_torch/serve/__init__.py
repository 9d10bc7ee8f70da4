"""Paged continuous-batching serving: pages (radix prefix cache, page
allocator, COW), scheduler, engine, speculative decoding, the request
journal and the trace replay; and the fleet: the router over N engine
replicas (prefix affinity, journal requeue after a replica dies, hedged
re-route off a wedged one, the exactly-once delivery ledger), in this
process or as worker processes (``worker``, the ``serve-worker``
subcommand) behind the RPC protocol (``rpc``), the session load
generator and fleet replay (``loadgen``), and the asyncio HTTP/SSE front
door (``http``, the ``serve`` subcommand).

Self-healing (step watchdog, speculative auto-disable, load shedding) is
opt-in through ``faults.watchdog.ResilienceConfig`` on the Engine; the
fleet's faults are ``faults.fleet``'s, the worker processes' supervisor
``faults.procsup``'s, the message faults ``faults.netchaos``'s.
Disaggregated prefill and decode tiers are ROADMAP.md queue A item 9(e).
"""

from .cache_pool import CachePool
from .engine import Engine, EngineConfig
from .journal import JournalBusyError, RequestJournal
from .loadgen import (SessionLoadConfig, StepClock, make_sessions,
                      run_fleet_replay, session_request)
from .pages import PageAllocator, PagedCachePool, RadixIndex
from .replay import ReplayConfig, format_summary, make_trace, run_replay
from .requests import (REJECT_FLEET_CAPACITY, REJECT_REPLICA_DOWN, Request,
                       RequestResult, SamplingParams)
from .router import (RemoteReplica, Replica, ReplicaBase, Router,
                     RouterConfig)
from .scheduler import Scheduler
from .speculative import (Drafter, ModelDrafter, NGramDrafter,
                          draft_config_from_preset, make_drafter)

__all__ = ["CachePool", "Engine", "EngineConfig",
           "PageAllocator", "PagedCachePool", "RadixIndex",
           "JournalBusyError", "RequestJournal",
           "ReplayConfig", "format_summary", "make_trace", "run_replay",
           "Request", "RequestResult", "SamplingParams", "Scheduler",
           "Drafter", "ModelDrafter", "NGramDrafter",
           "draft_config_from_preset", "make_drafter",
           "REJECT_FLEET_CAPACITY", "REJECT_REPLICA_DOWN",
           "RemoteReplica", "Replica", "ReplicaBase", "Router",
           "RouterConfig",
           "SessionLoadConfig", "StepClock", "make_sessions",
           "run_fleet_replay", "session_request"]
