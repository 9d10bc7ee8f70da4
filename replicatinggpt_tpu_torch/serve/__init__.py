"""Paged continuous-batching serving: pages (radix prefix cache, page
allocator, COW), scheduler, engine, speculative decoding, the request
journal and the trace replay; and the fleet in one process: the router
over N engine replicas (prefix affinity, journal requeue after a replica
dies, hedged re-route off a wedged one, the exactly-once delivery
ledger), the session load generator and fleet replay (``loadgen``), and
the asyncio HTTP/SSE front door (``http``, the ``serve`` subcommand).

Self-healing (step watchdog, speculative auto-disable, load shedding) is
opt-in through ``faults.watchdog.ResilienceConfig`` on the Engine; the
fleet's faults (replica kill and wedge, hot-key skew) are
``faults.fleet``'s. Worker processes behind an RPC protocol are
ROADMAP.md queue A item 10, disaggregated prefill and decode tiers queue
A item 9(e).
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
from .router import Replica, ReplicaBase, Router, RouterConfig
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
           "Replica", "ReplicaBase", "Router", "RouterConfig",
           "SessionLoadConfig", "StepClock", "make_sessions",
           "run_fleet_replay", "session_request"]
