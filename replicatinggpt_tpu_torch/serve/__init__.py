"""Paged continuous-batching serving: pages (radix prefix cache, page
allocator, COW), scheduler, engine, speculative decoding, the request
journal and the trace replay.

Self-healing (step watchdog, speculative auto-disable, load shedding) is
opt-in through ``faults.watchdog.ResilienceConfig`` on the Engine.
"""

from .cache_pool import CachePool
from .engine import Engine, EngineConfig
from .journal import JournalBusyError, RequestJournal
from .pages import PageAllocator, PagedCachePool, RadixIndex
from .replay import ReplayConfig, format_summary, make_trace, run_replay
from .requests import Request, RequestResult, SamplingParams
from .scheduler import Scheduler
from .speculative import (Drafter, ModelDrafter, NGramDrafter,
                          draft_config_from_preset, make_drafter)

__all__ = ["CachePool", "Engine", "EngineConfig",
           "PageAllocator", "PagedCachePool", "RadixIndex",
           "JournalBusyError", "RequestJournal",
           "ReplayConfig", "format_summary", "make_trace", "run_replay",
           "Request", "RequestResult", "SamplingParams", "Scheduler",
           "Drafter", "ModelDrafter", "NGramDrafter",
           "draft_config_from_preset", "make_drafter"]
