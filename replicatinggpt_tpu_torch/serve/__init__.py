"""Paged continuous-batching serving: pages (radix prefix cache, page
allocator, COW), scheduler, engine and the trace replay."""

from .engine import Engine, EngineConfig
from .replay import ReplayConfig, format_summary, make_trace, run_replay
from .requests import Request, RequestResult, SamplingParams

__all__ = ["Engine", "EngineConfig", "ReplayConfig", "Request",
           "RequestResult", "SamplingParams", "format_summary", "make_trace",
           "run_replay"]
