"""Fault injection, the training supervision that survives it, the
serving engine's self-healing policies and the in-process fleet's fault
kinds (the training, checkpoint, serving and in-process fleet part of
``replicatinggpt_tpu/faults/``; the worker processes' supervisor and the
network chaos are ROADMAP.md queue A item 10)."""

from .inject import Fault, FaultPlan, active, clear, fire, install, installed
from .supervise import (LossSpikeError, LossTracker, NonFiniteLossError,
                        SupervisedResult, SupervisionConfig,
                        SupervisionExhausted, supervised_train)
from .watchdog import (DEFAULT_SERVE_RESILIENCE, LoadShedder,
                       ResilienceConfig, SpecHealth, StepWatchdog)

__all__ = [
    "Fault", "FaultPlan", "active", "clear", "fire", "install", "installed",
    "LossSpikeError", "LossTracker", "NonFiniteLossError",
    "SupervisedResult", "SupervisionConfig", "SupervisionExhausted",
    "supervised_train",
    "DEFAULT_SERVE_RESILIENCE", "LoadShedder", "ResilienceConfig",
    "SpecHealth", "StepWatchdog",
]
