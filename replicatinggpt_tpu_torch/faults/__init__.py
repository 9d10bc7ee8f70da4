"""Fault injection, the training supervision that survives it, and the
serving engine's self-healing policies (the training, checkpoint and
single-engine serving part of ``replicatinggpt_tpu/faults/``)."""

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
