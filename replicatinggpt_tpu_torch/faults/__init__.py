"""Fault injection, the training supervision that survives it, the
serving engine's self-healing policies, the fleet's fault kinds, the
worker processes' supervisor (``procsup``) and the network chaos
(``netchaos``): the port of ``replicatinggpt_tpu/faults/``. ``procsup``
and ``netchaos`` are imported by their users, not here."""

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
