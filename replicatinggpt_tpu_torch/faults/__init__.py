"""Fault injection and the training supervision that survives it (the
training and checkpoint part of ``replicatinggpt_tpu/faults/``)."""

from .inject import Fault, FaultPlan, active, clear, fire, install, installed
from .supervise import (LossSpikeError, LossTracker, NonFiniteLossError,
                        SupervisedResult, SupervisionConfig,
                        SupervisionExhausted, supervised_train)

__all__ = [
    "Fault", "FaultPlan", "active", "clear", "fire", "install", "installed",
    "LossSpikeError", "LossTracker", "NonFiniteLossError",
    "SupervisedResult", "SupervisionConfig", "SupervisionExhausted",
    "supervised_train",
]
