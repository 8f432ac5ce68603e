"""Scalar logging, phase timing and profiling (the JAX package's
``utils`` names)."""

from .metrics import ScalarLogger
from .profiling import trace_to
from .timing import PhaseTimer

__all__ = ["ScalarLogger", "PhaseTimer", "trace_to"]
