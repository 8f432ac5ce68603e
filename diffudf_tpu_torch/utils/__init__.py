"""Scalar logging, spans and profiling (the JAX package's ``utils``
names, with ``span`` in place of its ``PhaseTimer``)."""

from .metrics import ScalarLogger
from .profiling import trace_to
from .timing import span

__all__ = ["ScalarLogger", "span", "trace_to"]
