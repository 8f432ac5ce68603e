"""Field evaluation and the CUDA kernels' wrappers (``vgh``, ``vg``,
``value``, ``min_distance``; the JAX package's ``ops`` names)."""

from .evaluate import FieldEval, evaluate_field

__all__ = ["evaluate_field", "FieldEval"]
