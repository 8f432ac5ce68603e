"""Fused value / gradient / Hessian of the SIREN field, the closed-form
3×3 eigensolver and curvatures (the JAX package's ``autodiff`` names)."""

from .curvature import gaussian_curvature, mean_curvature, principal_curvatures
from .eigh3 import eigh3x3, top_eigenvector
from .ops import value, value_grad, value_grad_hessian, value_grad_hessian_ad

__all__ = [
    "value",
    "value_grad",
    "value_grad_hessian",
    "value_grad_hessian_ad",
    "eigh3x3",
    "top_eigenvector",
    "mean_curvature",
    "gaussian_curvature",
    "principal_curvatures",
]
