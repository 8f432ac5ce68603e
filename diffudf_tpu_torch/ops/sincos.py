"""Shared-range-reduction sin/cos: the torch counterpart of
``diffudf_tpu/ops/sincos.py``.

``fast_sincos`` computes both sin z and cos z from ONE Cody-Waite range
reduction:

    q = round(z / 2π);   r = ((z − q·c_hi) − q·c_mid) − q·c_lo  ∈ [−π, π]
    sin z = r · P(r²)    (odd minimax-fit polynomial, 7 coefficients)
    cos z = Q(r²)        (even minimax-fit polynomial, 8 coefficients)

The constants are those of the JAX package, bit for bit, so the CUDA
kernels (``csrc/sincos.cuh``, the same constants) and their plain torch
versions here compute the same function.  ``round`` is round-half-to-even
(``torch.round``; ``rintf`` on the card), as ``jnp.round`` is.  Accuracy:
≤ 6.3e-7 absolute for |z| ≤ 300, ≤ 8.5e-8 for |z| ≤ 1.
"""

from __future__ import annotations

import torch

# 2π split for Cody-Waite reduction: c_hi = 201/32 exactly representable
# with 11 trailing zero mantissa bits (q·c_hi exact for q ≤ 2048);
# c_hi + c_mid + c_lo reproduces float64 2π to the last bit.
_TWO_PI_HI = 6.28125
_TWO_PI_MID = 0.0019353071
_TWO_PI_LO = 1.0253132e-11
_INV_TWO_PI = 0.15915494309189535

# Chebyshev-node least-squares fits on [-π, π]:
# sin(x) = x·P(x²), max abs err 6.0e-7; cos(x) = Q(x²), max abs err 3.9e-7.
_SIN_COEF = (
    1.0, -0.16666664, 0.0083333105, -0.00019840153,
    2.7529395e-06, -2.4676488e-08, 1.3449976e-10,
)
_COS_COEF = (
    1.0, -0.5, 0.041666664, -0.0013888864,
    2.4800554e-05, -2.7534804e-07, 2.0603605e-09, -9.7225665e-12,
)


def _horner(coef, u):
    acc = torch.full_like(u, coef[-1])
    for c in coef[-2::-1]:
        acc = acc * u + c
    return acc


def _reduce(z):
    q = torch.round(z * _INV_TWO_PI)
    return ((z - q * _TWO_PI_HI) - q * _TWO_PI_MID) - q * _TWO_PI_LO


def fast_sincos(z):
    """(sin z, cos z) from one shared range reduction; z float32, any shape."""
    r = _reduce(z)
    u = r * r
    return r * _horner(_SIN_COEF, u), _horner(_COS_COEF, u)


def fast_sin(z):
    """sin z alone (the sphere-trace value kernel needs no cos)."""
    r = _reduce(z)
    return r * _horner(_SIN_COEF, r * r)
