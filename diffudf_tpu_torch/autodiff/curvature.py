"""Differential geometry of the learned implicit surface: the torch
counterpart of ``diffudf_tpu/autodiff/curvature.py``.

Closed-form curvatures from (∇f, H), no extra autodiff passes.  For an
implicit surface f = const:

  * mean curvature      K_m = ( |∇f|² tr H − ∇fᵀ H ∇f ) / (2 |∇f|³)
  * gaussian curvature  K_g = − det [[H, ∇f], [∇fᵀ, 0]] / |∇f|⁴
  * principal curvatures K_m ± sqrt(|K_m² − K_g| + ε)

Signs are the JAX package's (raw geometric values; callers flip).  The
render path instead takes curvatures from the Jacobian of the unit-normal
field (:func:`vector_field_jacobian`, :func:`shape_operator_curvatures`).
"""

from __future__ import annotations

import torch


def divergence(hess):
    """∇·(∇f) = tr H, from the fused Hessian."""
    return hess.diagonal(dim1=-2, dim2=-1).sum(-1)


def laplacian(hess):
    """Δf = tr H (alias)."""
    return divergence(hess)


def vector_field_jacobian(field_fn, x):
    """Jacobian of an R³→R³ field at points x: (N, 3) -> (N, 3, 3), entry
    [n, i, k] = ∂F_i/∂x_k at point n.

    ``field_fn`` maps (N, 3) -> (N, 3) row by row, so one forward-mode
    product with the unit tangent e_k over the whole batch gives column k of
    every point's Jacobian: three ``torch.func.jvp`` calls."""
    cols = []
    for k in range(3):
        tangent = torch.zeros_like(x)
        tangent[:, k] = 1.0
        cols.append(torch.func.jvp(field_fn, (x,), (tangent,))[1])
    return torch.stack(cols, dim=-1)


def mean_curvature(grad, hess):
    """(..., 3), (..., 3, 3) -> (...,). ½ ∇·(∇f/|∇f|) in closed form."""
    gnorm = torch.linalg.norm(grad, dim=-1)
    g3 = torch.clamp(gnorm, min=1e-12) ** 3
    gHg = torch.einsum("...i,...ij,...j->...", grad, hess, grad)
    return (gnorm**2 * divergence(hess) - gHg) / (2.0 * g3)


def _bordered(mat, vec):
    """[[mat, vec], [vecᵀ, 0]]: (..., 3, 3), (..., 3) -> (..., 4, 4)."""
    top = torch.cat([mat, vec[..., :, None]], dim=-1)
    bottom = torch.cat([vec, torch.zeros_like(vec[..., :1])], dim=-1)
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def gaussian_curvature(grad, hess):
    """(..., 3), (..., 3, 3) -> (...,). Bordered-Hessian determinant form."""
    gnorm4 = torch.clamp(torch.linalg.norm(grad, dim=-1), min=1e-12) ** 4
    return -torch.linalg.det(_bordered(hess, grad)) / gnorm4


def principal_curvatures(grad, hess):
    """Returns (k_min, k_max), each (...,)."""
    km = mean_curvature(grad, hess)
    kg = gaussian_curvature(grad, hess)
    a = torch.sqrt(torch.abs(km * km - kg) + 1e-5)
    return km - a, km + a


def principal_directions(grad, hess):
    """Principal curvature directions of the implicit surface, closed form
    (Che, Paul & Zhang, CAGD 2007).  Returns (T1 (..., 3), T2 (..., 3),
    umbilical (...,) bool); directions are not normalised."""
    g, h = grad, hess
    gx, gy, gz = g[..., 0:1], g[..., 1:2], g[..., 2:3]

    A = gy * h[..., 0, 2:3] - gz * h[..., 0, 1:2]
    B = 0.5 * (gz * h[..., 0, 0:1] - gx * h[..., 0, 2:3]
               + gy * h[..., 1, 2:3] - gz * h[..., 1, 1:2])
    C = 0.5 * (gy * h[..., 2, 2:3] - gz * h[..., 1, 2:3]
               + gx * h[..., 0, 1:2] - gy * h[..., 0, 0:1])
    D = gz * h[..., 0, 1:2] - gx * h[..., 1, 2:3]
    E = 0.5 * (gx * h[..., 1, 1:2] - gy * h[..., 0, 1:2]
               + gz * h[..., 0, 2:3] - gx * h[..., 2, 2:3])
    F = gx * h[..., 1, 2:3] - gy * h[..., 0, 2:3]

    U = A * gz**2 - 2.0 * C * gx * gz + F * gx**2
    V = 2.0 * (B * gz**2 - C * gy * gz - E * gx * gz + F * gx * gy)
    W = D * gz**2 - 2.0 * E * gy * gz + F * gy**2

    disc = torch.sign(gz) * torch.sqrt(torch.abs(V**2 - 4.0 * U * W) + 1e-10)
    t1 = torch.cat([(-V + disc) * gz, 2.0 * U * gz, (V - disc) * gx - 2.0 * U * gy], dim=-1)
    t2 = torch.cat([(-V - disc) * gz, 2.0 * U * gz, (V + disc) * gx - 2.0 * U * gy], dim=-1)
    umbilical = (torch.abs(U) + torch.abs(V) + torch.abs(W))[..., 0] < 1e-6
    return t1, t2, umbilical


def shape_operator_curvatures(normals_jac, normals, mode: str):
    """Curvatures from the Jacobian of a unit-normal field (render path):
    mean = ½ tr(J), gaussian = −det of the bordered Jacobian."""
    if mode == "mean":
        return 0.5 * normals_jac.diagonal(dim1=-2, dim2=-1).sum(-1)
    if mode == "gaussian":
        return -torch.linalg.det(_bordered(normals_jac, normals))
    raise ValueError(f"unknown curvature mode {mode!r}")
