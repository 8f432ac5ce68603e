"""Closed-form eigendecomposition of batched symmetric 3×3 matrices: the
torch counterpart of ``diffudf_tpu/autodiff/eigh3.py``.

Trigonometric solution of the characteristic cubic (Smith's algorithm) plus a
Cayley–Hamilton eigenvector construction: elementwise arithmetic over any
batch shape, differentiable.  Conventions mirror ``numpy.linalg.eigh``:
eigenvalues ascending, eigenvector k is the column ``v[..., :, k]``, so
``v[..., 2]`` belongs to the largest eigenvalue (the "Hessian normal").
Eigenvector signs are arbitrary.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-30


def _eigvals3(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending: (..., 3)."""
    q = A.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01**2 + a02**2 + a12**2
    d0, d1, d2 = A[..., 0, 0] - q, A[..., 1, 1] - q, A[..., 2, 2] - q
    p2 = d0**2 + d1**2 + d2**2 + 2.0 * p1
    # gradient-safe: sqrt'(0) and acos'(±1) are infinite; the 1e-12 / 1e-7
    # pads bias eigenvalues by ≲1e-6 — far below field accuracy
    p = torch.sqrt((torch.clamp(p2, min=0.0) + 1e-12) / 6.0)
    safe_p = torch.clamp(p, min=_EPS)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = (A - q[..., None, None] * eye) / safe_p[..., None, None]
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = torch.clamp(detB / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    phi = torch.acos(r) / 3.0
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_hi - lam_lo
    return torch.stack([lam_lo, lam_mid, lam_hi], dim=-1)


def _eigvec_for(A, lam_a, lam_b):
    """Eigenvector for the remaining eigenvalue via Cayley–Hamilton.

    M = (A - λa I)(A - λb I) maps everything into the remaining eigenspace;
    the largest-norm column of M is taken for conditioning, and an all-zero
    M (repeated eigenvalue) falls back to ẑ.
    """
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    Ma = A - lam_a[..., None, None] * eye
    Mb = A - lam_b[..., None, None] * eye
    M = torch.sum(Ma[..., :, :, None] * Mb[..., None, :, :], dim=-2)
    norms = torch.sum(M * M, dim=-2)  # (..., 3) column squared norms
    n0, n1, n2 = norms[..., 0], norms[..., 1], norms[..., 2]
    c0, c1, c2 = M[..., :, 0], M[..., :, 1], M[..., :, 2]
    use0 = ((n0 >= n1) & (n0 >= n2))[..., None]
    use1 = (n1 >= n2)[..., None]
    v = torch.where(use0, c0, torch.where(use1, c1, c2))
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device).expand_as(v)
    # double-where: degenerate columns are replaced BEFORE the division so
    # reverse mode never sees a 0/0 through the untaken branch
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    v_safe = torch.where(vn2 > 1e-20, v, fallback)
    vnorm = torch.sqrt(torch.sum(v_safe * v_safe, dim=-1, keepdim=True))
    return v_safe / torch.clamp(vnorm, min=_EPS)


def eigh3x3(A):
    """Batched eigh for symmetric (..., 3, 3) -> (eigvals (..., 3) ascending,
    eigvecs (..., 3, 3)) with eigenvector k in column ``[..., :, k]``."""
    lam = _eigvals3(A)
    l0, l1, l2 = lam[..., 0], lam[..., 1], lam[..., 2]
    v2 = _eigvec_for(A, l0, l1)  # largest
    v0 = _eigvec_for(A, l1, l2)  # smallest
    # middle eigenvector: orthogonal complement, better conditioned than the
    # Cayley–Hamilton column when λ1 sits near λ0 or λ2
    v1 = torch.linalg.cross(v2, v0)
    n1 = torch.linalg.norm(v1, dim=-1, keepdim=True)
    v1 = torch.where(n1 > 1e-20, v1 / torch.clamp(n1, min=_EPS), _eigvec_for(A, l0, l2))
    return lam, torch.stack([v0, v1, v2], dim=-1)


def top_eigenvector(A):
    """Unit eigenvector of the largest eigenvalue: (..., 3, 3) -> (..., 3)."""
    lam = _eigvals3(A)
    return _eigvec_for(A, lam[..., 0], lam[..., 1])


def top_eigenvector_packed(h6):
    """Top eigenvector straight from a packed (..., 6) Hessian."""
    from .ops import hess_from_packed

    return top_eigenvector(hess_from_packed(h6))
