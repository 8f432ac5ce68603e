"""Fused value / gradient / Hessian of the SIREN field: the torch
counterpart of ``diffudf_tpu/autodiff/ops.py``.

(f, ∇f, H) are propagated analytically forward through the MLP in one pass
(Taylor mode specialised to affine layers + pointwise activations).  Per
layer with pre-activation z = a·W + b and activation σ(w·z):

    a'  = σ(w z)
    J'  = w σ'(w z) ⊙ (J·W)
    H'ᵢⱼ = w σ'(w z) ⊙ (H·W)ᵢⱼ + w² σ''(w z) ⊙ (J·W)ᵢ (J·W)ⱼ

J is carried as (N, 3, h) and the symmetric Hessian as its 6 upper-triangle
components (N, 6, h), packed in the order (xx, xy, xz, yy, yz, zz).  These
are the plain torch versions with exact ``torch.sin``/``torch.cos``; the
fused CUDA kernel is :mod:`..ops.vgh`.
"""

from __future__ import annotations

import torch

from ..fields.siren import SirenSpec, siren_apply

# upper-triangle index pairs, row-major: (0,0),(0,1),(0,2),(1,1),(1,2),(2,2)
_TRI_I = (0, 0, 0, 1, 1, 2)
_TRI_J = (0, 1, 2, 1, 2, 2)


def hess_from_packed(h6: torch.Tensor) -> torch.Tensor:
    """(..., 6) packed upper triangle -> (..., 3, 3) full symmetric matrix."""
    xx, xy, xz, yy, yz, zz = h6.unbind(-1)
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def pack_hess(h: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric matrix -> (..., 6) packed upper triangle."""
    return torch.stack([h[..., i, j] for i, j in zip(_TRI_I, _TRI_J)], dim=-1)


def value(params, spec: SirenSpec, x: torch.Tensor) -> torch.Tensor:
    """f(x): (N, 3) -> (N,)."""
    return siren_apply(params, spec, x)[..., 0]


def _act(spec: SirenSpec, freq, z):
    """Returns (σ(wz), w·σ'(wz), w²·σ''(wz)) elementwise."""
    wz = freq * z
    if spec.activation == "sine":
        s = torch.sin(wz)
        return s, freq * torch.cos(wz), -(freq * freq) * s
    relu_mask = (wz > 0).to(z.dtype)
    return wz * relu_mask, freq * relu_mask, torch.zeros_like(z)


def _check_scalar(spec: SirenSpec):
    if spec.n_out != 1:
        raise ValueError("gradient ops require a scalar field (n_out == 1)")


def value_grad(params, spec: SirenSpec, x: torch.Tensor):
    """Fused (f, ∇f): (N, 3) -> ((N,), (N, 3))."""
    _check_scalar(spec)
    freqs = spec.freqs
    a = x
    jac = torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[0], 3, 3)
    for i, layer in enumerate(params[:-1]):
        w = layer["w"]
        z = a @ w + layer["b"]
        jz = jac @ w  # (N, 3, h)
        a, d1, _ = _act(spec, freqs[i], z)
        jac = d1[:, None, :] * jz
    last = params[-1]
    f = (a @ last["w"] + last["b"])[..., 0]
    g = (jac @ last["w"])[..., 0]
    return f, g


def value_grad_hessian_packed(params, spec: SirenSpec, x: torch.Tensor):
    """Fused (f, ∇f, packed H): (N, 3) -> ((N,), (N, 3), (N, 6))."""
    _check_scalar(spec)
    freqs = spec.freqs
    n = x.shape[0]
    a = x
    jac = torch.eye(3, dtype=x.dtype, device=x.device).expand(n, 3, 3)
    hes = torch.zeros((n, 6, 3), dtype=x.dtype, device=x.device)
    for i, layer in enumerate(params[:-1]):
        w = layer["w"]
        z = a @ w + layer["b"]
        jz = jac @ w  # (N, 3, h)
        hz = hes @ w  # (N, 6, h)
        a, d1, d2 = _act(spec, freqs[i], z)
        outer = jz[:, _TRI_I, :] * jz[:, _TRI_J, :]  # (N, 6, h)
        jac = d1[:, None, :] * jz
        hes = d1[:, None, :] * hz + d2[:, None, :] * outer
    last = params[-1]
    f = (a @ last["w"] + last["b"])[..., 0]
    g = (jac @ last["w"])[..., 0]
    h6 = (hes @ last["w"])[..., 0]
    return f, g, h6
