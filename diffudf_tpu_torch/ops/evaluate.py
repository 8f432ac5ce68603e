"""Chunked field evaluation over large point sets: the torch counterpart of
``diffudf_tpu/ops/evaluate.py``.

``evaluate_field`` sends a Hessian request for a uniform-width sine SIREN on
a CUDA device to the fused kernel :func:`.vgh.vgh` (K1), which masks the
ragged last tile itself, so the points go in whole.  Everything else runs
the plain torch functions of :mod:`..autodiff.ops` over fixed-size tiles:
value-only passes are chains of ``torch.matmul`` (float32, no TF32), as the
JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..autodiff.ops import hess_from_packed, value, value_grad, value_grad_hessian_packed
from ..fields.siren import SirenSpec


class FieldEval(NamedTuple):
    f: torch.Tensor  # (Q,)
    grad: torch.Tensor | None  # (Q, 3)
    hess: torch.Tensor | None  # (Q, 3, 3)


def _kernel_ok(spec: SirenSpec, want_hess: bool, device: torch.device) -> bool:
    """K1 applies: Hessian requested, uniform-width sine net, CUDA device."""
    return (
        want_hess
        and spec.activation == "sine"
        and len(set(spec.hidden)) == 1
        and device.type == "cuda"
    )


def evaluate_field(
    params,
    spec: SirenSpec,
    points: torch.Tensor,
    *,
    want_grad: bool = False,
    want_hess: bool = False,
    tile: int = 8192,
    use_pallas: bool | None = None,
) -> FieldEval:
    """Evaluate f (+ ∇f, H) at (Q, 3) float32 points on their device.

    ``use_pallas`` keeps the JAX package's config key: None selects the
    fused kernel where it applies, False forces the plain torch path.
    """
    points = points.to(torch.float32)
    use_kernel = _kernel_ok(spec, want_hess, points.device) and use_pallas is not False
    if use_kernel:
        from .vgh import vgh

        f, g, h6 = vgh(params, spec, points.contiguous())
        return FieldEval(f=f, grad=g, hess=hess_from_packed(h6))

    fs, gs, hs = [], [], []
    for lo in range(0, points.shape[0], tile):
        pts = points[lo:lo + tile]
        if want_hess:
            f, g, h6 = value_grad_hessian_packed(params, spec, pts)
            hs.append(h6)
        elif want_grad:
            f, g = value_grad(params, spec, pts)
        else:
            f, g = value(params, spec, pts), None
        fs.append(f)
        if g is not None:
            gs.append(g)
    dev = points.device
    f = torch.cat(fs) if fs else torch.zeros(0, device=dev)
    grad = hess = None
    if want_grad or want_hess:
        grad = torch.cat(gs) if gs else torch.zeros((0, 3), device=dev)
    if want_hess:
        hess = hess_from_packed(torch.cat(hs) if hs else torch.zeros((0, 6), device=dev))
    return FieldEval(f=f, grad=grad, hess=hess)
