"""Chunked field evaluation over large point sets: the torch counterpart of
``diffudf_tpu/ops/evaluate.py``.

``evaluate_field`` sends a Hessian request on a CUDA device to the fused
kernel :func:`.vgh.vgh` (K1) when the kernels take the net
(:func:`.kernel_io.kernel_spec_ok`: a uniform-width sine SIREN whose width
is a multiple of 32 and at most 256).  K1 masks the ragged last tile
itself, so the points go in whole.  Everything else runs
the plain torch functions of :mod:`..autodiff.ops` over fixed-size tiles:
value-only passes are chains of ``torch.matmul`` (float32, no TF32), as the
JAX package leaves them to XLA.

With a ``group`` of several ranks (:mod:`..parallel.mesh`) each rank
evaluates its contiguous block of the points on its own device, kernel
included, and every rank gets the gathered rows.  (In the JAX package a
mesh of several devices leaves Pallas; here each rank is one device.)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..autodiff.ops import hess_from_packed, value, value_grad, value_grad_hessian_packed
from ..fields.siren import SirenSpec
from .kernel_io import kernel_spec_ok


class FieldEval(NamedTuple):
    f: torch.Tensor  # (Q,)
    grad: torch.Tensor | None  # (Q, 3)
    hess: torch.Tensor | None  # (Q, 3, 3)


def _kernel_ok(spec: SirenSpec, want_hess: bool, device: torch.device) -> bool:
    """K1 applies: Hessian requested, a net the kernels take, CUDA device."""
    return want_hess and kernel_spec_ok(spec) and device.type == "cuda"


def unit(g: torch.Tensor) -> torch.Tensor:
    """g / max(‖g‖, 1e-12), row by row: the projections' step direction."""
    return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)


def projection_launches() -> tuple[int, int]:
    """-> (K3a, K1) launches so far, the counts of :mod:`.vg` and :mod:`.vgh`."""
    from . import vg, vgh

    return vg.launches, vgh.launches


def field_fns(spec: SirenSpec):
    """-> (vg_fn, vgh_fn), the (f, ∇f) and (f, ∇f, packed H) functions of
    the per-point projections (``pc/sampler.py``, ``extract/refine.py``).

    For a net the kernels take (:func:`.kernel_io.kernel_spec_ok`) they are
    the wrappers :func:`.vg.vg` (K3a) and :func:`.vgh.vgh` (K1), which run
    their plain versions on a CPU tensor; every other net gets the plain
    Taylor-mode functions of :mod:`..autodiff.ops`.
    """
    if kernel_spec_ok(spec):
        from .vg import vg
        from .vgh import vgh

        return vg, vgh
    return value_grad, value_grad_hessian_packed


def evaluate_field(
    params,
    spec: SirenSpec,
    points: torch.Tensor,
    *,
    want_grad: bool = False,
    want_hess: bool = False,
    tile: int = 8192,
    use_pallas: bool | None = None,
    group=None,
) -> FieldEval:
    """Evaluate f (+ ∇f, H) at (Q, 3) float32 points on their device.

    ``use_pallas`` keeps the JAX package's config key: None selects the
    fused kernel where it applies, False forces the plain torch path.
    ``group``: every rank passes the same points; each evaluates its block
    (``DataGroup.shard_rows``) and the rows are gathered.
    """
    points = points.to(torch.float32)
    if group is not None and group.backend is not None:
        n = points.shape[0]
        part = _evaluate_packed(params, spec, points[group.shard_rows(n)], want_grad,
                                want_hess, tile, use_pallas)
        f, g, h6 = (None if t is None else group.gather_rows(t, n) for t in part)
    else:
        f, g, h6 = _evaluate_packed(params, spec, points, want_grad, want_hess, tile,
                                    use_pallas)
    return FieldEval(f=f, grad=g, hess=None if h6 is None else hess_from_packed(h6))


def _evaluate_packed(params, spec, points, want_grad, want_hess, tile, use_pallas):
    """-> (f, ∇f or None, packed H or None) of :func:`evaluate_field` on one
    device."""
    use_kernel = _kernel_ok(spec, want_hess, points.device) and use_pallas is not False
    if use_kernel:
        from .vgh import vgh

        return vgh(params, spec, points.contiguous())

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
    grad = h6 = None
    if want_grad or want_hess:
        grad = torch.cat(gs) if gs else torch.zeros((0, 3), device=dev)
    if want_hess:
        h6 = torch.cat(hs) if hs else torch.zeros((0, 6), device=dev)
    return f, grad, h6
