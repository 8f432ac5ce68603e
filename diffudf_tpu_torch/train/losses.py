"""DUDF training losses: the torch counterpart of ``diffudf_tpu/train/losses.py``.

Every term is a masked mean over the fixed-layout batch (rows: on-surface |
far | near; "on surface" ⇔ gt sdf == 0), with no boolean indexing, so a step
needs no host sync.  Loss weights are Python floats: a zero weight drops its
term, as the reference's ``if loss_weights[i] != 0`` gating does
(``loss_functions.py:134-147``).

Term-for-term mapping (reference lines):
  * loss_s1   — ``loss_functions.py:123-155``
  * loss_s2   — ``loss_functions.py:106-121`` (torch.std ⇒ Bessel-corrected)
  * loss_siren— ``loss_functions.py:82-104``
  * total_variation, grad_consistency — ``loss_functions.py:56-80``
"""

from __future__ import annotations

import torch

from ..autodiff.eigh3 import top_eigenvector_packed
from ..autodiff.ops import hess_from_packed, value, value_grad, value_grad_hessian_packed
from ..ops.evaluate import autograd_ops
from ..utils.timing import span

_COS_EPS = 1e-8  # torch F.cosine_similarity denominator clamp


def _cosine_sim(a, b):
    """As the JAX package computes it: each norm clamped on its own
    (``F.cosine_similarity`` clamps differently)."""
    na = torch.clamp(torch.linalg.norm(a, dim=-1), min=_COS_EPS)
    nb = torch.clamp(torch.linalg.norm(b, dim=-1), min=_COS_EPS)
    return torch.sum(a * b, dim=-1) / (na * nb)


def _masked_mean(mask, v):
    return torch.mean(torch.where(mask, v, torch.zeros_like(v)))


def loss_s1(params, spec, points, gt_normals, gt_sdf, weights, alpha,
            n_surface=None, vgh_fn=None, vg_fn=None):
    """Stage-1 DUDF loss. gt_sdf: (B, 1); returns dict of weighted scalars.

    ``n_surface``: count of leading on-surface rows (the sampler's batch
    layout).  When given, the Hessian is only computed for those rows: the
    loss value is identical because ``hessian_constraint`` is masked to the
    surface anyway.  It may be 0 or every row (a data-parallel rank's
    block).  ``vgh_fn`` / ``vg_fn`` (``ops.vgh.vgh_op`` / ``ops.vg.vg_op``)
    then compute (f, g, h6) of the surface rows and (f, g) of the others;
    the kernels mask their ragged last tile, so no padding.
    Without them the plain Taylor-mode functions of ``autodiff.ops`` run.
    The derivatives are the span ``loss.derivs``, the eigenvectors
    ``loss.eig`` and the rest ``loss.terms``.
    """
    w0, w1, w2, w3 = (float(w) for w in weights)
    udf = gt_sdf[:, 0]
    on_surf = udf == 0

    need_h = w2 != 0
    need_g = w3 != 0

    # a data-parallel rank's block may hold only surface rows, or none
    split = need_h and n_surface is not None and 0 <= n_surface <= points.shape[0]

    with span("loss.derivs"):
        if need_h and not split:
            f, g, h6_surf = value_grad_hessian_packed(params, spec, points)
            surf_normals = gt_normals
            surf_mask = on_surf
        elif split:
            surf, off = points[:n_surface], points[n_surface:]
            if vgh_fn is not None:
                fs, gs, h6_surf = vgh_fn(params, spec, surf)
            else:
                fs, gs, h6_surf = value_grad_hessian_packed(params, spec, surf)
            if vg_fn is not None:
                fo, go = vg_fn(params, spec, off)
            else:
                fo, go = value_grad(params, spec, off)
            f = torch.cat([fs, fo])
            g = torch.cat([gs, go])
            surf_normals = gt_normals[:n_surface]
            surf_mask = on_surf[:n_surface]
        elif need_g:
            f, g = value_grad(params, spec, points)
        else:
            f = value(params, spec, points)

    if need_h:
        with span("loss.eig"):
            pred_normals = top_eigenvector_packed(h6_surf)

    with span("loss.terms"):
        tan = torch.tanh(alpha * udf)
        tdf = udf * tan

        terms = {}
        terms["sdf_on_surf"] = _masked_mean(on_surf, torch.abs(f)) * w0
        terms["sdf_off_surf"] = _masked_mean(~on_surf, torch.abs(tdf - f)) * w1

        if need_h:
            align = 1.0 - torch.abs(_cosine_sim(surf_normals, pred_normals))
            # masked mean over the FULL batch size (reference semantics:
            # zeros for off-surface rows still count in the denominator)
            total = (torch.sum(torch.where(surf_mask, align, torch.zeros_like(align)))
                     / points.shape[0])
            terms["hessian_constraint"] = total * w2
        else:
            terms["hessian_constraint"] = torch.zeros((), device=points.device)

        if need_g:
            target = torch.abs(tan + udf * alpha * (1.0 - tan * tan))
            gnorm = torch.linalg.norm(g, dim=-1)
            terms["grad_constraint"] = torch.mean(torch.abs(gnorm - target)) * w3
        else:
            terms["grad_constraint"] = torch.zeros((), device=points.device)

    return terms


def loss_s2(params, spec, points, gt_normals, gt_sdf, weights, alpha, group=None,
            n_surface=None, value_fn=None):
    """Stage-2 polish: |mean| and std of the on-surface field values.

    ``value_fn`` (``ops.value_vjp.value_vjp_op``) computes f of the rows;
    without it the exact ``torch.sin`` value path (``autodiff.ops.value``)
    runs.

    ``n_surface``: count of leading on-surface rows (the sampler's batch
    layout).  When given, only those rows are evaluated: the loss reads no
    other row, so the terms and their gradient are those of the mask over
    the whole batch, and a row past them whose distance rounds to 0 stays
    off the surface.  It may be 0 (a data-parallel rank's block).

    ``group`` (a :class:`..parallel.mesh.DataGroup`): each rank holds rows
    of one batch, and the mean and variance are those of the whole batch's
    on-surface set: ``n_on`` and ``sum_on``, then ``sse``, are summed over
    the ranks (a local variance around a local mean does not average)."""
    w0, w1 = (float(w) for w in weights[:2])
    if n_surface is not None:
        points, gt_sdf = points[:n_surface], gt_sdf[:n_surface]
    udf = gt_sdf[:, 0]
    on_surf = udf == 0
    f = (value_fn or value)(params, spec, points)
    zero = torch.zeros_like(f)

    n_on = torch.sum(on_surf)
    sum_on = torch.sum(torch.where(on_surf, f, zero))
    if group is not None:
        n_on = group.all_reduce_sum(n_on.to(torch.float32))
        sum_on = group.all_reduce_sum(sum_on)
    mean_on = sum_on / torch.clamp(n_on, min=1)
    sse = torch.sum(torch.where(on_surf, (f - mean_on) ** 2, zero))
    if group is not None:
        sse = group.all_reduce_sum(sse)
    var_on = sse / torch.clamp(n_on - 1, min=1)

    return {
        "sdf_on_surf": torch.abs(mean_on) * w0,
        "std_on_surf": torch.sqrt(var_on) * w1,
    }


def loss_siren(params, spec, points, gt_normals, gt_sdf, weights, alpha=None):
    """SIREN SDF baseline: on/off clamp + normal alignment + eikonal."""
    w0, w1, w2, w3 = (float(w) for w in weights)
    sdf = gt_sdf[:, 0]
    on_surf = sdf == 0

    f, g = value_grad(params, spec, points)

    off_constraint = torch.where(~on_surf, torch.exp(-1e2 * torch.abs(f)), torch.zeros_like(f))
    normal_align = 1.0 - _cosine_sim(g, gt_normals)
    eikonal = (torch.linalg.norm(g, dim=-1) - 1.0) ** 2

    return {
        "sdf_on_surf": _masked_mean(on_surf, torch.abs(f)) * w0,
        "sdf_off_surf": torch.mean(off_constraint) * w1,
        "normal_constraint": _masked_mean(on_surf, normal_align) * w2,
        "grad_constraint": torch.mean(eikonal) * w3,
    }


LOSS_FNS = {"s1": loss_s1, "s2": loss_s2, "siren": loss_siren}


# --- auxiliary regularisers ---------------------------------------------------
# Carried for inventory parity with the reference (``loss_functions.py:
# 56-80``); no recipe uses them, in the JAX package either.


def _derivs(spec, deriv_dtype, which, plain):
    """The kernels' autograd op ``which`` of :func:`..ops.evaluate.
    autograd_ops` for float32 carries and a net the kernels take, else
    ``plain`` with ``deriv_dtype``."""
    op = autograd_ops(spec)[which] if deriv_dtype is None else None
    return op or (lambda params, spec, x: plain(params, spec, x, deriv_dtype))


def total_variation(params, spec, points, gt_sdf, alpha, deriv_dtype=None, vgh_fn=None):
    """|∇‖∇f‖| against the analytic second-derivative magnitude of the tanh
    field, off-surface (``loss_functions.py:56-65``); ∇‖∇f‖ = H·∇f/‖∇f‖
    from the fused (f, ∇f, H).

    (f, ∇f, H) come from ``vgh_fn`` when given; else, with ``deriv_dtype``
    None and a net the kernels take, from K1 + K2 (``ops.vgh.vgh_op``, its
    plain versions on a CPU tensor), as the Trainer's s1 loss takes them;
    otherwise from the plain Taylor-mode function."""
    udf = gt_sdf[:, 0]
    fn = vgh_fn or _derivs(spec, deriv_dtype, 1, value_grad_hessian_packed)
    _, g, h6 = fn(params, spec, points)
    h = hess_from_packed(h6)
    gnorm = torch.clamp(torch.linalg.norm(g, dim=-1), min=1e-12)
    grad_of_gnorm = torch.einsum("nij,nj->ni", h, g) / gnorm[:, None]
    lhs = torch.linalg.norm(grad_of_gnorm, dim=-1)
    t = torch.tanh(alpha * udf)
    sech2 = 1.0 - t * t
    rhs = 2.0 * alpha * torch.abs(sech2 - udf * t * sech2)
    return _masked_mean(udf != 0, torch.abs(lhs - rhs))


def grad_consistency(params, spec, generator, surf_points, gt_normals, alpha,
                     stddev: float = 0.01, deriv_dtype=None, vg_fn=None):
    """Consistency of the field at offsets along the GT normals
    (``loss_functions.py:67-80``): -> the (direction, value, grad-norm)
    residual means at x + n·ε, ε ~ N(0, σ²) drawn from ``generator`` (on
    the points' device; the JAX function takes a key).  (f, ∇f) come from
    ``vg_fn`` when given, else as :func:`total_variation` chooses, with K3a
    + K3b (``ops.vg.vg_op``) for the kernels."""
    eps = stddev * torch.randn((surf_points.shape[0], 1), generator=generator,
                               device=surf_points.device, dtype=surf_points.dtype)
    return _grad_consistency_at(params, spec, eps, surf_points, gt_normals, alpha,
                                deriv_dtype, vg_fn)


def _grad_consistency_at(params, spec, eps, surf_points, gt_normals, alpha,
                         deriv_dtype=None, vg_fn=None):
    """:func:`grad_consistency` at given offsets ``eps`` (N, 1)."""
    fn = vg_fn or _derivs(spec, deriv_dtype, 0, value_grad)
    f, g = fn(params, spec, surf_points + gt_normals * eps)
    gn = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)
    e = eps[:, 0]
    tan = torch.tanh(alpha * torch.abs(e))
    dir_res = 1.0 - _cosine_sim(gn, gt_normals * torch.sign(eps))
    val_res = torch.abs(f - e * tan)
    norm_res = torch.abs(torch.linalg.norm(g, dim=-1)
                         - torch.abs(tan + torch.abs(e) * alpha * (1.0 - tan * tan)))
    return torch.mean(dir_res), torch.mean(val_res), torch.mean(norm_res)
