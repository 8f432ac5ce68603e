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
"""

from __future__ import annotations

import torch

from ..autodiff.eigh3 import top_eigenvector_packed
from ..autodiff.ops import value, value_grad, value_grad_hessian_packed

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
    """
    w0, w1, w2, w3 = (float(w) for w in weights)
    udf = gt_sdf[:, 0]
    on_surf = udf == 0

    need_h = w2 != 0
    need_g = w3 != 0

    # a data-parallel rank's block may hold only surface rows, or none
    split = need_h and n_surface is not None and 0 <= n_surface <= points.shape[0]

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

    tan = torch.tanh(alpha * udf)
    tdf = udf * tan

    terms = {}
    terms["sdf_on_surf"] = _masked_mean(on_surf, torch.abs(f)) * w0
    terms["sdf_off_surf"] = _masked_mean(~on_surf, torch.abs(tdf - f)) * w1

    if need_h:
        pred_normals = top_eigenvector_packed(h6_surf)
        align = 1.0 - torch.abs(_cosine_sim(surf_normals, pred_normals))
        # masked mean over the FULL batch size (reference semantics: zeros
        # for off-surface rows still count in the denominator)
        total = torch.sum(torch.where(surf_mask, align, torch.zeros_like(align))) / points.shape[0]
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


def loss_s2(params, spec, points, gt_normals, gt_sdf, weights, alpha, group=None):
    """Stage-2 polish: |mean| and std of the on-surface field values, through
    the exact ``torch.sin`` value path (``autodiff.ops.value``).

    ``group`` (a :class:`..parallel.mesh.DataGroup`): each rank holds rows
    of one batch, and the mean and variance are those of the whole batch's
    on-surface set: ``n_on`` and ``sum_on``, then ``sse``, are summed over
    the ranks (a local variance around a local mean does not average)."""
    w0, w1 = (float(w) for w in weights[:2])
    udf = gt_sdf[:, 0]
    on_surf = udf == 0
    f = value(params, spec, points)
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
