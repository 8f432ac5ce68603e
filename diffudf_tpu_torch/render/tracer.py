"""Sphere tracing and hit-point differential geometry on one device: the
torch counterpart of ``diffudf_tpu/render/tracer.py``.

The march keeps the whole ray set on the device: per-ray active masks,
positions updated in place, and only the active count crosses to the host
between rounds.  :func:`trace_rays_compacted` (the render CLI's march)
gathers the still-active rays to the front of a power-of-4 bucket before
each round of ``segment`` iterations, so converged and dead rays stop
costing field evaluations.  On a CUDA device each iteration's field values
come from the value kernel K4 (:func:`..ops.value.value`) where it takes
the net; elsewhere from the plain :func:`..autodiff.ops.value`.

Hit attributes: normals are the Hessian's top eigenvector, ``pc1``/``pc2``
the other two eigenvectors (principal-direction proxies for Ward shading);
the curvature modes take the Jacobian of the unit-normal field by forward
mode through the closed-form eigensolver.  Ray sharding over several
devices (``mesh``) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..autodiff.curvature import shape_operator_curvatures, vector_field_jacobian
from ..autodiff.eigh3 import eigh3x3
from ..autodiff.ops import hess_from_packed, value, value_grad, value_grad_hessian_packed
from ..fields.siren import SirenSpec
from ..fields.transforms import inverse_map
from ..ops import value as k4
from ..ops.evaluate import evaluate_field
from ..ops.kernel_io import kernel_spec_ok
from ..utils.buckets import next_bucket


def _device(params) -> torch.device:
    return params[0]["w"].device


def _march_while(params, spec, origins, rays, active0, *, gt_mode, alpha,
                 surface_threshold, max_iterations, compute_dtype):
    """The masked march over every ray until none is active."""
    t0 = origins.to(torch.float32)
    active = active0.clone()
    hits = torch.zeros_like(active)
    it = 0
    while it < max_iterations and bool(active.any()):
        f = value(params, spec, t0, compute_dtype=compute_dtype)
        steps = inverse_map(gt_mode, torch.abs(f), alpha)
        t1 = t0 + rays * steps[:, None]
        t0 = torch.where(active[:, None], t1, t0)
        if gt_mode == "siren":
            thresh = f < surface_threshold
        else:
            thresh = torch.abs(steps) < surface_threshold
        in_domain = torch.all((t0 > -1.0) & (t0 < 1.0), dim=-1)
        hits = hits | (active & thresh & in_domain)
        active = active & ~thresh & in_domain
        it += 1
    return t0, hits, it


def trace_rays(params, spec: SirenSpec, origins, rays, active0, *, gt_mode: str,
               alpha: float, surface_threshold: float, max_iterations: int = 100,
               fast: bool = True, mesh=None):
    """March ``t ← t + ray · inverse(|f(t)|)`` until convergence, on the
    params' device.  origins, rays (N, 3) and active0 (N,) are tensors or
    arrays.  -> (positions (N, 3), hits (N,) bool, iterations used).

    A ray hits when its step (in siren mode its field value) drops below
    the threshold while still inside [-1, 1]³; it dies when it leaves the
    domain.  ``fast=True`` evaluates the field in the mixed bf16 mode.
    """
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError("ray sharding over several devices is not ported")
    dev = _device(params)
    return _march_while(
        params, spec, torch.as_tensor(origins, dtype=torch.float32, device=dev),
        torch.as_tensor(rays, dtype=torch.float32, device=dev),
        torch.as_tensor(active0, dtype=torch.bool, device=dev),
        gt_mode=gt_mode, alpha=alpha, surface_threshold=surface_threshold,
        max_iterations=max_iterations, compute_dtype=torch.bfloat16 if fast else None,
    )


def _value_kernel_ok(spec: SirenSpec, device) -> bool:
    """K4 applies: a net the kernels take, on a CUDA device."""
    return kernel_spec_ok(spec) and torch.device(device).type == "cuda"


def _trace_segment_body(params, spec, t0, rays, active, hits, *, gt_mode,
                        alpha, surface_threshold, segment, fast,
                        relaxation: float = 1.0, weights=None):
    """``segment`` march iterations over a compact ray bucket; -> the new
    (t0, active, hits).  With K4's ``weights`` (:func:`..ops.value.
    prepare`'s layout) each iteration is one K4 launch; without them the
    plain torch value.

    ``relaxation`` ω > 1 enables over-relaxed sphere tracing (Keinert et
    al. 2014), one field evaluation per iteration: march ω·d; if the next
    unbounding sphere fails to overlap the previous one (d_new <
    (ω−1)·d_prev) the surface may sit in the uncovered gap, so the ray
    reverts to the conservative position t_prev + d_prev and re-marches
    from there.  Hits are only taken on evaluations that were not reverted.
    """
    compute_dtype = torch.bfloat16 if fast else None

    def field(pts):
        if weights is not None:
            return k4.value(params, spec, pts, compute_dtype=compute_dtype, weights=weights)
        return value(params, spec, pts, compute_dtype=compute_dtype)

    omega = float(relaxation)
    prev_d = torch.zeros(t0.shape[0], dtype=t0.dtype, device=t0.device)
    for _ in range(segment):
        f = field(t0)
        d = inverse_map(gt_mode, torch.abs(f), alpha)
        if omega > 1.0:
            fail = active & (d < (omega - 1.0) * prev_d)
            # revert to the conservative position t_prev + d_prev·ray
            t0 = torch.where(fail[:, None], t0 - rays * ((omega - 1.0) * prev_d)[:, None], t0)
            adv = torch.where(fail, 0.0, omega * d)
            # an over-relaxed step that would leave [-1,1]³ falls back to the
            # conservative step if that stays inside; the domain test below
            # would otherwise kill the ray before the next revert could act
            cons = torch.where(fail, 0.0, d)
            over_out = ~torch.all(torch.abs(t0 + rays * adv[:, None]) < 1.0, dim=-1)
            cons_in = torch.all(torch.abs(t0 + rays * cons[:, None]) < 1.0, dim=-1)
            clamp = active & over_out & cons_in
            adv = torch.where(clamp, cons, adv)
            valid_eval = ~fail
            # a conservative step leaves the next overlap test no relaxed
            # span to check: treat it like a post-revert step
            prev_d = torch.where(fail | clamp, 0.0, d)
        else:
            adv = d
            valid_eval = torch.ones_like(active)
            prev_d = d
        t1 = t0 + rays * adv[:, None]
        t0 = torch.where(active[:, None], t1, t0)
        if gt_mode == "siren":
            thresh = valid_eval & (f < surface_threshold)
        else:
            thresh = valid_eval & (torch.abs(d) < surface_threshold)
        in_domain = torch.all((t0 > -1.0) & (t0 < 1.0), dim=-1)
        hits = hits | (active & thresh & in_domain)
        active = active & ~thresh & in_domain
    return t0, active, hits


def _march_round(params, spec, t0, rays, active, hits, *, gt_mode, alpha,
                 surface_threshold, bucket, segment, fast, relaxation, weights=None):
    """One round: gather the ≤ bucket active rays to the front (a stable
    sort keeps them in order), march ``segment`` iterations on the bucket,
    scatter back.  Updates t0, active and hits in place; -> them and the
    new active count (a device tensor)."""
    order = torch.argsort((~active).to(torch.uint8), stable=True)
    perm = order[:bucket]
    t0_b, act_b, hit_b = _trace_segment_body(
        params, spec, t0[perm], rays[perm], active[perm],
        torch.zeros(bucket, dtype=torch.bool, device=t0.device),
        gt_mode=gt_mode, alpha=alpha, surface_threshold=surface_threshold,
        segment=segment, fast=fast, relaxation=relaxation, weights=weights,
    )
    t0[perm] = t0_b
    hits[perm] = hits[perm] | hit_b
    active[perm] = act_b
    return t0, active, hits, active.sum()


def _bucket_for(count: int, n: int) -> int:
    """Smallest power-of-4 bucket ≥ count (floor 1024, cap n)."""
    return next_bucket(count, 1024, factor=4, cap=n)


def _padded_rays(n_rays: int) -> int:
    """Rays are padded to a multiple of 1024, so every bucket is one."""
    return ((n_rays + 1023) // 1024) * 1024


def _k4_weights(params, spec, use_pallas: bool, fast: bool):
    """K4's weights laid out once for a whole trace, or None off the
    kernel."""
    if not use_pallas:
        return None
    return k4.prepare(params, spec, compute_dtype=torch.bfloat16 if fast else None)


def warmup_compacted(params, spec: SirenSpec, n_rays: int, *, gt_mode: str, alpha: float,
                     surface_threshold: float, max_iterations: int = 100, segment: int = 8,
                     fast: bool = True, relaxation: float = 1.0):
    """Run one round at every (bucket, segment) shape an ``n_rays`` march
    can visit, on no active ray.  Nothing compiles here; on a CUDA device
    this builds K4's library and launches it at each bucket once, before a
    timed march."""
    n = _padded_rays(n_rays)
    buckets = {n}
    b = 1024
    while b < n:
        buckets.add(b)
        b *= 4
    segments = {segment}
    if max_iterations % segment:
        segments.add(max_iterations % segment)
    dev = _device(params)
    t0 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros_like(t0)
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    hits = torch.zeros_like(active)
    weights = _k4_weights(params, spec, _value_kernel_ok(spec, dev), fast)
    for bk in sorted(buckets):
        for seg in sorted(segments):
            _march_round(params, spec, t0, rays, active, hits, gt_mode=gt_mode, alpha=alpha,
                         surface_threshold=surface_threshold, bucket=bk, segment=seg,
                         fast=fast, relaxation=relaxation, weights=weights)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gather_rows(arr: torch.Tensor, idx: np.ndarray) -> np.ndarray:
    """``arr[idx]`` as a host array: only the rows asked for cross."""
    return arr[torch.as_tensor(idx, dtype=torch.long, device=arr.device)].cpu().numpy()


class _PendingCount:
    """An active count read that may still be in flight on the device."""

    def __init__(self, count: torch.Tensor):
        self.count = count
        self.event = None
        if count.device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def ready(self) -> bool:
        return self.event is None or self.event.query()


def trace_rays_compacted(params, spec: SirenSpec, origins, rays, active0, *, gt_mode: str,
                         alpha: float, surface_threshold: float, max_iterations: int = 100,
                         segment: int = 8, fast: bool = True, relaxation: float = 1.0,
                         pipeline_below: float = 0.0, return_device: bool = False,
                         use_pallas: bool | None = None):
    """March with periodic active-ray compaction, on the params' device.

    The march runs in rounds of ``segment`` iterations; before each round
    the active rays are gathered to the front of a power-of-4 bucket, so
    the field evaluations add up to about Σ active(t) rather than
    N · iterations.  Only the active count crosses to the host.  With
    ``pipeline_below`` > 0 the count read overlaps the next round once the
    active share drops below it (a stale count only over-sizes the bucket,
    never drops a ray: the active set only shrinks); the default 0 reads
    it after every round.

    ``use_pallas``: None (the default) takes K4 where
    :func:`_value_kernel_ok` holds, False the plain torch value; K4's
    weights are laid out once for the trace.  ``fast`` selects the mixed
    bf16 mode.  Same contract and result as
    :func:`trace_rays`: -> numpy (positions, hits, iterations), or device
    tensors with ``return_device=True``.  The caller's arrays are not
    changed.
    """
    dev = _device(params)
    n_real = origins.shape[0]
    n = _padded_rays(n_real)
    t0 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rays_d = torch.zeros_like(t0)
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    t0[:n_real] = torch.as_tensor(origins, dtype=torch.float32, device=dev)
    rays_d[:n_real] = torch.as_tensor(rays, dtype=torch.float32, device=dev)
    active[:n_real] = torch.as_tensor(active0, dtype=torch.bool, device=dev)
    hits = torch.zeros_like(active)
    if use_pallas is None:
        use_pallas = _value_kernel_ok(spec, dev)
    weights = _k4_weights(params, spec, use_pallas, fast)
    count = int(active.sum())
    it = 0
    pending = None  # in-flight count read from an earlier round
    while it < max_iterations and count > 0:
        seg = min(segment, max_iterations - it)
        t0, active, hits, post_count = _march_round(
            params, spec, t0, rays_d, active, hits, gt_mode=gt_mode, alpha=alpha,
            surface_threshold=surface_threshold, bucket=_bucket_for(count, n),
            segment=seg, fast=fast, relaxation=relaxation, weights=weights,
        )
        it += seg
        if count > n * pipeline_below:
            count = int(post_count)
            pending = None
        elif pending is None:
            pending = _PendingCount(post_count)
        elif pending.ready():
            # the oldest resolved read: it resolves even when the host
            # runs ahead of the device
            count = int(pending.count)
            pending = _PendingCount(post_count)
    if return_device:
        return t0[:n_real], hits[:n_real], it
    return t0[:n_real].cpu().numpy(), hits[:n_real].cpu().numpy(), it


def gradient_descent_refine(params, spec, positions, mask, *, gt_mode, alpha, steps: int):
    """Optional post-march refinement ``t ← t − ∇̂f · inverse(f)`` of the
    masked rows."""
    t0 = positions
    for _ in range(steps):
        f, g = value_grad(params, spec, t0)
        gn = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)
        t1 = t0 - gn * inverse_map(gt_mode, torch.abs(f), alpha)[:, None]
        t0 = torch.where(mask[:, None], t1, t0)
    return t0


def _normal_field(params, spec, x):
    """Unit Hessian-top-eigenvector field n(x); runs under ``torch.func``."""
    _, _, h6 = value_grad_hessian_packed(params, spec, x)
    _, vecs = eigh3x3(hess_from_packed(h6))
    return vecs[..., 2]


def hit_attributes(params, spec: SirenSpec, positions: torch.Tensor, *,
                   curvature_mode: str = "none", tile: int = 4096,
                   use_pallas: bool | None = None):
    """-> dict of normals (N, 3), pc1 (N, 3), pc2 (N, 3), curvature (N,).

    normals = Hessian top eigenvector; pc1/pc2 = the other two
    eigenvectors.  ``"none"`` takes the Hessian from ``evaluate_field``
    (K1 on a CUDA device where it applies; ``use_pallas=False`` forces the
    plain path) and sets the curvature to 0.  ``"mean"`` and
    ``"gaussian"`` take the shape operator of the normal field in tiles of
    ``tile`` points: mean = ½ tr(∂n/∂x), gaussian = −det of the bordered
    Jacobian, through the plain Taylor-mode functions.
    """
    n = positions.shape[0]
    if curvature_mode == "none":
        ev = evaluate_field(params, spec, positions, want_hess=True, tile=tile,
                            use_pallas=use_pallas)
        _, vecs = eigh3x3(ev.hess)
        return {"normals": vecs[..., 2], "pc1": vecs[..., 0], "pc2": vecs[..., 1],
                "curvature": torch.zeros(n, device=positions.device)}

    outs = {"normals": [], "pc1": [], "pc2": [], "curvature": []}
    for lo in range(0, n, tile):
        pts = positions[lo:lo + tile]
        _, _, h6 = value_grad_hessian_packed(params, spec, pts)
        _, vecs = eigh3x3(hess_from_packed(h6))
        jac = vector_field_jacobian(lambda p: _normal_field(params, spec, p), pts)
        outs["normals"].append(vecs[..., 2])
        outs["pc1"].append(vecs[..., 0])
        outs["pc2"].append(vecs[..., 1])
        outs["curvature"].append(shape_operator_curvatures(jac, vecs[..., 2], curvature_mode))
    return {k: torch.cat(v) for k, v in outs.items()}
