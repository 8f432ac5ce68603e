"""Dense point-cloud + normal extraction from a trained UDF: the torch
counterpart of ``diffudf_tpu/pc/sampler.py``.

NDF-style projection sampling (reference ``src/render_pc.py:26-73``): sample
candidate points, project them onto the zero set with
``x ← x − inverse(|f|)·∇̂f`` steps, keep converged in-domain points, resample
around found points, repeat until the target count is reached.

On the GPU each projection step's (f, ∇f) is one launch of K3a
(:func:`..ops.vg.vg`) and the last step's (f, ∇f, H) for the Hessian normals
one launch of K1 (:func:`..ops.vgh.vgh`), for every net the kernels take;
other nets, and CPU tensors, run the plain versions
(:func:`..ops.evaluate.field_fns`).  Candidates and kept points stay on the
device; each round reads back one count, which the stopping test needs.
The random stream is a ``torch.Generator`` seeded by ``seed``, not the JAX
key stream.

With a ``group`` (:mod:`..parallel.mesh`, the JAX ``mesh``) every rank
draws the same candidates (the count rounded up to a multiple of the group
size, as the JAX sampler rounds it), projects its contiguous block on its
own device, and every rank gets the gathered rows, so the rounds' keep
logic runs on the same arrays everywhere.

Normal orientation (:func:`orient_normals_consistent`) is the JAX package's
numpy/scipy code, copied: Riemannian MST over the kNN graph with 1−|n·n'|
weights, sign-propagated from the topmost point, as Open3D's
``orient_normals_consistent_tangent_plane`` (``generate_pc.py:40``).
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..autodiff.eigh3 import top_eigenvector_packed
from ..fields.siren import SirenSpec
from ..fields.transforms import inverse_map
from ..ops.evaluate import field_fns, projection_launches, unit
from ..parallel.mesh import pad_to_multiple


@torch.no_grad()
def project_points(
    params,
    spec: SirenSpec,
    x0: torch.Tensor,  # (N, 3) float32, on the params' device
    *,
    gt_mode: str,
    alpha: float,
    num_steps: int,
    want_hessian_normals: bool,
    vg_fn=None,
    vgh_fn=None,
    group=None,
):
    """-> (x_final, last_step_size (N,), normals (N, 3)), on x0's device.

    ``num_steps − 1`` steps of ``x ← x − inverse(|f|)·∇̂f`` (min step 0),
    then a last one that also returns its step size and the normals: the
    top eigenvector of H with ``want_hessian_normals`` (f and ∇f from the
    same pass), else ∇̂f.  ``vg_fn`` / ``vgh_fn`` (default
    :func:`..ops.evaluate.field_fns`) compute (f, ∇f) and (f, ∇f, h6).
    ``group``: each rank projects its block of ``x0`` (every rank passes all
    of it) and the results are gathered.
    """
    if group is not None and group.backend is not None:
        n = x0.shape[0]
        part = project_points(params, spec, x0[group.shard_rows(n)], gt_mode=gt_mode,
                              alpha=alpha, num_steps=num_steps,
                              want_hessian_normals=want_hessian_normals, vg_fn=vg_fn,
                              vgh_fn=vgh_fn)
        return tuple(group.gather_rows(t, n) for t in part)
    default_vg, default_vgh = field_fns(spec)
    vg_fn, vgh_fn = vg_fn or default_vg, vgh_fn or default_vgh
    x = x0
    for _ in range(num_steps - 1):
        f, g = vg_fn(params, spec, x)
        x = x - inverse_map(gt_mode, torch.abs(f), alpha, min_step=0.0)[:, None] * unit(g)
    if want_hessian_normals:
        f, g, h6 = vgh_fn(params, spec, x)
        normals = top_eigenvector_packed(h6)
    else:
        f, g = vg_fn(params, spec, x)
        normals = unit(g)
    step = inverse_map(gt_mode, torch.abs(f), alpha, min_step=0.0)
    return x - step[:, None] * unit(g), step, normals


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate_point_cloud(
    params,
    spec: SirenSpec,
    *,
    gt_mode: str,
    alpha: float,
    num_steps: int = 5,
    num_points: int = 20000,
    surf_thresh: float = 0.01,
    max_iter: int = 1000,
    seed: int = 0,
    stats: dict | None = None,
    group=None,
):
    """-> (points (≥num_points, 3), normals) as float32 numpy arrays, unless
    max_iter exhausts first (then a RuntimeWarning).

    Runs on the params' device.  ``stats``: when given a dict, it receives
    ``rounds``, ``candidates`` and ``kept`` (one entry a round),
    ``project_s`` (the rounds' projections, device synchronised) and the
    ``k3a_launches`` and ``k1_launches`` of the call (this rank's, with a
    ``group``: see the module docstring).
    """
    device = params[0]["w"].device
    if group is not None and group.backend is not None:
        num_points = pad_to_multiple(num_points, group.size)
    gen = torch.Generator(device=device).manual_seed(seed)
    hessian_normals = gt_mode != "siren"
    found = torch.zeros((0, 3), device=device)
    found_normals = torch.zeros((0, 3), device=device)
    record = stats is not None
    counts0 = projection_launches()
    candidates, kept, project_s = [], [], 0.0

    def uniform(n):
        return torch.rand((n, 3), generator=gen, device=device) * 2.0 - 1.0

    for _ in range(max_iter):
        if len(found):
            half = num_points // 2
            picks = torch.randint(0, len(found), (half,), generator=gen, device=device)
            seeds = found[picks] + 0.1 * torch.randn((half, 3), generator=gen, device=device)
            samples = torch.cat([seeds, uniform(num_points - half)])
        else:
            samples = uniform(num_points)

        if record:
            _sync(device)
            t0 = time.perf_counter()
        x, step, nrm = project_points(
            params, spec, samples, gt_mode=gt_mode, alpha=alpha, num_steps=num_steps,
            want_hessian_normals=hessian_normals, group=group,
        )
        if record:
            _sync(device)
            project_s += time.perf_counter() - t0

        keep = (torch.abs(x) <= 1.0).all(dim=1) & (step < surf_thresh)
        new = x[keep]  # the round's one read of a count
        found = torch.cat([found, new])
        found_normals = torch.cat([found_normals, nrm[keep]])
        candidates.append(len(samples))
        kept.append(len(new))
        if len(found) >= num_points:
            break

    if record:
        k3a_launches, k1_launches = (b - a for a, b in zip(counts0, projection_launches()))
        stats.update(rounds=len(candidates), candidates=candidates, kept=kept,
                     project_s=project_s, k3a_launches=k3a_launches, k1_launches=k1_launches)
    if len(found) < num_points:
        warnings.warn(
            f"Max iterations reached. Only sampled {len(found)} surface points.",
            RuntimeWarning,
        )
    return found.cpu().numpy(), found_normals.cpu().numpy()


def orient_normals_consistent(points: np.ndarray, normals: np.ndarray, k: int = 10):
    """Consistently orient normals by sign propagation over a kNN MST.

    Open3D ``orient_normals_consistent_tangent_plane(k)`` equivalent: build
    the kNN graph weighted by 1−|nᵢ·nⱼ|, take its minimum spanning tree,
    seed at the point with max z (normal forced toward +z) and flip along
    tree edges to keep neighbouring normals agreeing.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order, minimum_spanning_tree
    from scipy.spatial import cKDTree

    n = len(points)
    if n == 0:
        return normals
    tree = cKDTree(points)
    kk = min(k + 1, n)
    _, nbrs = tree.query(points, k=kk)
    rows = np.repeat(np.arange(n), kk - 1)
    cols = nbrs[:, 1:].reshape(-1)
    w = 1.0 - np.abs(np.sum(normals[rows] * normals[cols], axis=1))
    graph = coo_matrix((w + 1e-9, (rows, cols)), shape=(n, n)).tocsr()
    mst = minimum_spanning_tree(graph)
    mst = (mst + mst.T).tocsr()

    # spanning-forest parents (seeded at the topmost point of each
    # component), then flip flags as path-XOR of "neighbouring original
    # normals disagree" relations — vectorised pointer doubling instead of
    # a python walk (the relation is static: flip[v] = flip[parent] XOR
    # (n_parent·n_v < 0))
    parent = np.arange(n, dtype=np.int64)
    seen = np.zeros(n, bool)
    root_flip = np.zeros(n, np.int8)
    seed_order = np.argsort(-points[:, 2])
    for seed in seed_order:
        if seen[seed]:
            continue
        order, preds = breadth_first_order(mst, seed, directed=False,
                                           return_predecessors=True)
        seen[order] = True
        vs = order[1:]
        if len(vs):
            parent[vs] = preds[vs]
        root_flip[seed] = 1 if normals[seed, 2] < 0 else 0

    flag = np.zeros(n, np.int8)
    vs = np.flatnonzero(parent != np.arange(n))
    if len(vs):
        dots = np.sum(normals[parent[vs]] * normals[vs], axis=1)
        flag[vs] = (dots < 0).astype(np.int8)
    acc = flag.copy()  # per-node edge flag; the root's own flip folds in below
    ptr = parent.copy()
    for _ in range(64):
        nxt = ptr[ptr]
        if np.array_equal(nxt, ptr):
            break
        acc ^= acc[ptr]
        ptr = nxt
    # ptr now points at each node's root: fold in the root's own flip
    acc ^= root_flip[ptr]
    out = np.where(acc[:, None].astype(bool), -normals, normals)
    return out
