"""Field-guided refinement of extracted mesh vertices: the torch counterpart
of ``diffudf_tpu/extract/refine.py``.

Marching-cubes vertices are linear interpolations on a voxel lattice: even
with exact corner values they carry O(voxel) staircase noise.  Projecting
each vertex onto the zero set with the point-cloud sampler's step
(``x ← x − inverse(|f|)·∇̂f``, reference ``src/render_pc.py:43-53``) removes
most of it.  This is a refinement the reference does not perform; it is
opt-in from ``generate_mc`` (config key ``refine_vertices``, the
``enhanced`` preset).  Topology is untouched, and a trust region bounds
each vertex to a fraction of a voxel so triangles cannot collapse or fold.

Each step's (f, ∇f) is one launch of K3a on the GPU for a net the kernels
take, the plain version otherwise (:func:`..ops.evaluate.field_fns`).  The
JAX package pads the vertices to a power-of-4 bucket to bound its XLA
compiles; the rows are independent and K3a masks its ragged last tile, so
the port sends them as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.siren import SirenSpec
from ..fields.transforms import inverse_map
from ..ops.evaluate import field_fns, unit


@torch.no_grad()
def refine_vertices(
    params,
    spec: SirenSpec,
    verts: np.ndarray,
    *,
    gt_mode: str,
    alpha: float,
    N: int,
    steps: int = 2,
    max_move_voxels: float = 0.5,
    vg_fn=None,
) -> np.ndarray:
    """Project mesh vertices onto the field's zero set (bounded move).

    verts: (V, 3) in [-1, 1]³ from an N³ extraction.  Each of ``steps``
    steps moves a vertex at most ``max_move = max_move_voxels · 2/(N−1)``,
    and the total displacement is capped at ``max_move``.  Runs on the
    params' device, in their dtype (float32; float64 params give a float64
    witness of the same steps); ``vg_fn`` (default
    :func:`..ops.evaluate.field_fns`) computes (f, ∇f).  Returns the refined
    vertices as numpy; faces are unchanged by construction.
    """
    if len(verts) == 0 or steps <= 0:
        return verts
    vg_fn = vg_fn or field_fns(spec)[0]
    voxel = 2.0 / (N - 1)
    max_move = float(np.float32(max_move_voxels * voxel))
    w = params[0]["w"]
    x0 = torch.as_tensor(np.ascontiguousarray(verts, np.float32), device=w.device).to(w.dtype)
    x = x0
    for _ in range(steps):
        f, g = vg_fn(params, spec, x)
        d = inverse_map(gt_mode, torch.abs(f), alpha, min_step=0.0)
        # per-step trust region: never move more than the budget
        x = x - torch.clamp(d, max=max_move)[:, None] * unit(g)
    # global trust region: total displacement capped at max_move
    delta = x - x0
    norm = torch.linalg.norm(delta, dim=-1, keepdim=True)
    scale = torch.clamp(max_move / torch.clamp(norm, min=1e-12), max=1.0)
    return (x0 + delta * scale).cpu().numpy()
