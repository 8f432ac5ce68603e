"""Signed-field marching cubes baseline (gt_mode='siren' path).

Replaces the reference's skimage ``marching_cubes`` at level 0
(``src/render_mc.py:314-406``) with the shared vectorised triangulation
backends: active cells = sign changes in the raw field.
"""

from __future__ import annotations

import numpy as np

from .cap import _corner_views
from .triangulate import DEFAULT_TRIANGULATOR, triangulate_cells


def extract_mesh_signed(sdf, level: float = 0.0, origin: float = -1.0, extent: float = 2.0,
                        triangulator: str = DEFAULT_TRIANGULATOR):
    """-> (verts, faces) of the ``sdf == level`` surface.

    sdf: (N, N, N) signed field on the standard lattice.
    """
    sdf = np.asarray(sdf, dtype=np.float32) - level
    N = sdf.shape[0]
    uc = _corner_views(sdf)
    cmin = np.minimum.reduce(uc)
    cmax = np.maximum.reduce(uc)
    active = (cmin < 0) & (cmax >= 0)
    idx = np.argwhere(active)
    if len(idx) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    ii, jj, kk = idx[:, 0], idx[:, 1], idx[:, 2]
    vals = np.stack([c[ii, jj, kk] for c in uc], axis=1)
    spacing = extent / (N - 1)
    verts, faces = triangulate_cells(idx, vals, spacing, triangulator)
    return verts + origin, faces
