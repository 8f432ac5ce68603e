"""Triangulation backend dispatch for all extraction paths.

Two vectorised backends share one contract (compact active cells in,
shared-vertex mesh out):

  * ``"mc33"`` — table-driven marching cubes with asymptotic-decider
    ambiguity resolution (:mod:`.table_mc`); the rebuild's counterpart of
    the reference's native Lewiner MC33 triangulation.  Default.
  * ``"lewiner33"`` — reference-exact Lewiner tables with ``test_face``
    AND ``test_internal`` (tunnel) ambiguity resolution
    (:mod:`.lewiner_mc`), including the center-vertex tilings.
  * ``"tets"`` — marching tetrahedra (:mod:`.tet_mc`); simpler topology
    handling, ~2× triangle count, noisier triangle normals.  Kept for
    comparison.
"""

from __future__ import annotations

import numpy as np

from .lewiner_mc import lewiner_cells
from .table_mc import marching_cubes_cells
from .tet_mc import marching_tets_cells

TRIANGULATORS = {
    "mc33": marching_cubes_cells,
    "lewiner33": lewiner_cells,
    "tets": marching_tets_cells,
}

DEFAULT_TRIANGULATOR = "mc33"


def triangulate_cells(cell_origins, cell_values, spacing: float = 1.0,
                      method: str = DEFAULT_TRIANGULATOR):
    """-> (verts, faces) of the zero level set over compact cells."""
    try:
        fn = TRIANGULATORS[method]
    except KeyError:
        raise ValueError(
            f"Invalid triangulator {method!r}; expected one of "
            f"{tuple(TRIANGULATORS)}"
        ) from None
    return fn(np.asarray(cell_origins, np.float64),
              np.asarray(cell_values, np.float64), spacing)
