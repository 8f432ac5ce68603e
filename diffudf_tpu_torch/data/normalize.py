"""Normalisation of meshes / point clouds into the side-2 training cube.

A copy of ``diffudf_tpu/data/normalize.py``.  Matches the reference
transform exactly (``src/preprocess_mesh.py:5-27``):
translate the centroid to the origin, then scale uniformly by
1 / (max_abs_coord · 1.1) so the shape fits in [-1, 1]³ with a 10% margin.
Returns the combined 4×4 transform S·T so callers can map results back.
"""

from __future__ import annotations

import numpy as np

from .mesh_io import Mesh, PointCloudData


def _normalize_transform(points: np.ndarray) -> np.ndarray:
    center = points.mean(axis=0)
    T = np.eye(4)
    T[:3, 3] = -center
    max_coord = np.abs(points - center).max()
    s = 1.0 / (max_coord + max_coord * 0.1)
    S = np.eye(4)
    S[0, 0] = S[1, 1] = S[2, 2] = s
    return S @ T


def normalize_mesh(mesh: Mesh):
    """Returns (normalized_mesh, transform_4x4)."""
    T = _normalize_transform(mesh.vertices)
    return mesh.transform(T), T


def normalize_point_cloud(pc: PointCloudData):
    """Returns (normalized_pc, transform_4x4)."""
    T = _normalize_transform(pc.points)
    return pc.transform(T), T
