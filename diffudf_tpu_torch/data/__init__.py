"""Mesh and point-cloud I/O, normalisation, training samplers and the
distance oracles (the JAX package's ``data`` names)."""

from .mesh_distance import (
    point_cloud_distance,
    point_triangle_distance,
    signed_mesh_distance,
    winding_number,
)
from .mesh_io import Mesh, PointCloudData, load_mesh, load_point_cloud, save_mesh, save_point_cloud
from .normalize import normalize_mesh, normalize_point_cloud
from .sampling import TrainingSampler, sample_surface_points

__all__ = [
    "Mesh",
    "PointCloudData",
    "load_mesh",
    "save_mesh",
    "load_point_cloud",
    "save_point_cloud",
    "normalize_mesh",
    "normalize_point_cloud",
    "sample_surface_points",
    "TrainingSampler",
    "point_cloud_distance",
    "point_triangle_distance",
    "winding_number",
    "signed_mesh_distance",
]
