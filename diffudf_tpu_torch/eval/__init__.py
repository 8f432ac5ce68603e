"""Chamfer / normal-consistency evaluation (the JAX package's ``eval``
names)."""

from .chamfer import chamfer_distance, nearest_neighbor

__all__ = ["chamfer_distance", "nearest_neighbor"]
