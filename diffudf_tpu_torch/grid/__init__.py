"""The extraction lattice and its field passes (the JAX package's
``grid`` names)."""

from .lattice import extract_fields, extract_fields_sparse, lattice_points

__all__ = ["lattice_points", "extract_fields", "extract_fields_sparse"]
