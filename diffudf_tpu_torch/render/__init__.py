"""Sphere-traced rendering: cameras, the march and shading (the JAX
package's ``render`` names)."""

from .camera import cube_entry_points, look_at_rotation, pixel_rays
from .shading import phong_shading, ward_reflectance
from .tracer import hit_attributes, trace_rays

__all__ = [
    "pixel_rays",
    "look_at_rotation",
    "cube_entry_points",
    "trace_rays",
    "hit_attributes",
    "phong_shading",
    "ward_reflectance",
]
