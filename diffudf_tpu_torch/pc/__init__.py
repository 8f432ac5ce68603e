from .sampler import generate_point_cloud, orient_normals_consistent

__all__ = ["generate_point_cloud", "orient_normals_consistent"]
