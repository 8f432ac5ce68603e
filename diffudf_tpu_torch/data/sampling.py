"""Training batch sampling on the device: the point-cloud part of
``diffudf_tpu/data/sampling.py``.

Batch layout matches the reference contract (``src/dataset.py:54-70``):
rows = [on-surface | far-uniform | near-surface], normals zero off-surface,
sdf column = [0 | oracle(far) | |near offset|].

  * far points: uniform in [-1,1]³, GT = nearest-point distance through the
    candidate-grid oracle (:mod:`.mesh_distance`, ``dataset.py:103``);
  * near points: surface point + normal · N(0, 0.01) (scalar per point);
    GT = |offset| (``dataset.py:109-111``).

``TrainingSampler.sample`` draws from an explicit ``torch.Generator`` on the
sampler's device, so a step moves nothing between host and device.  The
random stream is torch's, not ``jax.random``'s: the two packages draw other
batches from the same seed.  The mesh-input oracle and the overlapped
oracle build are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mesh_distance import point_cloud_distance_cells


def sample_surface_points(mesh, n: int, seed: int = 123):
    """Host-side area-weighted uniform surface sampling with triangle normals.

    Open3D ``sample_points_uniformly(use_triangle_normal=True)`` analogue
    (``src/preprocess_mesh.py:39``). Returns (points (n,3), normals (n,3)).
    The numpy stream of the JAX package's, so the same seed gives the same
    points."""
    rng = np.random.default_rng(seed)
    areas, tri_normals = mesh.face_areas_normals()
    probs = areas / areas.sum()
    tri_idx = rng.choice(len(probs), size=n, p=probs)
    v = mesh.vertices[mesh.faces[tri_idx]]  # (n, 3, 3)
    u1 = rng.random(n)
    u2 = rng.random(n)
    flip = u1 + u2 > 1
    u1 = np.where(flip, 1 - u1, u1)
    u2 = np.where(flip, 1 - u2, u2)
    pts = v[:, 0] + u1[:, None] * (v[:, 1] - v[:, 0]) + u2[:, None] * (v[:, 2] - v[:, 0])
    return pts, tri_normals[tri_idx]


@dataclasses.dataclass(frozen=True)
class BatchSizes:
    on_surface: int
    far: int
    near: int

    @property
    def total(self) -> int:
        return self.on_surface + self.far + self.near

    @classmethod
    def from_config(cls, batch_size: int, percentiles) -> "BatchSizes":
        """Reference split (``src/dataset.py:161-163,27-28``):
        on = int(B·p0); off = int(B·p1); far = off//2; near = off - far."""
        on = int(batch_size * percentiles[0])
        off = int(batch_size * percentiles[1])
        return cls(on_surface=on, far=off // 2, near=off - off // 2)


@dataclasses.dataclass
class TrainingSampler:
    """Device-resident point-cloud sampler; ``sample(gen)`` draws one batch."""

    surface_points: torch.Tensor  # (N, 3) f32
    surface_normals: torch.Tensor  # (N, 3) f32
    sizes: BatchSizes
    pc_candidates: torch.Tensor  # (G³, K, 3) per-cell point table
    stddev: float = 0.01

    @classmethod
    def from_point_cloud(cls, points, normals, batch_size, percentiles, stddev=0.01,
                         cache_path: str | None = None, device="cuda"):
        """``cache_path`` (optional) caches the one-shot candidate-grid
        build on disk, keyed by the cloud bytes (:mod:`.oracle_cache`)."""
        from .oracle_cache import cached_point_candidate_grid

        return cls(
            surface_points=torch.as_tensor(np.asarray(points, np.float32), device=device),
            surface_normals=torch.as_tensor(np.asarray(normals, np.float32), device=device),
            sizes=BatchSizes.from_config(batch_size, percentiles),
            pc_candidates=cached_point_candidate_grid(points, cache_path, device=device),
            stddev=stddev,
        )

    @property
    def device(self) -> torch.device:
        return self.surface_points.device

    def sample(self, gen: torch.Generator):
        """-> (points (B,3), normals (B,3), sdf (B,1)), B = sizes.total."""
        sz = self.sizes
        dev = self.device
        n_cloud = self.surface_points.shape[0]
        surf_idx = torch.randint(0, n_cloud, (sz.on_surface,), generator=gen, device=dev)
        surf_pts = self.surface_points[surf_idx]
        surf_nrm = self.surface_normals[surf_idx]

        far_pts = torch.rand((sz.far, 3), generator=gen, device=dev) * 2.0 - 1.0

        near_sel = torch.randint(0, sz.on_surface, (sz.near,), generator=gen, device=dev)
        offset = self.stddev * torch.randn((sz.near, 1), generator=gen, device=dev)
        near_pts = surf_pts[near_sel] + surf_nrm[near_sel] * offset

        far_sdf = point_cloud_distance_cells(far_pts, self.pc_candidates)
        near_sdf = torch.abs(offset)[:, 0]

        points = torch.cat([surf_pts, far_pts, near_pts], dim=0)
        normals = torch.cat(
            [surf_nrm, torch.zeros((sz.far + sz.near, 3), device=dev)], dim=0)
        sdf = torch.cat(
            [torch.zeros((sz.on_surface,), device=dev), far_sdf, near_sdf], dim=0)[:, None]
        return points, normals, sdf
