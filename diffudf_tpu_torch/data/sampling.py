"""Training batch sampling on the device: the torch copy of
``diffudf_tpu/data/sampling.py``.

Batch layout matches the reference contract (``src/dataset.py:54-70``):
rows = [on-surface | far-uniform | near-surface], normals zero off-surface,
sdf column = [0 | oracle(far) | oracle(near) or |near offset|].

  * far points: uniform in [-1,1]³.  Mesh input: GT = the unsigned
    point-triangle distance (the JAX package's documented deviation from
    the reference's signed one, ``dataset.py:35``; see ``sample``) through
    the coordinate-table oracle, or the exact bootstrap sweep before the
    table lands.  Point-cloud input: GT = the nearest-point distance through
    the candidate-grid oracle, or the exact sweep (K5 on the card) before it
    lands (``dataset.py:103``);
  * near points: surface point + normal · N(0, 0.01) (scalar per point);
    GT = the mesh oracle (mesh) or |offset| (``dataset.py:109-111``).

``TrainingSampler.sample`` draws from an explicit ``torch.Generator`` on the
sampler's device, so a step moves nothing between host and device, and the
draws do not depend on which oracle answers.  The random stream is torch's,
not ``jax.random``'s: the two packages draw other batches from the same
seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.timing import span
from .mesh_distance import (
    build_triangle_table,
    point_cloud_distance,
    point_cloud_distance_cells,
    point_triangle_distance_bootstrap,
    point_triangle_distance_table,
)


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


def _device_points(points, normals, device):
    return (torch.as_tensor(np.asarray(points, np.float32), device=device),
            torch.as_tensor(np.asarray(normals, np.float32), device=device))


@dataclasses.dataclass
class TrainingSampler:
    """Device-resident sampler; ``sample(gen)`` draws one batch.

    The tensors that are set pick the oracle: ``tri_table`` (the coordinate
    table of ``build_candidate_grid``'s candidate sets) or ``tri_verts``
    (the exact bootstrap sweep) for a mesh; ``pc_candidates`` (the point
    table) or neither (the exact sweep) for a cloud."""

    surface_points: torch.Tensor  # (N, 3) f32
    surface_normals: torch.Tensor  # (N, 3) f32
    sizes: BatchSizes
    pc_candidates: torch.Tensor | None = None  # (G³, K, 3) per-cell point table
    stddev: float = 0.01
    tri_verts: torch.Tensor | None = None  # (T, 3, 3)
    tri_table: torch.Tensor | None = None  # (G³, K·9) per-cell triangle coords

    @classmethod
    def from_point_cloud(cls, points, normals, batch_size, percentiles, stddev=0.01,
                         cache_path: str | None = None, device="cuda", cache_wait_s=0.0):
        """``cache_path`` (optional) caches the one-shot candidate-grid
        build on disk, keyed by the cloud bytes (:mod:`.oracle_cache`;
        ``cache_wait_s`` > 0: another process writes it)."""
        from .oracle_cache import cached_point_candidate_grid

        pts, nrm = _device_points(points, normals, device)
        table = cached_point_candidate_grid(points, cache_path, device=device,
                                            wait_s=cache_wait_s)
        return cls(pts, nrm, BatchSizes.from_config(batch_size, percentiles),
                   pc_candidates=table, stddev=stddev)

    @classmethod
    def from_point_cloud_bootstrap(cls, points, normals, batch_size, percentiles,
                                   stddev=0.01, device="cuda"):
        """Point-cloud sampler that is ready at once: the far oracle is the
        exact nearest-point sweep (:func:`.mesh_distance.point_cloud_distance`,
        one K5 launch a step on the card) until the candidate table is
        swapped in (:mod:`.async_build`)."""
        pts, nrm = _device_points(points, normals, device)
        return cls(pts, nrm, BatchSizes.from_config(batch_size, percentiles), stddev=stddev)

    @classmethod
    def from_mesh_bootstrap(cls, points, normals, tri_verts, batch_size, percentiles,
                            stddev=0.01, device="cuda"):
        """Mesh sampler that is ready at once, with no candidate-grid build:
        the oracle is the exact brute closest-point sweep in bounded blocks
        (:func:`.mesh_distance.point_triangle_distance_bootstrap`) while
        :mod:`.async_build` builds the grid on a host thread.  Exact, so
        when the swap lands changes the GT values only within the table
        oracle's near-exactness."""
        pts, nrm = _device_points(points, normals, device)
        return cls(pts, nrm, BatchSizes.from_config(batch_size, percentiles), stddev=stddev,
                   tri_verts=torch.as_tensor(np.asarray(tri_verts, np.float32), device=device))

    @classmethod
    def from_mesh(cls, points, normals, tri_verts, batch_size, percentiles, stddev=0.01,
                  cache_path: str | None = None, device="cuda", cache_wait_s=0.0):
        """The candidate grid as per-cell triangle *coordinates*
        (``build_triangle_table``): the per-step oracle is one contiguous
        row gather a query.

        ``cache_path`` (optional) caches the one-shot candidate-grid build
        on disk, keyed by the triangle bytes (:mod:`.oracle_cache`;
        ``cache_wait_s`` > 0: another process writes it)."""
        from .oracle_cache import cached_candidate_grid

        real = np.asarray(tri_verts, np.float32)
        cand = cached_candidate_grid(real, cache_path, device=device, wait_s=cache_wait_s)
        table = build_triangle_table(torch.as_tensor(real, device=device), cand)
        pts, nrm = _device_points(points, normals, device)
        return cls(pts, nrm, BatchSizes.from_config(batch_size, percentiles), stddev=stddev,
                   tri_table=table)

    @property
    def device(self) -> torch.device:
        return self.surface_points.device

    @property
    def oracle(self) -> str:
        """``"mesh"`` or ``"pointcloud"``, from the tensors that are set."""
        return "pointcloud" if self.tri_table is None and self.tri_verts is None else "mesh"

    def local(self, n_devices: int) -> "TrainingSampler":
        """Per-rank sampler for the data-parallel step: each rank draws its
        own ``batch/n_devices`` sub-batch in the same [surf|far|near]
        layout, so the single-device loss (the split Hessian and the fused
        kernels) runs unchanged on each rank.  Raises ValueError when a
        group does not divide."""
        sz = self.sizes
        for name, v in (("on_surface", sz.on_surface), ("far", sz.far), ("near", sz.near)):
            if v % n_devices:
                raise ValueError(
                    f"batch group {name}={v} not divisible by mesh size "
                    f"{n_devices}; pick batch_size/sampling_percentiles that "
                    f"split evenly"
                )
        return dataclasses.replace(self, sizes=BatchSizes(
            sz.on_surface // n_devices, sz.far // n_devices, sz.near // n_devices))

    def sample(self, gen: torch.Generator):
        """-> (points (B,3), normals (B,3), sdf (B,1)), B = sizes.total.
        The draws and gathers are the span ``sample.draw``, the oracle that
        answers ``sample.oracle``."""
        sz = self.sizes
        dev = self.device
        n_cloud = self.surface_points.shape[0]
        with span("sample.draw"):
            surf_idx = torch.randint(0, n_cloud, (sz.on_surface,), generator=gen, device=dev)
            surf_pts = self.surface_points[surf_idx]
            surf_nrm = self.surface_normals[surf_idx]

            far_pts = torch.rand((sz.far, 3), generator=gen, device=dev) * 2.0 - 1.0

            near_sel = torch.randint(0, sz.on_surface, (sz.near,), generator=gen, device=dev)
            offset = self.stddev * torch.randn((sz.near, 1), generator=gen, device=dev)
            near_pts = surf_pts[near_sel] + surf_nrm[near_sel] * offset

        with span("sample.oracle"):
            if self.oracle == "mesh":
                # UNSIGNED distance (the JAX package's documented deviation):
                # the reference feeds Open3D *signed* distances here
                # (dataset.py:35, 50), but no loss reads the sign: every
                # tanh-mode term is even in the GT distance and the siren
                # loss only tests d == 0.  So the oracle skips the
                # winding-number sweep.
                q = torch.cat([far_pts, near_pts], dim=0)
                if self.tri_table is not None:
                    both = point_triangle_distance_table(q, self.tri_table)
                else:
                    both = point_triangle_distance_bootstrap(q, self.tri_verts)
                far_sdf, near_sdf = both[:sz.far], both[sz.far:]
            elif self.pc_candidates is not None:
                far_sdf = point_cloud_distance_cells(far_pts, self.pc_candidates)
                near_sdf = torch.abs(offset)[:, 0]
            else:
                far_sdf = point_cloud_distance(far_pts, self.surface_points)
                near_sdf = torch.abs(offset)[:, 0]

        points = torch.cat([surf_pts, far_pts, near_pts], dim=0)
        normals = torch.cat(
            [surf_nrm, torch.zeros((sz.far + sz.near, 3), device=dev)], dim=0)
        sdf = torch.cat(
            [torch.zeros((sz.on_surface,), device=dev), far_sdf, near_sdf], dim=0)[:, None]
        return points, normals, sdf
