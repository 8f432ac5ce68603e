"""Port parity: the point-cloud data path of ``diffudf_tpu_torch`` (PLY IO,
normalisation, preprocessing, the candidate-grid oracle, its disk cache and
the training sampler) against the JAX package."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from diffudf_tpu.cli import preprocess as jpre
from diffudf_tpu.data import mesh_distance as jmd
from diffudf_tpu.data import normalize as jnorm
from diffudf_tpu.data import oracle_cache as joc
from diffudf_tpu_torch.cli import preprocess as tpre
from diffudf_tpu_torch.data import mesh_distance as tmd
from diffudf_tpu_torch.data import normalize as tnorm
from diffudf_tpu_torch.data import oracle_cache as toc
from diffudf_tpu_torch.data.mesh_io import PointCloudData
from diffudf_tpu_torch.data.sampling import BatchSizes, TrainingSampler

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    """A 20,000-point cloud on the sphere |x| = 0.7 with its normals, and a
    candidate-index cache written by the JAX package."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=(20000, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    cache = str(tmp_path_factory.mktemp("oracle") / "sphere_oracle_cache.npz")
    cloud = (0.7 * u).astype(np.float32)
    idx = joc.cached_point_candidate_idx_host(cloud, cache)
    return cloud, u.astype(np.float32), cache, idx


def test_preprocess_writes_the_jax_bytes(tmp_path):
    src = os.path.join(REPO, "data", "demo", "torus.obj")
    tpre.preprocess_mesh(str(tmp_path / "port"), src, 2000)
    jpre.preprocess_mesh(str(tmp_path / "jax"), src, 2000)
    for name in ("torus_pc.ply", "torus_t.obj"):
        with open(tmp_path / "port" / name, "rb") as a, open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
    # point-cloud input (-pc): the subsampled cloud and the normalised copy
    tpre.preprocess_point_cloud(str(tmp_path / "port_pc"), str(tmp_path / "port" / "torus_pc.ply"), 500)
    jpre.preprocess_point_cloud(str(tmp_path / "jax_pc"), str(tmp_path / "jax" / "torus_pc.ply"), 500)
    for name in ("torus_pc_pc.ply", "torus_pc_t.ply"):
        with open(tmp_path / "port_pc" / name, "rb") as a, open(tmp_path / "jax_pc" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_normalize_matches_jax():
    pts = np.random.default_rng(1).normal(size=(300, 3)) * [1, 2, 3] + 5
    got, t_got = tnorm.normalize_point_cloud(PointCloudData(pts, None))
    from diffudf_tpu.data.mesh_io import PointCloudData as JPC

    want, t_want = jnorm.normalize_point_cloud(JPC(pts, None))
    np.testing.assert_array_equal(t_got, t_want)
    np.testing.assert_array_equal(got.points, want.points)


def test_oracle_cache_is_shared_with_jax(sphere, tmp_path):
    """Same key function and file layout: the JAX package's cache file
    serves the port (and the key of the same cloud is equal in both)."""
    cloud, _, cache, idx = sphere
    args = ("pc", cloud, tmd.CAND_GRID_G, tmd.CAND_PTS_K, tmd.CAND_GRID_LO, tmd.CAND_GRID_HI)
    assert toc._key(*args) == joc._key(*args)
    assert os.path.exists(cache + ".pc_cand.npz")
    np.testing.assert_array_equal(toc.cached_point_candidate_idx_host(cloud, cache), idx)
    # a changed cloud misses the cache and is rebuilt, not served stale
    moved = cloud + np.float32(1e-3)
    assert toc._key("pc", moved, *args[2:]) != toc._key(*args)


def test_point_cloud_distance_cells_matches_jax_and_kdtree(sphere):
    cloud, _, _, idx = sphere
    rng = np.random.default_rng(2)
    far = rng.uniform(-1, 1, size=(2000, 3)).astype(np.float32)
    near = (cloud[rng.integers(0, len(cloud), 2000)]
            + 0.01 * rng.normal(size=(2000, 3))).astype(np.float32)
    q = np.concatenate([far, near])
    table = cloud[idx]
    got = tmd.point_cloud_distance_cells(torch.from_numpy(q), torch.from_numpy(table)).numpy()
    want = np.asarray(jmd.point_cloud_distance_cells(jnp.asarray(q), jnp.asarray(table)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    # exact nearest-point distances on the near-surface rows (the table's
    # guarantee; far rows are exact on their candidates only)
    exact, _ = cKDTree(cloud).query(q[2000:])
    np.testing.assert_allclose(got[2000:], exact, rtol=0, atol=1e-6)


def test_sampler_rows_follow_the_reference_layout(sphere):
    cloud, normals, cache, _ = sphere
    sampler = TrainingSampler.from_point_cloud(cloud, normals, 3000, (0.333, 0.666),
                                               cache_path=cache, device="cpu")
    sz = sampler.sizes
    assert sz == BatchSizes.from_config(3000, (0.333, 0.666)) == BatchSizes(999, 999, 999)
    gen = torch.Generator().manual_seed(5)
    replay = torch.Generator().manual_seed(5)
    pts, nrm, sdf = sampler.sample(gen)
    assert pts.shape == nrm.shape == (sz.total, 3) and sdf.shape == (sz.total, 1)
    sdf = sdf[:, 0]
    on, far = slice(0, sz.on_surface), slice(sz.on_surface, sz.on_surface + sz.far)
    near = slice(sz.on_surface + sz.far, sz.total)
    assert torch.all(sdf[on] == 0) and torch.all(nrm[sz.on_surface:] == 0)
    assert torch.all(nrm[on].norm(dim=1) > 0.99)
    assert torch.all(pts[far].abs() <= 1)
    # far rows: never nearer than the true sphere, within the cloud spacing
    r = pts[far].norm(dim=1)
    assert torch.all(sdf[far] >= (r - 0.7).abs() - 1e-5)
    assert torch.all(sdf[far] <= (r - 0.7).abs() + 0.05)
    # near rows: the draws replayed give base + normal * offset and |offset|
    torch.randint(0, len(cloud), (sz.on_surface,), generator=replay)
    torch.rand((sz.far, 3), generator=replay)
    sel = torch.randint(0, sz.on_surface, (sz.near,), generator=replay)
    offset = 0.01 * torch.randn((sz.near, 1), generator=replay)
    assert torch.equal(sdf[near], offset.abs()[:, 0])
    assert torch.equal(pts[near], pts[on][sel] + nrm[on][sel] * offset)
