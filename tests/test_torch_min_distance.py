"""Port parity: the brute nearest-point distance (K5's plain version and
``point_cloud_distance``) and the brute triangle sweep of
``diffudf_tpu_torch`` against the JAX package, on the same numpy inputs."""

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffudf_tpu.ops.pallas_distance as pdist
from diffudf_tpu.data import mesh_distance as jmd
from diffudf_tpu_torch.data import mesh_distance as tmd
from diffudf_tpu_torch.grid.slices import plane_samples
from diffudf_tpu_torch.ops import min_distance as k5

torch.set_num_threads(2)


@pytest.fixture
def interp(monkeypatch):
    """The Pallas kernel in interpret mode, as tests/test_pallas.py runs it."""
    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pdist.pl, "pallas_call", interp_call)


def _torus_cloud(m, rng, big=0.55, small=0.22):
    """m points on a torus about the x axis, so the x=0 plane cuts it."""
    u, v = rng.uniform(0, 2 * np.pi, (2, m))
    ring = big + small * np.cos(v)
    return np.stack([small * np.sin(v), ring * np.cos(u), ring * np.sin(u)], 1).astype(np.float32)


# (queries, cloud points): the Pallas test's 300 x 3000, Q = 1, Q not a
# multiple of K5's 512-query tile, M below and not a multiple of its
# 2048-point chunk
SHAPES = [(300, 3000), (1, 3000), (513, 2049), (700, 1000)]


@pytest.mark.parametrize("n,m", SHAPES)
def test_plain_version_matches_the_pallas_kernel(interp, n, m):
    """1e-4: tests/test_pallas.py::TestPallasDistance's tolerance for K5."""
    rng = np.random.default_rng(0)
    cloud = rng.normal(size=(m, 3)).astype(np.float32)
    q = rng.normal(size=(n, 3)).astype(np.float32)
    want = np.asarray(pdist.min_distance_pallas(q, cloud))
    got = k5.min_distance_reference(torch.as_tensor(q), torch.as_tensor(cloud))
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_wrapper_on_the_cpu_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.normal(size=(257, 3)), dtype=torch.float32)
    cloud = torch.as_tensor(rng.normal(size=(999, 3)), dtype=torch.float32)
    before = (k5.launches, k5.queries)
    assert torch.equal(k5.min_distance(q, cloud), k5.min_distance_reference(q, cloud))
    assert (k5.launches, k5.queries) == before
    exact = np.sqrt(((q.double().numpy()[:, None] - cloud.double().numpy()[None]) ** 2)
                    .sum(-1)).min(1)
    np.testing.assert_allclose(k5.min_distance_reference(q.double(), cloud.double()).numpy(),
                               exact, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="empty"):
        k5.min_distance(q, cloud[:0])
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        k5.min_distance(q[:, :2], cloud)


def test_point_cloud_distance_matches_jax_near_the_surface():
    """The slice figure's plane queries (width 64) nearest a torus cloud,
    where the expanded form cancels: the port's CPU path and K5's plain
    version against the JAX function at 1e-5, and against float64 brute
    force."""
    cloud = _torus_cloud(8000, np.random.default_rng(2))
    q = plane_samples(64)
    want = np.asarray(jmd.point_cloud_distance(jnp.asarray(q), jnp.asarray(cloud)))
    tq, tc = torch.as_tensor(q), torch.as_tensor(cloud)
    got = tmd.point_cloud_distance(tq, tc)
    plain = k5.min_distance_reference(tq, tc)
    exact = k5.min_distance_reference(tq.double(), tc.double()).numpy()
    near = exact < 0.02
    assert near.sum() > 50  # the plane cuts the surface
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-5)


def _box_mesh():
    """A closed unit box, 12 triangles, and an open fan of 6."""
    v = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)])
    f = [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
         [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]]
    ang = np.linspace(0, 2 * np.pi, 7)[:-1]
    fan = np.stack([0.8 * np.cos(ang), 0.8 * np.sin(ang), np.full(6, 0.7)], 1)
    v = np.concatenate([v, [[0.0, 0.0, 0.75]], fan])
    f += [[8, 9 + i, 9 + (i + 1) % 6] for i in range(6)]
    return v.astype(np.float32), np.array(f)


def test_point_triangle_distance_matches_jax():
    """Every Voronoi region (vertex, edge, face) of box and fan triangles,
    on queries inside, outside and near the surfaces: 1e-5."""
    v, f = _box_mesh()
    q = np.random.default_rng(3).uniform(-1.2, 1.2, (1500, 3)).astype(np.float32)
    want = np.asarray(jmd.point_triangle_distance(jnp.asarray(q),
                                                  jmd.triangles_from_mesh(v, f)))
    tris = tmd.triangles_from_mesh(v, f, device="cpu")
    np.testing.assert_array_equal(tris.numpy(), np.asarray(jmd.triangles_from_mesh(v, f)))
    got = tmd.point_triangle_distance(torch.as_tensor(q), tris)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
