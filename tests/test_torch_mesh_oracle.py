"""Port parity: the mesh-input oracle of ``diffudf_tpu_torch`` (the candidate
grid, the table, cells, pruned and bootstrap oracles, the ``tri_cand`` disk
cache, the mesh sampler, the overlapped build and the trainer's sampler
swap, the mesh branches of the CLIs and the GT-mesh render trace) against
the JAX package on shared numpy inputs.

Distances are held at atol 1e-5, the tolerance of the JAX package's own
``tests/test_data.py::test_candidate_grid_*``.  Grids are built at a coarse
lattice (``G``) where a test does not need the module's g = 48, to keep the
host builds cheap."""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffudf_tpu.cli import generate_st as jst
from diffudf_tpu.data import mesh_distance as jmd
from diffudf_tpu.data import oracle_cache as joc
from diffudf_tpu_torch import config as tcfg
from diffudf_tpu_torch.cli import generate_st as tst
from diffudf_tpu_torch.cli import preprocess as tpre
from diffudf_tpu_torch.cli import quantitative as tquant
from diffudf_tpu_torch.cli import train as tcli
from diffudf_tpu_torch.data import async_build as tab
from diffudf_tpu_torch.data import mesh_distance as tmd
from diffudf_tpu_torch.data import oracle_cache as toc
from diffudf_tpu_torch.data.mesh_io import Mesh, load_mesh, save_mesh
from diffudf_tpu_torch.data.sampling import BatchSizes, TrainingSampler, sample_surface_points
from diffudf_tpu_torch.fields.siren import SirenSpec
from diffudf_tpu_torch.render.camera import cube_entry_points, world_rays
from diffudf_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
G = 24  # the test lattice: 13,824 cells of 0.09 (the module's g = 48: 110,592)
# The oracle-cache key of the port's preprocessed data/demo/trefoil.obj, as
# stored in the committed data/demo/trefoil_oracle_cache.npz.tri_cand.npz.
TREFOIL_KEY = "31def3cbe536a91a8b0efa7da4db4c7c6568d3a7"


def torus_mesh(nu, nv):
    """The torus shell of tests/test_data.py (radii 0.6 and 0.25) at nu x nv
    quads, two triangles a quad."""
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = np.stack([(0.6 + 0.25 * np.cos(vv)) * np.cos(uu),
                      (0.6 + 0.25 * np.cos(vv)) * np.sin(uu), 0.25 * np.sin(vv)],
                     -1).reshape(-1, 3)
    faces = []
    for i in range(nu):
        for j in range(nv):
            a, b = i * nv + j, ((i + 1) % nu) * nv + j
            c, d = ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv
            faces += [[a, b, c], [a, c, d]]
    return Mesh(verts, np.asarray(faces))


def cube_mesh(half=0.5):
    """The axis-aligned cube |x|_inf = half, 12 triangles."""
    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half) for z in (-half, half)])
    f = [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
         [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]]
    return Mesh(v, np.asarray(f))


def soup(rng, n=1500, spread=0.03):
    """A fine random triangle soup, the regime of a preprocessed mesh."""
    base = rng.uniform(-0.9, 0.9, size=(n, 3))
    e1, e2 = rng.normal(size=(2, n, 3)) * spread
    return np.stack([base, base + e1, base + e2], axis=1).astype(np.float32)


def cube_distance(x, half=0.5):
    """Exact unsigned distance to the cube's surface."""
    a = np.abs(x)
    outside = np.linalg.norm(np.maximum(a - half, 0.0), axis=1)
    inside = half - a.max(axis=1)
    return np.where((a <= half).all(axis=1), inside, outside)


@pytest.fixture(scope="module")
def torus():
    """The 48 x 24 torus shell (2,304 triangles), training-like queries
    (uniform far and near-surface offsets) and the port's grid at G."""
    m = torus_mesh(48, 24)
    tris = m.vertices[m.faces].astype(np.float32)
    rng = np.random.default_rng(0)
    far = rng.uniform(-1, 1, size=(400, 3))
    near = m.vertices[rng.integers(0, len(m.vertices), 400)] + 0.01 * rng.normal(size=(400, 3))
    q = np.concatenate([far, near]).astype(np.float32)
    cand = tmd.build_candidate_grid(tris, g=G)
    brute = tmd.point_triangle_distance(torch.from_numpy(q), torch.from_numpy(tris)).numpy()
    return tris, q, cand, brute


@pytest.mark.parametrize("shape", ["soup", "torus", "cube"])
def test_candidate_grid_matches_jax(shape, torus):
    """The same candidate set in every cell as the JAX build, on a fine
    soup, the torus shell and a mesh of fewer triangles than k."""
    if shape == "soup":
        tris = soup(np.random.default_rng(1))
    elif shape == "torus":
        tris = torus[0]
    else:
        m = cube_mesh()
        tris = m.vertices[m.faces].astype(np.float32)
    got = tmd.build_candidate_grid(tris, g=12)
    want = jmd.build_candidate_grid(jnp.asarray(tris), g=12, as_numpy=True)
    assert got.dtype == np.int32 and got.shape == want.shape == (12 ** 3, tmd.CAND_GRID_K)
    np.testing.assert_array_equal(np.sort(got, axis=1), np.sort(want, axis=1))


@pytest.mark.parametrize("oracle", ["table", "pruned", "bootstrap"])
def test_mesh_oracles_match_jax_and_brute_force(oracle, torus):
    """Each training oracle against the JAX function on the same inputs and
    against the brute sweep.  The bootstrap runs in blocks of 100 queries x
    1,000 triangles (2,304 is no multiple of the slab): its running min
    gives the brute sweep's values bit for bit (the brute sweep is held to
    the JAX function in tests/test_torch_min_distance.py)."""
    tris, q, cand, brute = torus
    tq, tt = torch.from_numpy(q), torch.from_numpy(tris)
    jq, jt = jnp.asarray(q), jnp.asarray(tris)
    if oracle == "table":
        table = tmd.build_triangle_table(tt, cand)
        assert table.shape == (G ** 3, 9 * tmd.CAND_GRID_K)
        got = tmd.point_triangle_distance_table(tq, table, g=G).numpy()
        want = jmd.point_triangle_distance_table(jq, jmd.build_triangle_table(jt, jnp.asarray(cand)),
                                                 g=G)
    elif oracle == "pruned":
        got = tmd.point_triangle_distance_pruned(tq, tt, tile=256).numpy()
        want = jmd.point_triangle_distance_pruned(jq, jt, tile=256)
    else:
        got = tmd.point_triangle_distance(tq, tt, tile=100, slab=1000).numpy()
        np.testing.assert_array_equal(got, brute)
        return
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, brute, rtol=0, atol=ATOL)


def test_committed_trefoil_cache_serves_the_port(tmp_path, monkeypatch):
    """The port's preprocessed trefoil has the key of the committed
    tri_cand file, which serves it unchanged: the build is made to raise."""
    tpre.preprocess_mesh(str(tmp_path), os.path.join(REPO, "data", "demo", "trefoil.obj"), 100)
    m = load_mesh(str(tmp_path / "trefoil_t.obj"))
    tris = np.asarray(m.vertices[m.faces], np.float32)
    key = toc._key("tri", tris, tmd.CAND_GRID_G, tmd.CAND_GRID_K, tmd.CAND_GRID_LO,
                   tmd.CAND_GRID_HI)
    assert key == TREFOIL_KEY

    def no_build(*a, **k):
        raise AssertionError("the committed cache was not used")

    monkeypatch.setattr(toc.md, "build_candidate_grid", no_build)
    cand = toc.cached_candidate_grid_host(
        tris, os.path.join(REPO, "data", "demo", "trefoil_oracle_cache.npz"))
    assert cand.dtype == np.int32 and cand.shape == (tmd.CAND_GRID_G ** 3, tmd.CAND_GRID_K)
    assert cand.min() >= 0 and cand.max() < len(tris)


def test_tri_cache_is_shared_with_jax(tmp_path, monkeypatch):
    """A tri_cand file written by either package is read by the other (the
    reader's build is made to raise), and the keys agree."""
    m = cube_mesh()
    tris = m.vertices[m.faces].astype(np.float32)
    args = ("tri", tris, tmd.CAND_GRID_G, tmd.CAND_GRID_K, tmd.CAND_GRID_LO, tmd.CAND_GRID_HI)
    assert toc._key(*args) == joc._key(*args)
    by_jax, by_port = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    want = joc.cached_candidate_grid_host(tris, by_jax)
    got = toc.cached_candidate_grid_host(tris, by_port)
    np.testing.assert_array_equal(got, want)

    def no_build(*a, **k):
        raise AssertionError("rebuilt instead of reading the cache")

    monkeypatch.setattr(toc.md, "build_candidate_grid", no_build)
    monkeypatch.setattr(joc.md, "build_candidate_grid", no_build)
    np.testing.assert_array_equal(toc.cached_candidate_grid_host(tris, by_jax), want)
    np.testing.assert_array_equal(joc.cached_candidate_grid_host(tris, by_port), got)
    moved = tris + np.float32(1e-3)  # a changed mesh misses the cache
    with pytest.raises(AssertionError, match="rebuilt"):
        toc.cached_candidate_grid_host(moved, by_port)


@pytest.fixture(scope="module")
def cube():
    """The cube mesh, 3,000 surface samples with their normals, and its
    triangles."""
    m = cube_mesh()
    pts, nrm = sample_surface_points(m, 3000, seed=0)
    return pts.astype(np.float32), nrm.astype(np.float32), m.vertices[m.faces].astype(np.float32)


def test_mesh_sampler_rows_and_exact_unsigned_gt(cube):
    """Both mesh oracles (table, bootstrap) draw the same batch
    from one generator state, in the reference's row layout, with the exact
    unsigned distance to the cube's surface on the far and near rows."""
    pts, nrm, tris = cube
    args = (pts, nrm, tris, 3000, (0.333, 0.666))
    samplers = {
        "table": TrainingSampler.from_mesh(*args, device="cpu"),
        "bootstrap": TrainingSampler.from_mesh_bootstrap(*args, device="cpu"),
    }
    batches = {k: s.sample(torch.Generator().manual_seed(3)) for k, s in samplers.items()}
    sz = samplers["table"].sizes
    assert sz == BatchSizes(999, 999, 999)
    p, n, sdf = batches["table"]
    assert p.shape == n.shape == (sz.total, 3) and sdf.shape == (sz.total, 1)
    assert torch.all(sdf[:sz.on_surface] == 0) and torch.all(n[sz.on_surface:] == 0)
    assert torch.all(p[sz.on_surface:sz.on_surface + sz.far].abs() <= 1)
    exact = cube_distance(p.numpy().astype(np.float64))[sz.on_surface:]
    for name, (pb, nb, sb) in batches.items():
        assert torch.equal(pb, p) and torch.equal(nb, n), name
        np.testing.assert_allclose(sb[sz.on_surface:, 0].numpy(), exact, rtol=0, atol=ATOL)
        assert torch.all(sb >= 0)


class Recorder:
    """A sampler that logs each batch it draws."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log
        self.sizes, self.device = inner.sizes, inner.device

    def sample(self, gen):
        out = self.inner.sample(gen)
        self.log.append(out)
        return out


def test_trainer_swaps_at_the_third_poll_and_draws_the_same_points(cube):
    """An update that arrives at the third poll swaps before epoch 2; the
    batches are those of a run without the swap, the GT within ATOL."""
    pts, nrm, tris = cube
    args = (pts, nrm, tris, 300, (0.333, 0.666))
    boot = TrainingSampler.from_mesh_bootstrap(*args, device="cpu")
    table = TrainingSampler.from_mesh(*args, device="cpu")
    cfg = tcfg.TrainConfig.from_dict({
        "dataset": "unused", "num_epochs": 4, "s1_epochs": 4, "warmup_epochs": 1,
        "batch_size": 300, "gt_mode": "tanh", "alpha": 10, "onlyPCloud": False,
        "network": {"hidden_layer_nodes": [32, 32, 32], "w0": 30}})
    spec = SirenSpec(hidden=(32, 32, 32))
    runs = {}
    for name in ("swap", "none"):
        log = []
        polls = iter([None, None, Recorder(table, log)] if name == "swap" else [])
        trainer = Trainer(spec, Recorder(boot, log), cfg)
        _, losses, _ = trainer.run(sampler_update=lambda: next(polls, None))
        assert np.isfinite(losses["total"]).all()
        runs[name] = (log, trainer.last_swap_epoch)
    assert runs["swap"][1] == 2 and runs["none"][1] is None
    for (p, n, s), (pn, nn, sn) in zip(runs["swap"][0], runs["none"][0]):
        assert torch.equal(p, pn) and torch.equal(n, nn)
        np.testing.assert_allclose(s.numpy(), sn.numpy(), rtol=0, atol=ATOL)
    assert len(runs["swap"][0]) == 4


def test_failed_build_warns_and_training_degrades(cube, monkeypatch):
    """A build that raises: one RuntimeWarning, no handover, and training
    finishes on the bootstrap oracle."""
    pts, nrm, tris = cube

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tab, "cached_candidate_grid_host", broken)
    boot, handle = tab.overlapped_mesh_sampler(pts, nrm, tris, 300, (0.333, 0.666),
                                               device="cpu")
    assert boot.tri_verts is not None and boot.tri_table is None
    with pytest.warns(RuntimeWarning, match="disk full"):
        assert handle.wait(timeout=30) is None
    assert handle.done and handle.build_seconds is not None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert handle.poll() is None  # warned once


def test_point_cloud_handover(cube, tmp_path):
    """The point-cloud bootstrap (the exact sweep) hands over to the
    candidate table of the JAX package's indices (its cache file, read by
    the build thread): the same batch from one generator state, exact far
    rows before, the table's rows after."""
    pts, nrm = cube[0][:40], cube[1][:40]  # fewer points than k: a quick index build
    cache = str(tmp_path / "cube_oracle_cache.npz")
    idx = joc.cached_point_candidate_idx_host(pts, cache)  # the build thread reads it
    boot, handle = tab.overlapped_pc_sampler(pts, nrm, 300, (0.333, 0.666), cache_path=cache,
                                             device="cpu")
    assert boot.pc_candidates is None and boot.oracle == "pointcloud"
    upgraded = handle.wait(timeout=60)
    assert upgraded is not None and handle.poll() is None  # one handover
    np.testing.assert_array_equal(upgraded.pc_candidates.numpy(), pts[idx])
    (p0, n0, s0), (p1, n1, s1) = (s.sample(torch.Generator().manual_seed(4))
                                  for s in (boot, upgraded))
    assert torch.equal(p0, p1) and torch.equal(n0, n1)
    sz = boot.sizes
    far = slice(sz.on_surface, sz.on_surface + sz.far)
    d = np.linalg.norm(p0[far].numpy()[:, None, :] - pts[None], axis=2).min(1)
    np.testing.assert_allclose(s0[far, 0].numpy(), d, rtol=0, atol=1e-6)
    table = jmd.point_cloud_distance_cells(jnp.asarray(p0[far].numpy()), jnp.asarray(pts[idx]))
    np.testing.assert_allclose(s1[far, 0].numpy(), np.asarray(table), rtol=0, atol=1e-7)
    assert torch.equal(s0[sz.on_surface + sz.far:], s1[sz.on_surface + sz.far:])


def test_cli_trains_a_mesh_shape(tmp_path, monkeypatch):
    """``cli.quantitative`` on a directory with a ``_t.obj`` trains it in
    mesh mode through ``setup_train`` (build then train here; the overlap
    is covered above) and writes its row, the figure from the triangle
    table and both meshes."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli, "SLICE_WIDTH", 16)
    monkeypatch.setenv("DIFFUDF_ORACLE_OVERLAP", "0")
    save_mesh("cube.obj", cube_mesh())
    tpre.preprocess_mesh("data/cube", "cube.obj", 2000)
    with open("sweep.json", "w") as fh:
        json.dump({"num_epochs": 2, "s1_epochs": 1, "warmup_epochs": 0, "batch_size": 300,
                   "resolution": 16, "network": {"hidden_layer_nodes": [32, 32, 32], "w0": 30}},
                  fh)
    stats = tquant.main(["data", "out", "--config", "sweep.json", "--no-provenance",
                         "--device", "cpu"])["cube"]
    assert stats["swap_epoch"] is None and stats["bootstrap_epochs"] == 0
    assert stats["oracle_build_s"] == stats["oracle_s"] > 0
    assert stats["s1_steps"] == 1 and stats["s2_steps"] == 1
    with open("out/cube/params.json") as fh:
        assert json.load(fh)["onlyPCloud"] is False
    with open("out/results.csv") as fh:
        rows = fh.read().splitlines()
    assert len(rows) == 2 and rows[1].startswith("cube,")
    for name in ("distance_fields.png", "pred_grad.png"):
        assert os.path.exists(os.path.join("out", "cube", "reconstructions", name))
    assert os.path.exists("data/cube/cube_oracle_cache.npz.tri_cand.npz")


def test_gt_plane_distances_take_the_table_or_the_pruned_sweep(cube):
    """The figure's mesh branches: the sampler's table when it holds one,
    else the pruned sweep over the mesh; both the exact cube distance."""
    pts, nrm, tris = cube
    samples = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (400, 3)).astype(np.float32))
    table = TrainingSampler.from_mesh(pts, nrm, tris, 300, (0.333, 0.666), device="cpu")
    exact = cube_distance(samples.numpy().astype(np.float64))
    mesh = cube_mesh()
    for sampler in (table, None):
        got = tcli.gt_plane_distances(None, mesh, samples, sampler).numpy()
        np.testing.assert_allclose(got, exact, rtol=0, atol=ATOL)


@pytest.mark.parametrize("distance", ["jax", "shared"])
def test_gt_render_matches_jax(tmp_path, monkeypatch, distance):
    """``create_projectional_image_gt`` against the JAX function on the same
    host rays and a 24 x 12 torus mesh: the hit mask exactly.  With the
    port's distance inside the JAX function ("shared"), the colours too, to
    the shading goldens' 1e-12.  With each package's own distance the
    colours are not compared: the normals are central differences (step
    1e-4) of float32 distances, so the two libraries' last-bit differences
    in a distance reach a normal at about 3e-4, and Phong's exponent 40
    multiplies that in the specular term (up to 0.12 on one pixel of this
    render at 36 x 18).  JAX's eager sweep compiles anew for every count of active
    rays, so its own distance runs here under ``jax.jit`` on queries padded
    to one shape, which leaves each ray's distance as it was."""
    save_mesh(str(tmp_path / "torus_t.obj"), torus_mesh(24, 12))
    if distance == "jax":
        jitted = jax.jit(jmd.point_triangle_distance)

        def dist(q, tris):
            pad = np.zeros((256, 3), np.float32)  # every ray of the 16 x 16 image
            pad[:len(q)] = q
            return jitted(jnp.asarray(pad), tris)[:len(q)]
    else:
        def dist(q, tris):
            return tmd.point_triangle_distance(torch.tensor(np.asarray(q)),
                                               torch.tensor(np.asarray(tris))).numpy()

    monkeypatch.setattr(jmd, "point_triangle_distance", dist)
    cam, light = [0.0, 1.2, 2.0], np.array([1.0, 2.0, 4.0])
    rays = world_rays(16, 16, 60, cam, 0.5)
    t0, valid = cube_entry_points(rays, cam)
    stats = {}
    got = tst.create_projectional_image_gt(str(tmp_path / "torus_t.obj"), rays, t0, valid, light,
                                           device="cpu", stats=stats)
    want = np.asarray(jst.create_projectional_image_gt(str(tmp_path / "torus_t.obj"), rays, t0,
                                                       valid, light))
    hits = got[:, 0] < 1
    assert stats["hits"] == hits.sum() > 0 and stats["nonfinite"] == 0
    np.testing.assert_array_equal(hits, want[:, 0] < 1)
    if distance == "shared":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_generate_st_renders_the_gt_mesh(tmp_path):
    """``gt_mode: "gt"`` through ``main`` with the JAX package's config keys:
    a PNG with hits and background, and one pass record."""
    save_mesh(str(tmp_path / "torus_t.obj"), torus_mesh(24, 12))
    cfg = {"network_config": {"gt_mode": "gt"}, "mesh_path": str(tmp_path / "torus_t.obj"),
           "light_pos": [1.0, 2.0, 4.0], "max_iter": 30, "surface_eps": 1e-3,
           "rendering_config": {"width": 12, "height": 12, "fov": 60,
                                "camera_position": [0.0, 1.2, 2.0],
                                "output_path": str(tmp_path / "gt.png")}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    img, stats = tst.main([str(path), "--device", "cpu"])
    assert img.shape == (12, 12, 3) and (img < 255).any() and (img == 255).any()
    (p,) = stats["passes"]
    assert p["hits"] > 0 and p["iterations"] > 0 and p["nonfinite"] == 0
    with open(tmp_path / "gt.png", "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
