"""Port parity: vertex refinement (``extract/refine.py``) and its hook in
``generate_mc`` against the JAX package, on the same numpy inputs.

The fields are those of ``tests/golden/pc_golden.npz`` (its α 10: every
step hits the trust region) and ``tests/golden/grid_rays_golden.npz`` (at
α 100, as the port's extraction test runs it: steps inside the trust
region), both 3→32→32→1 nets the kernels take (on the CPU the plain version
of K3a), and a random 3→48→48→1 net they do not take (the plain path).
"""

import os.path as osp
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from diffudf_tpu.cli import generate_mc as jmc
from diffudf_tpu.extract.refine import refine_vertices as jax_refine
from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
from diffudf_tpu.grid import lattice as jlat
from diffudf_tpu_torch.cli import generate_mc as tmc
from diffudf_tpu_torch.extract.refine import refine_vertices
from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax

torch.set_num_threads(2)

GOLDEN = osp.join(osp.dirname(__file__), "golden")


def _field(name):
    """(np params, hidden, w0, alpha, points near the zero set)."""
    if name == "wide48":
        spec = SirenSpec(hidden=(48, 48), w0=30.0)
        g = np.load(osp.join(GOLDEN, "pc_golden.npz"))
        return init_siren(spec, np.random.default_rng(4)), spec.hidden, 30.0, 10.0, g["positions"]
    g = np.load(osp.join(GOLDEN, name + "_golden.npz"))
    n = sum(1 for k in g.files if re.fullmatch(r"w\d+", k))
    np_params = [{"w": g[f"w{i}"], "b": g[f"b{i}"]} for i in range(n)]
    hidden = tuple(p["w"].shape[1] for p in np_params[:-1])
    if name == "pc":
        return np_params, hidden, float(g["freq_w0"]), float(g["alpha"]), g["positions"]
    return np_params, hidden, float(g["freq_w0"]), 100.0, g["hit_positions"][g["hit_mask"]]


def _face_set(faces):
    """Faces as sorted rows in lexicographic order: the same set gives the
    same array, whatever the order of the faces and of their corners."""
    rows = np.sort(faces, axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("name", ["pc", "grid_rays", "wide48"])
def test_refine_vertices_matches_jax(name):
    np_params, hidden, w0, alpha, pts = _field(name)
    verts = (pts + 0.01 * np.random.default_rng(6).normal(size=pts.shape)).astype(np.float32)
    kw = dict(gt_mode="tanh", alpha=alpha, N=64, steps=2)
    got = refine_vertices(params_from_jax(np_params, "cpu"), SirenSpec(hidden=hidden, w0=w0),
                          verts, **kw)
    want = jax_refine([{k: jnp.asarray(v) for k, v in p.items()} for p in np_params],
                      JaxSpec(hidden=hidden, w0=w0), verts, **kw)
    assert got.shape == verts.shape and got.dtype == np.float32
    assert np.abs(got - np.asarray(want)).max() <= 1e-5
    assert np.abs(got - verts).max() > 1e-3  # the vertices moved


def test_refine_vertices_trust_region():
    np_params, hidden, w0, alpha, _ = _field("grid_rays")
    pts = np.random.default_rng(12).uniform(-0.9, 0.9, (512, 3)).astype(np.float32)
    N = 65
    out = refine_vertices(params_from_jax(np_params, "cpu"), SirenSpec(hidden=hidden, w0=w0),
                          pts, gt_mode="tanh", alpha=alpha, N=N, steps=5, max_move_voxels=0.5)
    move = np.linalg.norm(out - pts, axis=1)
    assert move.max() <= 0.5 * 2.0 / (N - 1) + 1e-7
    assert np.mean(move > 0.49 * 2.0 / (N - 1)) > 0.5  # far points want to move further


def test_refine_vertices_identity_cases():
    np_params, hidden, w0, alpha, _ = _field("pc")
    params, spec = params_from_jax(np_params, "cpu"), SirenSpec(hidden=hidden, w0=w0)
    kw = dict(gt_mode="tanh", alpha=alpha, N=65)
    assert refine_vertices(params, spec, np.zeros((0, 3), np.float32), steps=2, **kw).shape == (0, 3)
    pts = np.full((4, 3), 0.3, np.float32)
    np.testing.assert_array_equal(refine_vertices(params, spec, pts, steps=0, **kw), pts)


def test_run_mc_refines_as_the_jax_package(tmp_path, monkeypatch):
    """run_mc with refine_steps=2, taubin_iters=10 at N=32 in both packages,
    the JAX fields in float32: the same faces, and vertices within 1e-5.

    The MeshUDF mesh numbers its vertices in another order in the two
    packages before any refinement (its grid directions differ by up to
    3e-3 where the gradient nearly vanishes), so, as in
    ``test_run_mc_both_end_to_end_in_both_packages``, its vertices are
    matched to their nearest JAX vertex: one to one, within 1e-5, and the
    faces the same under that matching."""
    np_params, hidden, w0, alpha, _ = _field("grid_rays")
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]

    def f32_fields(*a, **k):
        return jlat.extract_fields_sparse(*a, **dict(k, deriv_dtype=None))

    monkeypatch.setattr(jmc, "extract_fields_sparse", f32_fields)
    kw = dict(algorithm="both", refine_steps=2, taubin_iters=10)
    stats = {}
    got = tmc.run_mc(params_from_jax(np_params, "cpu"), SirenSpec(hidden=hidden, w0=w0), "tanh",
                     32, str(tmp_path / "t.ply"), alpha, stats=stats, **kw)
    want = jmc.run_mc(jparams, JaxSpec(hidden=hidden, w0=w0), "tanh", 32,
                      str(tmp_path / "j.ply"), alpha, **kw)
    for name, m, w in zip(("mu", "cap"), got, want):
        assert len(m.faces) > 100
        dist, idx = cKDTree(w.vertices).query(m.vertices)
        assert dist.max() <= 1e-5 and len(np.unique(idx)) == len(w.vertices)
        if name == "cap":
            np.testing.assert_array_equal(m.faces, w.faces)
            np.testing.assert_array_equal(idx, np.arange(len(idx)))
        np.testing.assert_array_equal(_face_set(idx[m.faces]), _face_set(w.faces))
        assert 0 < stats[name + "_refine_max_voxels"] <= 0.5 + 1e-5
        assert stats[name + "_refine_s"] <= stats[name + "_s"]
