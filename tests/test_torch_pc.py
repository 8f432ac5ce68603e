"""Port parity: point-cloud extraction (``pc/sampler.py``) and the
``generate_pc`` CLI of ``diffudf_tpu_torch`` against the JAX package, on the
same numpy inputs.

The projection runs on the field of ``tests/golden/pc_golden.npz`` (a
3→32→32→1 SIREN the kernels take: on the CPU the plain versions of K3a and
K1) and on a random 3→48→48→1 net the kernels do not take (the plain
Taylor-mode path).  The sampler runs on the field of
``tests/golden/grid_rays_golden.npz`` at α = 100, as the port's extraction
test does: the pc fixture's field never comes within 0.01 of its zero set.
"""

import json
import os.path as osp
import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
from diffudf_tpu.pc import sampler as jsampler
from diffudf_tpu_torch.autodiff.ops import value_grad
from diffudf_tpu_torch.cli import generate_pc
from diffudf_tpu_torch.data.mesh_io import load_point_cloud
from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax
from diffudf_tpu_torch.ops import vg
from diffudf_tpu_torch.ops.evaluate import field_fns
from diffudf_tpu_torch.pc import sampler
from diffudf_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)

PC_GOLDEN = osp.join(osp.dirname(__file__), "golden", "pc_golden.npz")
GRID_GOLDEN = osp.join(osp.dirname(__file__), "golden", "grid_rays_golden.npz")
# the sampler's settings; the field of GRID_GOLDEN at the alpha its
# extraction test uses
SAMPLER = dict(gt_mode="tanh", alpha=100.0, num_steps=5, num_points=2000, surf_thresh=0.01,
               max_iter=20)
# symmetric Chamfer-L1 of the port's cloud against the JAX package's (seed 0
# each): measured 0.1025; seeds 0-3 of either package lie 0.091-0.105 from
# each other, and port-JAX pairs 0.094-0.103
MAX_CLOUD_CHAMFER = 0.12


def _load(path):
    g = np.load(path)
    n = sum(1 for k in g.files if re.fullmatch(r"w\d+", k))
    np_params = [{"w": g[f"w{i}"], "b": g[f"b{i}"]} for i in range(n)]
    return g, np_params, tuple(p["w"].shape[1] for p in np_params[:-1]), float(g["freq_w0"])


def _both(np_params, hidden, w0):
    """(torch params on the CPU, torch spec, JAX params, JAX spec)."""
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
    return (params_from_jax(np_params, "cpu"), SirenSpec(hidden=hidden, w0=w0), jparams,
            JaxSpec(hidden=hidden, w0=w0))


@pytest.fixture(scope="module")
def golden():
    g, np_params, hidden, w0 = _load(PC_GOLDEN)
    return g, _both(np_params, hidden, w0)


@pytest.fixture(scope="module")
def grid_field():
    _, np_params, hidden, w0 = _load(GRID_GOLDEN)
    return np_params, hidden, w0


@pytest.fixture(scope="module")
def cloud(grid_field):
    params, spec, _, _ = _both(*grid_field)
    stats = {}
    points, normals = sampler.generate_point_cloud(params, spec, seed=0, stats=stats, **SAMPLER)
    return points, normals, stats


def _field(golden, net):
    """(torch params, spec, JAX params, JAX spec) of the fixture's field or
    of a random 48-wide net the kernels do not take."""
    if net == "golden":
        return golden[1]
    spec = SirenSpec(hidden=(48, 48), w0=30.0)
    return _both(init_siren(spec, np.random.default_rng(4)), spec.hidden, spec.w0)


@pytest.mark.parametrize("net,gt_mode,hess", [
    ("golden", "tanh", True), ("golden", "tanh", False), ("golden", "siren", True),
    ("golden", "siren", False), ("wide48", "siren", True)])
def test_project_points_matches_jax(golden, net, gt_mode, hess):
    """Positions, steps and normals of the projection against the JAX
    function.  The random 48-wide net runs in "siren" mode (step = |f|):
    its f crosses zero, and there tanh's step sqrt(|f|/α) turns a 5e-8
    difference in f into 1.7e-6, where the JAX function itself lies 2.8e-6
    from the float64 projection."""
    g = golden[0]
    params, spec, jparams, jspec = _field(golden, net)
    assert field_fns(spec)[0] is (vg.vg if net == "golden" else value_grad)
    kw = dict(gt_mode=gt_mode, alpha=float(g["alpha"]), num_steps=int(g["num_steps"]),
              want_hessian_normals=hess)
    x, step, nrm = (t.numpy() for t in sampler.project_points(
        params, spec, torch.as_tensor(g["samples0"]), **kw))
    jx, jstep, jnrm = (np.asarray(t) for t in jsampler.project_points(
        jparams, jspec, jnp.asarray(g["samples0"]), **kw))
    err = np.abs(x - jx).max(axis=1)
    assert err.max() <= 1e-5 and np.median(err) <= 1e-6, (err.max(), np.median(err))
    assert np.abs(step - jstep).max() <= 1e-6
    cos = np.abs(np.sum(nrm * jnrm, axis=1))
    assert np.mean(1 - cos <= 1e-5) >= 0.99


def test_projection_matches_reference_golden(golden):
    """The limits of tests/test_golden_pc.py, on the port."""
    g, (params, spec, _, _) = golden
    x, step, nrm = (t.numpy() for t in sampler.project_points(
        params, spec, torch.as_tensor(g["samples0"]), gt_mode="tanh", alpha=float(g["alpha"]),
        num_steps=int(g["num_steps"]), want_hessian_normals=True))
    err = np.abs(x - g["positions"]).max(axis=1)
    assert np.median(err) < 1e-6 and err.max() < 5e-4
    np.testing.assert_allclose(step, g["last_steps"], atol=5e-4)
    keep = (np.abs(x) <= 1.0).all(axis=1)
    borderline = (np.abs(np.abs(g["positions"]) - 1.0) < 1e-3).any(axis=1)
    np.testing.assert_array_equal(keep[~borderline], g["keep_mask"][~borderline])
    cos = np.abs(np.sum(nrm * g["normals"], axis=1))
    assert np.median(1 - cos) < 1e-5 and np.mean(cos > 0.999) > 0.99


def test_generate_point_cloud(cloud):
    points, normals, stats = cloud
    assert len(points) >= SAMPLER["num_points"] and points.dtype == np.float32
    assert (np.abs(points) <= 1.0).all() and np.isfinite(normals).all()
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-5)
    assert stats["rounds"] == len(stats["kept"]) == len(stats["candidates"])
    assert sum(stats["kept"]) == len(points) and stats["project_s"] > 0
    assert stats["k3a_launches"] == stats["k1_launches"] == 0  # CPU: the plain versions


def test_generate_point_cloud_seeds(grid_field):
    params, spec, _, _ = _both(*grid_field)
    kw = dict(SAMPLER, max_iter=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        a, b, c = (sampler.generate_point_cloud(params, spec, seed=s, **kw) for s in (0, 0, 1))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(a[0]) and not (len(a[0]) == len(c[0]) and np.array_equal(a[0], c[0]))


def test_generate_point_cloud_warns_like_jax(grid_field):
    params, spec, _, _ = _both(*grid_field)
    with pytest.warns(RuntimeWarning, match=r"^Max iterations reached\. Only sampled \d+ "
                                            r"surface points\.$"):
        points, _ = sampler.generate_point_cloud(params, spec, **dict(SAMPLER, max_iter=1))
    assert len(points) < SAMPLER["num_points"]


def test_point_cloud_distribution_matches_jax(cloud, grid_field):
    _, _, jparams, jspec = _both(*grid_field)
    jpoints, _ = jsampler.generate_point_cloud(jparams, jspec, seed=0, **SAMPLER)
    points = cloud[0]
    chamfer = (cKDTree(jpoints).query(points, p=1)[0].mean()
               + cKDTree(points).query(jpoints, p=1)[0].mean())
    assert chamfer <= MAX_CLOUD_CHAMFER, chamfer


def test_orient_normals_is_the_jax_function():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(600, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts[:100] += 3.0  # a second component
    flipped = pts * np.where(rng.random(600)[:, None] < 0.5, -1.0, 1.0)
    got = sampler.orient_normals_consistent(pts, flipped, k=10)
    assert np.array_equal(got, jsampler.orient_normals_consistent(pts, flipped, k=10))
    assert sampler.orient_normals_consistent(pts[:0], flipped[:0]).shape == (0, 3)


def test_generate_pc_cli(tmp_path, grid_field):
    np_params, hidden, w0 = grid_field
    ckpt.save_params(str(tmp_path / "m.npz"), params_from_jax(np_params, "cpu"),
                     SirenSpec(hidden=hidden, w0=w0))
    cfg = {"alpha": SAMPLER["alpha"], "gt_mode": "tanh", "hidden_layer_nodes": list(hidden),
           "w0": w0, "model_path": str(tmp_path / "m.npz"),
           "output_path": str(tmp_path / "pc.ply"), "nsamples": 500, "ref_steps": 5,
           "surf_thresh": 0.01, "max_iter": 20}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    pc, stats = generate_pc.main([str(tmp_path / "cfg.json"), "--device", "cpu"])
    back = load_point_cloud(str(tmp_path / "pc.ply"))
    assert len(back.points) == len(pc.points) >= 500
    np.testing.assert_allclose(back.points, pc.points, atol=1e-7)
    assert stats["orient_s"] >= 0 and sum(stats["kept"]) == len(pc.points)
    # shard_points on the CPU: every visible device is one, a group of one
    (tmp_path / "shard.json").write_text(json.dumps(dict(cfg, shard_points=True)))
    sharded, _ = generate_pc.main([str(tmp_path / "shard.json"), "--device", "cpu"])
    assert np.array_equal(sharded.points, pc.points)
