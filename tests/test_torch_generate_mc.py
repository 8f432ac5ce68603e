"""Port parity: mesh extraction and the ``generate_mc`` CLI of
``diffudf_tpu_torch`` against the JAX package, plus the port's import
boundary and its native build."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from diffudf_tpu.cli import generate_mc as jmc
from diffudf_tpu.extract.meshudf import extract_mesh_meshudf as jax_extract_mu
from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
from diffudf_tpu.grid import lattice as jlat
from diffudf_tpu.train import checkpoint as jckpt
from diffudf_tpu_torch.cli import generate_mc as tmc
from diffudf_tpu_torch.data.mesh_io import load_obj
from diffudf_tpu_torch.extract.meshudf import extract_mesh_meshudf
from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax
from diffudf_tpu_torch.native import build, udf_mc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _analytic_fields(N=40):
    """udf and dirs of a sphere (r=0.55) joined by an open square sheet
    (z = 0.1, |x|, |y| < 0.8): a closed and an open surface."""
    ax = np.linspace(-1, 1, N)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    p = np.stack([x, y, z], -1)
    r = np.linalg.norm(p, axis=-1, keepdims=True)
    d_s = np.abs(r[..., 0] - 0.55)
    n_s = -np.sign(r - 0.55) * p / np.maximum(r, 1e-9)
    q = np.stack([np.clip(x, -0.8, 0.8), np.clip(y, -0.8, 0.8), np.full_like(z, 0.1)], -1)
    v = q - p
    d_p = np.linalg.norm(v, axis=-1)
    n_p = v / np.maximum(d_p[..., None], 1e-9)
    pick = d_s <= d_p
    udf = np.where(pick, d_s, d_p).astype(np.float32)
    dirs = np.where(pick[..., None], n_s, n_p).astype(np.float32)
    return udf, dirs, N


@pytest.mark.parametrize("path", ["mu", "mu_mst", "cap", "cap_anchor"])
def test_meshes_are_exactly_the_jax_meshes(path):
    udf, dirs, N = _analytic_fields()
    if path == "mu":
        got = tmc._mu_postprocessed(udf, dirs, None)
        want = jmc._mu_postprocessed(udf, dirs, None)
    elif path == "mu_mst":
        got = extract_mesh_meshudf(udf, dirs, signing="mst")
        want = jax_extract_mu(udf, dirs, signing="mst")
    else:
        signing = "vote" if path == "cap" else "anchor"
        got = tmc._cap_postprocessed(udf, dirs, N, cap_signing=signing)
        want = jmc._cap_postprocessed(udf, dirs, N, cap_signing=signing)
    assert len(got[1]) > 500
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _golden_field():
    g = np.load(os.path.join(REPO, "tests", "golden", "grid_rays_golden.npz"))
    np_params = [{"w": g[f"w{i}"], "b": g[f"b{i}"]} for i in range(3)]
    return np_params, (32, 32), float(g["freq_w0"])


def test_run_mc_both_end_to_end_in_both_packages(tmp_path):
    np_params, hidden, w0 = _golden_field()
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
    jspec = JaxSpec(hidden=hidden, w0=w0)
    stats = {}
    mu, cap = tmc.run_mc(params_from_jax(np_params, "cpu"), SirenSpec(hidden=hidden, w0=w0),
                         "tanh", 32, str(tmp_path / "t.ply"), 100.0, "both", stats=stats)
    assert (tmp_path / "t_MU.ply").exists() and (tmp_path / "t_CAP.ply").exists()
    assert stats["mu_faces"] == len(mu.faces) and stats["cap_faces"] == len(cap.faces)
    # JAX's run_mc carries its derivatives in bf16 here, so its signs and
    # vertices differ: the MeshUDF face counts agree to 5%, and the thin CAP
    # band (0.008 absolute, a quarter voxel at N=32) only has to be found
    jmu, jcap = jmc.run_mc(jparams, jspec, "tanh", 32, str(tmp_path / "j.ply"), 100.0, "both")
    assert abs(len(mu.faces) - len(jmu.faces)) <= 0.05 * len(jmu.faces) and len(jcap.faces)
    # the same chain in float32 gives the port's vertices
    udf, dirs = jlat.extract_fields_sparse(jparams, jspec, 32, "tanh", 100.0, deriv_dtype=None)
    f32 = (jmc._mu_postprocessed(udf, dirs, None), jmc._cap_postprocessed(udf, dirs, 32))
    for m, (verts, faces) in ((mu, f32[0]), (cap, f32[1])):
        assert len(m.faces) > 100 and np.isfinite(m.vertices).all()
        assert len(m.faces) == len(faces)
        assert cKDTree(verts).query(m.vertices)[0].max() < 1e-6


def test_cli_main_reads_a_jax_checkpoint(tmp_path):
    np_params, hidden, w0 = _golden_field()
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
    jckpt.save_params(str(tmp_path / "m.npz"), jparams, JaxSpec(hidden=hidden, w0=w0))
    cfg = {"alpha": 100.0, "gt_mode": "tanh", "hidden_layer_nodes": list(hidden), "w0": w0,
           "model_path": str(tmp_path / "m.npz"), "output_path": str(tmp_path / "out.obj"),
           "algorithm": "meshudf", "nsamples": 33}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    mesh, stats = tmc.main([str(tmp_path / "cfg.json"), "--device", "cpu"])
    back = load_obj(str(tmp_path / "out.obj"))
    np.testing.assert_array_equal(back.faces, mesh.faces)
    np.testing.assert_allclose(back.vertices, mesh.vertices, atol=1e-7)
    assert stats["band_points"] >= stats["dirs_points"] > 0 and stats["mu_faces"] == len(mesh.faces)


def test_run_mc_rejects_what_it_cannot_do(tmp_path):
    spec = SirenSpec(hidden=(32, 32))
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cpu")
    out = str(tmp_path / "x.ply")
    with pytest.raises(ValueError, match="Invalid algorithm"):
        tmc.run_mc(params, spec, "tanh", 16, out, 100.0, algorithm="bogus")
    with pytest.raises(ValueError, match="layer dims"):
        tmc.run_mc(params, SirenSpec(hidden=(32, 32, 32)), "tanh", 16, out, 100.0)


def test_run_mc_enhanced_refines_at_385(tmp_path, monkeypatch):
    """quality="enhanced" resolves to N=385 and reaches the refinement (2
    steps, then Taubin 10) of each mesh; the grid pass and the refinement
    are stubbed so that nothing is extracted at 385 on the CPU."""
    spec = SirenSpec(hidden=(32, 32))
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cpu")
    udf, dirs, _ = _analytic_fields()
    calls = []

    def fields(params, spec, N, *a, **k):
        calls.append(("grid", N))
        return udf, dirs

    def refine(params, spec, verts, *, N, steps, **k):
        calls.append(("refine", N, steps))
        return verts + np.float32(1e-3)

    monkeypatch.setattr(tmc, "extract_fields_sparse", fields)
    monkeypatch.setattr(tmc, "refine_vertices", refine)
    stats = {}
    mesh = tmc.run_mc(params, spec, "tanh", 256, str(tmp_path / "e.ply"), 100.0,
                      algorithm="meshudf", quality="enhanced", stats=stats)
    assert calls == [("grid", 385), ("refine", 385, 2)]
    assert len(mesh.faces) > 500 and np.isfinite(mesh.vertices).all()
    np.testing.assert_allclose(stats["mu_refine_max_voxels"], 1e-3 * 3 ** 0.5 * 192, rtol=1e-3)


def test_quality_presets_match_jax():
    assert tmc.QUALITY_PRESETS == jmc.QUALITY_PRESETS
    knobs = dict(triangulator=None, refine_steps=0, taubin_iters=0, cap_signing="vote")
    for q in (None, "parity", "default", "enhanced"):
        assert tmc.resolve_quality(q, 256, knobs) == jmc.resolve_quality(q, 256, knobs)


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Every module of the port imports, and a small render, point cloud,
    slice figures (``generate_df`` on a point cloud and on a mesh) and a
    one-shape ``quantitative`` sweep trained on 2 CPU ranks (``--mesh 2``,
    :mod:`diffudf_tpu_torch.parallel.mesh`) run, without jax or the JAX
    package, and without matplotlib and PIL, in one process that imports
    them once.  The spawned rank is held to the same boundary by
    ``tests/test_torch_parallel.py::test_two_ranks_match_jax_and_one_rank``."""
    g = np.load(os.path.join(REPO, "tests", "golden", "st_image_golden.npz"))
    spec = SirenSpec(hidden=(64, 64, 64), w0=30.0)
    model = str(tmp_path / "model.npz")
    jckpt.save_params(model, [{"w": g[f"w{i}"], "b": g[f"b{i}"]} for i in range(4)])
    cfg = tmp_path / "st.json"
    cfg.write_text(json.dumps({
        "network_config": {"gt_mode": "tanh", "alpha": 10.0, "model_path": model,
                           "hidden_layer_nodes": list(spec.hidden), "w0": spec.w0},
        "rendering_config": {"width": 16, "height": 12, "fov": 60, "surface_threshold": 0.008,
                             "camera_position": [0.0, 0.0, 2.0], "shininess": 40,
                             "light_position": [1.0, 2.0, 4.0], "max_iterations": 60,
                             "plot_curvatures": "mean", "output_path": str(tmp_path / "st.png")},
    }))
    (tmp_path / "pc.json").write_text(json.dumps({
        "gt_mode": "tanh", "alpha": 10.0, "model_path": model, "w0": spec.w0,
        "hidden_layer_nodes": list(spec.hidden), "nsamples": 300, "ref_steps": 3,
        "surf_thresh": 0.01, "max_iter": 3, "output_path": str(tmp_path / "pc.ply")}))
    (tmp_path / "sweep.json").write_text(json.dumps({
        "num_epochs": 2, "s1_epochs": 1, "warmup_epochs": 0, "batch_size": 300,
        "resolution": 16, "network": {"hidden_layer_nodes": [32, 32, 32], "w0": 30}}))
    code = (
        "import os, pkgutil, importlib, sys, diffudf_tpu_torch\n"
        "for m in pkgutil.walk_packages(diffudf_tpu_torch.__path__, 'diffudf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from diffudf_tpu_torch.cli import generate_df, generate_st, preprocess, quantitative\n"
        "from diffudf_tpu_torch.cli import generate_pc, train\n"
        "tmp = sys.argv[2]\n"
        "generate_st.main([sys.argv[1], '--device', 'cpu'])\n"
        "generate_pc.main([tmp + '/pc.json', '--device', 'cpu'])\n"
        "preprocess.preprocess_mesh(tmp + '/data/torus', 'data/demo/torus.obj', 2000)\n"
        "os.replace(tmp + '/data/torus/torus_t.obj', tmp + '/torus_t.obj')\n"
        "for geo in ('/data/torus/torus_pc.ply', '/torus_t.obj'):\n"
        "    generate_df.main([tmp + geo, sys.argv[3], tmp + '/df', '-w', '16', '--hidden',\n"
        "                      '64', '64', '64', '-a', '10', '--device', 'cpu'])\n"
        "train.SLICE_WIDTH = 16\n"
        "quantitative.main([tmp + '/data', tmp + '/sweep', '--config', tmp + '/sweep.json',\n"
        "                   '--no-provenance', '--device', 'cpu', '--mesh', '2'])\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'diffudf_tpu', 'matplotlib', 'PIL')]\n"
        "assert not bad, bad\n"
        "print(' '.join(k for k in sys.modules if k.startswith('diffudf_tpu_torch')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code, str(cfg), str(tmp_path), model], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.splitlines()[-1].split())  # after the CLIs' Stats lines
    assert len(loaded) > 20
    assert {"diffudf_tpu_torch.parallel.mesh", "diffudf_tpu_torch.utils.timing",
            "diffudf_tpu_torch.utils.profiling"} <= loaded
    assert os.path.exists(tmp_path / "st.png") and os.path.exists(tmp_path / "pc.ply")
    for name in ("distance_fields.png", "pred_grad.png"):
        assert os.path.exists(tmp_path / "df" / name)
        assert os.path.exists(tmp_path / "sweep" / "torus" / "reconstructions" / name)
    with open(tmp_path / "sweep" / "results.csv") as fh:
        assert len(fh.read().splitlines()) == 2
    # the training, render, evaluation and point-cloud slices' modules are
    # among those walked and imported
    for name in ("cli.train", "cli.preprocess", "config", "data.mesh_distance",
                 "data.normalize", "data.oracle_cache", "data.sampling", "ops.kernel_io",
                 "ops.vg", "train.losses", "train.loop", "train.schedule", "utils.metrics",
                 "autodiff.curvature", "cli.generate_st", "ops.value", "render.camera",
                 "render.png", "render.shading", "render.tracer", "cli.generate_df",
                 "cli.quantitative", "eval.chamfer", "grid.slices", "ops.min_distance",
                 "utils.drift", "pc.sampler", "extract.refine", "cli.generate_pc"):
        assert "diffudf_tpu_torch." + name in loaded, name


def test_native_library_is_built_from_source():
    """The port never loads a prebuilt library: its sign-voting library is
    built from the copied source into the ignored build directory."""
    path = udf_mc.build()
    assert os.path.dirname(path) == build.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path) == os.path.basename(
        build.library_path("udf_mc", udf_mc._CMD, [udf_mc._SRC]))
    assert "-march=native" not in udf_mc._CMD
    assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(udf_mc._SRC)))
