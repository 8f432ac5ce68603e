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
    with pytest.raises(NotImplementedError, match="Vertex refinement"):
        tmc.run_mc(params, spec, "tanh", 16, out, 100.0, quality="enhanced")
    with pytest.raises(ValueError, match="Invalid algorithm"):
        tmc.run_mc(params, spec, "tanh", 16, out, 100.0, algorithm="bogus")
    with pytest.raises(ValueError, match="layer dims"):
        tmc.run_mc(params, SirenSpec(hidden=(32, 32, 32)), "tanh", 16, out, 100.0)


def test_quality_presets_match_jax():
    assert tmc.QUALITY_PRESETS == jmc.QUALITY_PRESETS
    knobs = dict(triangulator=None, refine_steps=0, taubin_iters=0, cap_signing="vote")
    for q in (None, "parity", "default", "enhanced"):
        assert tmc.resolve_quality(q, 256, knobs) == jmc.resolve_quality(q, 256, knobs)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, importlib, sys, diffudf_tpu_torch\n"
        "for m in pkgutil.walk_packages(diffudf_tpu_torch.__path__, 'diffudf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'diffudf_tpu' or k.startswith('diffudf_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('diffudf_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20


def test_native_library_is_built_from_source():
    """The port never loads a prebuilt library: its sign-voting library is
    built from the copied source into the ignored build directory."""
    path = udf_mc.build()
    assert os.path.dirname(path) == build.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path) == os.path.basename(
        build.library_path("udf_mc", udf_mc._CMD, [udf_mc._SRC]))
    assert "-march=native" not in udf_mc._CMD
    assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(udf_mc._SRC)))
