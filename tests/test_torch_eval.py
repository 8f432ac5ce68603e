"""Port parity: the evaluation of ``diffudf_tpu_torch`` (``eval/chamfer.py``)
against the JAX package and the reference's metric goldens, and the
``quantitative`` sweep's CSV and provenance sidecar with training
stubbed out, on the CPU."""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

from diffudf_tpu.cli import quantitative as jq
from diffudf_tpu.data.mesh_io import Mesh as JaxMesh
from diffudf_tpu.eval import chamfer as jch
from diffudf_tpu_torch.cli import quantitative as tq
from diffudf_tpu_torch.data.mesh_io import Mesh, PointCloudData, save_point_cloud
from diffudf_tpu_torch.eval import chamfer as tch

torch.set_num_threads(2)

GOLDEN = osp.join(osp.dirname(__file__), "golden", "metrics_golden.npz")
CASES = ("random", "sphere", "degenerate", "unnormalized")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("norm", [1, 2])
def test_chamfer_and_nc_match_the_reference_golden(golden, case, norm, backend):
    """tests/test_golden_metrics.py's tolerances: Chamfer 2e-5 relative, NC
    2e-5 (1e-4 on the tie-constructed case, where equidistant neighbours
    may be picked in another order)."""
    args = [golden[f"{case}_{k}"] for k in ("verts", "pts", "vnorms", "pnorms")]
    cd, nc = tch.chamfer_distance(*args, norm=norm, backend=backend, device="cpu")
    assert cd == pytest.approx(float(golden[f"{case}_cd_l{norm}"]), rel=2e-5)
    rel = 1e-4 if case == "degenerate" else 2e-5
    assert nc == pytest.approx(float(golden[f"{case}_nc_l{norm}"]), rel=rel, abs=1e-7)


@pytest.mark.parametrize("norm", [1, 2])
def test_device_backend_matches_jax(golden, norm):
    """The chunked scan, in pieces smaller than the clouds, finds the k-d
    tree's neighbours; its metrics are the JAX scan's to 1e-6 relative."""
    x, y = golden["sphere_verts"], golden["sphere_pts"]
    td, ti = tch.nearest_neighbor(x, y, norm, y_chunk=512, x_tile=700, device="cpu")
    hd, hi = tch._nn_host(x.astype(np.float32), y.astype(np.float32), norm)
    np.testing.assert_array_equal(ti.numpy(), hi)
    np.testing.assert_allclose(td.numpy(), hd, rtol=1e-5, atol=1e-6)
    args = [golden[f"sphere_{k}"] for k in ("verts", "pts", "vnorms", "pnorms")]
    got = tch.chamfer_distance(*args, norm=norm, backend="device", device="cpu")
    want = jch.chamfer_distance(*args, norm=norm, backend="device")
    assert got == pytest.approx(want, rel=1e-6)


def test_auto_backend_and_protocol_floor_match_jax(golden):
    """Host arrays go to the k-d tree, tensors to the scan; the protocol
    floor of a mesh is the JAX package's (same samples, same seeds)."""
    x, y = golden["random_verts"], golden["random_pts"]
    host = tch.chamfer_distance(x, y, norm=1)
    assert host == tch.chamfer_distance(x, y, norm=1, backend="host")
    scan = tch.chamfer_distance(torch.as_tensor(x), torch.as_tensor(y), norm=1)
    assert scan[0] == pytest.approx(host[0], rel=1e-6) and scan[1] is None
    with pytest.raises(ValueError, match="backend"):
        tch.chamfer_distance(x, y, backend="gpu")
    v, f = _octahedron()
    got = tch.protocol_floor(Mesh(v, f), n_samples=2000)
    want = jch.protocol_floor(JaxMesh(v, f), n_samples=2000)
    assert got == pytest.approx(want, rel=1e-6)


def _octahedron(scale=0.6):
    v = scale * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                         np.float64)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    return v, f


def test_quantitative_writes_the_jax_csv_and_sidecar(tmp_path, monkeypatch):
    """The sweep over two shapes with setup_train stubbed: the JAX package's
    header and defaults, a row per shape with mesh_metrics' values (the JAX
    package's on the same meshes), the provenance sidecar and its
    ``previous`` record, skipped shapes on a second pass, and --mesh 2
    refused."""
    assert tq.CSV_HEADER == jq.CSV_HEADER and tq.DEFAULT_CONFIG == jq.DEFAULT_CONFIG
    rng = np.random.default_rng(0)
    v, f = _octahedron()
    meshes = {"a": (Mesh(v, f), Mesh(0.9 * v, f)), "b": (Mesh(1.1 * v, f), Mesh(v, f))}
    for name in meshes:
        pts = rng.normal(size=(500, 3))
        pts = 0.6 * pts / np.linalg.norm(pts, axis=1, keepdims=True)
        os.makedirs(tmp_path / "data" / name)
        save_point_cloud(str(tmp_path / "data" / name / f"{name}_pc.ply"),
                         PointCloudData(pts.astype(np.float32), pts.astype(np.float32)))
    seen = []

    def fake_setup_train(cfg, make_meshes=True, verbose=True, resume=False, device="cuda",
                         stats=None):
        seen.append((cfg.experiment_name, cfg.only_pcloud, cfg.num_epochs, device))
        os.makedirs(osp.join(cfg.checkpoint_path, cfg.experiment_name), exist_ok=True)
        return 12.5, meshes[cfg.experiment_name], None

    prints = iter([{"final_loss": 1.0, "param_sum": 2.0}, {"final_loss": 1.5, "param_sum": 2.0}])
    monkeypatch.setattr("diffudf_tpu_torch.cli.train.setup_train", fake_setup_train)
    monkeypatch.setattr("diffudf_tpu_torch.utils.drift.fingerprint",
                        lambda device="cuda": dict(next(prints)))
    (tmp_path / "cfg.json").write_text(json.dumps({"num_epochs": 7}))
    out = str(tmp_path / "out")
    argv = [str(tmp_path / "data"), out, "--config", str(tmp_path / "cfg.json"),
            "--device", "cpu"]
    tq.main(argv)
    assert seen == [("a", True, 7, "cpu"), ("b", True, 7, "cpu")]
    with open(osp.join(out, "results.csv")) as fh:
        lines = fh.read().splitlines()
    assert lines[0] + "\n" == jq.CSV_HEADER and len(lines) == 3
    for line in lines[1:]:
        name, t, *vals = line.split(",")
        mu, cap = meshes[name]
        pc = str(tmp_path / "data" / name / f"{name}_pc.ply")
        from diffudf_tpu.data.mesh_io import load_point_cloud as jload

        gt = jload(pc)
        want = (jq.mesh_metrics(JaxMesh(cap.vertices, cap.faces), gt.points, gt.normals)
                + jq.mesh_metrics(JaxMesh(mu.vertices, mu.faces), gt.points, gt.normals))
        assert float(t) == 12.5
        np.testing.assert_allclose([float(x) for x in vals], want, rtol=1e-6)
    with open(osp.join(out, "results_provenance.json")) as fh:
        prov = json.load(fh)
    assert prov["final_loss"] == 1.0 and "git_rev" in prov and "previous" not in prov

    tq.main(argv)  # every shape is done: skipped; the fingerprint moved
    assert len(seen) == 2
    with open(osp.join(out, "results_provenance.json")) as fh:
        prov = json.load(fh)
    assert prov["final_loss"] == 1.5 and prov["previous"]["final_loss"] == 1.0
    with pytest.raises(NotImplementedError, match="data-parallel"):
        tq.main(argv + ["--mesh", "2"])


def test_fingerprint_records_the_torch_platform():
    """Two CPU epochs of the fingerprint's run: its keys, finite numbers."""
    from diffudf_tpu_torch.utils.drift import fingerprint

    prov = fingerprint(epochs=2, batch=300, device="cpu")
    assert {"date", "platform", "device", "torch", "cuda", "epochs", "final_loss",
            "param_sum"} <= set(prov)
    assert prov["platform"] == "cpu" and prov["epochs"] == 2
    assert np.isfinite(prov["final_loss"]) and np.isfinite(prov["param_sum"])
