"""CLI: batch quantitative evaluation over a dataset directory, on the GPU:
the torch counterpart of ``diffudf_tpu/cli/quantitative.py``.

Reference surface (``cuantitative.py``): walk a dataset tree for
``_pc.ply`` files (one shape a directory), train each shape through
:func:`.train.setup_train` (which also draws its slice figure), extract
both MC meshes, compute Chamfer-L1/L2 and normal consistency against the GT
point cloud, and append to ``results.csv`` with the reference's columns.

    python -m diffudf_tpu_torch.cli.quantitative <dataset_dir> <out_dir>
        [--config cfg.json] [--no-provenance] [--device cpu]

A directory with a ``_t.obj`` trains in mesh mode (the triangle oracle),
one without in point-cloud mode, as in the JAX package.  ``--mesh N``
trains each shape data-parallel on N ranks (``cli.train --mesh``).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import torch

from ..config import TrainConfig
from ..data.mesh_io import Mesh, load_point_cloud
from ..eval.chamfer import chamfer_distance

CSV_HEADER = "mesh,time,L1CD_CAP,L2CD_CAP,NC_CAP,L1CD_MU,L2CD_MU,NC_MU\n"

DEFAULT_CONFIG = {
    "num_epochs": 3000, "s1_epochs": 2000, "warmup_epochs": 1000,
    "batch_size": 30000, "sampling_percentiles": [0.333, 0.666],
    "batches_per_epoch": 1, "epochs_to_checkpoint": 8001,
    "gt_mode": "tanh",
    "loss_s1_weights": [1e4, 1e4, 1e4, 1e3], "loss_s2_weights": [1e5, 1e5],
    "alpha": 10,
    "optimizer": {"type": "adam", "lr_s1": 1e-5, "lr_s2": 1e-7},
    "network": {"hidden_layer_nodes": [256] * 8, "w0": 30, "pretrained_dict": "None"},
    "resolution": 256,
}


def _git_rev() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def mesh_metrics(mesh: Mesh, gt_points, gt_normals):
    """-> (L1CD, L2CD, NC) vs the GT cloud (pytorch3d conventions)."""
    vn = mesh.compute_vertex_normals()
    l1, nc = chamfer_distance(mesh.vertices, gt_points, vn, gt_normals, norm=1)
    l2, _ = chamfer_distance(mesh.vertices, gt_points, vn, gt_normals, norm=2)
    return l1, l2, nc


def evaluate_shape(cfg: TrainConfig, gt_pc_path: str, device="cuda", stats=None,
                   n_mesh_devices: int = 0):
    """Train one shape (on ``n_mesh_devices`` ranks, :func:`.train.setup_train`)
    and score its two meshes; -> (training seconds, (L1, L2, NC) of the CAP
    mesh, (L1, L2, NC) of the MeshUDF mesh)."""
    from .train import setup_train

    training_time, meshes, _ = setup_train(cfg, verbose=False, device=device, stats=stats,
                                           n_mesh_devices=n_mesh_devices)
    mesh_mu, mesh_cap = meshes
    gt = load_point_cloud(gt_pc_path)
    l1_cap, l2_cap, nc_cap = mesh_metrics(mesh_cap, gt.points, gt.normals)
    l1_mu, l2_mu, nc_mu = mesh_metrics(mesh_mu, gt.points, gt.normals)
    return training_time, (l1_cap, l2_cap, nc_cap), (l1_mu, l2_mu, nc_mu)


def write_provenance(prov_path: str, device) -> dict:
    """Stamp the sweep with the platform fingerprint
    (:func:`..utils.drift.fingerprint`); a record that moved since the last
    rows were written is kept under ``previous``."""
    from ..utils.drift import fingerprint

    prov = fingerprint(device=device)
    prov["git_rev"] = _git_rev()
    if osp.exists(prov_path):
        with open(prov_path) as fh:
            old = json.load(fh)
        if (old.get("final_loss"), old.get("param_sum")) != (prov["final_loss"],
                                                             prov["param_sum"]):
            prov["previous"] = old
        elif old.get("previous") is not None:
            prov["previous"] = old["previous"]
    with open(prov_path, "w") as fh:
        json.dump(prov, fh, indent=1)
        fh.write("\n")
    return prov


def main(argv=None):
    """Run the sweep; -> {shape: stats of its setup_train}."""
    parser = argparse.ArgumentParser(description="Quantitative batch evaluation")
    parser.add_argument("dataset", type=str)
    parser.add_argument("outfolder", type=str)
    parser.add_argument("--config", type=str, default=None,
                        help="JSON training config overriding the defaults")
    parser.add_argument("--mesh", type=int, default=0, metavar="N",
                        help="data-parallel training on N ranks; N=1 pins one device; "
                             "default every visible GPU (see cli.train --mesh)")
    parser.add_argument("--no-provenance", action="store_true",
                        help="skip the platform-numerics fingerprint sidecar "
                             "(results_provenance.json)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for a run without a GPU)")
    args = parser.parse_args(argv)
    # float32 means float32: no TF32 rounding of matmul or convolution inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    base = dict(DEFAULT_CONFIG)
    if args.config:
        with open(args.config) as fh:
            base.update(json.load(fh))

    os.makedirs(args.outfolder, exist_ok=True)
    results_path = osp.join(args.outfolder, "results.csv")
    if not osp.exists(results_path):
        with open(results_path, "w") as fh:
            fh.write(CSV_HEADER)
    if not args.no_provenance:
        prov = write_provenance(osp.join(args.outfolder, "results_provenance.json"), args.device)
        print(f"Platform fingerprint: {prov['final_loss']} / {prov['param_sum']}")

    all_stats = {}
    for dirpath, _, filenames in sorted(os.walk(args.dataset)):
        pcs = [f for f in filenames if f.endswith("_pc.ply")]
        if not pcs:
            continue
        pc_file = osp.join(dirpath, pcs[0])
        experiment_name = osp.basename(dirpath.rstrip("/"))
        if osp.exists(osp.join(args.outfolder, experiment_name)):
            print(f"Skipping {experiment_name}")
            continue
        print(f"Training for {experiment_name}", flush=True)

        d = dict(base)
        d["dataset"] = pc_file[: -len("_pc.ply")]
        d["experiment_name"] = experiment_name
        d["checkpoint_path"] = args.outfolder
        d["onlyPCloud"] = not any(f.endswith("_t.obj") for f in filenames)
        cfg = TrainConfig.from_dict(d)

        all_stats[experiment_name] = stats = {}
        t, cap, mu = evaluate_shape(cfg, pc_file, device=args.device, stats=stats,
                                    n_mesh_devices=args.mesh)
        with open(results_path, "a") as fh:
            fh.write(f"{experiment_name},{t},{cap[0]},{cap[1]},{cap[2]},"
                     f"{mu[0]},{mu[1]},{mu[2]}\n")
        print(f"  time={t:.1f}s CAP: L1={cap[0]:.6f} MU: L1={mu[0]:.6f}")
        print(f"Stats {experiment_name}: " + json.dumps(stats), flush=True)
    return all_stats


if __name__ == "__main__":
    main()
