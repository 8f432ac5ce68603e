"""CLI: dense point-cloud extraction from a trained model, on the GPU.

The torch counterpart of ``diffudf_tpu/cli/generate_pc.py``:

    python -m diffudf_tpu_torch.cli.generate_pc <config.json> [--device cpu]

Config keys (``configs/pc_cfg.json``): model_path (.npz + .spec.json, the
JAX package's checkpoint format), hidden_layer_nodes, w0, activation,
gt_mode, alpha, nsamples, ref_steps, surf_thresh, max_iter, output_path.
Not ported: ``shard_points`` (several devices).  Prints a ``Stats:`` line:
the sampler's rounds, candidates and kept rows a round, projection seconds
and K3a / K1 launches, and the orientation's host seconds.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..data.mesh_io import PointCloudData, save_point_cloud
from ..fields.siren import SirenSpec
from ..pc.sampler import generate_point_cloud, orient_normals_consistent
from ..train import checkpoint as ckpt


def generate_pc(config: dict, device="cuda", stats: dict | None = None) -> PointCloudData:
    """The oriented point cloud of ``config``'s model; ``stats`` as
    :func:`..pc.sampler.generate_point_cloud` fills it, plus ``orient_s``."""
    if config.get("shard_points"):
        raise NotImplementedError(
            "shard_points (several devices) is not ported yet: ROADMAP.md, "
            "'Modules to port', item 5 'Multi-GPU and utils'")
    if stats is None:
        stats = {}
    params = ckpt.load_params(config["model_path"], device=device)
    spec = SirenSpec(
        hidden=tuple(config["hidden_layer_nodes"]),
        w0=config.get("w0", 30),
        activation=config.get("activation", "sine"),
    )
    ckpt.check_params_match_spec(params, spec)
    points, normals = generate_point_cloud(
        params, spec,
        gt_mode=config["gt_mode"], alpha=config.get("alpha", 1.0),
        num_steps=config.get("ref_steps", 5),
        num_points=config.get("nsamples", 20000),
        surf_thresh=config.get("surf_thresh", 0.01),
        max_iter=config.get("max_iter", 1000),
        stats=stats,
    )
    t0 = time.perf_counter()
    normals = orient_normals_consistent(points, normals, k=10)
    stats["orient_s"] = time.perf_counter() - t0
    return PointCloudData(points, normals)


def main(argv=None):
    """Run the CLI; -> (the PointCloudData, its ``stats`` dict)."""
    parser = argparse.ArgumentParser(description="Generate dense point cloud")
    parser.add_argument("config_path", type=str)
    parser.add_argument("--device", default="cuda",
                        help="torch device for the projections (default cuda)")
    args = parser.parse_args(argv)
    with open(args.config_path) as fh:
        config = json.load(fh)

    # float32 means float32: no TF32 rounding of matmul or convolution inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats = {}
    t0 = time.perf_counter()
    pc = generate_pc(config, device=args.device, stats=stats)
    stats["total_s"] = time.perf_counter() - t0
    save_point_cloud(config["output_path"], pc)
    print(f"Saved {len(pc.points)} points to {config['output_path']}")
    print("Stats: " + json.dumps(stats))
    return pc, stats


if __name__ == "__main__":
    main()
