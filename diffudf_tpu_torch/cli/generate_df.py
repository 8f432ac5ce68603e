"""CLI: 2D distance-field slice diagnostics for a trained model, on the GPU.

The torch counterpart of ``diffudf_tpu/cli/generate_df.py`` (reference
surface ``generate_df.py:247-266``):

    python -m diffudf_tpu_torch.cli.generate_df <geometry> <model.npz> <out_dir/>
        [-w width] [-t surf_thresh] [--gt_mode MODE] [-a alpha] [-w0 W0]
        [--hidden H ...] [--device cpu]

<geometry> is a mesh (``.obj``, e.g. a preprocessed ``_t.obj``: exact GT
distances by the brute triangle sweep) or a ``.ply`` point cloud
(nearest-point GT distances: one launch of the kernel K5 on the GPU).  The
prediction is one launch of K1.  Writes ``distance_fields.png`` and
``pred_grad.png`` (:mod:`..grid.slices`, drawn without matplotlib or PIL)
and prints a ``Stats:`` line with the seconds of the prediction
(``predict_s``), the GT distances (``gt_s``) and the drawing
(``render_s``); the first two end in a read to the host, which waits for
the device.  ``cli.train`` draws the same figure through
:func:`slice_figure`.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..data.mesh_distance import point_cloud_distance, point_triangle_distance, triangles_from_mesh
from ..data.mesh_io import load_mesh, load_point_cloud
from ..fields.siren import SirenSpec
from ..grid.slices import plane_samples, predicted_slice, render_slice_figure
from ..train import checkpoint as ckpt


def slice_figure(params, spec: SirenSpec, gt_distances, gt_mode: str, alpha: float,
                 width: int, output_path: str, surf_thresh: float = 1e-3) -> dict:
    """Predict the x=0 slice (K1), take its GT distances from
    ``gt_distances(samples)`` ((W², 3) tensor on the params' device ->
    (W²,) tensor) and draw both PNGs into ``output_path``; -> stats dict
    (``predict_s``, ``gt_s``, ``render_s``)."""
    device = params[0]["w"].device
    stats = {}
    t0 = time.perf_counter()
    pred = predicted_slice(params, spec, width)
    stats["predict_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    samples = torch.as_tensor(plane_samples(width), device=device)
    with torch.no_grad():
        gt = gt_distances(samples).abs().cpu().numpy()
    stats["gt_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    render_slice_figure(pred, gt, gt_mode, alpha, width, output_path, surf_thresh=surf_thresh)
    stats["render_s"] = time.perf_counter() - t0
    return stats


def generate_df(model_path, geometry_path, output_path, options, device="cuda") -> dict:
    """Draw the slice figure of the model at ``model_path`` against the
    geometry; -> stats dict (:func:`slice_figure`)."""
    params = ckpt.load_params(model_path, device=device)
    spec = SirenSpec(
        hidden=tuple(options["hidden_layer_nodes"]),
        w0=options.get("weight0", 30),
        activation=options.get("activation", "sine"),
    )
    ckpt.check_params_match_spec(params, spec)
    if geometry_path.endswith(".obj"):
        mesh = load_mesh(geometry_path)
        tris = triangles_from_mesh(mesh.vertices, mesh.faces, device=device)

        def gt_distances(samples):
            return point_triangle_distance(samples, tris)
    else:
        cloud = torch.as_tensor(np.asarray(load_point_cloud(geometry_path).points, np.float32),
                                device=device)

        def gt_distances(samples):
            return point_cloud_distance(samples, cloud)
    return slice_figure(params, spec, gt_distances, options.get("gt_mode", "tanh"),
                        options.get("alpha", 1.0), options.get("width", 512), output_path,
                        surf_thresh=options.get("surf_thresh", 1e-3))


def main(argv=None):
    """Run the CLI; -> its stats dict."""
    parser = argparse.ArgumentParser(description="Generate distance-field slices")
    parser.add_argument("geometry_path", type=str)
    parser.add_argument("model_path", type=str)
    parser.add_argument("output_path", type=str)
    parser.add_argument("-w0", "--weight0", type=float, default=30)
    parser.add_argument("-w", "--width", type=int, default=512)
    parser.add_argument("-t", "--surf_thresh", type=float, default=1e-3)
    parser.add_argument("--gt_mode", type=str, default="tanh")
    parser.add_argument("-a", "--alpha", type=float, default=1)
    parser.add_argument("--hidden", type=int, nargs="+", default=[256] * 8)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for a run without a GPU)")
    args = parser.parse_args(argv)
    opts = vars(args)
    opts["hidden_layer_nodes"] = opts.pop("hidden")
    # float32 means float32: no TF32 rounding of matmul or convolution inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats = generate_df(args.model_path, args.geometry_path, args.output_path, opts,
                        device=opts.pop("device"))
    print("Stats: " + json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
