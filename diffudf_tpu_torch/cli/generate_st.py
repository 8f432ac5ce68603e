"""CLI: sphere-traced rendering of a trained field, on the GPU.

The torch counterpart of ``diffudf_tpu/cli/generate_st.py``:

    python -m diffudf_tpu_torch.cli.generate_st <config.json> [--device cpu]

The config schema is ``configs/st_cfg.json``'s: ``network_config`` (model
path in the JAX package's ``.npz`` + ``.spec.json`` format, architecture,
gt_mode, alpha) and ``rendering_config`` (resolution, camera, light,
shading, curvature plotting, passes of jittered anti-aliasing ...).

``use_pallas`` defaults to None here: the march takes the value kernel K4
and the hit attributes the fused kernel K1 wherever they apply (a CUDA
device, a uniform-width sine SIREN of width a multiple of 32 and at most
256); ``false`` forces the plain torch path.  The JAX CLI defaults it to
false only to spare a one-shot render the remote TPU compiles of its
kernels, a cost that does not exist here.

``gt_mode: "gt"`` renders the ground-truth mesh at the top-level
``mesh_path`` instead of a field (``create_projectional_image_gt``: a sphere
trace on the exact triangle distance, with the top-level ``light_pos``,
``max_iter`` and ``surface_eps`` and the float64 host camera), as the JAX
package does.

The render imports neither PIL nor matplotlib: the curvature colormap is
the package's own copy of RdYlBu and ``main`` writes the PNG with the
standard library (``render/png.py``); PIL is imported only to rotate the
image when ``rotation`` is non-zero.

``shard_rays: true`` marches over every visible GPU, one rank each
(:mod:`..parallel.mesh`; one GPU is a group of one), as the JAX key shards
the march over every device: each rank marches its block of each pass's
rays (``render.tracer.trace_rays_compacted(group=)``) and rank 0 computes
the hit geometry, shades and writes.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..data.mesh_distance import point_triangle_distance, triangles_from_mesh
from ..data.mesh_io import load_mesh
from ..fields.siren import SirenSpec
from ..ops import value as k4
from ..parallel.mesh import spread
from ..render.camera import camera_rays_device, cube_entry_points, world_rays
from ..render.png import write_png
from ..render.shading import phong_shading, rdylbu, ward_reflectance
from ..render.tracer import (gather_rows, gradient_descent_refine, hit_attributes,
                             trace_rays_compacted)
from ..train import checkpoint as ckpt


def _pad(arr, mult):
    """Pad to a power-of-4 multiple of ``mult`` rows -> (array, real rows);
    the hit-attribute passes then see the shapes the JAX package gives
    them."""
    n = len(arr)
    cap = mult
    while cap < n:
        cap *= 4
    if cap == n:
        return arr, n
    return np.concatenate([arr, np.zeros((cap - n, *arr.shape[1:]), arr.dtype)]), n


def create_projectional_image(params, spec: SirenSpec, rays, t0, mask, network_config,
                              rendering_config, stats=None, group=None):
    """One render pass -> (H·W, 3) colours: the march and the hit geometry on
    the params' device, shading on the host.  With a ``group`` each rank
    marches its block of the rays; ranks other than 0 then return None.

    rays, t0 (N, 3) and mask (N,) are tensors (the device camera) or host
    arrays.  With a ``stats`` dict, the pass records there its march
    seconds and iterations, the valid and hit ray counts, the K4 launches
    and points of its march and its K4 launches by bucket (``k4_at``:
    points -> launches), its hit-attribute and shading seconds, and
    the count of non-finite colour values.
    """
    dev = params[0]["w"].device
    gt_mode = network_config["gt_mode"]
    alpha = network_config.get("alpha", 1.0)
    # "fast_march": the mixed bf16 march (default); false = the float32
    # march, faithful to the reference's hit set at silhouettes
    fast = rendering_config.get("fast_march", True)
    use_pallas = rendering_config.get("use_pallas")
    on_device = isinstance(t0, torch.Tensor)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_start = time.perf_counter()
    k4_launches, k4_points, k4_at = k4.launches, k4.points, dict(k4.launches_at)
    positions, hits, iters = trace_rays_compacted(
        params, spec, t0, rays, mask,
        gt_mode=gt_mode, alpha=alpha,
        surface_threshold=rendering_config["surface_threshold"],
        max_iterations=rendering_config.get("max_iterations", 100),
        relaxation=rendering_config.get("relaxation", 1.0),
        fast=fast, return_device=True, use_pallas=use_pallas, group=group,
    )
    if group is not None and group.rank != 0:
        if stats is not None:
            stats.update(iterations=int(iters), k4_launches=k4.launches - k4_launches,
                         k4_points=k4.points - k4_points)
        return None
    gd_steps = rendering_config.get("gd_steps", 0)
    if gd_steps:
        positions = gradient_descent_refine(params, spec, positions, hits, gt_mode=gt_mode,
                                            alpha=alpha, steps=gd_steps)
    hits_np = hits.cpu().numpy()
    march_s = time.perf_counter() - t_start
    if hits_np.sum() == 0:
        raise ValueError(
            f"Ray tracing did not converge in "
            f"{rendering_config.get('max_iterations', 100)} iterations to any "
            f"point at distance {rendering_config['surface_threshold']} or "
            f"lower from surface."
        )
    t_attr = time.perf_counter()
    # only the hit rows cross to the host
    hit_idx = np.flatnonzero(hits_np)
    hit_pts = gather_rows(positions, hit_idx)
    pos_np = np.zeros((len(hits_np), 3), np.float32)
    pos_np[hit_idx] = hit_pts
    padded, n_real = _pad(hit_pts.astype(np.float32), 4096)
    padded = torch.as_tensor(padded, device=dev)

    if gt_mode == "siren":
        from ..autodiff.ops import value_grad

        normals = value_grad(params, spec, padded)[1].cpu().numpy()[:n_real]
        normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
        attributes_s = time.perf_counter() - t_attr
        t_shade = time.perf_counter()
        colors = phong_shading(rendering_config["light_position"],
                               rendering_config["shininess"], hits_np, pos_np, normals)
    else:
        curvature_mode = rendering_config.get("plot_curvatures", "none")
        attrs = hit_attributes(
            params, spec, padded,
            curvature_mode=curvature_mode if curvature_mode in ("mean", "gaussian") else "none",
            use_pallas=use_pallas,
        )
        attrs = {k: v.cpu().numpy()[:n_real] for k, v in attrs.items()}
        attributes_s = time.perf_counter() - t_attr
        t_shade = time.perf_counter()
        normals, pc1, pc2 = attrs["normals"], attrs["pc1"], attrs["pc2"]

        # sign-align the normals against the incoming rays
        hit_rays = gather_rows(rays, hit_idx) if on_device else np.asarray(rays)[hits_np]
        align = -np.sign(np.sum(normals * hit_rays, axis=1, keepdims=True))
        normals = normals * align

        color_map = None
        if curvature_mode in ("mean", "gaussian"):
            curv = attrs["curvature"][:, None]
            if curvature_mode == "mean":
                curv = curv * align
            lo = np.percentile(curv, rendering_config.get("curv_low_bound", 5))
            hi = np.percentile(curv, rendering_config.get("curv_high_bound", 95))
            curv = np.clip(curv, lo, hi)
            curv -= curv.min()
            curv /= max(curv.max(), 1e-12)
            color_map = rdylbu(curv[:, 0])

        if rendering_config.get("reflection_method", "blinn-phong") == "ward":
            colors = ward_reflectance(
                rendering_config["light_position"], rendering_config["camera_position"],
                hits_np, pos_np, normals,
                alpha1=rendering_config.get("alpha1", 0.2),
                alpha2=rendering_config.get("alpha2", 0.2),
                pc1=pc1, pc2=pc2, color_map=color_map,
            )
        else:
            colors = phong_shading(rendering_config["light_position"],
                                   rendering_config["shininess"], hits_np, pos_np, normals,
                                   color_map=color_map)
    if stats is not None:
        valid = mask.sum() if on_device else np.asarray(mask).sum()
        stats.update(march_s=march_s, iterations=int(iters), valid=int(valid),
                     hits=int(hits_np.sum()), k4_launches=k4.launches - k4_launches,
                     k4_points=k4.points - k4_points,
                     k4_at={n: c - k4_at.get(n, 0) for n, c in sorted(k4.launches_at.items())
                            if c > k4_at.get(n, 0)},
                     attributes_s=attributes_s,
                     shading_s=time.perf_counter() - t_shade,
                     nonfinite=int((~np.isfinite(colors)).sum()))
    return colors


def create_projectional_image_gt(mesh_path, rays, t0, mask, light_position, specular_comp=40,
                                 surface_eps=1e-3, max_iterations=30, device="cuda", stats=None):
    """Trace the GT mesh distance field directly (``render_st.py:248-281``)
    -> (H·W, 3) colours: a sphere trace on the exact distance to the mesh's
    triangles (:func:`..data.mesh_distance.point_triangle_distance`, on
    ``device``), then central-difference normals of that distance and Phong
    shading on the host.  rays, t0 (N, 3) and mask (N,) are host arrays.
    With a ``stats`` dict, the pass records there its march seconds and
    iterations, the valid and hit ray counts and the count of non-finite
    colour values."""
    mesh = load_mesh(mesh_path)
    tris = triangles_from_mesh(mesh.vertices, mesh.faces, device=device)

    def distance(x):
        q = torch.as_tensor(np.asarray(x, np.float32), device=device)
        return point_triangle_distance(q, tris).cpu().numpy()

    t_start = time.perf_counter()
    t0 = np.array(t0)
    active = np.array(mask)
    hits = np.zeros_like(active)
    iters = 0
    for _ in range(max_iterations):
        if not active.any():
            break
        iters += 1
        d = distance(t0[active])
        t0[active] += rays[active] * d[:, None]
        close = d < surface_eps
        idx = np.flatnonzero(active)
        hits[idx[close]] = True
        active[idx[close]] = False
        out = np.any(np.abs(t0) > 1.3, axis=1)
        active &= ~out
    march_s = time.perf_counter() - t_start
    if hits.sum() == 0:
        raise ValueError("GT ray tracing did not converge")

    # central-difference normals of the GT field
    eps = 1e-4
    pts = t0[hits]
    grads = []
    for i in range(3):
        e = np.zeros(3)
        e[i] = eps
        grads.append((distance(pts + e) - distance(pts - e)) / (2 * eps))
    normals = np.stack(grads, axis=1)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
    flip = np.sum(normals * rays[hits], axis=1, keepdims=True) > 0
    normals = np.where(flip, -normals, normals)
    colors = phong_shading(light_position, specular_comp, hits, t0, normals)
    if stats is not None:
        stats.update(march_s=march_s, iterations=iters, valid=int(np.asarray(mask).sum()),
                     hits=int(hits.sum()), nonfinite=int((~np.isfinite(colors)).sum()))
    return colors


def generate_st(config: dict, device="cuda", stats=None, group=None):
    """Multi-pass anti-aliased render -> (H, W, 3) uint8 image.

    With a ``stats`` dict, ``stats["passes"]`` lists each pass's record
    (see :func:`create_projectional_image`).  ``shard_rays`` without a
    ``group`` runs a group (:func:`..parallel.mesh.spread`: every visible
    GPU for ``device="cuda"``, the one GPU an index names); with a group
    each pass's march is split over the ranks and rank 0 returns the image
    (the others None)."""
    network_config = config["network_config"]
    rendering = config["rendering_config"]
    gt = network_config.get("gt_mode") == "gt"
    if group is None and rendering.get("shard_rays") and not gt:
        return spread(generate_st, device, config=config, stats=stats)
    W, H = rendering["width"], rendering["height"]
    n_passes = rendering.get("sample_rate", 1)

    rng = np.random.default_rng(config.get("seed", 0))
    colors = np.zeros((H * W, 3))
    if not gt:
        params = ckpt.load_params(network_config["model_path"], device=device)
        spec = SirenSpec(
            hidden=tuple(network_config["hidden_layer_nodes"]),
            w0=network_config.get("w0", 30),
            activation=network_config.get("activation", "sine"),
        )
    # the float32 device camera by default; the float64 host camera under
    # "device_camera": false (the golden-parity path) and for the GT trace
    device_camera = rendering.get("device_camera", True) and not gt
    passes = []
    for _ in range(n_passes):
        noise = rng.normal(0.5, 0.35)
        if device_camera:
            rays, t0, valid = camera_rays_device(
                W, H, rendering["fov"], rendering["camera_position"], noise,
                rendering.get("planes"), device=device,
            )
        else:
            rays = world_rays(W, H, rendering["fov"], rendering["camera_position"], noise)
            t0, valid = cube_entry_points(rays, rendering["camera_position"],
                                          rendering.get("planes"))
        passes.append({})
        if gt:
            colors += create_projectional_image_gt(
                config["mesh_path"], rays, t0, valid, np.asarray(config["light_pos"]),
                max_iterations=config.get("max_iter", 30),
                surface_eps=config.get("surface_eps", 1e-3), device=device, stats=passes[-1])
        else:
            pass_colors = create_projectional_image(params, spec, rays, t0, valid,
                                                    network_config, rendering,
                                                    stats=passes[-1], group=group)
            if pass_colors is not None:
                colors += pass_colors
    if stats is not None:
        stats["passes"] = passes
    if group is not None and group.rank != 0:
        return None

    img = (colors / n_passes * 255).astype(np.uint8).reshape(H, W, 3)
    if rendering.get("rotation", 0):
        from PIL import Image

        img = np.asarray(Image.fromarray(img).rotate(rendering["rotation"]))
    return img


def main(argv=None):
    """Run the CLI; -> (the image, its ``stats`` dict)."""
    parser = argparse.ArgumentParser(description="Sphere-traced render")
    parser.add_argument("config_path", type=str)
    parser.add_argument("--device", default="cuda",
                        help="torch device for the march and the hit geometry (default cuda)")
    args = parser.parse_args(argv)
    with open(args.config_path) as fh:
        config = json.load(fh)

    # float32 means float32: no TF32 rounding of matmul or convolution inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats = {}
    t0 = time.perf_counter()
    img = generate_st(config, device=args.device, stats=stats)
    stats["render_s"] = time.perf_counter() - t0
    write_png(config["rendering_config"]["output_path"], img)
    print("Stats: " + json.dumps(stats))
    return img, stats


if __name__ == "__main__":
    main()
