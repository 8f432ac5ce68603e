"""CLI: marching-cubes mesh extraction from a trained model, on the GPU.

The torch counterpart of ``diffudf_tpu/cli/generate_mc.py``:

    python -m diffudf_tpu_torch.cli.generate_mc <config.json> [--device cpu]

Config keys (``configs/mc_cfg.json``): alpha, gt_mode, hidden_layer_nodes,
w0, model_path (.npz + .spec.json, the JAX package's checkpoint format),
output_path, algorithm ∈ {meshudf, cap, both, siren}, nsamples (grid N),
triangulator ∈ {mc33, lewiner33, tets} (optional, default mc33),
use_pallas (false forces the plain torch path instead of the fused kernel),
quality ∈ {parity, default, enhanced}, refine_vertices (zero-set
reprojection steps of each mesh's vertices, ``extract/refine.py``: one K3a
launch a step), taubin_iters.  ``enhanced`` extracts at N ≥ 385 and
refines each mesh with 2 steps, then 10 Taubin iterations.
``shard_grid: true`` splits the lattice's field evaluations over every
visible GPU, one rank each (:mod:`..parallel.mesh`; one GPU is a group of
one), as the JAX key shards them over every device; rank 0 meshes, refines
and writes.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..data.mesh_io import Mesh, save_mesh
from ..extract.cap import extract_mesh_cap
from ..extract.meshudf import extract_mesh_meshudf
from ..extract.refine import refine_vertices
from ..extract.sdf_mc import extract_mesh_signed
from ..extract.triangulate import DEFAULT_TRIANGULATOR
from ..fields.siren import SirenSpec
from ..grid.lattice import extract_fields_sparse, extract_sdf_grid
from ..parallel.mesh import spread
from ..train import checkpoint as ckpt


VALID_ALGORITHMS = ("meshudf", "cap", "both", "siren")

# One-key quality presets bundling the extraction knobs (the JAX package's).
# "parity": every documented deviation off — reference-exact extraction
#   (anchor-signed raw CAP soup, Lewiner-33 tables, no pruning/smoothing).
# "default" (or None): the shipping defaults (vote signing + face prune +
#   light Taubin on both MC paths — same geometry class, far better
#   normals; each knob individually switchable).
# "enhanced": beyond-reference vertex quality — N≥385 sparse extraction,
#   2 zero-set reprojection steps, Taubin 10 (the combination measured at
#   beetle L1 6.77e-3 / NC 0.045, results_beetle_enhanced.csv; halves the
#   staircase-limited trefoil NC).  Preset values override the individual
#   keyword knobs they name.
QUALITY_PRESETS = {
    "parity": dict(refine_steps=0, taubin_iters=0, triangulator="lewiner33",
                   cap_signing="anchor", cap_face_prune_voxels=None,
                   cap_taubin=0, mu_face_prune_voxels=None, mu_taubin=0),
    "default": {},
    "enhanced": dict(refine_steps=2, taubin_iters=10, min_resolution=385),
}


def resolve_quality(quality, N, knobs):
    """Merge a ``QUALITY_PRESETS`` entry over the individual knob values.

    -> (N, knobs dict) with preset values overriding the knobs they name
    (``min_resolution`` only raises N, never lowers it; ``triangulator``
    only fills in an unset one).  Raises ValueError on an unknown preset.
    """
    if quality is not None and quality not in QUALITY_PRESETS:
        raise ValueError(
            f"Invalid quality {quality!r}; expected one of {sorted(QUALITY_PRESETS)}"
        )
    preset = QUALITY_PRESETS.get(quality or "default", {})
    out = dict(knobs)
    for key, val in preset.items():
        if key == "min_resolution":
            N = max(N, val)
        elif key == "triangulator":
            if out.get("triangulator") is None:
                out["triangulator"] = val
        else:
            out[key] = val
    return N, out


def run_mc(params, spec, gt_mode, N, output_path, alpha=None, algorithm="meshudf",
           triangulator=None, sparse=True, refine_steps=0,
           taubin_iters=0, use_pallas=None, cap_signing="vote",
           cap_face_prune_voxels=1.0, cap_taubin=3,
           mu_face_prune_voxels=1.0, mu_taubin=3, quality=None, stats=None, group=None):
    """Extract and save mesh(es) from params on their device; returns Mesh
    or (meshMU, meshCAP).

    The knobs are those of the JAX package's ``run_mc`` (see its docstring);
    ``group`` (its ``mesh``) splits the grid's field evaluations over the
    ranks, and rank 0 alone meshes and saves (the others return None).
    ``refine_steps`` projects each mesh's
    vertices onto the zero set (``extract.refine.refine_vertices`` at the
    resolved N; not for the ``siren`` algorithm), then ``taubin_iters``
    smooths them, in the JAX package's order.
    ``stats``: when given a dict, it receives the grid pass's stage times
    and band sizes (``grid.lattice.extract_fields_sparse``) and the seconds
    and face counts of the MeshUDF (``mu_*``) and CAP (``cap_*``) steps;
    with refinement also each mesh's ``*_refine_s`` and its largest
    displacement in voxels, ``*_refine_max_voxels`` (both included in
    ``mu_s`` / ``cap_s``).
    """
    N, knobs = resolve_quality(quality, N, dict(
        triangulator=triangulator, refine_steps=refine_steps,
        taubin_iters=taubin_iters, cap_signing=cap_signing,
        cap_face_prune_voxels=cap_face_prune_voxels, cap_taubin=cap_taubin,
        mu_face_prune_voxels=mu_face_prune_voxels, mu_taubin=mu_taubin,
    ))
    triangulator = knobs["triangulator"] or DEFAULT_TRIANGULATOR
    taubin_iters = knobs["taubin_iters"]
    if algorithm not in VALID_ALGORITHMS:
        raise ValueError(
            f"Invalid algorithm {algorithm!r}; expected one of {VALID_ALGORITHMS}"
        )
    refine_steps = knobs["refine_steps"]
    ckpt.check_params_match_spec(params, spec)
    if stats is None:
        stats = {}

    def _refine(verts, faces, tag):
        if gt_mode != "siren" and refine_steps:
            t0 = time.perf_counter()
            refined = refine_vertices(params, spec, verts, gt_mode=gt_mode, alpha=alpha, N=N,
                                      steps=refine_steps)
            stats[tag + "_refine_s"] = time.perf_counter() - t0
            move = np.linalg.norm(refined - verts, axis=1).max(initial=0.0)
            stats[tag + "_refine_max_voxels"] = float(move) * (N - 1) / 2.0
            verts = refined
        if taubin_iters:
            from ..extract.postprocess import taubin_smooth

            verts = taubin_smooth(verts, faces, iterations=taubin_iters)
        return verts

    def _mu():
        t0 = time.perf_counter()
        verts, faces = _mu_postprocessed(udf, dirs, triangulator,
                                         knobs["mu_face_prune_voxels"], knobs["mu_taubin"])
        m = Mesh(_refine(verts, faces, "mu"), faces)
        stats["mu_s"] = time.perf_counter() - t0
        stats["mu_faces"] = len(faces)
        return m

    def _cap():
        t0 = time.perf_counter()
        verts, faces = _cap_postprocessed(udf, dirs, N, triangulator, knobs["cap_signing"],
                                          knobs["cap_face_prune_voxels"],
                                          knobs["cap_taubin"])
        m = Mesh(_refine(verts, faces, "cap"), faces)
        stats["cap_s"] = time.perf_counter() - t0
        stats["cap_faces"] = len(faces)
        return m

    main_rank = group is None or group.rank == 0
    if algorithm == "siren":
        sdf = extract_sdf_grid(params, spec, N, group=group).cpu().numpy()
        if not main_rank:
            return None
        verts, faces = extract_mesh_signed(sdf, triangulator=triangulator)
        m = Mesh(verts, faces)
        save_mesh(output_path, m)
        print(f"Saved to {output_path}")
        return m

    udf, dirs = extract_fields_sparse(
        params, spec, N, gt_mode, alpha,
        coarse_stride=None if sparse else 1, use_pallas=use_pallas, stats=stats, group=group,
    )
    if not main_rank:
        return None

    if algorithm in ("cap", "meshudf"):
        m = _cap() if algorithm == "cap" else _mu()
        save_mesh(output_path, m)
        print(f"Saved to {output_path}")
        return m
    stem, ext = os.path.splitext(output_path)
    mesh_mu = _mu()
    save_mesh(stem + "_MU" + ext, mesh_mu)
    mesh_cap = _cap()
    save_mesh(stem + "_CAP" + ext, mesh_cap)
    print(f"Saved to {stem + '_MU' + ext}, {stem + '_CAP' + ext}")
    return mesh_mu, mesh_cap


def _mu_postprocessed(udf, dirs, triangulator, mu_face_prune_voxels=1.0,
                      mu_taubin=3):
    """MeshUDF extraction + the CLI cleanup knobs.

    ``extract_mesh_meshudf`` already performs the reference's own cleanup
    chain (dedupe / degenerate / border smoothing, ``render_mc.py:148-197``).
    On top of it, mirroring the CAP path's treatment (both with
    parity-off switches):

      * ``mu_face_prune_voxels`` — centroid-UDF face prune; the reference
        has this step stubbed out for MU (``render_mc.py:142``);
      * ``mu_taubin`` — light shrink-free Taubin smoothing, removing the
        MC-staircase normal noise that put MU's NC *behind* CAP's (the
        reference publishes MU ahead: NC 0.019/0.020 vs 0.024/0.025,
        BASELINE.md — restored by this knob).
    """
    verts, faces = extract_mesh_meshudf(
        udf, dirs, triangulator=triangulator or DEFAULT_TRIANGULATOR,
        max_face_dist_voxels=mu_face_prune_voxels,
    )
    if mu_taubin:
        from ..extract.postprocess import taubin_smooth

        verts = taubin_smooth(verts, faces, iterations=mu_taubin)
    return verts, faces


def _cap_postprocessed(udf, dirs, N, triangulator=None, cap_signing="vote",
                       cap_face_prune_voxels=1.0, cap_taubin=3):
    """CAP extraction + cleanup for the CLI artifact.

    The reference exports the raw CAP triangle soup (``render_mc.py:254``,
    ``process=False``).  Documented deviations, each with a parity-off
    switch (beetle A/B in README "Fidelity notes"):

      * duplicate merge / speck removal / consistent winding — same
        geometry, far better vertex normals;
      * ``cap_face_prune_voxels`` (default 1.0, None disables): drop
        faces whose centroid UDF exceeds this many voxels — the vote band
        can fabricate crossings past open borders; this is the same gate
        the reference has stubbed out for MU (``render_mc.py:142``);
      * ``cap_taubin`` (default 3, 0 disables): shrink-free Taubin
        smoothing, removing MC staircase normal noise.

    Measured on the beetle recipe: anchor-raw L1 9.65e-3 / NC 0.080 →
    vote+prune+taubin L1 9.48e-3 / NC 0.053 (MU: 9.68e-3 / 0.058).
    """
    from ..extract.meshudf import _trilinear
    from ..extract.postprocess import (
        clean_mesh,
        orient_faces_consistently,
        remove_small_components,
        taubin_smooth,
    )

    verts, faces = extract_mesh_cap(
        udf, dirs, N, triangulator=triangulator or DEFAULT_TRIANGULATOR,
        signing=cap_signing,
    )
    if cap_face_prune_voxels is not None and len(faces):
        voxel = 2.0 / (N - 1)
        d = _trilinear(np.maximum(np.asarray(udf, np.float32), 0.0),
                       verts[faces].mean(axis=1), voxel)
        faces = faces[d <= cap_face_prune_voxels * voxel]
    verts, faces = clean_mesh(verts, faces, fill_holes=False)
    verts, faces = remove_small_components(verts, faces)
    faces = orient_faces_consistently(faces)
    if cap_taubin:
        verts = taubin_smooth(verts, faces, iterations=cap_taubin)
    return verts, faces


def generate_mc(cfg: dict, device="cuda", stats: dict | None = None, group=None):
    """The mesh(es) of ``cfg``'s model (:func:`run_mc` with the config's
    knobs).  ``shard_grid`` without a ``group`` runs a group
    (:func:`..parallel.mesh.spread`: every visible GPU for ``device="cuda"``,
    the one GPU an index names); -> rank 0's result."""
    if stats is None:
        stats = {}
    if group is None and cfg.get("shard_grid"):
        return spread(generate_mc, device, cfg=cfg, stats=stats)
    params = ckpt.load_params(cfg["model_path"], device=device)
    spec = SirenSpec(
        hidden=tuple(cfg["hidden_layer_nodes"]),
        w0=cfg.get("w0", 30),
        activation=cfg.get("activation", "sine"),
    )
    if group is None or group.rank == 0:
        print("Generating mesh...")
    return run_mc(
        params, spec, cfg["gt_mode"], cfg["nsamples"], cfg["output_path"],
        cfg.get("alpha"), cfg.get("algorithm", "meshudf"),
        triangulator=cfg.get("triangulator"),
        sparse=cfg.get("sparse_grid", True),
        refine_steps=cfg.get("refine_vertices", 0),
        taubin_iters=cfg.get("taubin_iters", 0),
        use_pallas=cfg.get("use_pallas"),
        cap_signing=cfg.get("cap_signing", "vote"),
        cap_face_prune_voxels=cfg.get("cap_face_prune_voxels", 1.0),
        cap_taubin=cfg.get("cap_taubin", 3),
        mu_face_prune_voxels=cfg.get("mu_face_prune_voxels", 1.0),
        mu_taubin=cfg.get("mu_taubin", 3),
        quality=cfg.get("quality"),
        stats=stats,
        group=group,
    )


def main(argv=None):
    """Run the CLI; -> (what :func:`run_mc` returns, its ``stats`` dict)."""
    parser = argparse.ArgumentParser(description="Generate mesh from trained model")
    parser.add_argument("config_path", type=str)
    parser.add_argument("--device", default="cuda",
                        help="torch device for the field passes (default cuda)")
    args = parser.parse_args(argv)
    with open(args.config_path) as fh:
        cfg = json.load(fh)

    # float32 means float32: no TF32 rounding of matmul or convolution inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats = {}
    result = generate_mc(cfg, args.device, stats)
    print("Stats: " + json.dumps(stats))
    return result, stats


if __name__ == "__main__":
    main()
