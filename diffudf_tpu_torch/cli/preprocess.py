"""CLI: preprocess meshes / point clouds for training: the torch package's
copy of ``diffudf_tpu/cli/preprocess.py`` (host numpy, no device), which
writes the same files byte for byte.

    python -m diffudf_tpu_torch.cli.preprocess <input> <output_dir> [-s N] [-pc]

For a mesh input writes ``<name>_t.obj`` (normalised into the side-2 cube
with 10% margin) and ``<name>_pc.ply`` (N surface samples with triangle
normals).  For a point-cloud input (``-pc``) writes ``<name>_t.ply`` +
``<name>_pc.ply`` subsampled without replacement.  Directory inputs are
walked recursively, skipping already-produced ``_t`` / ``_pc`` files.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.mesh_io import (
    PointCloudData,
    load_mesh,
    load_point_cloud,
    save_mesh,
    save_point_cloud,
)
from ..data.normalize import normalize_mesh, normalize_point_cloud
from ..data.sampling import sample_surface_points


def preprocess_mesh(output_dir: str, mesh_file: str, surface_points: int = 100000,
                    seed: int = 123):
    mesh = load_mesh(mesh_file)
    mesh, _ = normalize_mesh(mesh)
    name = os.path.splitext(os.path.basename(mesh_file))[0]
    os.makedirs(output_dir, exist_ok=True)
    save_mesh(os.path.join(output_dir, name + "_t.obj"), mesh)
    pts, normals = sample_surface_points(mesh, int(surface_points), seed=seed)
    save_point_cloud(
        os.path.join(output_dir, name + "_pc.ply"), PointCloudData(pts, normals)
    )
    return name


def preprocess_point_cloud(output_dir: str, pc_file: str, surface_points: int = 100000,
                           seed: int = 123):
    pc = load_point_cloud(pc_file)
    pc, _ = normalize_point_cloud(pc)
    name = os.path.splitext(os.path.basename(pc_file))[0]
    if surface_points > len(pc.points):
        raise ValueError(
            f"Cannot sample more points ({surface_points}) than present on the "
            f"input pointcloud ({len(pc.points)})."
        )
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(pc.points), size=int(surface_points), replace=False)
    os.makedirs(output_dir, exist_ok=True)
    save_point_cloud(os.path.join(output_dir, name + "_t.ply"), pc)
    save_point_cloud(
        os.path.join(output_dir, name + "_pc.ply"),
        PointCloudData(pc.points[idx], None if pc.normals is None else pc.normals[idx]),
    )
    return name


def main(argv=None):
    parser = argparse.ArgumentParser(description="Preprocess geometry for training")
    parser.add_argument("input_path", type=str)
    parser.add_argument("output_path", type=str)
    parser.add_argument("-s", "--samples", type=int, default=100000)
    parser.add_argument("-pc", "--pointcloud", action="store_true")
    args = parser.parse_args(argv)

    if os.path.isfile(args.input_path):
        if args.pointcloud:
            preprocess_point_cloud(args.output_path, args.input_path, args.samples)
        else:
            preprocess_mesh(args.output_path, args.input_path, args.samples)
        return

    ext = ".ply" if args.pointcloud else ".obj"
    for dirpath, _, filenames in os.walk(args.input_path):
        for fname in filenames:
            stem = os.path.splitext(fname)[0]
            if not fname.endswith(ext) or stem.endswith("_t") or stem.endswith("_pc"):
                continue
            print(f"Processing {fname}...")
            if args.pointcloud:
                preprocess_point_cloud(dirpath, os.path.join(dirpath, fname), args.samples)
            else:
                preprocess_mesh(dirpath, os.path.join(dirpath, fname), args.samples)


if __name__ == "__main__":
    main()
