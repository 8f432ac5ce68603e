#!/usr/bin/env python
"""Do the two packages preprocess a demo shape the same way?  (ROADMAP D1.)

Runs ``cli.preprocess`` of the JAX package and of the PyTorch port on the
same mesh (default ``data/demo/torus.obj``, 100k samples, seed 123) into a
temporary directory, on the CPU, and prints for each package: the sample
count, the largest absolute coordinate of the normalised mesh and cloud
(1/1.1 by construction: centroid to the origin, scale 1/(1.1·max|x|)), and
then whether the files are identical byte for byte and the Chamfer-L1 and
normal consistency of the two clouds against each other (the port's
``eval/chamfer.py``, host backend).

    python scripts/d1_preprocess_check.py [mesh.obj] [--samples N]
"""

import argparse
import filecmp
import os
import os.path as osp
import sys
import tempfile

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("mesh", nargs="?", default=osp.join(REPO, "data", "demo", "torus.obj"))
    parser.add_argument("--samples", type=int, default=100000)
    args = parser.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    from diffudf_tpu.cli import preprocess as jpre
    from diffudf_tpu_torch.cli import preprocess as tpre
    from diffudf_tpu_torch.data.mesh_io import load_mesh, load_point_cloud
    from diffudf_tpu_torch.eval.chamfer import chamfer_distance

    name = osp.splitext(osp.basename(args.mesh))[0]
    with tempfile.TemporaryDirectory() as tmp:
        clouds = {}
        for pkg, mod in (("jax", jpre), ("torch", tpre)):
            out = osp.join(tmp, pkg)
            mod.preprocess_mesh(out, args.mesh, args.samples)
            mesh = load_mesh(osp.join(out, f"{name}_t.obj"))
            pc = load_point_cloud(osp.join(out, f"{name}_pc.ply"))
            clouds[pkg] = pc
            print(f"{pkg}: {len(pc.points)} samples; max |coord| mesh "
                  f"{np.abs(mesh.vertices).max():.9f}, cloud {np.abs(pc.points).max():.9f} "
                  f"(1/1.1 = {1 / 1.1:.9f}); mesh centroid {mesh.vertices.mean(0)}")
        for suffix in ("_t.obj", "_pc.ply"):
            same = filecmp.cmp(osp.join(tmp, "jax", name + suffix),
                               osp.join(tmp, "torch", name + suffix), shallow=False)
            print(f"{name}{suffix} identical byte for byte: {same}")
        a, b = clouds["jax"], clouds["torch"]
        l1, nc = chamfer_distance(a.points, b.points, a.normals, b.normals, norm=1,
                                  backend="host")
        print(f"Chamfer-L1 of the two clouds: {l1}; normal consistency loss: {nc}")


if __name__ == "__main__":
    main()
