#!/usr/bin/env python
"""Split the port's torus Chamfer gap (ROADMAP D1) into training and
extraction, on the CPU.

Takes a checkpoint trained by the port (``model_best.npz`` + ``.spec.json``,
e.g. from ``scripts/reproduce_demo_torch.py --keep-model torus``), extracts
it at N=256 with ``run_mc`` of both packages ("both" algorithms, default
quality), and scores each mesh's vertices against the preprocessed 100k
cloud with both packages' ``eval/chamfer.py`` (Chamfer-L1, host k-d tree).
If the JAX package's extraction of the port's field scores as the port's
does, the gap lies in training, not in extraction or evaluation.

    python scripts/d1_extraction_check.py model_best.npz [--shape torus] [--n 256]
"""

import argparse
import os
import os.path as osp
import sys
import tempfile
import time

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("model")
    parser.add_argument("--shape", default="torus")
    parser.add_argument("--n", type=int, default=256)
    parser.add_argument("--alpha", type=float, default=10.0)
    args = parser.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax.numpy as jnp

    from diffudf_tpu.cli import generate_mc as jmc
    from diffudf_tpu.eval.chamfer import chamfer_distance as jchamfer
    from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
    from diffudf_tpu_torch.cli import generate_mc as tmc
    from diffudf_tpu_torch.cli import preprocess
    from diffudf_tpu_torch.data.mesh_io import load_point_cloud
    from diffudf_tpu_torch.eval.chamfer import chamfer_distance as tchamfer
    from diffudf_tpu_torch.train import checkpoint as ckpt

    spec = ckpt.load_spec(args.model)
    params = ckpt.load_params(args.model, device="cpu")
    jparams = [{k: jnp.asarray(v.numpy()) for k, v in layer.items()} for layer in params]
    jspec = JaxSpec(hidden=spec.hidden, w0=spec.w0, ww=spec.ww, activation=spec.activation)
    with tempfile.TemporaryDirectory() as tmp:
        preprocess.preprocess_mesh(tmp, osp.join(REPO, "data", "demo", f"{args.shape}.obj"),
                                   100000)
        cloud = load_point_cloud(osp.join(tmp, f"{args.shape}_pc.ply")).points
        for pkg, run, p, s in (("torch", tmc.run_mc, params, spec),
                               ("jax", jmc.run_mc, jparams, jspec)):
            t0 = time.perf_counter()
            meshes = run(p, s, "tanh", args.n, osp.join(tmp, f"{pkg}.obj"), args.alpha, "both")
            secs = time.perf_counter() - t0
            for name, m in zip(("MU", "CAP"), meshes):
                l1_t = tchamfer(m.vertices, cloud, norm=1, backend="host")[0]
                l1_j = jchamfer(m.vertices, cloud, norm=1, backend="host")[0]
                print(f"{pkg} run_mc ({secs:.1f} s) {name}: {len(m.faces)} faces, Chamfer-L1 "
                      f"{l1_t:.6f} (port eval), {l1_j:.6f} (JAX eval)", flush=True)


if __name__ == "__main__":
    main()
