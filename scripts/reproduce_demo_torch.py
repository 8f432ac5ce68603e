#!/usr/bin/env python
"""The five-shape demo sweep through the PyTorch/CUDA port.

The port's counterpart of ``python scripts/reproduce_demo.py [--mode pc]``:
preprocesses each committed ``data/demo/<shape>.obj`` with the port's
``cli.preprocess`` (100k surface samples) into its own subdirectory and runs
``python -m diffudf_tpu_torch.cli.quantitative`` over them with the JAX
package's ``DEFAULT_CONFIG`` recipe.  ``--mode mesh`` (default) keeps each
``_t.obj``, so every shape trains from its mesh (the triangle oracle, its
build overlapped with training); ``--mode pc`` drops it, so every shape
trains from its point cloud (``onlyPCloud``); ``--mode enhanced`` trains
from each mesh and extracts with ``"quality": "enhanced"`` (N=385, two
refinement steps of each mesh's vertices, Taubin 10), the JAX script's
override.  Needs a GPU:

    python scripts/reproduce_demo_torch.py --out DIR [--mode pc|enhanced] [--keep-model torus]

``--config`` (the mode's keys override it), ``--no-provenance`` and
``--device cpu`` pass through to ``cli.quantitative`` (a small config and
``--samples`` make a CPU rehearsal).

Writes ``results.csv`` and ``results_provenance.json`` to ``--out`` and
prints each shape's Chamfer-L1 beside its protocol floor in
``results/protocol_floors_demo.json`` and the JAX package's row in
``results/results_demo.csv`` (mesh), ``results/results_demo_pc.csv`` (pc) or
``results/results_demo_enhanced.csv`` (enhanced),
with the signed gap of each mesh's Chamfer-L1 to the JAX row, and each
shape's oracle build seconds, swap epoch and bootstrap epochs.
``--keep-model`` copies a shape's ``model_best`` checkpoint to ``--out`` as
well.
"""

import argparse
import csv
import json
import os
import os.path as osp
import shutil
import sys
import tempfile

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = ("torus", "trefoil", "cloth", "shell", "skirt")
# per mode: the JAX package's CSV and the config keys it sets
# (scripts/reproduce_demo.py MODES)
MODES = {
    "mesh": ("results_demo.csv", {}),
    "pc": ("results_demo_pc.csv", {}),
    "enhanced": ("results_demo_enhanced.csv", {"quality": "enhanced"}),
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--samples", type=int, default=100000)
    parser.add_argument("--mode", choices=sorted(MODES), default="mesh")
    parser.add_argument("--out", required=True, help="directory for the results")
    parser.add_argument("--keep-model", action="append", default=[], metavar="SHAPE")
    parser.add_argument("--config", default=None)
    parser.add_argument("--no-provenance", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from diffudf_tpu_torch.cli import preprocess, quantitative

    work = tempfile.mkdtemp(prefix="demo_sweep_torch_")
    dataset = osp.join(work, "dataset")
    for shape in SHAPES:
        shape_dir = osp.join(dataset, shape)
        preprocess.preprocess_mesh(shape_dir, osp.join(REPO, "data", "demo", f"{shape}.obj"),
                                   args.samples)
        if args.mode == "pc":
            os.remove(osp.join(shape_dir, f"{shape}_t.obj"))  # point-cloud input

    jax_csv, overrides = MODES[args.mode]
    config = {}
    if args.config:
        with open(args.config) as fh:
            config = json.load(fh)
    config.update(overrides)
    cfg_path = osp.join(work, "cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(config, fh)

    exp_dir = osp.join(work, "results")
    extra = ["--device", args.device, "--config", cfg_path]
    all_stats = quantitative.main([dataset, exp_dir] + extra
                                  + (["--no-provenance"] if args.no_provenance else []))

    os.makedirs(args.out, exist_ok=True)
    for name in ("results.csv", "results_provenance.json"):
        if osp.exists(osp.join(exp_dir, name)):
            shutil.copy(osp.join(exp_dir, name), osp.join(args.out, name))
    for shape in args.keep_model:
        for suffix in (".npz", ".spec.json"):
            src = osp.join(exp_dir, shape, "models", "model_best" + suffix)
            if osp.exists(src):
                shutil.copy(src, osp.join(args.out, f"{shape}_model_best{suffix}"))

    with open(osp.join(REPO, "results", "protocol_floors_demo.json")) as fh:
        floors = {r["shape"]: r for r in json.load(fh)}
    with open(osp.join(REPO, "results", jax_csv)) as fh:
        jax_rows = {r["mesh"]: r for r in csv.DictReader(fh)}
    with open(osp.join(args.out, "results.csv")) as fh:
        for r in csv.DictReader(fh):
            name, floor, jr = r["mesh"], floors[r["mesh"]], jax_rows[r["mesh"]]
            gap = {k: float(r[f"L1CD_{k}"]) / float(jr[f"L1CD_{k}"]) - 1 for k in ("CAP", "MU")}
            st = all_stats.get(name, {})
            print(f"{name}: time {float(r['time']):.2f} s; CAP L1 {float(r['L1CD_CAP']):.6f} "
                  f"L2 {float(r['L2CD_CAP']):.4e} NC {float(r['NC_CAP']):.5f}; MU L1 "
                  f"{float(r['L1CD_MU']):.6f} L2 {float(r['L2CD_MU']):.4e} NC "
                  f"{float(r['NC_MU']):.5f}; floor L1 {floor['floor_L1CD']} NC "
                  f"{floor['floor_NC']}; JAX package ({jax_csv}) CAP L1 "
                  f"{float(jr['L1CD_CAP']):.6f} MU L1 {float(jr['L1CD_MU']):.6f}; gap CAP "
                  f"{gap['CAP']:+.2%} MU {gap['MU']:+.2%}; oracle build "
                  f"{st.get('oracle_build_s')} s, swap epoch {st.get('swap_epoch')}, "
                  f"bootstrap epochs {st.get('bootstrap_epochs')}")
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
