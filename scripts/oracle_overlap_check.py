#!/usr/bin/env python
"""Time mesh-mode training with the oracle build overlapped and not, in turns.

Preprocesses ``data/demo/<shape>.obj`` (100k surface samples) and runs
``cli.train.setup_train`` on the demo recipe in mesh mode, cut to
``--epochs`` epochs (s1 for four fifths of them), with the candidate-grid
build on a host thread behind the first epochs (overlap on, the default)
and before training (overlap off, ``DIFFUDF_ORACLE_OVERLAP=0``), in the
order on, off, off, on, ... so that drift on the machine falls on both.
The oracle cache is off, so every run builds.  Each run prints its
pipeline seconds, the build's seconds (the thread's wall time with the
overlap, so the host contention of the launches shows in it), the swap
epoch, the bootstrap epochs and the s1 rate; the last lines give the
medians of each side and a build timed alone.  Needs a GPU:

    python scripts/oracle_overlap_check.py [--shape trefoil] [--epochs 500] [--pairs 2]
"""

import argparse
import json
import os
import os.path as osp
import statistics
import sys
import tempfile
import time

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--shape", default="trefoil")
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from diffudf_tpu_torch.cli import preprocess, train
    from diffudf_tpu_torch.cli.quantitative import DEFAULT_CONFIG
    from diffudf_tpu_torch.config import TrainConfig
    from diffudf_tpu_torch.data.mesh_io import load_mesh
    from diffudf_tpu_torch.data.oracle_cache import cached_candidate_grid_host

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["DIFFUDF_ORACLE_CACHE"] = "0"
    train.SLICE_WIDTH = 64  # the figure is not what is timed here
    work = tempfile.mkdtemp(prefix="overlap_check_")
    data = osp.join(work, "data")
    preprocess.preprocess_mesh(data, osp.join(REPO, "data", "demo", f"{args.shape}.obj"), 100000)
    if args.device == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)

    runs = {True: [], False: []}
    order = [flag for _ in range(args.pairs) for flag in (True, False)]
    order = [flag if i % 4 < 2 else not flag for i, flag in enumerate(order)]  # on off off on
    for i, overlap in enumerate(order):
        cfg = TrainConfig.from_dict(dict(
            DEFAULT_CONFIG, dataset=osp.join(data, args.shape), onlyPCloud=False,
            experiment_name=f"run{i}", checkpoint_path=osp.join(work, "runs"),
            num_epochs=args.epochs, s1_epochs=4 * args.epochs // 5,
            warmup_epochs=min(1000, 4 * args.epochs // 5)))
        stats = {}
        pipeline_s, _, _ = train.setup_train(cfg, make_meshes=False, verbose=False,
                                             device=args.device, stats=stats,
                                             overlap_oracle=overlap)
        row = {"overlap": overlap, "pipeline_s": pipeline_s,
               **{k: stats[k] for k in ("oracle_s", "oracle_build_s", "swap_epoch",
                                        "bootstrap_epochs", "train_s", "s1_s", "s1_steps")}}
        row["s1_steps_per_s"] = row["s1_steps"] / row["s1_s"]
        runs[overlap].append(row)
        print(json.dumps(row), flush=True)

    m = load_mesh(osp.join(data, f"{args.shape}_t.obj"))
    tris = np.asarray(m.vertices[m.faces], np.float32)
    t0 = time.perf_counter()
    cached_candidate_grid_host(tris, None)
    alone = time.perf_counter() - t0
    summary = {"triangles": len(tris), "epochs": args.epochs, "build_alone_s": alone}
    for overlap, rows in runs.items():
        side = "overlap_on" if overlap else "overlap_off"
        for k in ("pipeline_s", "oracle_build_s", "train_s", "s1_steps_per_s"):
            summary[f"{side}_median_{k}"] = statistics.median(r[k] for r in rows)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
