"""Readings that the limits of a training cell are set from, at the cell's
own size, on many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed the program runs its checked steps as in a benchmark run
(``drivers/train.start``) and every number of ``checks.py`` is read for:

* ``program``: the program against the reference (the lower readings);
* ``control``: the reference computed with TF32 products, the precision
  below the configuration's float32, in the program's place;
* ``half_batch``: the reference on every other row of each batch, the mean
  taken over those;
* ``altered``: the reference with each far row's GT distance made 1% too
  large, an oracle answer altered where it is produced;
* ``moved``: the reference with each near row's point moved by 1e-3, a
  sampled point altered where it is produced;
* ``unchanged``: a step that returns its state unchanged (no gradient in
  Adam's moment, no change of the parameters);
* ``cloud_moved``: ``data_gap`` of the program's cloud with every point
  moved by 1e-3 along x, a data set altered where it is produced.

Beside them, per seed: ``terms`` (the first step's relative gap of each
term, for the program and the control) and, in stage 1, ``witness``, the
reference with the Hessian's eigenvectors taken in float32 (a plain
float32 path), its terms, and ``eigen`` (the first batch's surface rows by
the relative gap between the Hessian's two largest eigenvalues).  A run
with no CUDA device stops.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = REPO


def altered(split):
    """-> a change of the reference's batches: each far row's GT distance 1%
    too large."""

    def alter(batches):
        out = []
        for pts, nrm, sdf in batches:
            sdf = sdf.clone()
            sdf[split.on:split.on + split.far] *= 1.01
            out.append((pts, nrm, sdf))
        return out

    return alter


def moved(split):
    """-> a change of the reference's batches: each near row's point moved by
    1e-3 along x, its GT distance kept."""

    def alter(batches):
        out = []
        for pts, nrm, sdf in batches:
            pts = pts.clone()
            pts[split.on + split.far:, 0] += 1e-3
            out.append((pts, nrm, sdf))
        return out

    return alter


def readings(cell, prep, seed, device):
    import numpy as np
    import torch

    from benchmark import checks, reference
    from benchmark.drivers import train

    stage = cell.traffic["stage"]
    trainer, state, gen, _, first = train.start(cell, prep, seed, device)
    del trainer, state, gen
    data, data_gap = train.reference_data(cell, prep, device)
    ref_b, ref = train.reference_steps(cell, data, first, device)
    prog = dataclasses.asdict(first)
    out = {"program": dict(checks.gaps(prog, ref, first.batches, ref_b, stage),
                           data_gap=data_gap)}
    _, ctl = train.reference_steps(cell, data, first, device, tf32=True)
    out["control"] = checks.gaps(ctl, ref, stage=stage)
    _, half = train.reference_steps(cell, data, first, device,
                                    rows=lambda n: torch.arange(0, n, 2))
    out["half_batch"] = checks.gaps(half, ref, stage=stage)
    t = cell.config["train"]
    split = reference.Split.of(t["batch_size"], t["sampling_percentiles"])
    alt_b, alt = train.reference_steps(cell, data, first, device, alter=altered(split))
    out["altered"] = checks.gaps(alt, ref, alt_b, ref_b, stage)
    mov_b, mov = train.reference_steps(cell, data, first, device, alter=moved(split))
    out["moved"] = checks.gaps(mov, ref, mov_b, ref_b, stage)
    still = dict(prog, grad1=[0 * g for g in prog["grad1"]], delta1=[0 * d for d in prog["delta1"]],
                 delta=[0 * d for d in prog["delta"]])
    out["unchanged"] = checks.gaps(still, ref, stage=stage)
    tris = torch.as_tensor(reference.normalized_triangles(
        os.path.join(REPO, cell.config["mesh"])), device=device)
    shift = torch.tensor([1e-3, 0.0, 0.0], device=device)
    out["cloud_moved"] = {"data_gap": float(reference.cloud_off_mesh(
        data["cloud"] + shift, data["normals"], tris).max())}
    runs = [("program", prog), ("control", ctl)]
    if stage == "s1":
        _, wit = train.reference_steps(cell, data, first, device, eig_dtype=torch.float32)
        out["witness"] = checks.gaps(wit, ref, stage=stage)
        runs.append(("witness", wit))
        out["eigen"] = _eigen_gaps(cell, first, split, device)
    out["terms"] = {k: (np.abs(np.asarray(v["terms"])[0] - ref["terms"][0])
                        / np.abs(ref["terms"][0])).tolist() for k, v in runs}
    return out


def _eigen_gaps(cell, first, split, device):
    """The first batch's surface rows by the gap between the Hessian's two
    largest eigenvalues, over its largest magnitude, at the initial weights."""
    import torch

    from benchmark import reference

    p0 = [torch.as_tensor(p, device=device) for p in first.params0]
    params = [(p0[2 * i], p0[2 * i + 1]) for i in range(len(p0) // 2)]
    pts = torch.as_tensor(first.batches[0][0][:split.on], device=device)
    _, _, hm = reference.siren_derivatives(params, pts, float(cell.config["network"]["w0"]), True)
    lam = torch.linalg.eigvalsh(hm.double())
    rel = ((lam[:, 2] - lam[:, 1]) / lam.abs().amax(1)).cpu().numpy()
    return {"below": {t: int((rel < float(t)).sum()) for t in ("1e-2", "1e-3", "1e-4")},
            "smallest": float(rel.min())}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from benchmark import cells
    from benchmark.drivers import train

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cell = cells.load(args.workload, limits=False)
    prep = train.prepare(cell, "cuda")
    rows = []
    for s in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(cell, prep, s, "cuda")
        rows.append({"seed": s, **r})
        print(json.dumps({"seed": s, "seconds": time.perf_counter() - t0, **r}), flush=True)
    summary = {}
    kinds = ("program", "control", "half_batch", "altered", "moved", "unchanged", "cloud_moved",
             "witness")
    for kind in (k for k in kinds if k in rows[0]):
        agg = max if kind == "program" else min
        names = rows[0][kind].keys()
        summary[kind] = {n: agg(r[kind][n] for r in rows) for n in names}
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "lower_max": summary["program"],
                      "upper_min": {k: v for k, v in summary.items() if k != "program"}}),
          flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"workload": args.workload, "rows": rows, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
