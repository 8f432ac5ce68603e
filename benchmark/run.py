"""The benchmark of ``diffudf_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic mix,
limits and per-layer metrics are found by name (``benchmark/cells.py``); the
mix names the driver that sets up, warms up, measures for ``--seconds``
and checks the first steps against the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; then ``checks``,
each number compared beside its limit, which are also the last lines of
standard error.  A run without as many CUDA devices as the cell asks for,
or with JAX or the JAX package loaded once the window has closed, prints
no result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()  # set-up counts from here: imports included

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = REPO  # import the harness as the package ``benchmark``
FORBIDDEN = ("jax", "jaxlib", "flax", "diffudf_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, out, chips, kind):
    """The contract's JSON line for a driver's outcome ``out``."""
    entries = cell.end_to_end if out.ctx is None else cell.per_layer
    metrics = {}
    if out.ctx is None:
        for m in entries:
            metrics[m["name"]] = {"value": out.values[m["name"]], "unit": m["unit"]}
    else:
        from benchmark import cells

        for m in entries:
            v = cells.metric_reader(m["name"])(out.ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if out.ctx is not None:
        device.update(busy_s=out.busy_s, window_s=out.window_s)
    line = {"correct": bool(out.correct), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = out.checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    try:
        import torch

        from benchmark import cells

        cell = cells.load(args.workload)
    except (ImportError, OSError, KeyError, ValueError) as exc:
        print(f"benchmark: cannot load cell {args.workload!r}: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    try:
        driver = cells.driver(cell)
        import diffudf_tpu_torch  # noqa: F401  the system under test
    except ImportError as exc:
        print(f"benchmark: cannot import the program: {exc}", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    print(f"benchmark: {args.workload} seed {args.seed} on {power_limit()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    line = result_line(cell, out, cell.chips, kind)
    for name, c in out.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
