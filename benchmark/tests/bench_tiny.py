"""Cells cut to a size the CPU tests can hold: the same files, a 3x32
SIREN, a batch of 300 rows and a 500-point cloud.  The cells of
``BENCHMARK.json``, and cells that are not in it yet (``PERF.md``, Open
questions): stage 2 on the mesh input, held to its limits' file, and the
stage-1 mix on both configurations, which waits for the program's
eigensolver, held here to the stage-1 limits last set on the card with
``grad_gap`` from the sound seeds."""

import copy
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import cells  # noqa: E402

with open(os.path.join(REPO, "BENCHMARK.json")) as _fh:
    MANIFEST_CELLS = tuple(w["name"] for w in json.load(_fh)["workloads"])
S1_LIMITS = {"data_gap": 1e-5, "batch_gap": 1e-5, "sdf_mean_gap": 2e-4, "loss_gap": 5e-4,
              "surface_loss_gap": 8e-6, "grad_gap": 2e-3, "step1_gap": 0.01}
# cell -> (configuration, mix, limits or None for its file under limits/)
OFF_MANIFEST = {
    "train_s2.trefoil-mesh": ("dudf-8x256-trefoil-mesh", "s2", None),
    "train_s1.torus-pc": ("dudf-8x256-torus-pc", "s1", S1_LIMITS),
    "train_s1.trefoil-mesh": ("dudf-8x256-trefoil-mesh", "s1", S1_LIMITS),
}
CELLS = MANIFEST_CELLS + tuple(OFF_MANIFEST)


def full_cell(name: str):
    """The cell at its own size, from ``BENCHMARK.json`` or ``OFF_MANIFEST``."""
    if name not in OFF_MANIFEST:
        return cells.load(name)
    config, mix, limits = OFF_MANIFEST[name]
    if limits is None:
        with open(os.path.join(REPO, "benchmark", "limits", name + ".json")) as fh:
            limits = json.load(fh)
    return cells.compose(name, os.path.join(REPO, "benchmark", "configs", config + ".json"),
                         mix, limits=limits)


def tiny_cell(name: str):
    cell = full_cell(name)
    c = copy.deepcopy(cell.config)
    c["name"] = f"tiny-{cell.traffic['stage']}-{c['name']}"
    c["network"]["hidden_layer_nodes"] = [32, 32, 32]
    c["train"]["batch_size"] = 300
    c["surface_points"] = 500
    cell.config = c
    cell.traffic = dict(cell.traffic, read_every=5)
    return cell
