"""A cell of ``BENCHMARK.json`` and the files that belong to it, found by
name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py``, all in this folder.
A mix runs on the driver (``drivers/<driver>.py``) its file names under
``driver``, the training driver where it names none."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MANIFEST = os.path.join(REPO, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the manifest's entries this cell reports
    per_layer: list


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(entry: dict, cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports the metric ``entry``: a metric with
    ``workloads`` in those cells; else an end-to-end metric in every cell,
    and a per-layer one in every cell that reports the metric it moves."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry["moves"] in e2e_names if "moves" in entry else True


def load(name: str, limits: bool = True) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    KeyError for an unknown cell and FileNotFoundError for a missing file
    (the limits' only with ``limits``: ``calibrate.py`` reads the numbers
    that they are set from)."""
    bench = _read_json(MANIFEST)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {MANIFEST}; cells: {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    lim_path = os.path.join(HERE, "limits", name + ".json")
    return compose(name, os.path.join(REPO, cfg["file"]), w["traffic"], int(w["chips"]),
                   _read_json(lim_path) if limits or os.path.exists(lim_path) else {},
                   e2e, per_layer)


def compose(name: str, config_file: str, traffic: str, chips: int = 1, limits=None,
            end_to_end=(), per_layer=()) -> Cell:
    """A cell from a configuration's file and a mix's name, in or out of
    ``BENCHMARK.json``."""
    return Cell(
        name=name,
        chips=chips,
        config=_read_json(config_file),
        traffic=_read_json(os.path.join(HERE, "traffic", traffic + ".json")),
        limits=dict(limits or {}),
        end_to_end=list(end_to_end),
        per_layer=list(per_layer),
    )


def driver(cell: Cell):
    """The driver module that runs the cell's traffic."""
    return importlib.import_module(f"benchmark.drivers.{cell.traffic.get('driver', 'train')}")


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``: the metric's value, or None
    where the run holds nothing for it to read."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
