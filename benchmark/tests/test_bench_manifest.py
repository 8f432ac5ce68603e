"""BENCHMARK.json against the contract: its keys, names, units and bounds,
and every cell, configuration, mix, limit and metric resolving to its
files."""

import json
import os
import re

from bench_tiny import REPO

from benchmark import cells, checks

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"] and all(PATH.match(p) for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_bounds():
    b = manifest()
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in b[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in b[key]}) == len(b[key])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16


def test_every_cell_resolves_to_its_files():
    b = manifest()
    for w in b["workloads"]:
        cell = cells.load(w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) <= set(checks.NAMES)
        assert {"data_gap", "batch_gap", "loss_gap", "grad_gap", "step1_gap"} <= set(cell.limits)
        assert cells.driver(cell).run
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    for c in b["configs"]:
        with open(os.path.join(REPO, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert os.path.exists(os.path.join(REPO, cfg["mesh"]))
        assert cfg["mesh"].startswith("benchmark/")


def test_configs_hold_the_published_recipe():
    for name in ("dudf-8x256-torus-pc", "dudf-8x256-trefoil-mesh"):
        with open(os.path.join(REPO, "benchmark", "configs", name + ".json")) as fh:
            c = json.load(fh)
        assert c["network"] == {"hidden_layer_nodes": [256] * 8, "w0": 30,
                                "activation": "sine"}
        t = c["train"]
        assert t["batch_size"] == 30000 and t["sampling_percentiles"] == [0.333, 0.666]
        assert t["loss_s1_weights"] == [1e4, 1e4, 1e4, 1e3]
        assert t["optimizer"]["lr_s1"] == 1e-5 and t["warmup_epochs"] == 1000
        assert t["alpha"] == 100 and t["epochs_to_checkpoint"] == 8001
        assert t["num_epochs"] == 3000 and t["s1_epochs"] == 2000
        assert t["loss_s2_weights"] == [1e5, 1e5] and t["optimizer"]["lr_s2"] == 1e-7
        assert c["precision"] == {"dtype": "float32", "tf32": False}
        assert "surface_points" in c["assumed"]


def test_mixes_hold_only_the_stage_its_first_epoch_and_the_read_cadence():
    folder = os.path.join(REPO, "benchmark", "traffic")
    for f in sorted(os.listdir(folder)):
        with open(os.path.join(folder, f)) as fh:
            mix = json.load(fh)
        assert set(mix) == {"stage", "first_epoch", "read_every"}, f
