"""The harness's arguments and result line, its refusal without a card or
without the program, and the absence of JAX and the JAX package from its
process."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch
from bench_tiny import MANIFEST_CELLS, REPO

from benchmark import cells, checks, run

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CELL = MANIFEST_CELLS[0]


def test_arguments():
    a = run.parse(["--workload", CELL, "--seed", str(2**31 + 5),
                   "--seconds", "20", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == (CELL, 2**31 + 5, 20.0, 1)
    with pytest.raises(SystemExit):
        run.parse(["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"])


def _outcome(cell, traced):
    table = checks.verdict({n: 0.0 for n in cell.limits}, cell.limits)[1]
    out = types.SimpleNamespace(
        values={"s2_steps_per_s": 180.0, "setup_s": 12.0}, ctx=None, attempted=9000, failed=0,
        memory_peak_bytes=123, correct=True, checks=table, breakdown=None)
    if traced:
        out.ctx = types.SimpleNamespace(
            stage="s2", steps=2, window_s=0.05, busy_s=0.04, kernels=[], device=[],
            sample_ms=0.5, oracle_build_s=1.5, hidden=[256] * 8, n_on=9990, n_off=19980,
            kernel_rows={}, launch_counts={})
        out.busy_s, out.window_s = 0.04, 0.05
        out.breakdown = {"device_ops": [["k", 0.01]], "idle_gaps": [["aten::mul", 0.001]]}
    return out


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contract_keys(traced):
    cell = cells.load(CELL)
    line = json.loads(json.dumps(run.result_line(cell, _outcome(cell, traced), 1, "NVIDIA H100")))
    keys = CONTRACT_KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == keys
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if traced else set())
    if traced:
        assert set(line["metrics"]) == {"sample_ms.s2", "oracle_build_s", "device_idle_pct.s2",
                                        "step_mfu.s2"}
    else:
        assert line["metrics"] == {"s2_steps_per_s": {"value": 180.0, "unit": "steps/s"},
                                   "setup_s": {"value": 12.0, "unit": "s"}}
    assert list(line["checks"]) == [n for n in checks.NAMES if n in cell.limits]


def test_no_result_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELL, "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
    assert run.main(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1"]) != 0


def test_measuring_path_needs_a_card(monkeypatch):
    from benchmark.drivers import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError, AttributeError)):
        train.time_sampler(None, 1, 1, "cuda")


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A directory that holds only BENCHMARK.json and benchmark/ gives no
    result: the program is missing (and here also the card)."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_work", "__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL,
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_jax_after_a_run():
    """A run of the driver (on the CPU, tiny) leaves no module whose
    top-level name is exactly ``jax``, ``jaxlib``, ``flax`` or
    ``diffudf_tpu`` in its process."""
    code = f"""
import sys, time, json
sys.path.insert(0, {REPO!r}); sys.path.insert(0, {os.path.dirname(__file__)!r})
from benchmark import run, calibrate, reference, checks, tracing, kernels, workcount
from benchmark.drivers import train
from bench_tiny import tiny_cell
out = train.run(tiny_cell({CELL!r}), 3, 0.2, False, "cpu", time.perf_counter())
print(json.dumps({{"bad": run.forbidden_modules(), "correct": out.correct,
                  "torch_port": "diffudf_tpu_torch" in sys.modules}}))
"""
    env = dict(os.environ, USE_FLAX="0")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "correct": True, "torch_port": True}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffudf_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", types.ModuleType("y"))
    assert run.forbidden_modules() == [m for m in run.forbidden_modules()
                                       if m.split(".")[0] in run.FORBIDDEN]
    assert "diffudf_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("z"))
    assert "jax.numpy" in run.forbidden_modules()
