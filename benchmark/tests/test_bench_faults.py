"""A run of each cell, the card's look skipped and the timed path broken
underneath, comes out not correct; unbroken, correct.  The faults a
one-chip training cell can have: a step that returns its state unchanged,
half of the batch left out (the mean taken over the rest), an oracle's
answer altered where it is produced, and the data set altered where the
program's preprocessing produces it."""

import time

import pytest
from bench_tiny import CELLS, tiny_cell

from benchmark.drivers import train
from diffudf_tpu_torch.cli import preprocess
from diffudf_tpu_torch.data.sampling import TrainingSampler
from diffudf_tpu_torch.train import loop


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(loop, "adam_update", lambda params, grads, opt, lr: opt)


def _half_batch(monkeypatch):
    draw = loop.Trainer.draw

    def half(self, gen):
        pts, nrm, sdf, n_surface, share = draw(self, gen)
        return pts[::2], nrm[::2], sdf[::2], (n_surface + 1) // 2, share

    monkeypatch.setattr(loop.Trainer, "draw", half)


def _answer_altered(monkeypatch):
    sample = TrainingSampler.sample

    def altered(self, gen):
        pts, nrm, sdf = sample(self, gen)
        sz = self.sizes
        sdf = sdf.clone()
        sdf[sz.on_surface:sz.on_surface + sz.far] *= 1.01
        return pts, nrm, sdf

    monkeypatch.setattr(TrainingSampler, "sample", altered)


def _cloud_moved(monkeypatch):
    sample = preprocess.sample_surface_points

    def moved(mesh, n, seed=123):
        pts, normals = sample(mesh, n, seed=seed)
        return pts + [1e-3, 0.0, 0.0], normals

    monkeypatch.setattr(preprocess, "sample_surface_points", moved)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered, "cloud_moved": _cloud_moved}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_fault_makes_the_run_incorrect(name, fault, monkeypatch, tmp_path):
    cell = tiny_cell(name)
    monkeypatch.setattr(train, "WORK", str(tmp_path))  # its own data set and caches
    if fault is not None:
        FAULTS[fault](monkeypatch)
    out = train.run(cell, 2**31 + 1001, 0.2, False, "cpu", time.perf_counter())
    failing = [k for k, c in out.checks.items() if not c["value"] <= c["limit"]]
    assert out.correct == (fault is None), (fault, out.checks)
    assert bool(failing) == (fault is not None)
    assert out.attempted > 0 and out.values[f"{cell.traffic['stage']}_steps_per_s"] > 0
