"""The lower-precision control on the card: the reference computed with
TF32 products in the program's place fails the cell's limits, where the
program passes them.  At the cell's widths, on a tenth of its batch, on
three seeds.  Run on the card with ``python -m pytest -m cuda
benchmark/tests``; skips without one."""

import copy

import pytest
import torch
from bench_tiny import MANIFEST_CELLS

from benchmark import calibrate, cells, checks
from benchmark.drivers import train


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control reads TF32 products on the card")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield "cuda"
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("name", MANIFEST_CELLS)
def test_control_fails_where_the_program_passes(name, card):
    cell = cells.load(name)
    c = copy.deepcopy(cell.config)
    c["train"]["batch_size"] = 3000
    cell.config = c
    prep = train.prepare(cell, card)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        r = calibrate.readings(cell, prep, seed, card)
        assert checks.verdict(r["program"], cell.limits)[0], r["program"]
        for fault in ("control", "half_batch", "altered", "moved", "unchanged", "cloud_moved"):
            numbers = {n: r[fault].get(n, 0.0) for n in cell.limits}
            assert not checks.verdict(numbers, cell.limits)[0], (fault, r[fault])
