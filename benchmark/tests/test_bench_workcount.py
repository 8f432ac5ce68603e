"""The frozen work counts against hand counts, and the per-layer readers on
a made-up traced stretch."""

import types

import pytest
from bench_tiny import MANIFEST_CELLS

from benchmark import cells, kernels, workcount

H = [256] * 8


def test_kernel_bounds_by_hand():
    # K1 at 9,990 rows: 10 carry rows through 7 (256, 256) products, plus
    # the first layer and the head, at 165 TFLOP/s
    k1 = 9990 * (7 * 10 * 2 * 256 * 256 + 2 * 3 * 256 + 10 * 2 * 256)
    assert workcount.kernel_flops("K1", 9990, H) == k1
    assert workcount.kernel_bound_s("K1", 9990, H) * 1e3 == pytest.approx(0.556, abs=5e-4)
    assert workcount.kernel_bound_s("K2", 9990, H) * 1e3 == pytest.approx(1.112, abs=5e-4)
    assert workcount.kernel_bound_s("K3a", 19980, H) * 1e3 == pytest.approx(0.445, abs=5e-4)
    assert workcount.kernel_bound_s("K3b", 19980, H) * 1e3 == pytest.approx(0.890, abs=5e-4)
    # every kernel is bound by its operations, not its bytes
    for k, n in (("K1", 9990), ("K2", 9990), ("K3a", 19980), ("K3b", 19980)):
        assert workcount.kernel_flops(k, n, H) / workcount.PEAK_FLOPS > \
            workcount.kernel_bytes(k, n, H) / workcount.PEAK_BYTES_PER_S


def test_step_flops_by_hand():
    rows = 9990 * (10 + 20) + 19980 * (4 + 8)
    assert rows == 539460
    step = workcount.step_flops("s1", 9990, 19980, H)
    assert step == pytest.approx(rows * 7 * 2 * 256 * 256, rel=2e-3)
    assert step / 1e12 == pytest.approx(0.495, abs=1e-3)
    # stage 2: the value (one row) and its VJP on the 9,990 surface rows
    s2 = workcount.step_flops("s2", 9990, 19980, H)
    assert s2 == 3 * 9990 * (2 * 3 * 256 + 7 * 2 * 256 * 256 + 2 * 256)
    assert s2 / 1e12 == pytest.approx(0.02756, abs=1e-5)
    assert workcount.param_count(H) == 3 * 256 + 256 + 7 * (256 * 256 + 256) + 256 + 1


def test_kernel_attribution_by_stream_order():
    names = ["void at::native::elementwise_kernel<128, 2>(x)",
             "void dudf::fwd::fwd_kernel<10, 8, (dudf::fwd::Product)0>(x)",
             "dudf::frag_kernel(x)",
             "void dudf::fwd::fwd_kernel<4, 16, (dudf::fwd::Product)1>(x)",
             "dudf::frag_kernel(x)", "void dudf::bwd::tile_kernel<4, 16>(x)",
             "dudf::bwd::wbar_kernel(x)", "dudf::bwd::reduce_kernel(x)",
             "void at::native::reduce_kernel<512, 1>(x)",
             "_ZN4dudf11frag_kernelEPKfiiiP6float4", "_ZN4dudf3bwd11tile_kernelILi10ELi8EEEvPKf",
             "_ZN4dudf3bwd11wbar_kernelEPKf", "_ZN4dudf3bwd13reduce_kernelEPKf",
             "dudf::bwd::reduce_kernel(x)"]
    labels, unattributed = kernels.attribute(names)
    assert labels == [None, "K1", "K3a", "K3a", "K3b", "K3b", "K3b", "K3b", None,
                      "K2", "K2", "K2", "K2", "K2"]
    assert unattributed == 0
    assert kernels.attribute(["dudf::frag_kernel(x)"]) == ([None], 1)


STEP = (("void dudf::fwd::fwd_kernel<10, 8, (dudf::fwd::Product)0>(x)", 2e-3),
        ("dudf::frag_kernel(x)", 1e-4),
        ("void dudf::fwd::fwd_kernel<4, 16, (dudf::fwd::Product)1>(x)", 1e-3),
        ("void at::native::vectorized_elementwise_kernel<4>(x)", 5e-3),
        ("dudf::frag_kernel(x)", 1e-4),
        ("void dudf::bwd::tile_kernel<4, 16>(x)", 4e-3),
        ("dudf::bwd::wbar_kernel(x)", 1e-4),
        ("dudf::bwd::reduce_kernel(x)", 1e-4),
        ("dudf::frag_kernel(x)", 1e-4),
        ("void dudf::bwd::tile_kernel<10, 8>(x)", 5e-3),
        ("dudf::bwd::wbar_kernel(x)", 1e-4),
        ("dudf::bwd::reduce_kernel(x)", 1e-4))


def _ctx(stage="s1"):
    ev = []
    for _ in range(2):
        for name, dur in STEP:
            ev.append({"name": name, "cat": "kernel", "ts": float(len(ev)), "dur_s": dur})
    return types.SimpleNamespace(
        stage=stage, steps=2, window_s=0.05, busy_s=0.04, kernels=ev, device=ev,
        sample_ms=0.5, oracle_build_s=1.5, hidden=H, n_on=9990, n_off=19980,
        kernel_rows={"K1": 9990, "K2": 9990, "K3a": 19980, "K3b": 19980}, launch_counts={})


def test_per_layer_readers():
    ctx = _ctx()
    read = {m: cells.metric_reader(m)(ctx) for m in (
        "K1_roofline", "K2_roofline", "K3a_roofline", "K3b_roofline", "step_mfu.s1",
        "nonkernel_ms.s1", "launches_per_step.s1", "device_idle_pct.s1", "sample_ms.s1",
        "oracle_build_s")}
    k1 = workcount.kernel_bound_s("K1", 9990, H)
    assert read["K1_roofline"] == pytest.approx(100 * k1 / 2e-3)
    assert read["K2_roofline"] == pytest.approx(100 * workcount.kernel_bound_s("K2", 9990, H)
                                                / 5.3e-3)
    assert read["K3a_roofline"] == pytest.approx(100 * workcount.kernel_bound_s("K3a", 19980, H)
                                                 / 1.1e-3)
    assert read["nonkernel_ms.s1"] == pytest.approx(5.0)
    assert read["launches_per_step.s1"] == 12
    assert read["device_idle_pct.s1"] == pytest.approx(20.0)
    assert read["step_mfu.s1"] == pytest.approx(
        100 * workcount.step_flops("s1", 9990, 19980, H) * 40 / workcount.PEAK_FLOPS)
    assert read["sample_ms.s1"] == 0.5 and read["oracle_build_s"] == 1.5


S1 = ("K1_roofline", "K2_roofline", "K3a_roofline", "K3b_roofline", "step_mfu.s1",
      "nonkernel_ms.s1", "launches_per_step.s1", "device_idle_pct.s1", "sample_ms.s1")
S2 = ("step_mfu.s2", "nonkernel_ms.s2", "launches_per_step.s2", "device_idle_pct.s2",
      "sample_ms.s2")


def test_stage2_readers():
    """A stage-2 stretch runs no SIREN kernel: every device activity is
    outside K1-K3b."""
    ctx = _ctx(stage="s2")
    ctx.kernels = ctx.device = [e for e in ctx.kernels if "dudf" not in e["name"]]
    read = {m: cells.metric_reader(m)(ctx) for m in S2}
    assert read["nonkernel_ms.s2"] == pytest.approx(5.0)
    assert read["launches_per_step.s2"] == 1
    assert read["device_idle_pct.s2"] == pytest.approx(20.0)
    assert read["step_mfu.s2"] == pytest.approx(
        100 * workcount.step_flops("s2", 9990, 19980, H) * 40 / workcount.PEAK_FLOPS)
    assert read["sample_ms.s2"] == 0.5


@pytest.mark.parametrize("stage, others", [("s2", S1), ("s1", S2)])
def test_readers_find_nothing_outside_their_stage(stage, others):
    ctx = _ctx(stage=stage)
    if stage == "s2":
        ctx.kernels = ctx.device = [e for e in ctx.kernels if "dudf" not in e["name"]]
    for m in others:
        assert cells.metric_reader(m)(ctx) is None, m


@pytest.mark.parametrize("name", MANIFEST_CELLS)
def test_cells_report_their_metrics(name):
    cell = cells.load(name)
    assert {m["name"] for m in cell.end_to_end} == {"s2_steps_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"oracle_build_s", *S2}
