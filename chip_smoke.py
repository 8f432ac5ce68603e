#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``diffudf_tpu_torch`` alone (no JAX, no ``diffudf_tpu``) through its
paths: mesh extraction, ``generate_mc`` at N=256 with both MeshUDF and CAP
on an 8x256 SIREN fitted in process to a sphere; training, ``cli.train`` on
the point-cloud torus recipe (8x256, batch 30,000, 3000 epochs) with its
slice figure and the Chamfer evaluation of its meshes; rendering,
``cli.generate_st`` at 720x720 with 3 passes on the trained torus; the
slice figures of ``cli.generate_df`` at width 512 on the trained torus;
mesh-input training, ``cli.train`` on the trefoil's mesh with the same
recipe; the GT-mesh render of ``cli.generate_st``; point-cloud extraction,
``cli.generate_pc`` on the trained torus; and the enhanced extraction,
``cli.generate_mc`` at N=385 with vertex refinement.  It
holds every kernel of those paths against its plain torch version: K1 (f,
grad f, Hessian), K2 (its VJP), K3a (f, grad f), K3b (its VJP), K4 (f
alone, the march's value) and K5 (the nearest cloud point's distance).
Phases, in order, each printing its seconds:

  1. device   — needs CUDA; prints the nvidia-smi name and power limit,
                and whether the optional matplotlib and PIL import;
  2. build    — nvcc (K1; K2; K3a and K3b; K4; K5) and g++ (sign voting), all
                started together, into the package's ignored build
                directory, with each ptxas register report;
  3. kernel   — K1 vs ``vgh_reference`` on 65,536 points of a random-init
                8x256 net, with the tolerances of the JAX package's Pallas
                test (f 1e-5, g 1e-4, h6 5e-3, absolute), and its times
                beside its FP32 FMA bound (K1 sums in FP32 FMA), the 3xTF32
                tensor bound and the bytes its design moves;
  4. fixture  — fits the 8x256 SIREN to g(d) = d*tanh(10 d) of the sphere
                |x| = 0.7 by value regression (autograd + Adam, no kernels),
                saved as a JAX-format checkpoint in a temporary directory;
  5. slice    — ``diffudf_tpu_torch.cli.generate_mc.main`` in process with
                algorithm "both", N=256; the K1 launch count of this run,
                the stage times, band sizes, face counts, and the Chamfer-L1
                of each mesh against 100k points of the sphere;
  6. timing   — K1 against its plain version, element by element, and both
                against the plain version in float64, at the shape the
                slice gave K1; then their times and K1's bounds;
  7. train    — preprocesses data/demo/torus.obj (100k points) and runs
                ``diffudf_tpu_torch.cli.train.main`` on the recipe of
                results/results_demo_pc.csv, its oracle build overlapped
                with the first epochs; gates: K1, K2, K3a and K3b
                each launched once per s1 step (K1 once more for the slice
                figure and once by the final extraction), K5 once for the
                figure's plane distances and once a step of the epochs the
                bootstrap oracle (the exact nearest-point sweep) served
                before the swap, both figure PNGs with 512x512
                panels, finite losses, the s1 loss of the last 50 s1 epochs
                below that of the first 50, and the Chamfer-L1 of both final
                meshes against the 100k-point cloud within the torus
                protocol floor; then the port's ``eval/chamfer.py`` scores
                the meshes with both backends (L1 within 1e-6 of the
                script's own, L2 and NC of the two backends within 1e-4 of
                each other); prints s1 and s2 steps/s beside the original
                DiffUDF's 7.54;
  8. training kernels — K1, K2, K3a and K3b against their plain versions,
                element by element, and against the plain versions in
                float64, on the trained net and a batch of its sampler at
                the slice's shapes (9,990 surface rows for K1 and K2,
                19,980 off-surface rows for K3a and K3b, the loss's own
                cotangents for K2 and K3b); then their times and bounds:
                the FP32 FMA bound and the 3xTF32 tensor bound (K1 sums in
                FP32 FMA, the other three multiply on the tensor cores in
                3xTF32) and the device-memory bytes their design moves;
  9. render   — ``diffudf_tpu_torch.cli.generate_st.main`` in process on
                configs/st_cfg.json's rendering config (720x720, 3 passes,
                the mixed bf16 march) with the trained torus; gates: K4
                launched once per march iteration (prints each pass's
                launches by bucket), K1 once per pass, every
                pass with hits on 1-99% of its valid rays, finite colours, a
                PNG file; then a one-pass float32 march (hit pixels against
                the bf16 march's first pass) and a one-pass gaussian-
                curvature Ward render (the plain Jacobian path); prints
                Mrays/s beside the original DiffUDF's 0.045;
 10. render kernel — K4 against its plain version in both modes, element
                by element, and in float32 against the plain version in
                float64, on pass 1's entry points at the first round's
                bucket shape; then, on the weights laid out once as the
                march lays them out, K4 in both modes at every bucket of
                the march (65,536 down to 1,024 points, each with its own
                tile) against its plain version under the same gate, and
                its times beside each bound, tile, grid and bytes, the
                plain versions' at the first bucket, and K4's estimated
                share of pass 1's march: its launches at each bucket times
                that bucket's time;
 11. figures  — ``diffudf_tpu_torch.cli.generate_df.main`` at width 512 on
                the trained torus against its point cloud (one K1 and one
                K5 launch) and against its normalised mesh ``torus_t.obj``
                (one K1 launch, the brute triangle sweep); gates: the launch
                counts and both PNGs with 512x512 panels; prints the
                ``Stats:`` lines;
 12. distance kernel — K5 against its plain version and the plain version
                in float64, element by element within 1e-4, at the figure's
                262,144 plane queries against the 100k-point torus cloud;
                prints the max and RMS errors, the error K5's own expanded
                form would have had, and the median of 20 CUDA-event times
                of K5, its plain version and chunked ``torch.cdist`` +
                ``amin`` beside the bound and K5's issue floor (four issue
                slots a pair); then K1 at the figure's 262,144 points beside
                its bounds;
 13. mesh train — preprocesses data/demo/trefoil.obj (100k points, 24,576
                triangles) and runs ``cli.train.main`` on the same recipe in
                mesh mode (``onlyPCloud`` false), the candidate-grid build
                on a host thread while the first epochs train on the exact
                bootstrap sweep; gates: K1, K2, K3a and K3b as in phase 7,
                K5 never (the figure reads the triangle table), the table
                swapped in, both figure PNGs, finite losses, the s1 loss
                falling, and the Chamfer-L1 of both meshes within the
                trefoil protocol floor; then the table oracle against the
                brute sweep on the 19,980 off-surface queries of a batch:
                within 1e-5 on the near-surface rows and on every row the
                grid's guarantee covers (its cell's k-th lower bound from
                the centre, less the half-diagonal, above the row's
                distance), the other rows' errors printed; and the
                CUDA-event times of both oracles a step;
                prints s1 and s2 steps/s beside phase 7's and the JAX
                package's trefoil row;
 14. gt render — ``cli.generate_st.main`` with ``gt_mode`` "gt" on the
                trefoil's normalised mesh with configs/st_cfg.json's camera
                and light, 720x720, one pass (the exact triangle distance,
                no kernel); gates: hits on 1-99% of the valid rays, finite
                colours, a PNG file;
 15. point cloud — ``cli.generate_pc.main`` in process with
                configs/pc_cfg.json's keys (100,000 samples, ref_steps 3,
                surf_thresh 0.007, max_iter 10) on the trained torus at its
                alpha 10; gates: K3a launched (ref_steps - 1) times a round
                and K1 once a round, at least 100,000 finite points in
                [-1, 1]^3 with unit normals; then the first round's
                candidates projected on K3a + K1, on the plain versions and
                on the plain versions in float64, all on the card (positions
                and steps: the kernels' max and RMS distance from float64 at
                most WITNESS times the plain version's, and their max
                distance from the plain version at most WITNESS times the
                plain version's max distance from float64; keep masks equal
                off the borderline rows, normals |cos| > 0.999 on 99%),
                K3a's and K1's times at that shape beside their bounds, and
                the cloud against torus_t.obj: median exact distance (the
                brute sweep's closest-point test) within 2e-3, median |cos|
                to the nearest triangle's normal at least 0.95, one sign of
                n . n_tri on at least 90% of the points; prints the rounds,
                the kept share a round, the projection and orientation
                seconds and the Chamfer-L1 against the 100k-point cloud;
 16. enhanced — ``cli.generate_mc.main`` with configs/mc_enhanced_cfg.json's
                keys (N=385, "both", mc33, sparse, refine_vertices 2,
                taubin_iters 10) on the trained torus; gates: K3a launched
                twice a mesh, K1 by the grid pass, every refinement move
                within half a voxel (+ 1e-6), both meshes' Chamfer-L1
                within the torus protocol floor, and the MU mesh's
                unrefined vertices refined on K3a, on the plain version and
                on the plain version in float64, under phase 15's gates;
                prints the Stats line beside phase 5's and the
                Chamfer beside the JAX package's enhanced torus row;
 17. dp train — data-parallel training (``diffudf_tpu_torch.parallel``):
                2 ranks on cuda:0 over gloo (``run_group``), each drawing
                its 4,995 + 4,995 + 4,995 rows of the recipe's batch of
                phase 7's torus; gates: step 1's terms (1e-5 relative) and
                gradients (phase 8's GTOL form) against the single-rank
                step on the union of the two ranks' batches, K1, K2, K3a
                and K3b launched once each by every rank's step; then
                ``cli.train.setup_train`` on the 2 ranks cut to 30 s1 + 10
                s2 epochs: K2, K3a, K3b once per s1 step on every rank (K1
                also, plus the figure's on rank 0), finite losses, params
                and best params equal bit for bit on both ranks, rank 0
                alone writing; then one fallback step on 4 ranks (9,990
                divides by no 4): the RuntimeWarning, terms and gradients
                against the single-device step on the same batch; then a
                one-rank NCCL group (start, one all-reduce, destroy);
                prints each rank's s1 ms and its gradient all-reduce's ms;
 18. sharded serving — one launch of 2 ranks on cuda:0: ``generate_mc``
                with ``shard_grid`` on phase 4's sphere (N=256, "both"; the
                gathered udf and dirs against phase 5's grid pass at phase
                3's K1 tolerances, both meshes' Chamfer-L1 within phase 5's
                limit), ``generate_st`` with ``shard_rays`` on phase 9's
                config (hit pixels against phase 9's render: at most 5% of
                the hits differ), ``generate_pc`` with ``shard_points`` on
                phase 15's config (phase 15's distance and normal gates,
                max |delta| against phase 15's cloud printed); each rank's
                launches by path.

Then a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.
Any failed phase raises, and the script exits non-zero without those two
lines.  Files go to a temporary directory and the build directory only.
"""

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import diffudf_tpu_torch  # noqa: F401  (fails at once outside a checkout)

# Tolerances of tests/test_pallas.py::TestPallasVGH::test_matches_reference.
TOL = {"f": 1e-5, "g": 1e-4, "h6": 5e-3}
# At the slice's shape the fitted net's outputs reach several hundred, and
# float32 sums taken in another order differ in proportion to the terms:
# phase 6 adds RTOL * |plain| to each element's TOL, and bounds K1's distance
# from the float64 plain version by WITNESS times the float32 one's.
RTOL = 1e-4
WITNESS = 2.0
# Phase 5 gates.  Chamfer-L1 is the sum of the two directional mean L1
# nearest-neighbour distances, 100k samples a side; the bound was set after
# the first run on an H100 measured 0.0119 for both meshes (PERF.md).
MAX_ACTIVE_BLOCK_SHARE = 0.5
MAX_CHAMFER_L1 = 0.015
# Peaks of one H100 SXM at a 700 W power limit (NVIDIA data sheet).
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense TF32 tensor rate; K2, K3a, K3b run 3 TF32 products a product
PEAK_BYTES_PER_S = 3.35e12

RADIUS, ALPHA, N_GRID = 0.7, 10.0, 256
HIDDEN = (256,) * 8

# Phase 7: the recipe of results/results_demo_pc.csv (diffudf_tpu/cli/
# quantitative.py DEFAULT_CONFIG with onlyPCloud), on the torus.
REPO = os.path.dirname(os.path.abspath(__file__))
RECIPE = {
    "num_epochs": 3000, "s1_epochs": 2000, "warmup_epochs": 1000,
    "batch_size": 30000, "sampling_percentiles": [0.333, 0.666],
    "batches_per_epoch": 1, "epochs_to_checkpoint": 8001, "gt_mode": "tanh",
    "loss_s1_weights": [1e4, 1e4, 1e4, 1e3], "loss_s2_weights": [1e5, 1e5],
    "alpha": 10, "optimizer": {"type": "adam", "lr_s1": 1e-5, "lr_s2": 1e-7},
    "network": {"hidden_layer_nodes": [256] * 8, "w0": 30, "pretrained_dict": "None"},
    "resolution": 256, "onlyPCloud": True,
}
# The torus protocol floor (results/protocol_floors_demo.json) for the
# Chamfer-L1 of each final mesh's vertices against the 100k-point cloud,
# nearest neighbours under the L1 norm (eval/chamfer.py, norm=1).
MAX_TORUS_CHAMFER_L1 = 0.011975
BASELINE_STEPS_PER_S = 7.54  # original DiffUDF, 3000 epochs in 398 s (BASELINE.md)
# Phase 8: each gradient element within GTOL * max(max |plain|, 1) +
# RTOL * |plain| of the plain version; GTOL is the Pallas gradcheck's
# (tests/test_pallas.py: 2e-5 for the vgh VJP, 1e-5 for the vg VJP).
GTOL = {"K2": 2e-5, "K3b": 1e-5}
# Phase 9: configs/st_cfg.json's rendering on the torus of phase 7, whose
# recipe trained at alpha 10 (st_cfg's alpha 100 belongs to its beetle).
ST_CONFIG = os.path.join(REPO, "configs", "st_cfg.json")
BASELINE_MRAYS_PER_S = 0.045  # the original DiffUDF tracer (bench_rays.py, BASELINE.md)
MAX_HIT_FLIPS = 0.05  # float32 vs bf16 march: hit pixels that differ, share of the hits
# Phase 10: K4 element by element within K4_TOL + RTOL * |plain|; K4_TOL is
# the Pallas value test's (tests/test_pallas.py: f32 1e-5, bf16 2e-3).
K4_TOL = {"f32": 1e-5, "bf16": 2e-3}
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor rate, H100 SXM at 700 W
# Phases 7, 11 and 12: the slice figure's width (JAX cli/train.py:287-292 and
# generate_df's default), K5's tolerance (tests/test_pallas.py::
# TestPallasDistance), and the agreement of eval/chamfer.py with the script's
# own Chamfer-L1 (float64 k-d tree) and of its two backends on L2 and NC
# (the device scan's L2 is the float32 expanded form; NC moves where
# near-tied neighbours are taken in another order).
FIGURE_WIDTH = 512
K5_TOL = 1e-4
# Phase 13: the trefoil protocol floor (results/protocol_floors_demo.json);
# the JAX package's mesh-input trefoil row (results/results_demo.csv, a
# record, not a gate); the table oracle against the brute sweep within the
# tolerance of the JAX package's tests/test_data.py::test_candidate_grid_*.
MAX_TREFOIL_CHAMFER_L1 = 0.012503
JAX_TREFOIL_L1 = {"CAP": 0.010658, "MU": 0.010655}
MESH_TOL = 1e-5
CHAMFER_RTOL = {"L1": 1e-6, "L2": 1e-4, "NC": 1e-4}
# Phases 15 and 16: configs/pc_cfg.json's and configs/mc_enhanced_cfg.json's
# keys on the torus of phase 7 at its alpha 10 (their alpha 100 is the
# beetle's).  A projection's last step sqrt(|f|/alpha) turns float32 noise
# in f near the zero set into moves of several 1e-4, so the projection on
# the kernels is held to the same projection in float64 (WITNESS times the
# float32 plain version's distance) and to the float32 plain version (at
# most WITNESS times the plain version's own largest distance from float64);
# the rows beyond the golden point-cloud tolerance PROJ_TOL
# (tests/test_golden_pc.py) from the plain version are printed, no gate.
# The point cloud's median exact distance to the
# normalised mesh (the JAX package's dense-point-cloud field error is about
# 1e-3) and the median |cos| of its normals against the nearest triangle's
# (tests/test_render_pc.py::test_generate_point_cloud); the JAX package's
# enhanced torus row (results/results_demo_enhanced.csv: a TPU run with
# another schedule, a record, not a gate).
PC_CONFIG = os.path.join(REPO, "configs", "pc_cfg.json")
ENHANCED_CONFIG = os.path.join(REPO, "configs", "mc_enhanced_cfg.json")
# Phase 17: the recipe cut to 30 s1 + 10 s2 epochs on 2 ranks; step 1's
# terms within DP_TERM_RTOL of the single-rank step on the union batch
DP_EPOCHS = {"num_epochs": 40, "s1_epochs": 30, "warmup_epochs": 10}
DP_TERM_RTOL = 1e-5
PROJ_TOL = 5e-4
MAX_PC_FIELD_ERROR = 2e-3
MIN_PC_NORMAL_COS = 0.95
MIN_ORIENTED_SHARE = 0.9
JAX_ENHANCED_TORUS_L1 = {"CAP": 0.008765, "MU": 0.008766}


def phase(name):
    """Decorator: run a phase, print its seconds, let any failure propagate."""
    def wrap(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)
            return out
        return run
    return wrap


def unit_sphere_points(n, rng):
    p = rng.normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def siren_kernel_bound(n_points, hidden, rows, products, row_bytes, weight_copies,
                       rate=PEAK_FP32_FLOPS, passes=1):
    """(bound ms, "operations" or "bytes") of a SIREN kernel: ``rows`` carry
    rows a point through ``products`` (h, h) products per hidden layer plus
    the first layer and the head, against ``row_bytes`` of input and output
    a point and ``weight_copies`` times the weights (read, and for a VJP
    the gradient written).  The operations run ``passes`` times at ``rate``:
    FP32 FMA by default, or 3 TF32 passes at the tensor rate for the 3xTF32
    products of K2, K3a and K3b."""
    h, n_mm = hidden[0], len(hidden) - 1
    flops = n_points * (2 * 3 * h + n_mm * products * rows * 2 * h * h + rows * 2 * h)
    weights = 4 * (4 * h + n_mm * (h * h + h) + h + 1)
    nbytes = n_points * row_bytes + weight_copies * weights
    flop_ms, byte_ms = 1e3 * passes * flops / rate, 1e3 * nbytes / PEAK_BYTES_PER_S
    return max(flop_ms, byte_ms), ("operations" if flop_ms >= byte_ms else "bytes")


# rows of the carry, hidden (h, h) products a layer, output columns and
# copies of the weights moved (read; K2 and K3b also write the gradient)
SIREN_KERNELS = {"K1": (10, 1, 16, 1), "K2": (10, 3, 16, 2), "K3a": (4, 1, 8, 1),
                 "K3b": (4, 3, 8, 2)}


def kernel_bounds(name, n_points):
    """A SIREN kernel's bounds at n_points of the 8x256 net: the 3xTF32
    tensor bound (three TF32 products at the tensor rate), the FP32 FMA
    bound, and the device-memory bytes of its design (``FwdPlan`` or
    ``BwdPlan.bytes_moved``).  ``bound_ms`` is the bound of the product the
    kernel runs: FP32 FMA for K1, 3xTF32 for K2, K3a and K3b."""
    from diffudf_tpu_torch.fields.siren import SirenSpec
    from diffudf_tpu_torch.ops import kernel_io as kio
    from diffudf_tpu_torch.ops import vg, vgh

    rows, products, cols, copies = SIREN_KERNELS[name]
    shape = (rows, products, 4 * (3 + cols), copies)
    tensor, tby = siren_kernel_bound(n_points, HIDDEN, *shape, rate=PEAK_TF32_FLOPS, passes=3)
    fp32, fby = siren_kernel_bound(n_points, HIDDEN, *shape)
    spec, sms = SirenSpec(hidden=HIDDEN), torch.cuda.get_device_properties(0).multi_processor_count
    if name == "K1":
        plan = kio.forward_plan(spec, n_points, vgh._lib().vgh_tile(), cols, False, sms)
    elif name == "K3a":
        plan = kio.forward_plan(spec, n_points, vg._lib().vg_tile(), cols, True, sms)
    else:
        tile = vgh._bwd_lib().vgh_bwd_tile() if name == "K2" else vg._lib().vg_tile()
        plan = kio.backward_plan(spec, n_points, rows, tile, sms)
    bound, by = (fp32, fby) if name == "K1" else (tensor, tby)
    return {"bound_ms": bound, "bound_by": by, "tensor_bound_ms": tensor,
            "fp32_bound_ms": fp32, "bytes_moved": plan.bytes_moved}


def bounds_text(ms, b):
    """A kernel's time against its 3xTF32 tensor bound, FP32 FMA bound and
    design bytes, as phases 3, 6, 8 and 12 print it."""
    return (f"tensor bound (3xTF32) {b['tensor_bound_ms']:.3f} ms, "
            f"{b['tensor_bound_ms'] / ms:.1%} of it; FP32 FMA bound {b['fp32_bound_ms']:.3f} ms, "
            f"{b['fp32_bound_ms'] / ms:.1%} of it; bound by {b['bound_by']}; "
            f"the design moves {b['bytes_moved'] / 1e9:.4f} GB "
            f"({1e3 * b['bytes_moved'] / PEAK_BYTES_PER_S:.3f} ms at {PEAK_BYTES_PER_S / 1e12} TB/s)")


def cuda_ms(fn, reps):
    """Median milliseconds of fn() over reps CUDA-event-timed runs, after
    one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_errors(got, want):
    return {k: float((a - b).abs().max()) for k, a, b in zip(("f", "g", "h6"), got, want)}


@phase("device")
def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in ("matplotlib", "PIL"):
        try:
            __import__(name)
            print(f"[device] optional package {name}: imports")
        except ImportError as exc:
            print(f"[device] optional package {name}: missing ({exc})")


# siren_fwd.cuh's Product, in the order of its enum
PRODUCTS = ("kFp32", "kTf32x3", "kBf16")


@phase("build")
def build_phase():
    """Every native library at once: one compiler process per source."""
    from diffudf_tpu_torch.native import udf_mc
    from diffudf_tpu_torch.ops import min_distance, value, vg, vgh

    builds = {"vgh (nvcc, K1)": vgh.build, "vgh_bwd (nvcc, K2)": vgh.build_bwd,
              "vg (nvcc, K3a + K3b)": vg.build, "value (nvcc, K4)": value.build,
              "min_distance (nvcc, K5)": min_distance.build, "udf_mc (g++)": udf_mc.build}

    def timed(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in builds.items()}
        done = {name: f.result() for name, f in futures.items()}
    for name, (lib, secs) in done.items():
        print(f"[build] {name}: {secs:.2f} s", flush=True)
        if "nvcc" in name:
            with open(lib[:-3] + ".log") as fh:
                for line in fh:
                    entry = re.search(r"entry function '.*?\d([a-z_]+_kernel)"
                                      r"(ILi(\d+)ELi(\d+)E(LN\w*?ProductE(\d))?)?", line)
                    if entry:
                        args = f"<{entry.group(3)}, {entry.group(4)}" if entry.group(2) else ""
                        if entry.group(6):
                            args += f", {PRODUCTS[int(entry.group(6))]}"
                        print(f"[build]   ptxas: {entry.group(1)}{args}{'>' if args else ''}")
                    elif "registers" in line or "spill" in line:
                        print(f"[build]   ptxas: {line.strip()}")


@phase("kernel")
def kernel_phase():
    from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax
    from diffudf_tpu_torch.ops import vgh

    spec = SirenSpec(hidden=HIDDEN)
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cuda")
    x = torch.as_tensor(
        np.random.default_rng(1).uniform(-1, 1, (65536, 3)).astype(np.float32), device="cuda")
    got = vgh.vgh(params, spec, x)
    torch.cuda.synchronize()
    want = vgh.vgh_reference(params, spec, x)
    err = max_errors(got, want)
    print(f"[kernel] K1 vs vgh_reference, 65536 points, 8x256: max abs err {err}")
    for k, v in err.items():
        if not v <= TOL[k]:
            raise AssertionError(f"K1 disagrees with vgh_reference on {k}: {v} > {TOL[k]}")
    ms = cuda_ms(lambda: vgh.vgh(params, spec, x), 20)
    plain_ms = cuda_ms(lambda: vgh.vgh_reference(params, spec, x), 5)
    print(f"[kernel] K1 {ms:.3f} ms (median of 20), plain {plain_ms:.3f} ms at 65536 points; "
          f"{bounds_text(ms, kernel_bounds('K1', len(x)))}")


@phase("fixture")
def fixture_phase(tmp, steps=3000, batch=16384, seed=0):
    """Fit a SIREN to the tanh-scaled distance of the sphere; -> model path.

    L1 value regression with Adam (lr 3e-4, cosine decay to 3e-6) on
    batches of four quarters: uniform in the cube, within ~0.05 and ~0.01
    of the surface, and on it."""
    from diffudf_tpu_torch.fields.siren import Siren, SirenSpec
    from diffudf_tpu_torch.fields.transforms import gt_transform
    from diffudf_tpu_torch.train.checkpoint import save_params

    device = "cuda"
    spec = SirenSpec(hidden=HIDDEN)
    model = Siren.init(spec, np.random.default_rng(seed)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=3e-4)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, steps, eta_min=3e-6)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = batch // 4
    for step in range(steps):
        cube = torch.rand((q, 3), generator=gen, device=device) * 2 - 1
        u = torch.randn((3 * q, 3), generator=gen, device=device)
        r = RADIUS + torch.cat([
            0.05 * torch.randn((q, 1), generator=gen, device=device),
            0.01 * torch.randn((q, 1), generator=gen, device=device),
            torch.zeros((q, 1), device=device),
        ])
        x = torch.cat([cube, u / u.norm(dim=1, keepdim=True) * r])
        target = gt_transform("tanh", (x.norm(dim=1) - RADIUS).abs(), ALPHA)
        loss = (model(x)[:, 0] - target).abs().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        if step % 1000 == 0 or step == steps - 1:
            print(f"[fixture] step {step} L1 {loss.item():.3e}", flush=True)
    fit_report(model)
    path = os.path.join(tmp, "sphere.npz")
    save_params(path, model.params(), spec)
    return path


def fit_report(model):
    """Print the pseudo-UDF error of the fitted field by distance band."""
    from diffudf_tpu_torch.fields.transforms import inverse_map

    rng = np.random.default_rng(4)
    shell = unit_sphere_points(100000, rng) * (RADIUS + 0.02 * rng.normal(size=(100000, 1)))
    x = torch.as_tensor(np.concatenate([rng.uniform(-1, 1, (100000, 3)), shell]),
                        dtype=torch.float32, device="cuda")
    d = (x.norm(dim=1) - RADIUS).abs()
    with torch.no_grad():
        err = (inverse_map("tanh", model(x)[:, 0].abs(), ALPHA) - d).abs()
    for lo, hi in ((0.0, 0.005), (0.005, 0.02), (0.02, 0.1), (0.1, 2.0)):
        e = err[(d >= lo) & (d < hi)]
        print(f"[fixture] |udf - d| for d in [{lo}, {hi}): mean {e.mean().item():.2e} "
              f"max {e.max().item():.2e}")


def sample_mesh(verts, faces, n, rng):
    """n points uniformly on the triangle mesh (area-weighted)."""
    tri = verts[faces]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    pick = rng.choice(len(faces), size=n, p=area / area.sum())
    u, v = rng.random((2, n))
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    t = tri[pick]
    return t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0]) + v[:, None] * (t[:, 2] - t[:, 0])


def chamfer_l1(a, b):
    """Sum of the two directional mean L1 nearest-neighbour distances."""
    from scipy.spatial import cKDTree

    d_ab = cKDTree(b).query(a, p=1)[0]
    d_ba = cKDTree(a).query(b, p=1)[0]
    return float(d_ab.mean() + d_ba.mean())


@phase("slice")
def slice_phase(tmp, model_path):
    from diffudf_tpu_torch.cli import generate_mc
    from diffudf_tpu_torch.ops import vgh

    cfg = {
        "alpha": ALPHA, "gt_mode": "tanh", "hidden_layer_nodes": list(HIDDEN), "w0": 30,
        "model_path": model_path, "output_path": os.path.join(tmp, "sphere.ply"),
        "algorithm": "both", "nsamples": N_GRID,
    }
    cfg_path = os.path.join(tmp, "mc_cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)

    zero_counts()
    (mesh_mu, mesh_cap), stats = generate_mc.main([cfg_path])
    launches = vgh.launches

    print(f"[slice] stage1 {stats['stage1_s']:.3f} s, stage2 {stats['stage2_s']:.3f} s, "
          f"stage3 {stats['stage3_s']:.3f} s, MU host {stats['mu_s']:.3f} s, "
          f"CAP host {stats['cap_s']:.3f} s")
    print(f"[slice] coarse points {stats['coarse_points']}, active block share "
          f"{stats['active_block_share']:.4f}, band points {stats['band_points']}, "
          f"K1 points {stats['dirs_points']}")
    print(f"[slice] faces MU {stats['mu_faces']}, CAP {stats['cap_faces']}; K1 launches {launches}")
    if launches < 1:
        raise AssertionError("the slice did not launch K1")
    if stats["active_block_share"] > MAX_ACTIVE_BLOCK_SHARE:
        raise AssertionError(f"active-block share {stats['active_block_share']} > "
                             f"{MAX_ACTIVE_BLOCK_SHARE}: the fixture field is not fitted")
    chamfer = sphere_chamfer((mesh_mu, mesh_cap), "[slice]")
    return stats, launches, chamfer


def sphere_chamfer(meshes, tag):
    """Both meshes' Chamfer-L1 against 100k points of the sphere, each
    within MAX_CHAMFER_L1; -> {name: Chamfer-L1}."""
    rng = np.random.default_rng(2)
    ref = RADIUS * unit_sphere_points(100000, rng)
    chamfer = {}
    for name, m in zip(("MU", "CAP"), meshes):
        v, f = np.asarray(m.vertices, np.float64), np.asarray(m.faces)
        if len(f) == 0 or not np.isfinite(v).all() or v.shape[1] != 3:
            raise AssertionError(f"{name} mesh is empty or not finite")
        chamfer[name] = chamfer_l1(sample_mesh(v, f, 100000, rng), ref)
    print(f"{tag} Chamfer-L1 vs 100k sphere points: MU {chamfer['MU']:.5f}, "
          f"CAP {chamfer['CAP']:.5f} (bound {MAX_CHAMFER_L1})")
    for name, c in chamfer.items():
        if not c <= MAX_CHAMFER_L1:
            raise AssertionError(f"{name} Chamfer-L1 {c} > {MAX_CHAMFER_L1}")
    return chamfer


@phase("timing")
def timing_phase(model_path, n_points):
    """K1 and its plain version at the slice's K1 shape (n_points, 3).

    K1 is held to the plain version element by element, |K1 - plain| <=
    TOL + RTOL * |plain|.  The plain version in float64 is a second witness:
    on each component K1's largest and RMS distance from it may be at most
    WITNESS times the float32 plain version's.  Each output's worst distance
    from float64 over TOL + RTOL |float64| is printed for K1 and the plain
    version beside the gates; it is no gate."""
    from diffudf_tpu_torch.fields.siren import SirenSpec
    from diffudf_tpu_torch.ops import vgh
    from diffudf_tpu_torch.train.checkpoint import load_params

    spec = SirenSpec(hidden=HIDDEN)
    params = load_params(model_path, device="cuda")
    params64 = [{k: v.double() for k, v in p.items()} for p in params]
    x = torch.as_tensor(
        np.random.default_rng(3).uniform(-1, 1, (n_points, 3)).astype(np.float32),
        device="cuda")

    def plain(p=params, x=x):
        # chunked so the (10 M, 256) carries of a large band fit in memory
        parts = [vgh.vgh_reference(p, spec, c) for c in x.split(131072)]
        return tuple(torch.cat(q) for q in zip(*parts))

    got = vgh.vgh(params, spec, x)
    torch.cuda.synchronize()
    want, exact = plain(), plain(params64, x.double())
    print(f"[timing] {n_points} points, {n_points % 8} in the masked last tile of 8")
    report, failed = {}, []
    for k, a, b, e in zip(("f", "g", "h6"), got, want, exact):
        err = (a - b).abs()
        limit = TOL[k] + RTOL * b.abs()
        e_k1, e_plain = (a.double() - e).abs(), (b.double() - e).abs()
        limit64 = TOL[k] + RTOL * e.abs()
        r = {
            "max_err": err.max(), "rms_plain": b.square().mean().sqrt(),
            "max_plain": b.abs().max(), "worst_err/limit": (err / limit).max(),
            "f64_worst_err/limit": ((e_k1 / limit64).max(), (e_plain / limit64).max()),
            "f64_max": (e_k1.max(), e_plain.max()),
            "f64_rms": (e_k1.square().mean().sqrt(), e_plain.square().mean().sqrt()),
        }
        report[k] = r = {n: (tuple(map(float, v)) if isinstance(v, tuple) else float(v))
                         for n, v in r.items()}
        print(f"[timing] {k}: max |K1 - plain| {r['max_err']:.3e}, limit {TOL[k]} + "
              f"{RTOL} |plain| (plain: RMS {r['rms_plain']:.3e}, max {r['max_plain']:.3e}), "
              f"worst err/limit {r['worst_err/limit']:.3f}; vs float64, K1 / plain: "
              f"max {r['f64_max'][0]:.3e} / {r['f64_max'][1]:.3e}, "
              f"RMS {r['f64_rms'][0]:.3e} / {r['f64_rms'][1]:.3e}; worst |x - float64| / "
              f"({TOL[k]} + {RTOL} |float64|), K1 / plain: {r['f64_worst_err/limit'][0]:.3f} / "
              f"{r['f64_worst_err/limit'][1]:.3f}")
        if not r["worst_err/limit"] <= 1:
            failed.append(f"{k}: K1 outside {TOL[k]} + {RTOL} |plain| of the plain version")
        for n in ("f64_max", "f64_rms"):
            if not r[n][0] <= WITNESS * r[n][1]:
                failed.append(f"{k}: K1's {n} distance from float64 {r[n][0]} > "
                              f"{WITNESS} x the float32 plain version's {r[n][1]}")
    del want, exact
    if failed:
        raise AssertionError("; ".join(failed))
    ms = cuda_ms(lambda: vgh.vgh(params, spec, x), 20)
    plain_ms = cuda_ms(plain, 3)
    b = kernel_bounds("K1", n_points)
    print(f"[timing] {n_points} points: K1 {ms:.3f} ms (median of 20), plain "
          f"{plain_ms:.3f} ms; {bounds_text(ms, b)}")
    return {"ms": ms, "plain_ms": plain_ms, **b, "bound_share": b["bound_ms"] / ms,
            "max_err": {k: r["max_err"] for k, r in report.items()}}


def losses_table(path):
    """losses.csv -> {column: float array, NaN where the stage lacks it}."""
    with open(path) as fh:
        rows = [line.rstrip("\n").split(";") for line in fh]
    return {name: np.array([float(r[i]) if r[i] else np.nan for r in rows[1:]])
            for i, name in enumerate(rows[0])}


@phase("train")
def train_phase(tmp):
    """The torus recipe through cli.train.main; -> what phase 8 needs and
    the kernel launch counts of this run."""
    from diffudf_tpu_torch.cli import preprocess, train
    from diffudf_tpu_torch.data.mesh_io import load_point_cloud
    from diffudf_tpu_torch.ops import min_distance, vg, vgh

    data_dir = os.path.join(tmp, "demo")
    t0 = time.perf_counter()
    preprocess.preprocess_mesh(data_dir, os.path.join(REPO, "data", "demo", "torus.obj"), 100000)
    print(f"[train] preprocess (100k points): {time.perf_counter() - t0:.2f} s", flush=True)
    cfg = dict(RECIPE, dataset=os.path.join(data_dir, "torus"), experiment_name="torus",
               checkpoint_path=os.path.join(tmp, "runs"))
    cfg_path = os.path.join(tmp, "train_cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)

    zero_counts()
    min_distance.queries = 0
    (pipeline_s, meshes, state), stats = train.main([cfg_path])
    launches = {"K1": vgh.launches, "K2": vgh.bwd_launches, "K3a": vg.launches,
                "K3b": vg.bwd_launches, "K5": min_distance.launches}

    n_s1, n_s2 = stats["s1_steps"], stats["s2_steps"]
    s1_rate, s2_rate = rates_report(stats, pipeline_s, "[train]")
    print(f"[train] kernel launches in this run: {launches}; K5 queries {min_distance.queries}")
    print(f"[train] slice figure at width {train.SLICE_WIDTH}: {json.dumps(stats['figure'])}")
    extraction_k1 = 1 if stats["mesh"]["dirs_points"] > 0 else 0
    boot_steps = stats["bootstrap_epochs"] * RECIPE["batches_per_epoch"]
    want = {"K1": n_s1 + 1 + extraction_k1, "K2": n_s1, "K3a": n_s1, "K3b": n_s1,
            "K5": 1 + boot_steps}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}: once per s1 step, K1 once more "
                             f"for the slice figure and {extraction_k1} by the final "
                             f"extraction, K5 once for the figure and once per step of the "
                             f"{stats['bootstrap_epochs']} bootstrap epochs")
    check_figure(os.path.join(tmp, "runs", "torus", "reconstructions"), train.SLICE_WIDTH,
                 "[train]")
    check_losses(os.path.join(tmp, "runs", "torus", "losses.csv"), "[train]")
    chamfer = check_chamfer(meshes, cfg["dataset"], MAX_TORUS_CHAMFER_L1, "[train]")
    scores = score_meshes(meshes, load_point_cloud(cfg["dataset"] + "_pc.ply"), chamfer)
    params = [{k: v.detach().contiguous() for k, v in layer.items()}
              for layer in state.best_params]
    return {"params": params, "cfg_path": cfg_path, "launches": launches,
            "s1_steps_per_s": s1_rate, "s2_steps_per_s": s2_rate, "chamfer": chamfer,
            "scores": scores, "data_dir": data_dir, "bootstrap_epochs": stats["bootstrap_epochs"],
            "swap_epoch": stats["swap_epoch"], "oracle_build_s": stats["oracle_build_s"]}


def rates_report(stats, pipeline_s, tag):
    """Print a cli.train run's oracle, swap and step rates; -> s1 and s2
    steps/s."""
    n_s1, n_s2 = stats["s1_steps"], stats["s2_steps"]
    s1_rate, s2_rate = n_s1 / stats["s1_s"], n_s2 / stats["s2_s"]
    print(f"{tag} oracle {stats['oracle_s']:.2f} s, its build {stats['oracle_build_s']:.2f} s "
          f"(swapped in at epoch {stats['swap_epoch']}: {stats['bootstrap_epochs']} bootstrap "
          f"epochs), s1 {stats['s1_s']:.2f} s for {n_s1} steps ({s1_rate:.2f} steps/s), s2 "
          f"{stats['s2_s']:.2f} s for {n_s2} steps ({s2_rate:.2f} steps/s), all steps "
          f"{(n_s1 + n_s2) / stats['train_s']:.2f} steps/s (the original DiffUDF: "
          f"{BASELINE_STEPS_PER_S} steps/s); pipeline {pipeline_s:.2f} s; extraction "
          f"{json.dumps(stats['mesh'])}")
    return s1_rate, s2_rate


def check_losses(path, tag):
    """losses.csv holds every epoch, finite, and the s1 loss falls."""
    logs = losses_table(path)
    total = logs["total"]
    if len(total) != RECIPE["num_epochs"] or not np.isfinite(total).all():
        raise AssertionError("losses.csv lacks epochs or holds a non-finite total")
    for name, col in logs.items():
        if not np.isfinite(col[~np.isnan(col)]).all():
            raise AssertionError(f"non-finite {name} in losses.csv")
    s1 = total[:RECIPE["s1_epochs"]]
    first, last = float(s1[:50].mean()), float(s1[-50:].mean())
    print(f"{tag} s1 total loss: first 50 epochs {first:.3f}, last 50 {last:.3f}; "
          f"s2 total loss: last 50 {float(total[-50:].mean()):.3f}")
    if not last < first:
        raise AssertionError(f"the s1 loss did not fall: {first} -> {last}")


def check_chamfer(meshes, dataset, bound, tag):
    """The Chamfer-L1 of both final meshes' vertices against the dataset's
    100k-point cloud, each within ``bound``; -> {name: Chamfer-L1}."""
    from diffudf_tpu_torch.data.mesh_io import load_point_cloud

    cloud = load_point_cloud(dataset + "_pc.ply").points
    chamfer = {}
    for name, m in zip(("MU", "CAP"), meshes):
        v = np.asarray(m.vertices, np.float64)
        if len(m.faces) == 0 or not np.isfinite(v).all():
            raise AssertionError(f"{name} mesh is empty or not finite")
        chamfer[name] = chamfer_l1(v, cloud)
    print(f"{tag} Chamfer-L1 of the mesh vertices vs the 100k-point cloud: "
          f"MU {chamfer['MU']:.6f}, CAP {chamfer['CAP']:.6f} (bound {bound}; "
          f"faces MU {len(meshes[0].faces)}, CAP {len(meshes[1].faces)})")
    for name, c in chamfer.items():
        if not c <= bound:
            raise AssertionError(f"{name} Chamfer-L1 {c} > {bound}")
    return chamfer


def png_size(path):
    """(width, height) from a PNG file's IHDR chunk."""
    with open(path, "rb") as fh:
        head = fh.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG file")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


def check_figure(out_dir, width, tag):
    """Both slice-figure PNGs: the 2x2 mosaic of width x width panels and
    the width x width normal map."""
    sizes = {name: png_size(os.path.join(out_dir, name))
             for name in ("distance_fields.png", "pred_grad.png")}
    want = {"distance_fields.png": (2 * width, 2 * width), "pred_grad.png": (width, width)}
    print(f"{tag} figure PNGs: {sizes}")
    if sizes != want:
        raise AssertionError(f"figure PNG sizes {sizes} != {want}")


def score_meshes(meshes, cloud, chamfer):
    """Chamfer-L1/L2 and NC of the meshes by the port's eval/chamfer.py,
    host and device backends, against the script's own Chamfer-L1."""
    from diffudf_tpu_torch.eval.chamfer import chamfer_distance

    scores, failed = {}, []
    for name, m in zip(("MU", "CAP"), meshes):
        v, vn = np.asarray(m.vertices, np.float64), m.compute_vertex_normals()
        for backend in ("host", "device"):
            l1, nc = chamfer_distance(v, cloud.points, vn, cloud.normals, norm=1, backend=backend)
            l2, _ = chamfer_distance(v, cloud.points, vn, cloud.normals, norm=2, backend=backend)
            scores[f"{name}_{backend}"] = {"L1": l1, "L2": l2, "NC": nc}
            if not abs(l1 / chamfer[name] - 1) <= CHAMFER_RTOL["L1"]:
                failed.append(f"{name} {backend} L1 {l1} vs the script's {chamfer[name]}")
        h, d = scores[f"{name}_host"], scores[f"{name}_device"]
        for k in ("L2", "NC"):
            if not abs(d[k] / h[k] - 1) <= CHAMFER_RTOL[k]:
                failed.append(f"{name} {k}: device {d[k]} vs host {h[k]}")
        print(f"[train] eval/chamfer.py {name}: host L1 {h['L1']:.6f} L2 {h['L2']:.4e} NC "
              f"{h['NC']:.6f}; device L1 {d['L1']:.6f} L2 {d['L2']:.4e} NC {d['NC']:.6f}")
    if failed:
        raise AssertionError("; ".join(failed))
    return scores


def witness(name, got, want, exact, failed, tag="[train-kernels]"):
    """Print and gate got's max and RMS distance from the float64 exact
    values against WITNESS times the float32 plain version's; -> (max, RMS),
    each as (kernel, plain)."""
    e_k, e_p = (got.double() - exact).abs(), (want.double() - exact).abs()
    mx, rms = (float(e_k.max()), float(e_p.max())), (
        float(e_k.square().mean().sqrt()), float(e_p.square().mean().sqrt()))
    print(f"{tag} {name} vs float64, kernel / plain: max {mx[0]:.3e} / "
          f"{mx[1]:.3e}, RMS {rms[0]:.3e} / {rms[1]:.3e}")
    for what, (k, p) in (("max", mx), ("RMS", rms)):
        if not k <= WITNESS * p:
            failed.append(f"{name}: kernel's {what} distance from float64 {k} > "
                          f"{WITNESS} x the plain version's {p}")
    return mx, rms


@phase("training kernels")
def train_kernel_phase(params, cfg_path):
    """K1, K2, K3a and K3b against their plain versions on the trained net
    and a batch of the run's sampler, with the s1 loss's own cotangents."""
    from diffudf_tpu_torch.cli import train
    from diffudf_tpu_torch.config import TrainConfig
    from diffudf_tpu_torch.fields.siren import flatten_params
    from diffudf_tpu_torch.ops import vg, vgh
    from diffudf_tpu_torch.train.losses import loss_s1

    cfg = TrainConfig.from_json(cfg_path)
    spec = cfg.network.to_spec()
    sampler, _, _ = train.build_sampler(cfg)  # the run's oracle cache: no rebuild
    pts, nrm, sdf = sampler.sample(torch.Generator(device="cuda").manual_seed(7))
    n_on = sampler.sizes.on_surface
    surf, off = pts[:n_on].contiguous(), pts[n_on:].contiguous()
    outs = [t.detach().clone().requires_grad_(True)
            for t in vgh.vgh_reference(params, spec, surf) + vg.vg_reference(params, spec, off)]
    terms = loss_s1(params, spec, pts, nrm, sdf, cfg.loss_s1_weights, cfg.alpha,
                    n_surface=n_on, vgh_fn=lambda *a: tuple(outs[:3]),
                    vg_fn=lambda *a: tuple(outs[3:]))
    cf, cg, ch, cfo, cgo = torch.autograd.grad(sum(terms.values()), outs)
    cot16 = torch.cat([cf[:, None], cg, ch, torch.zeros_like(ch)], dim=1).contiguous()
    cot8 = torch.cat([cfo[:, None], cgo, torch.zeros_like(cfo)[:, None].expand(-1, 4)],
                     dim=1).contiguous()
    p64 = [{k: v.double() for k, v in layer.items()} for layer in params]
    print(f"[train-kernels] {n_on} surface rows ({n_on % 8} in K2's masked last tile of 8), "
          f"{len(off)} off-surface rows ({len(off) % 16} in the masked last tile of 16)")
    failed, out = [], {}

    # K1 and K3a: element by element, f 1e-5, g 1e-4 and h6 5e-3 absolute
    # plus RTOL |plain|
    for name, fn, plain, x, names in (
            ("K1", vgh.vgh, vgh.vgh_reference, surf, ("f", "g", "h6")),
            ("K3a", vg.vg, vg.vg_reference, off, ("f", "g"))):
        got, want = fn(params, spec, x), plain(params, spec, x)
        exact = plain(p64, spec, x.double())
        torch.cuda.synchronize()
        worst = 0.0
        for k, a, b, e in zip(names, got, want, exact):
            worst = max(worst, float(((a - b).abs() / (TOL[k] + RTOL * b.abs())).max()))
            witness(f"{name} {k}", a, b, e, failed)
            limit64 = TOL[k] + RTOL * e.abs()
            print(f"[train-kernels] {name} {k}: worst |x - float64| / ({TOL[k]} + {RTOL} "
                  f"|float64|), kernel / plain: {float(((a.double() - e).abs() / limit64).max()):.3f}"
                  f" / {float(((b.double() - e).abs() / limit64).max()):.3f}")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        print(f"[train-kernels] {name}: max |kernel - plain| {err:.3e}, worst err/limit "
              f"{worst:.3f}")
        if not worst <= 1:
            failed.append(f"{name} outside its tolerance of the plain version")
        out[name] = {"max_abs_err": err}

    # K2 and K3b: every gradient element within GTOL * max(max |plain|, 1)
    # + RTOL |plain| of the plain version
    for name, fn, plain, x, cot in (("K2", vgh.vgh_bwd, vgh.vgh_bwd_reference, surf, cot16),
                                    ("K3b", vg.vg_bwd, vg.vg_bwd_reference, off, cot8)):
        got, want = fn(params, spec, x, cot), plain(params, spec, x, cot)
        exact = plain(p64, spec, x.double(), cot.double())
        torch.cuda.synchronize()
        worst = 0.0
        for g, w in zip(got, want):
            for k in ("w", "b"):
                limit = GTOL[name] * max(float(w[k].abs().max()), 1.0) + RTOL * w[k].abs()
                worst = max(worst, float(((g[k] - w[k]).abs() / limit).max()))
        g_k, g_p, g_e = (flatten_params(t) for t in (got, want, exact))
        err = float((g_k - g_p).abs().max())
        print(f"[train-kernels] {name}: max |kernel - plain| {err:.3e} (plain: max "
              f"{float(g_p.abs().max()):.3e}, RMS {float(g_p.square().mean().sqrt()):.3e}), "
              f"worst err/limit {worst:.3f}")
        witness(name, g_k, g_p, g_e, failed)
        if not worst <= 1:
            failed.append(f"{name} outside its tolerance of the plain version")
        out[name] = {"max_abs_err": err}
    if failed:
        raise AssertionError("; ".join(failed))

    # times at the slice's shapes, and bounds: K1's is the FP32 FMA one, the
    # others' the 3xTF32 one, each with the other bound and the bytes of
    # their design beside it
    runs = {
        "K1": (lambda: vgh.vgh(params, spec, surf), lambda: vgh.vgh_reference(params, spec, surf),
               len(surf)),
        "K2": (lambda: vgh.vgh_bwd(params, spec, surf, cot16),
               lambda: vgh.vgh_bwd_reference(params, spec, surf, cot16), len(surf)),
        "K3a": (lambda: vg.vg(params, spec, off), lambda: vg.vg_reference(params, spec, off),
                len(off)),
        "K3b": (lambda: vg.vg_bwd(params, spec, off, cot8),
                lambda: vg.vg_bwd_reference(params, spec, off, cot8), len(off)),
    }
    for name, (kernel, plain, n) in runs.items():
        ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 5)
        b = kernel_bounds(name, n)
        out[name].update(ms=ms, plain_ms=plain_ms, **b, bound_share=b["bound_ms"] / ms)
        print(f"[train-kernels] {name} at {n} rows: {ms:.3f} ms (median of 20), plain "
              f"{plain_ms:.3f} ms; {bounds_text(ms, b)}")
    return out


def render_config(tmp, model_path, **overrides):
    """configs/st_cfg.json's rendering config on the torus checkpoint."""
    with open(ST_CONFIG) as fh:
        rendering = json.load(fh)["rendering_config"]
    rendering.update(output_path=os.path.join(tmp, "torus_st.png"), **overrides)
    return {"network_config": {"alpha": RECIPE["alpha"], "gt_mode": RECIPE["gt_mode"],
                               "hidden_layer_nodes": list(HIDDEN), "w0": 30,
                               "model_path": model_path},
            "rendering_config": rendering}


def hit_pixels(img):
    """Hit pixels of a one-pass render: hit colours are clipped to 0.9 (at
    most 229 of 255), the other pixels stay white."""
    return (img != 255).any(axis=-1)


@phase("render")
def render_phase(tmp):
    """configs/st_cfg.json's render of the trained torus through
    cli.generate_st.main, then two one-pass variants."""
    from diffudf_tpu_torch.cli import generate_st
    from diffudf_tpu_torch.ops import value, vg, vgh

    model_path = os.path.join(tmp, "runs", "torus", "models", "model_best.npz")
    cfg = render_config(tmp, model_path)
    rc = cfg["rendering_config"]
    cfg_path = os.path.join(tmp, "st_cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)

    zero_counts()
    value.points = 0
    value.launches_at.clear()
    img, stats = generate_st.main([cfg_path])
    launches = {"K1": vgh.launches, "K2": vgh.bwd_launches, "K3a": vg.launches,
                "K3b": vg.bwd_launches, "K4": value.launches}
    k4_points = value.points

    passes = stats["passes"]
    rays = rc["width"] * rc["height"] * len(passes)
    mrays = rays / stats["render_s"] / 1e6
    for i, p in enumerate(passes):
        print(f"[render] pass {i + 1}: march {p['march_s']:.3f} s, {p['iterations']} iterations, "
              f"{p['hits']} hits of {p['valid']} valid rays ({p['hits'] / p['valid']:.1%}), "
              f"K4 {p['k4_launches']} launches on {p['k4_points']} points (by bucket "
              f"{p['k4_at']}); hit attributes {p['attributes_s']:.3f} s, shading "
              f"{p['shading_s']:.3f} s", flush=True)
    print(f"[render] {rc['width']}x{rc['height']}, {len(passes)} passes: {stats['render_s']:.3f} s, "
          f"{mrays:.3f} Mrays/s (the original DiffUDF tracer: {BASELINE_MRAYS_PER_S} Mrays/s); "
          f"K4 points {k4_points}; kernel launches in this run: {launches}")
    want = {"K1": len(passes), "K2": 0, "K3a": 0, "K3b": 0,
            "K4": sum(p["iterations"] for p in passes)}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}: K4 once per march iteration, "
                             f"K1 once per pass")
    for i, p in enumerate(passes):
        if not (p["hits"] > 0 and 0.01 <= p["hits"] / p["valid"] <= 0.99):
            raise AssertionError(f"pass {i + 1}: {p['hits']} hits of {p['valid']} valid rays")
        if p["nonfinite"]:
            raise AssertionError(f"pass {i + 1}: {p['nonfinite']} non-finite colour values")
    if img.shape != (rc["height"], rc["width"], 3):
        raise AssertionError(f"image shape {img.shape}")
    with open(rc["output_path"], "rb") as fh:
        if fh.read(8) != b"\x89PNG\r\n\x1a\n":
            raise AssertionError("the render's output is not a PNG file")

    # the float32 march on pass 1's jitter, against the bf16 march's pass 1
    runs = {}
    for name, extra in (("bf16", {}), ("f32", {"fast_march": False}),
                        ("gaussian", {"plot_curvatures": "gaussian", "reflection_method": "ward"})):
        one = {}
        t0 = time.perf_counter()
        runs[name] = generate_st.generate_st(render_config(tmp, model_path, sample_rate=1, **extra),
                                             stats=one)
        p = one["passes"][0]
        print(f"[render] one pass, {name}: {time.perf_counter() - t0:.3f} s, march "
              f"{p['march_s']:.3f} s, {p['iterations']} iterations, {p['hits']} hits; hit "
              f"attributes {p['attributes_s']:.3f} s", flush=True)
        if p["nonfinite"] or not p["hits"] > 0:
            raise AssertionError(f"one-pass {name} render: {p['hits']} hits, "
                                 f"{p['nonfinite']} non-finite colour values")
        if name == "bf16" and (p["hits"], p["iterations"]) != (passes[0]["hits"],
                                                                passes[0]["iterations"]):
            raise AssertionError("the same pass rendered twice marched differently")
    hb, hf = hit_pixels(runs["bf16"]), hit_pixels(runs["f32"])
    flips = int((hb != hf).sum())
    print(f"[render] float32 vs bf16 march, pass 1: {flips} hit pixels differ of {int(hb.sum())} "
          f"(bound {MAX_HIT_FLIPS:.0%} of the hits)")
    if hb.sum() != passes[0]["hits"] or flips > MAX_HIT_FLIPS * hb.sum():
        raise AssertionError(f"{flips} of {int(hb.sum())} hit pixels differ between the marches")
    return {"launches": launches, "cfg": cfg, "model_path": model_path, "mrays_per_s": mrays,
            "img": img,
            "passes": passes, "flips": flips}


def value_bound(n_points, hidden, mode):
    """(bound ms, "operations" or "bytes") of K4 on n_points: its FLOPs at
    the FP32 rate (f32) or the dense bf16 tensor rate (bf16), against 16
    bytes a point and the weights once (hidden and head weights in bf16 in
    the bf16 mode)."""
    h, n_mm = hidden[0], len(hidden) - 1
    flops = n_points * (2 * 3 * h + n_mm * 2 * h * h + 2 * h)
    wbytes = 2 if mode == "bf16" else 4
    nbytes = n_points * 16 + 4 * (4 * h + n_mm * h + 1) + wbytes * (n_mm * h * h + h)
    peak = PEAK_BF16_FLOPS if mode == "bf16" else PEAK_FP32_FLOPS
    flop_ms, byte_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES_PER_S
    return max(flop_ms, byte_ms), ("operations" if flop_ms >= byte_ms else "bytes")


@phase("render kernel")
def render_kernel_phase(cfg, model_path, pass1):
    """K4 against value_reference in both modes on pass 1's entry points,
    padded and compacted as the tracer's first round gives them to K4; then
    K4 against value_reference and its times at every bucket of the march,
    and its share of pass 1's march (``pass1``: phase 9's record of that
    pass)."""
    from diffudf_tpu_torch.fields.siren import SirenSpec
    from diffudf_tpu_torch.ops import kernel_io as kio
    from diffudf_tpu_torch.ops import value
    from diffudf_tpu_torch.render.camera import camera_rays_device
    from diffudf_tpu_torch.render.tracer import _bucket_for, _padded_rays
    from diffudf_tpu_torch.train.checkpoint import load_params

    rc = cfg["rendering_config"]
    spec = SirenSpec(hidden=HIDDEN)
    params = load_params(model_path, device="cuda")
    p64 = [{k: v.double() for k, v in layer.items()} for layer in params]
    noise = np.random.default_rng(cfg.get("seed", 0)).normal(0.5, 0.35)  # pass 1's jitter
    _, t0, valid = camera_rays_device(rc["width"], rc["height"], rc["fov"], rc["camera_position"],
                                      noise, rc.get("planes"), device="cuda")
    n = _padded_rays(len(t0))
    count = int(valid.sum())
    bucket = _bucket_for(count, n)
    active = torch.zeros(n, dtype=torch.bool, device="cuda")
    active[:len(t0)] = valid
    entries = torch.zeros((n, 3), device="cuda")
    entries[:len(t0)] = t0
    x = entries[torch.argsort((~active).to(torch.uint8), stable=True)[:bucket]].contiguous()
    print(f"[render-kernel] pass 1: {count} of {len(t0)} rays enter the cube, padded to {n}; "
          f"K4's first bucket {bucket} points")

    modes = {"f32": None, "bf16": torch.bfloat16}
    exact = value.value_reference(p64, spec, x.double())
    failed, out = [], {}
    for mode, dt in modes.items():
        got = value.value(params, spec, x, compute_dtype=dt)
        want = value.value_reference(params, spec, x, compute_dtype=dt)
        torch.cuda.synchronize()
        err = (got - want).abs()
        worst = float((err / (K4_TOL[mode] + RTOL * want.abs())).max())
        e64 = (got.double() - exact).abs()
        print(f"[render-kernel] K4 {mode}: max |K4 - plain| {float(err.max()):.3e} (plain: RMS "
              f"{float(want.square().mean().sqrt()):.3e}, max {float(want.abs().max()):.3e}), "
              f"limit {K4_TOL[mode]} + {RTOL} |plain|, worst err/limit {worst:.3f}; vs float64: "
              f"max {float(e64.max()):.3e}, RMS {float(e64.square().mean().sqrt()):.3e}")
        if not worst <= 1:
            failed.append(f"K4 {mode} outside its tolerance of the plain version")
        if mode == "f32":
            witness("K4 f32", got, want, exact, failed, tag="[render-kernel]")
        out[mode] = {"max_abs_err": float(err.max())}
    del exact
    if failed:
        raise AssertionError("; ".join(failed))

    # at every bucket the march visits (its tile follows the bucket), on the
    # weights as the march lays them out once per trace: K4 against the plain
    # version under the same gate, and its times; the plain version's time
    # at the first bucket
    visited = {int(b) for b in pass1["k4_at"]}
    buckets = sorted(visited | {b for b in (1024, 4096, 16384, 65536) if b <= bucket},
                     reverse=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for mode, dt in modes.items():
        weights = value.prepare(params, spec, compute_dtype=dt)
        out[mode]["buckets"] = {}
        for b in buckets:
            xb = x[:b].contiguous()
            got = value.value(params, spec, xb, compute_dtype=dt, weights=weights)
            want = value.value_reference(params, spec, xb, compute_dtype=dt)
            torch.cuda.synchronize()
            err = (got - want).abs()
            worst = float((err / (K4_TOL[mode] + RTOL * want.abs())).max())
            if not worst <= 1:
                failed.append(f"K4 {mode} at {b} points outside its tolerance of the plain "
                              f"version")
            ms = cuda_ms(lambda: value.value(params, spec, xb, compute_dtype=dt,
                                             weights=weights), 20)
            bound, by = value_bound(b, HIDDEN, mode)
            plan = kio.value_plan(spec, b, mode == "bf16", sms)
            row = {"ms": ms, "bound_ms": bound, "bound_by": by, "tile": plan.tile,
                   "grid": plan.grid, "bytes_moved": plan.bytes_moved, "l2_bytes": plan.l2_bytes,
                   "max_abs_err": float(err.max()), "worst_err_over_limit": worst}
            out[mode]["buckets"][b] = row
            print(f"[render-kernel] K4 {mode} at {b} points: max |K4 - plain| "
                  f"{float(err.max()):.3e}, worst err/limit {worst:.3f}; {ms:.3f} ms (median of "
                  f"20), bound {bound:.3f} ms ({by}), {bound / ms:.1%} of the bound; tile "
                  f"{plan.tile}, {plan.grid} CTAs, device memory {plan.bytes_moved / 1e6:.3f} MB, "
                  f"W from L2 {plan.l2_bytes / 1e6:.1f} MB ({plan.l2_bytes / ms / 1e9:.2f} TB/s)")
        plain_ms = cuda_ms(lambda: value.value_reference(params, spec, x, compute_dtype=dt), 20)
        first = out[mode]["buckets"][bucket]
        out[mode].update(ms=first["ms"], plain_ms=plain_ms, bound_ms=first["bound_ms"],
                         bound_by=first["bound_by"], points=bucket)
        print(f"[render-kernel] K4 {mode} plain version at {bucket} points: {plain_ms:.3f} ms "
              f"(median of 20)")
    # pass 1 marched in the bf16 mode: its launches at each bucket times
    # that bucket's time, against its march seconds (host clock)
    est = sum(n * out["bf16"]["buckets"][int(b)]["ms"] for b, n in pass1["k4_at"].items())
    out["march_share"] = {"k4_ms": est, "march_s": pass1["march_s"],
                          "share": est / (1e3 * pass1["march_s"]), "launches": pass1["k4_at"]}
    print(f"[render-kernel] K4 in pass 1's march: {est:.3f} ms estimated (launches by bucket "
          f"{pass1['k4_at']} x each bucket's time) of its {1e3 * pass1['march_s']:.3f} ms march: "
          f"{out['march_share']['share']:.1%}")
    if failed:
        raise AssertionError("; ".join(failed))
    return out


@phase("figures")
def figures_phase(tmp, data_dir):
    """cli.generate_df.main at FIGURE_WIDTH on the trained torus against its
    point cloud (K5) and its normalised mesh (the triangle sweep)."""
    from diffudf_tpu_torch.cli import generate_df
    from diffudf_tpu_torch.ops import min_distance, value, vg, vgh

    model_path = os.path.join(tmp, "runs", "torus", "models", "model_best.npz")
    out = {}
    for geometry in ("torus_pc.ply", "torus_t.obj"):
        out_dir = os.path.join(tmp, "figures", geometry.replace(".", "_"))
        zero_counts()
        stats = generate_df.main([os.path.join(data_dir, geometry), model_path, out_dir,
                                  "-w", str(FIGURE_WIDTH), "-a", str(RECIPE["alpha"])])
        launches = {"K1": vgh.launches, "K2": vgh.bwd_launches, "K3a": vg.launches,
                    "K3b": vg.bwd_launches, "K4": value.launches, "K5": min_distance.launches}
        want = {"K1": 1, "K2": 0, "K3a": 0, "K3b": 0, "K4": 0,
                "K5": 1 if geometry.endswith(".ply") else 0}
        print(f"[figures] {geometry} at width {FIGURE_WIDTH}: predict {stats['predict_s']:.3f} s, "
              f"GT distances {stats['gt_s']:.3f} s, drawing {stats['render_s']:.3f} s; kernel "
              f"launches {launches}", flush=True)
        if launches != want:
            raise AssertionError(f"launches {launches} != {want}: K1 once for the prediction, "
                                 f"K5 once for a point cloud's distances")
        check_figure(out_dir, FIGURE_WIDTH, "[figures]")
        out[geometry] = {"stats": stats, "launches": launches}
    return out


def min_distance_bound(n_queries, n_cloud):
    """(bound ms, "operations" or "bytes") of K5: 3 FMAs (6 FLOP) a pair at
    the FP32 rate against the queries and cloud read once and the distances
    written once."""
    flops = 6 * n_queries * n_cloud
    nbytes = 4 * (3 * n_queries + 3 * n_cloud + n_queries)
    flop_ms, byte_ms = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    return max(flop_ms, byte_ms), ("operations" if flop_ms >= byte_ms else "bytes")


def min_distance_issue_floor(n_queries, n_cloud):
    """ms of K5's own floor: four issue slots a pair (3 FFMA + 1 FMNMX), a
    lane's instruction each, at PEAK_FP32_FLOPS / 2 lane instructions a
    second (one warp instruction a clock on every scheduler, at the clock
    the FP32 peak implies)."""
    return 1e3 * 4 * n_queries * n_cloud / (PEAK_FP32_FLOPS / 2)


@phase("distance kernel")
def distance_kernel_phase(data_dir, params):
    """K5 against its plain version and the float64 witness at the figure's
    shape: the plane's FIGURE_WIDTH^2 queries against the torus cloud."""
    from diffudf_tpu_torch.data.mesh_io import load_point_cloud
    from diffudf_tpu_torch.fields.siren import SirenSpec
    from diffudf_tpu_torch.grid.slices import plane_samples
    from diffudf_tpu_torch.ops import min_distance, vgh

    points = load_point_cloud(os.path.join(data_dir, "torus_pc.ply")).points
    cloud = torch.as_tensor(np.ascontiguousarray(points, np.float32), device="cuda")
    q = torch.as_tensor(plane_samples(FIGURE_WIDTH), device="cuda")
    nq, m = len(q), len(cloud)
    got = min_distance.min_distance(q, cloud)
    want = min_distance.min_distance_reference(q, cloud)
    exact = min_distance.min_distance_reference(q.double(), cloud.double())
    # the value K5's expanded form gives, sqrt(min rank + |q|^2): what the
    # argmin and the exact recompute avoid
    expanded = torch.cat([torch.sqrt(torch.clamp(min_distance.rank_reference(c, cloud)[0]
                                                 + (c * c).sum(1), min=0.0))
                          for c in q.split(min_distance.QUERY_TILE)])
    torch.cuda.synchronize()
    err = {"K5 - plain": (got - want).double().abs()}
    for name, a in (("K5", got), ("plain", want), ("expanded form", expanded)):
        err[f"{name} - float64"] = (a.double() - exact).abs()
    report = {k: (float(e.max()), float(e.square().mean().sqrt())) for k, e in err.items()}
    near = exact < 0.01
    print(f"[distance-kernel] {nq} plane queries x {m} cloud points; {int(near.sum())} queries "
          f"within 0.01 of the cloud (nearest {float(exact.min()):.3e})")
    for k, (mx, rms) in report.items():
        print(f"[distance-kernel] |{k}|: max {mx:.3e}, RMS {rms:.3e}")
    failed = [k for k in ("K5 - plain", "K5 - float64") if not report[k][0] <= K5_TOL]
    if failed or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K5 outside {K5_TOL} ({failed}) or not finite")
    del want, exact, expanded, err

    ms = cuda_ms(lambda: min_distance.min_distance(q, cloud), 20)
    plain_ms = cuda_ms(lambda: min_distance.min_distance_reference(q, cloud), 20)
    cdist_ms = cuda_ms(lambda: torch.cat([torch.cdist(c, cloud).amin(1)
                                          for c in q.split(min_distance.QUERY_TILE)]), 20)
    bound, by = min_distance_bound(nq, m)
    floor = min_distance_issue_floor(nq, m)
    print(f"[distance-kernel] K5 {ms:.3f} ms (median of 20), plain {plain_ms:.3f} ms (median of "
          f"20), torch.cdist + amin over {min_distance.QUERY_TILE}-query chunks {cdist_ms:.3f} ms "
          f"(median of 20), bound {bound:.3f} ms ({by}), {bound / ms:.1%} of the bound; issue "
          f"floor (4 slots a pair) {floor:.3f} ms, {floor / ms:.1%} of it")

    spec = SirenSpec(hidden=HIDDEN)
    k1_ms = cuda_ms(lambda: vgh.vgh(params, spec, q), 20)
    k1 = kernel_bounds("K1", nq)
    print(f"[distance-kernel] K1 at the figure's {nq} points: {k1_ms:.3f} ms (median of 20); "
          f"{bounds_text(k1_ms, k1)}")
    return {"max_abs_err": report["K5 - plain"][0], "witness_max_err": report["K5 - float64"][0],
            "expanded_form_max_err": report["expanded form - float64"][0], "ms": ms,
            "plain_ms": plain_ms, "cdist_ms": cdist_ms, "bound_ms": bound, "bound_by": by,
            "issue_floor_ms": floor, "queries": nq, "cloud": m,
            "k1_figure": {"points": nq, "ms": k1_ms, **k1}}


def cell_guarantee(tri_table):
    """(g^3,) per cell of the triangle table: the largest bounding-sphere
    lower bound ``|centre - centroid| - radius`` over its k candidates, less
    the cell's half-diagonal.  The grid holds the k best lower bounds of
    every triangle from the cell centre, so a query of the cell nearer than
    this to the mesh has its nearest triangle among the candidates."""
    from diffudf_tpu_torch.data import mesh_distance as md

    g, lo, hi = md.CAND_GRID_G, md.CAND_GRID_LO, md.CAND_GRID_HI
    tv = tri_table.view(tri_table.shape[0], -1, 3, 3)
    cen = tv.mean(dim=2)
    rad = torch.sqrt(((tv - cen[:, :, None]) ** 2).sum(-1).max(-1).values)
    centres = torch.as_tensor(md._cell_centers(g, lo, hi), device=tri_table.device)
    lb = (centres[:, None, :] - cen).norm(dim=-1) - rad
    return lb.max(dim=1).values - (hi - lo) / g * 3 ** 0.5 / 2


@phase("mesh train")
def mesh_train_phase(tmp, pc_run):
    """The trefoil recipe in mesh mode through cli.train.main, the oracle
    build overlapped; then the table oracle against the brute sweep on a
    batch of the run's sampler, and both oracles' times a step."""
    from diffudf_tpu_torch.cli import preprocess, train
    from diffudf_tpu_torch.config import TrainConfig
    from diffudf_tpu_torch.data import mesh_distance as md
    from diffudf_tpu_torch.data.mesh_io import load_mesh
    from diffudf_tpu_torch.data.sampling import TrainingSampler
    from diffudf_tpu_torch.ops import min_distance, vg, vgh

    data_dir = os.path.join(tmp, "mesh")
    t0 = time.perf_counter()
    preprocess.preprocess_mesh(data_dir, os.path.join(REPO, "data", "demo", "trefoil.obj"), 100000)
    print(f"[mesh-train] preprocess (100k points): {time.perf_counter() - t0:.2f} s", flush=True)
    cfg = dict(RECIPE, onlyPCloud=False, dataset=os.path.join(data_dir, "trefoil"),
               experiment_name="trefoil", checkpoint_path=os.path.join(tmp, "runs"))
    cfg_path = os.path.join(tmp, "mesh_train_cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)

    zero_counts()
    (pipeline_s, meshes, _), stats = train.main([cfg_path])
    launches = {"K1": vgh.launches, "K2": vgh.bwd_launches, "K3a": vg.launches,
                "K3b": vg.bwd_launches, "K5": min_distance.launches}
    n_s1 = stats["s1_steps"]
    s1_rate, s2_rate = rates_report(stats, pipeline_s, "[mesh-train]")
    print(f"[mesh-train] s1 {s1_rate:.2f} and s2 {s2_rate:.2f} steps/s against phase 7's point-"
          f"cloud {pc_run['s1_steps_per_s']:.2f} and {pc_run['s2_steps_per_s']:.2f}")
    print(f"[mesh-train] kernel launches in this run: {launches}; slice figure at width "
          f"{train.SLICE_WIDTH}: {json.dumps(stats['figure'])}")
    extraction_k1 = 1 if stats["mesh"]["dirs_points"] > 0 else 0
    want = {"K1": n_s1 + 1 + extraction_k1, "K2": n_s1, "K3a": n_s1, "K3b": n_s1, "K5": 0}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}: once per s1 step, K1 once more "
                             f"for the slice figure and {extraction_k1} by the final "
                             f"extraction, K5 never (the figure reads the triangle table)")
    if stats["swap_epoch"] is None:
        raise AssertionError("the triangle table was never swapped in")
    check_figure(os.path.join(tmp, "runs", "trefoil", "reconstructions"), train.SLICE_WIDTH,
                 "[mesh-train]")
    check_losses(os.path.join(tmp, "runs", "trefoil", "losses.csv"), "[mesh-train]")
    chamfer = check_chamfer(meshes, cfg["dataset"], MAX_TREFOIL_CHAMFER_L1, "[mesh-train]")
    print(f"[mesh-train] the JAX package's trefoil row (results/results_demo.csv, a record): "
          f"CAP {JAX_TREFOIL_L1['CAP']}, MU {JAX_TREFOIL_L1['MU']}")

    # the table oracle against the brute sweep on a batch of the run's
    # sampler (the run's cache: no rebuild), and each oracle's time a step
    tcfg = TrainConfig.from_json(cfg_path)
    table_sampler, pc, _ = train.build_sampler(tcfg)
    mesh = load_mesh(cfg["dataset"] + "_t.obj")
    boot = TrainingSampler.from_mesh_bootstrap(pc.points, pc.normals, mesh.vertices[mesh.faces],
                                               tcfg.batch_size, tcfg.sampling_percentiles)
    sz = table_sampler.sizes
    pts, _, _ = table_sampler.sample(torch.Generator(device="cuda").manual_seed(11))
    q = pts[sz.on_surface:].contiguous()
    table = md.point_triangle_distance_table(q, table_sampler.tri_table)
    brute = md.point_triangle_distance_bootstrap(q, boot.tri_verts)
    err = (table - brute).abs()
    # the oracle's guarantee: a query's nearest triangle is among its cell's
    # candidates when its distance is below the cell's k-th lower bound from
    # the cell centre minus the half-diagonal
    certified = brute < cell_guarantee(table_sampler.tri_table)[md._cell_rows(
        q, md.CAND_GRID_G, md.CAND_GRID_LO, md.CAND_GRID_HI)] - 1e-6
    near = torch.arange(len(q), device=q.device) >= sz.far
    checks = {"near-surface rows": err[near], "rows the guarantee covers": err[certified]}
    print(f"[mesh-train] table oracle vs the brute sweep on the {len(q)} off-surface queries of "
          f"a batch ({len(boot.tri_verts)} triangles; bound {MESH_TOL}): all rows max "
          f"{float(err.max()):.3e}, {int((err > MESH_TOL).sum())} above the bound (a record: "
          f"the grid is exact only where its guarantee covers a row); "
          + "; ".join(f"{k} ({len(e)}) max {float(e.max()):.3e}" for k, e in checks.items()))
    for k, e in checks.items():
        if not float(e.max()) <= MESH_TOL:
            raise AssertionError(f"the table oracle is {float(e.max())} from the brute sweep on "
                                 f"the {k}")
    times = {
        "table_oracle_ms": cuda_ms(lambda: md.point_triangle_distance_table(
            q, table_sampler.tri_table), 20),
        "bootstrap_oracle_ms": cuda_ms(lambda: md.point_triangle_distance_bootstrap(
            q, boot.tri_verts), 5),
        "table_sample_ms": cuda_ms(lambda: table_sampler.sample(
            torch.Generator(device="cuda").manual_seed(12)), 20),
        "bootstrap_sample_ms": cuda_ms(lambda: boot.sample(
            torch.Generator(device="cuda").manual_seed(12)), 5),
    }
    print(f"[mesh-train] a step's oracle at {len(q)} queries (CUDA-event medians): table "
          f"{times['table_oracle_ms']:.3f} ms (its sample() {times['table_sample_ms']:.3f} ms), "
          f"bootstrap sweep {times['bootstrap_oracle_ms']:.3f} ms (its sample() "
          f"{times['bootstrap_sample_ms']:.3f} ms); table {table_sampler.tri_table.numel() * 4 / 1e6:.1f} MB")
    return {"launches": launches, "chamfer": chamfer, "s1_steps_per_s": s1_rate,
            "s2_steps_per_s": s2_rate, "swap_epoch": stats["swap_epoch"],
            "bootstrap_epochs": stats["bootstrap_epochs"],
            "oracle_build_s": stats["oracle_build_s"],
            "table_vs_brute": {"all_max": float(err.max()),
                               "all_above_tol": int((err > MESH_TOL).sum()),
                               **{k: float(e.max()) for k, e in checks.items()},
                               "certified_share": float(certified.float().mean())}, **times,
            "data_dir": data_dir}


@phase("gt render")
def gt_render_phase(tmp, data_dir):
    """cli.generate_st.main with gt_mode "gt" on the trefoil's normalised
    mesh, configs/st_cfg.json's camera and light, 720x720, one pass."""
    from diffudf_tpu_torch.cli import generate_st

    with open(ST_CONFIG) as fh:
        rendering = json.load(fh)["rendering_config"]
    rendering.update(sample_rate=1, output_path=os.path.join(tmp, "trefoil_gt.png"))
    cfg = {"network_config": {"gt_mode": "gt"},
           "mesh_path": os.path.join(data_dir, "trefoil_t.obj"),
           "light_pos": rendering["light_position"], "rendering_config": rendering}
    cfg_path = os.path.join(tmp, "gt_st_cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    img, stats = generate_st.main([cfg_path])
    (p,) = stats["passes"]
    print(f"[gt-render] {rendering['width']}x{rendering['height']}, one pass: "
          f"{stats['render_s']:.3f} s, march {p['march_s']:.3f} s, {p['iterations']} iterations, "
          f"{p['hits']} hits of {p['valid']} valid rays ({p['hits'] / p['valid']:.1%})")
    if not (p["hits"] > 0 and 0.01 <= p["hits"] / p["valid"] <= 0.99):
        raise AssertionError(f"{p['hits']} hits of {p['valid']} valid rays")
    if p["nonfinite"] or img.shape != (rendering["height"], rendering["width"], 3):
        raise AssertionError(f"{p['nonfinite']} non-finite colour values, image {img.shape}")
    with open(rendering["output_path"], "rb") as fh:
        if fh.read(8) != b"\x89PNG\r\n\x1a\n":
            raise AssertionError("the GT render's output is not a PNG file")
    return {"render_s": stats["render_s"], **p}


def zero_counts():
    from diffudf_tpu_torch.ops import min_distance, value, vg, vgh

    vgh.launches = vgh.bwd_launches = vg.launches = vg.bwd_launches = value.launches = 0
    min_distance.launches = 0


def read_counts():
    from diffudf_tpu_torch.ops import min_distance, value, vg, vgh

    return {"K1": vgh.launches, "K2": vgh.bwd_launches, "K3a": vg.launches,
            "K3b": vg.bwd_launches, "K4": value.launches, "K5": min_distance.launches}


def nearest_triangles(queries, tris, tile=256):
    """(exact distance (Q,), index of the nearest triangle (Q,)) of each
    query: the brute sweep's closest-point test over every triangle, tile
    queries at a time."""
    from diffudf_tpu_torch.data.mesh_distance import _closest_point_sq_dist

    a, b, c = (tris[:, k][None] for k in range(3))
    dist, idx = [], []
    for q in torch.split(queries, tile):
        best = _closest_point_sq_dist(q[:, None, :], a, b, c).min(1)
        dist.append(torch.sqrt(torch.clamp(best.values, min=0.0)))
        idx.append(best.indices)
    return torch.cat(dist), torch.cat(idx)


def projection_errors(got, plain, exact, failed, name, tag):
    """A projection on the kernels against the plain versions and both
    against the plain versions in float64 (:func:`witness`); the kernels'
    largest distance from the plain version may be at most WITNESS times
    the plain version's largest distance from float64.  Prints the distance
    from the plain version by row and the rows beyond PROJ_TOL of it."""
    n = len(got)
    d = (got - plain).abs().reshape(n, -1).max(1).values
    mx, rms = witness(name, got, plain, exact, failed, tag)
    out = {"vs_plain_max": float(d.max()), "vs_plain_median": float(d.median()),
           "rows_beyond_tol": int((d > PROJ_TOL).sum()), "f64_max": mx, "f64_rms": rms}
    if not out["vs_plain_max"] <= WITNESS * mx[1]:
        failed.append(f"{name}: the kernels' distance from the plain version "
                      f"{out['vs_plain_max']} > {WITNESS} x the plain version's from float64 "
                      f"{mx[1]}")
    return out


@phase("point cloud")
def point_cloud_phase(tmp, run):
    """cli.generate_pc.main with configs/pc_cfg.json's keys on the trained
    torus; then the first round's projection on the kernels against the
    plain versions, and the cloud against the normalised mesh."""
    from diffudf_tpu_torch.cli import generate_pc
    from diffudf_tpu_torch.fields.siren import SirenSpec
    from diffudf_tpu_torch.ops import vg, vgh
    from diffudf_tpu_torch.pc.sampler import project_points

    with open(PC_CONFIG) as fh:
        cfg = json.load(fh)
    cfg.update(alpha=RECIPE["alpha"], output_path=os.path.join(tmp, "torus_generated.ply"),
               model_path=os.path.join(tmp, "runs", "torus", "models", "model_best.npz"))
    cfg_path = os.path.join(tmp, "pc_cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)

    zero_counts()
    t0 = time.perf_counter()
    pc, stats = generate_pc.main([cfg_path])
    wall_s = time.perf_counter() - t0
    launches = read_counts()

    rounds, n = stats["rounds"], len(pc.points)
    share = [k / c for k, c in zip(stats["kept"], stats["candidates"])]
    print(f"[pc] {n} points in {rounds} rounds (kept a round: {stats['kept']}, share "
          f"{', '.join(f'{s:.3f}' for s in share)}); projection {stats['project_s']:.3f} s on the "
          f"device, orientation {stats['orient_s']:.3f} s on the host, generate_pc "
          f"{stats['total_s']:.3f} s (main {wall_s:.3f} s with the PLY); launches {launches}",
          flush=True)
    want = {"K1": rounds, "K2": 0, "K3a": (cfg["ref_steps"] - 1) * rounds, "K3b": 0, "K4": 0,
            "K5": 0}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}: K3a (ref_steps - 1) times and K1 "
                             f"once a round")
    pts, nrm = np.asarray(pc.points), np.asarray(pc.normals)
    if not (n >= cfg["nsamples"] and np.isfinite(pts).all() and np.isfinite(nrm).all()
            and (np.abs(pts) <= 1.0).all()):
        raise AssertionError(f"{n} points (want >= {cfg['nsamples']}, finite, in [-1, 1]^3)")
    unit_err = float(np.abs(np.linalg.norm(nrm, axis=1) - 1).max())
    if not unit_err <= 1e-4:
        raise AssertionError(f"normals are not unit vectors: |norm - 1| up to {unit_err}")

    # the first round's candidates (the sampler's generator, seed 0), projected
    # on K3a + K1, on the plain versions and on the plain versions in float64,
    # all on the card
    spec = SirenSpec(hidden=HIDDEN)
    params = run["params"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x0 = torch.rand((cfg["nsamples"], 3), generator=gen, device="cuda") * 2.0 - 1.0
    kw = dict(gt_mode=RECIPE["gt_mode"], alpha=RECIPE["alpha"], num_steps=cfg["ref_steps"],
              want_hessian_normals=True)
    plain = dict(vg_fn=vg.vg_reference, vgh_fn=vgh.vgh_reference)
    got = project_points(params, spec, x0, **kw)
    want_p = project_points(params, spec, x0, **plain, **kw)
    p64 = [{k: v.double() for k, v in layer.items()} for layer in params]
    exact = project_points(p64, spec, x0.double(), **plain, **kw)
    torch.cuda.synchronize()
    proj, failed = {}, []
    for k, a, b, e in zip(("positions", "steps"), got, want_p, exact):
        proj[k] = projection_errors(a, b, e, failed, k, "[pc]")
    keep = [((x.abs() <= 1).all(1) & (st < cfg["surf_thresh"])) for x, st, _ in (got, want_p)]
    border = (((want_p[0].abs() - 1).abs() < 1e-3).any(1)
              | ((want_p[1] - cfg["surf_thresh"]).abs() < 1e-3))
    flips = int((keep[0] != keep[1])[~border].sum())
    cos_share = float(((got[2] * want_p[2]).sum(1).abs() > 0.999).float().mean())
    proj.update(keep_flips=flips, borderline=int(border.sum()), normal_cos_share=cos_share)
    print(f"[pc] first round, kernels vs plain versions on the card: {json.dumps(proj)}; keep "
          f"masks differ on {flips} rows off the {proj['borderline']} borderline ones; normals "
          f"|cos| > 0.999 on {cos_share:.4f}")
    if flips or cos_share < 0.99:
        failed.append(f"keep masks differ on {flips} rows, normals agree on {cos_share}")
    if failed:
        raise AssertionError("the projection on the kernels: " + "; ".join(failed))

    # K3a and K1 at the round's shape, with their bounds
    x1 = got[0].contiguous()
    times = {}
    for name, kernel, plain in (("K3a", vg.vg, vg.vg_reference),
                                ("K1", vgh.vgh, vgh.vgh_reference)):
        ms, plain_ms = cuda_ms(lambda: kernel(params, spec, x1), 20), cuda_ms(
            lambda: plain(params, spec, x1), 5)
        b = kernel_bounds(name, len(x1))
        times[name] = {"points": len(x1), "ms": ms, "plain_ms": plain_ms, **b}
        print(f"[pc] {name} at {len(x1)} points: {ms:.3f} ms (median of 20), plain "
              f"{plain_ms:.3f} ms; {bounds_text(ms, b)}")

    field_err, normal_cos, oriented, chamfer = cloud_against_mesh(pts, nrm, run, "[pc]")
    return {"launches": launches, "points": n, "rounds": rounds, "kept": stats["kept"],
            "project_s": stats["project_s"], "orient_s": stats["orient_s"],
            "total_s": stats["total_s"], "projection_vs_plain": proj, "times": times,
            "field_error_median": field_err, "normal_cos_median": normal_cos,
            "oriented_share": oriented, "chamfer_l1": chamfer, "cloud": pts}


def cloud_against_mesh(pts, nrm, run, tag):
    """A torus point cloud against the normalised mesh (exact distance and
    the nearest triangle's normal: phase 15's gates) and its Chamfer-L1
    against the 100k-point cloud; -> (median distance, median |cos|,
    oriented share, Chamfer-L1)."""
    from diffudf_tpu_torch.data.mesh_distance import triangles_from_mesh
    from diffudf_tpu_torch.data.mesh_io import load_obj, load_point_cloud

    mesh = load_obj(os.path.join(run["data_dir"], "torus_t.obj"))
    tris = triangles_from_mesh(mesh.vertices, mesh.faces)
    q = torch.as_tensor(pts, device="cuda")
    dist, tri = nearest_triangles(q, tris)
    tn = torch.linalg.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    tn = tn / tn.norm(dim=1, keepdim=True).clamp(min=1e-20)
    dots = (torch.as_tensor(nrm, device="cuda") * tn[tri]).sum(1)
    field_err = float(dist.median())
    normal_cos = float(dots.abs().median())
    oriented = float(max((dots > 0).float().mean(), (dots < 0).float().mean()))
    cloud = load_point_cloud(os.path.join(run["data_dir"], "torus_pc.ply")).points
    chamfer = chamfer_l1(pts.astype(np.float64), cloud)
    print(f"{tag} against torus_t.obj ({len(tris)} triangles): median distance {field_err:.3e} "
          f"(bound {MAX_PC_FIELD_ERROR}), max {float(dist.max()):.3e}; median |cos| to the "
          f"nearest triangle's normal {normal_cos:.4f} (bound {MIN_PC_NORMAL_COS}); one sign of "
          f"n . n_tri on {oriented:.4f} (bound {MIN_ORIENTED_SHARE}); Chamfer-L1 against the "
          f"100k-point cloud {chamfer:.6f} (phase 7's meshes: MU {run['chamfer']['MU']:.6f}, "
          f"CAP {run['chamfer']['CAP']:.6f})")
    if not (field_err <= MAX_PC_FIELD_ERROR and normal_cos >= MIN_PC_NORMAL_COS
            and oriented >= MIN_ORIENTED_SHARE):
        raise AssertionError(f"point cloud: median distance {field_err}, median |cos| "
                             f"{normal_cos}, oriented share {oriented}")
    return field_err, normal_cos, oriented, chamfer


@phase("enhanced")
def enhanced_phase(tmp, run, slice_stats):
    """cli.generate_mc.main with configs/mc_enhanced_cfg.json's keys on the
    trained torus; then the MU mesh's refinement on K3a against the plain
    version."""
    from diffudf_tpu_torch.cli import generate_mc
    from diffudf_tpu_torch.ops import vg

    with open(ENHANCED_CONFIG) as fh:
        cfg = json.load(fh)
    cfg.update(alpha=RECIPE["alpha"], output_path=os.path.join(tmp, "torus_enhanced.obj"),
               model_path=os.path.join(tmp, "runs", "torus", "models", "model_best.npz"))
    cfg_path = os.path.join(tmp, "mc_enhanced_cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)

    # record each refinement's input (the unrefined vertices) on the way
    calls, refine = [], generate_mc.refine_vertices

    def recording(params, spec, verts, **kw):
        calls.append((params, spec, verts, kw))
        return refine(params, spec, verts, **kw)

    generate_mc.refine_vertices = recording
    try:
        zero_counts()
        t0 = time.perf_counter()
        meshes, stats = generate_mc.main([cfg_path])
        wall_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        generate_mc.refine_vertices = refine

    N, steps = cfg["nsamples"], cfg["refine_vertices"]
    refine_s = stats["mu_refine_s"] + stats["cap_refine_s"]
    print(f"[enhanced] N={N}: {wall_s:.3f} s; stage1 {stats['stage1_s']:.3f} s, stage2 "
          f"{stats['stage2_s']:.3f} s, stage3 {stats['stage3_s']:.3f} s, MU {stats['mu_s']:.3f} s "
          f"(refine {stats['mu_refine_s']:.3f} s), CAP {stats['cap_s']:.3f} s (refine "
          f"{stats['cap_refine_s']:.3f} s), refine_s {refine_s:.3f}; K1 points "
          f"{stats['dirs_points']}, faces MU {stats['mu_faces']}, CAP {stats['cap_faces']}; "
          f"largest refinement move MU {stats['mu_refine_max_voxels']:.4f}, CAP "
          f"{stats['cap_refine_max_voxels']:.4f} voxels; launches {launches} (phase 5 at "
          f"N={N_GRID} on the sphere: stage1 {slice_stats['stage1_s']:.3f}, stage2 "
          f"{slice_stats['stage2_s']:.3f}, stage3 {slice_stats['stage3_s']:.3f}, MU "
          f"{slice_stats['mu_s']:.3f}, CAP {slice_stats['cap_s']:.3f} s)", flush=True)
    print("[enhanced] Stats: " + json.dumps(stats))
    want = {"K1": 1 if stats["dirs_points"] > 0 else 0, "K2": 0, "K3a": 2 * steps, "K3b": 0,
            "K4": 0, "K5": 0}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}: K3a once a refinement step of each "
                             f"mesh, K1 by the grid pass")
    limit = 0.5 + 1e-6 * (N - 1) / 2.0  # half a voxel + 1e-6, in voxels
    for name in ("mu", "cap"):
        if not stats[f"{name}_refine_max_voxels"] <= limit:
            raise AssertionError(f"{name}: refinement moved a vertex "
                                 f"{stats[f'{name}_refine_max_voxels']} voxels > {limit}")
    chamfer = check_chamfer(meshes, os.path.join(run["data_dir"], "torus"),
                            MAX_TORUS_CHAMFER_L1, "[enhanced]")
    print(f"[enhanced] Chamfer-L1 MU {chamfer['MU']:.6f}, CAP {chamfer['CAP']:.6f}; the JAX "
          f"package's enhanced torus row MU {JAX_ENHANCED_TORUS_L1['MU']}, CAP "
          f"{JAX_ENHANCED_TORUS_L1['CAP']} (a record); phase 7's N={RECIPE['resolution']} "
          f"meshes MU {run['chamfer']['MU']:.6f}, CAP {run['chamfer']['CAP']:.6f}")

    # the MU mesh's unrefined vertices: K3a against the plain version and
    # both against the plain version in float64
    params, spec, verts, kw = calls[0]
    p64 = [{k: v.double() for k, v in layer.items()} for layer in params]
    got, want_v, exact = (torch.as_tensor(refine(p, spec, verts, vg_fn=fn, **kw))
                          for p, fn in ((params, None), (params, vg.vg_reference),
                                        (p64, vg.vg_reference)))
    failed = []
    err = projection_errors(got, want_v, exact, failed, "refined vertices", "[enhanced]")
    print(f"[enhanced] refine_vertices on the MU mesh's {len(verts)} unrefined vertices, K3a vs "
          f"the plain version: {json.dumps(err)}")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"launches": launches, "wall_s": wall_s, "refine_s": refine_s, "chamfer": chamfer,
            "refine_vs_plain": err, "mu_vertices": len(verts),
            **{k: stats[k] for k in ("stage1_s", "stage2_s", "stage3_s", "mu_s", "cap_s",
                                     "mu_refine_s", "cap_refine_s", "mu_refine_max_voxels",
                                     "cap_refine_max_voxels", "dirs_points", "mu_faces",
                                     "cap_faces")}}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def float32_only():
    """What device_phase sets, for a rank process that did not run it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def flat_params(params):
    return torch.cat([t.detach().reshape(-1) for layer in params
                      for t in (layer["w"], layer["b"])])


def step_errors(row, grads, want_row, want_grads):
    """(largest relative term error, worst gradient element over phase 8's
    GTOL form, largest absolute gradient error) of a step against another."""
    row, want_row = row.detach(), want_row.detach()
    term = float(((row - want_row).abs() / want_row.abs().clamp(min=1e-30)).max())
    worst = err = 0.0
    for g, w in zip(grads, want_grads):
        limit = GTOL["K2"] * max(float(w.abs().max()), 1.0) + RTOL * w.abs()
        worst = max(worst, float(((g - w).abs() / limit).max()))
        err = max(err, float((g - w).abs().max()))
    return term, worst, err


def dp_train_rank(group, cfg_path, cut):
    """Phase 17 on one of 2 ranks: step 1 against the single-rank step on
    the union batch, the gradient all-reduce's time, then the cut recipe
    through cli.train.setup_train; -> rank 0's record."""
    from diffudf_tpu_torch.cli import train
    from diffudf_tpu_torch.config import TrainConfig
    from diffudf_tpu_torch.train.loop import Trainer, generator_for, rank_key

    float32_only()
    cfg = TrainConfig.from_json(cfg_path)
    spec, rank0, n = cfg.network.to_spec(), group.rank == 0, group.size
    sampler, _, _ = train.build_sampler(cfg, device=group.device, cache_writer=rank0)
    trainer = Trainer(spec, sampler, cfg, group=group)
    state = trainer.init_state()
    pts, nrm, sdf, n_surface, share = trainer.draw(
        generator_for(rank_key(state.key, group.rank), group.device))
    sync(group.device)
    zero_counts()
    row, _, grads = trainer.batch_step("s1", state.params, pts, nrm, sdf, n_surface, share)
    sync(group.device)
    step_launches = read_counts()

    # the union of the ranks' batches, surface rows first: each group of
    # rows gathered from every rank in turn
    sz = sampler.local(n).sizes
    cuts = np.cumsum([0, sz.on_surface, sz.far, sz.near])

    def union(t):
        return torch.cat([group.gather_rows(t[a:b].contiguous(), n * int(b - a))
                          for a, b in zip(cuts[:-1], cuts[1:])])

    batch = [union(t) for t in (pts, nrm, sdf)]
    flat = torch.cat([g.reshape(-1) for g in grads])
    times = []
    for _ in range(21):
        sync(group.device)
        t0 = time.perf_counter()
        group.all_reduce_sum(flat)
        sync(group.device)
        times.append(1e3 * (time.perf_counter() - t0))
    out = {"dp": trainer.dp, "rows": [len(pts), n_surface], "share": share,
           "values": len(flat), "all_reduce_ms": float(np.median(times[1:]))}
    if rank0:
        want_row, _, want_grads = Trainer(spec, sampler, cfg).batch_step(
            "s1", state.params, *batch, n * sz.on_surface)
        out["step"] = step_errors(row, grads, want_row, want_grads)
        out["terms"] = row.tolist()

    zero_counts()
    stats = {}
    cut = dict(cut, checkpoint_path=cut["checkpoint_path"] if rank0 else cut["rank1_path"])
    _, _, state = train.setup_train(TrainConfig.from_dict(cut), make_meshes=False,
                                    verbose=False, device=group.device, stats=stats,
                                    group=group)
    sync(group.device)
    run_launches = read_counts()
    p, best = flat_params(state.params), flat_params(state.best_params)
    out.update(
        step_launches=group.per_rank(list(step_launches.values())).astype(int).tolist(),
        run_launches=group.per_rank(list(run_launches.values())).astype(int).tolist(),
        s1_ms=group.per_rank([1e3 * stats["s1_s"] / stats["s1_steps"]])[:, 0].tolist(),
        s2_ms=group.per_rank([1e3 * stats["s2_s"] / stats["s2_steps"]])[:, 0].tolist(),
        all_reduce_ms=group.per_rank([out["all_reduce_ms"]])[:, 0].tolist(),
        params_equal=bool((group.per_rank(p.cpu().numpy()) == p.cpu().numpy()).all()),
        best_equal=bool((group.per_rank(best.cpu().numpy()) == best.cpu().numpy()).all()),
        finite=group.all_true(bool(torch.isfinite(p).all() and torch.isfinite(best).all())),
        stats=stats)
    return out


def dp_fallback_rank(group, cfg_path):
    """Phase 17's fallback step on one of 4 ranks: the warning, this rank's
    block of one batch, and (rank 0) the step against the single-device
    step on that batch."""
    import warnings

    from diffudf_tpu_torch.cli import train
    from diffudf_tpu_torch.config import TrainConfig
    from diffudf_tpu_torch.train.loop import Trainer, generator_for

    float32_only()
    cfg = TrainConfig.from_json(cfg_path)
    spec = cfg.network.to_spec()
    sampler, _, _ = train.build_sampler(cfg, device=group.device,
                                        cache_writer=group.rank == 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = Trainer(spec, sampler, cfg, group=group)
    warned = any(issubclass(w.category, RuntimeWarning) and "falling back to the "
                 "constrained-sharding DP step" in str(w.message) for w in caught)
    state = trainer.init_state()
    pts, nrm, sdf, n_surface, share = trainer.draw(generator_for(state.key, group.device))
    zero_counts()
    row, _, grads = trainer.batch_step("s1", state.params, pts, nrm, sdf, n_surface, share)
    sync(group.device)
    launches = read_counts()
    out = {"dp": trainer.dp, "warned": group.all_true(warned),
           "rows": group.per_rank([len(pts), n_surface]).astype(int).tolist(),
           "launches": group.per_rank(list(launches.values())).astype(int).tolist()}
    if group.rank == 0:
        full = sampler.sample(generator_for(state.key, group.device))
        want_row, _, want_grads = Trainer(spec, sampler, cfg).batch_step(
            "s1", state.params, *full, sampler.sizes.on_surface)
        out["step"] = step_errors(row, grads, want_row, want_grads)
    return out


def check_step(tag, errors):
    term, worst, err = errors
    print(f"{tag} step 1 against the single-device step: terms max relative error "
          f"{term:.3e} (bound {DP_TERM_RTOL}), gradient worst err/limit {worst:.3f} "
          f"(GTOL {GTOL['K2']} * max(max |g|, 1) + {RTOL} |g|), max |delta g| {err:.3e}")
    if not (term <= DP_TERM_RTOL and worst <= 1):
        raise AssertionError(f"{tag} the data-parallel step differs from the single-device "
                             f"step: terms {term}, gradients {worst} of the limit")


@phase("dp train")
def dp_train_phase(tmp, run):
    """Data-parallel training on the card: 2 ranks on cuda:0 (the fast
    step, the cut recipe), 4 ranks (the fallback step), a one-rank NCCL
    group."""
    from diffudf_tpu_torch.parallel import mesh

    names = list(read_counts())
    cut = dict(RECIPE, **DP_EPOCHS, dataset=os.path.join(run["data_dir"], "torus"),
               experiment_name="torus_dp", checkpoint_path=os.path.join(tmp, "runs"),
               rank1_path=os.path.join(tmp, "runs_rank1"))
    t0 = time.perf_counter()
    dp = mesh.run_group(dp_train_rank, 2, (run["cfg_path"], cut), devices=["cuda:0"] * 2)
    launch_s = time.perf_counter() - t0
    st = dp["stats"]
    print(f"[dp] 2 ranks on cuda:0 over gloo ({launch_s:.2f} s with the start): step "
          f"{dp['dp']}, each rank {dp['rows'][0]} rows ({dp['rows'][1]} on the surface), share "
          f"{dp['share']}; step 1 launches by rank {dict(zip(names, zip(*dp['step_launches'])))}"
          f"; the cut recipe ({DP_EPOCHS}): launches by rank "
          f"{dict(zip(names, zip(*dp['run_launches'])))}, s1 ms a step by rank "
          f"{[round(x, 3) for x in dp['s1_ms']]}, s2 {[round(x, 3) for x in dp['s2_ms']]}; "
          f"gradient all-reduce of {dp['values']} float32 values (gloo, CUDA tensors through "
          f"the host): {[round(x, 3) for x in dp['all_reduce_ms']]} ms by rank (median of 20); "
          f"bootstrap epochs {st['bootstrap_epochs']}, swap at {st['swap_epoch']}", flush=True)
    check_step("[dp]", dp["step"])
    want_step = {"K1": 1, "K2": 1, "K3a": 1, "K3b": 1, "K4": 0}
    n_s1, boot = st["s1_steps"], st["bootstrap_epochs"] * RECIPE["batches_per_epoch"]
    for r in range(2):
        got = dict(zip(names, dp["step_launches"][r]))
        if {k: got[k] for k in want_step} != want_step:
            raise AssertionError(f"[dp] rank {r}'s step launched {got}: K1, K2, K3a, K3b once")
        got = dict(zip(names, dp["run_launches"][r]))
        want = {"K1": n_s1 + (r == 0), "K2": n_s1, "K3a": n_s1, "K3b": n_s1, "K4": 0,
                "K5": boot + (r == 0)}
        if got != want:
            raise AssertionError(f"[dp] rank {r} launched {got} in the cut recipe, not {want}: "
                                 f"once per s1 step, K1 and K5 once more for rank 0's figure, "
                                 f"K5 once per bootstrap step")
    if not (dp["params_equal"] and dp["best_equal"] and dp["finite"]):
        raise AssertionError(f"[dp] params equal {dp['params_equal']}, best params equal "
                             f"{dp['best_equal']}, finite {dp['finite']}")
    logs = losses_table(os.path.join(tmp, "runs", "torus_dp", "losses.csv"))
    if len(logs["total"]) != DP_EPOCHS["num_epochs"] or not np.isfinite(logs["total"]).all():
        raise AssertionError("[dp] losses.csv lacks epochs or holds a non-finite total")
    if os.path.exists(cut["rank1_path"]):
        raise AssertionError("[dp] rank 1 wrote files")
    check_figure(os.path.join(tmp, "runs", "torus_dp", "reconstructions"), FIGURE_WIDTH, "[dp]")

    t0 = time.perf_counter()
    fb = mesh.run_group(dp_fallback_rank, 4, (run["cfg_path"],), devices=["cuda:0"] * 4)
    print(f"[dp] 4 ranks on cuda:0 ({time.perf_counter() - t0:.2f} s with the start): step "
          f"{fb['dp']}, the RuntimeWarning on every rank {fb['warned']}; rows, surface rows by "
          f"rank {fb['rows']}; launches by rank {dict(zip(names, zip(*fb['launches'])))}")
    check_step("[dp] fallback:", fb["step"])
    if fb["dp"] != "constrained" or not fb["warned"]:
        raise AssertionError("[dp] 4 ranks did not take the warned fallback step")

    store = os.path.join(tmp, "nccl_store")
    g = mesh.init_group(0, 1, "cuda:0", "nccl", store_path=store)
    try:
        t = torch.arange(4.0, device="cuda")
        same = bool((g.all_reduce_sum(t) == t).all())
    finally:
        mesh.close_group()
    print(f"[dp] a one-rank NCCL group: backend {g.backend}, all-reduce of 4 values returns "
          f"them {same}")
    if not (g.backend == "nccl" and same):
        raise AssertionError("[dp] the one-rank NCCL group failed")
    return {"launches": dp["run_launches"], "step_launches": dp["step_launches"],
            "step": dp["step"], "s1_ms": dp["s1_ms"], "s2_ms": dp["s2_ms"],
            "all_reduce_ms": dp["all_reduce_ms"], "fallback": fb}


SHARDED_PATHS = ("generate_mc_sharded", "generate_st_sharded", "generate_pc_sharded")


def serving_rank(group, a):
    """Phase 18 on one of 2 ranks: the three sharded serving paths through
    their CLI functions, this rank's launches by path; -> rank 0's record."""
    from diffudf_tpu_torch.cli import generate_mc, generate_pc, generate_st

    float32_only()
    fields, extract = [], generate_mc.extract_fields_sparse

    def recording(*args, **kw):
        fields.append(extract(*args, **kw))
        return fields[-1]

    out, launches = {}, {}
    fns = dict(zip(SHARDED_PATHS, (generate_mc.generate_mc, generate_st.generate_st,
                                   generate_pc.generate_pc)))
    generate_mc.extract_fields_sparse = recording
    try:
        for path, fn, cfg in ((p, fns[p], a[p]) for p in SHARDED_PATHS):
            zero_counts()
            stats = {}
            t0 = time.perf_counter()
            result = fn(cfg, group.device, stats, group=group)
            sync(group.device)
            secs = time.perf_counter() - t0
            launches[path] = group.per_rank(list(read_counts().values())).astype(int).tolist()
            out[path] = {"result": result, "stats": stats,
                         "seconds": group.per_rank([secs])[:, 0].tolist()}
    finally:
        generate_mc.extract_fields_sparse = extract
    out["fields"], out["launches"] = fields[0], launches
    return out


@phase("sharded serving")
def sharded_serving_phase(tmp, sphere_path, run, render, pc):
    """generate_mc (shard_grid), generate_st (shard_rays) and generate_pc
    (shard_points) on 2 ranks of cuda:0, against phases 5, 9 and 15."""
    from diffudf_tpu_torch.fields.siren import SirenSpec
    from diffudf_tpu_torch.grid.lattice import extract_fields_sparse
    from diffudf_tpu_torch.parallel import mesh
    from diffudf_tpu_torch.train.checkpoint import load_params

    names = list(read_counts())
    with open(PC_CONFIG) as fh:
        pc_cfg = json.load(fh)
    pc_cfg.update(alpha=RECIPE["alpha"], shard_points=True,
                  output_path=os.path.join(tmp, "torus_generated_sharded.ply"),
                  model_path=os.path.join(tmp, "runs", "torus", "models", "model_best.npz"))
    st_cfg = render_config(tmp, render["model_path"], shard_rays=True)
    mc_cfg = {"alpha": ALPHA, "gt_mode": "tanh", "hidden_layer_nodes": list(HIDDEN), "w0": 30,
              "model_path": sphere_path, "output_path": os.path.join(tmp, "sphere_sharded.ply"),
              "algorithm": "both", "nsamples": N_GRID, "shard_grid": True}
    t0 = time.perf_counter()
    out = mesh.run_group(serving_rank, 2, (dict(zip(SHARDED_PATHS, (mc_cfg, st_cfg, pc_cfg))),),
                         devices=["cuda:0"] * 2)
    seconds = {p: out[p]["seconds"] for p in SHARDED_PATHS}
    print(f"[serving] 2 ranks on cuda:0: {time.perf_counter() - t0:.2f} s with the start; "
          f"seconds by path and rank {json.dumps(seconds)}")
    launches = {path: {k: list(v) for k, v in zip(names, zip(*by_rank))}
                for path, by_rank in out["launches"].items()}
    print(f"[serving] launches by path and rank: {json.dumps(launches)}", flush=True)

    # generate_mc: the gathered fields against phase 5's grid pass
    spec = SirenSpec(hidden=HIDDEN)
    udf, dirs = out["fields"]
    udf1, dirs1 = extract_fields_sparse(load_params(sphere_path, device="cuda"), spec, N_GRID,
                                        "tanh", ALPHA)
    bg = udf1[0, 0, 0]  # the background: the corner's block is far from the sphere
    band, band1 = udf != bg, udf1 != bg
    has, has1 = np.abs(dirs).sum(-1) > 0, np.abs(dirs1).sum(-1) > 0
    both_u, both_d = band & band1, has & has1
    udf_worst = float((np.abs(udf - udf1) / (TOL["f"] + RTOL * np.abs(udf1)))[both_u].max())
    dirs_worst = float((np.abs(dirs - dirs1).max(-1) / (TOL["g"] + RTOL))[both_d].max())
    moved = {"band": int((band != band1).sum()), "dirs": int((has != has1).sum())}
    print(f"[serving] generate_mc N={N_GRID}: udf on {int(both_u.sum())} band points worst "
          f"|delta| / ({TOL['f']} + {RTOL} |udf|) {udf_worst:.3f}, max |delta| "
          f"{float(np.abs(udf - udf1)[both_u].max()):.3e}; dirs on {int(both_d.sum())} points "
          f"worst |delta| / {TOL['g'] + RTOL} {dirs_worst:.3f}; points in one band only {moved}")
    if not (udf_worst <= 1 and dirs_worst <= 1
            and max(moved.values()) <= 1e-4 * int(both_d.sum())):
        raise AssertionError(f"[serving] the sharded grid pass differs from phase 5's: udf "
                             f"{udf_worst}, dirs {dirs_worst} of the limit, {moved}")
    mc_chamfer = sphere_chamfer(out["generate_mc_sharded"]["result"], "[serving]")
    for r in range(2):
        if launches["generate_mc_sharded"]["K1"][r] != 1:
            raise AssertionError(f"[serving] rank {r} launched K1 "
                                 f"{launches['generate_mc_sharded']['K1'][r]} times in the grid")

    # generate_st: hit pixels against phase 9's render
    img = out["generate_st_sharded"]["result"]
    passes = out["generate_st_sharded"]["stats"]["passes"]
    hs, h9 = hit_pixels(img), hit_pixels(render["img"])
    flips = int((hs != h9).sum())
    rc = st_cfg["rendering_config"]
    print(f"[serving] generate_st {rc['width']}x{rc['height']}, {len(passes)} passes: {flips} hit "
          f"pixels differ from "
          f"phase 9's of {int(h9.sum())} (bound {MAX_HIT_FLIPS:.0%}); iterations by pass "
          f"{[p['iterations'] for p in passes]} (phase 9: "
          f"{[p['iterations'] for p in render['passes']]})")
    if flips > MAX_HIT_FLIPS * h9.sum() or not h9.sum():
        raise AssertionError(f"[serving] {flips} of {int(h9.sum())} hit pixels differ")
    k4, k1 = launches["generate_st_sharded"]["K4"], launches["generate_st_sharded"]["K1"]
    if min(k4) < len(passes) or k1 != [len(passes), 0]:
        raise AssertionError(f"[serving] generate_st launches K4 {k4}, K1 {k1}: K4 on every "
                             f"rank every pass, K1 once a pass on rank 0")

    # generate_pc: phase 15's gates, and the cloud against phase 15's
    cloud = out["generate_pc_sharded"]["result"]
    pts, nrm = np.asarray(cloud.points), np.asarray(cloud.normals)
    rounds = out["generate_pc_sharded"]["stats"]["rounds"]
    field_err, normal_cos, oriented, chamfer = cloud_against_mesh(pts, nrm, run, "[serving]")
    delta = (float(np.abs(pts - pc["cloud"]).max()) if pts.shape == pc["cloud"].shape
             else f"shapes {pts.shape} and {pc['cloud'].shape}")
    print(f"[serving] generate_pc: {len(pts)} points in {rounds} rounds; max |delta| against "
          f"phase 15's cloud {delta} (bound PROJ_TOL {PROJ_TOL})")
    if isinstance(delta, str) or not delta <= PROJ_TOL:
        raise AssertionError(f"[serving] the sharded cloud differs from phase 15's: {delta}")
    want = {"K1": [rounds] * 2, "K3a": [(pc_cfg["ref_steps"] - 1) * rounds] * 2}
    got = {k: launches["generate_pc_sharded"][k] for k in want}
    if got != want:
        raise AssertionError(f"[serving] generate_pc launches {got} != {want} on each rank")
    return {"launches": launches, "mc_chamfer": mc_chamfer, "udf_worst": udf_worst,
            "dirs_worst": dirs_worst, "hit_flips": flips, "pc_field_error": field_err,
            "pc_normal_cos": normal_cos, "pc_delta": delta, "seconds": seconds}


KERNELS = {
    "K1": ("vgh", "diffudf_tpu_torch/csrc/vgh.cu", "diffudf_tpu/ops/pallas_vgh.py:55 (_vgh_kernel)"),
    "K2": ("vgh_bwd", "diffudf_tpu_torch/csrc/vgh_bwd.cu",
           "diffudf_tpu/ops/pallas_vgh_vjp.py:45 (_vgh_bwd_kernel)"),
    "K3a": ("vg", "diffudf_tpu_torch/csrc/vg.cu", "diffudf_tpu/ops/pallas_vg.py:25 (_vg_fwd_kernel)"),
    "K3b": ("vg_bwd", "diffudf_tpu_torch/csrc/vg.cu",
            "diffudf_tpu/ops/pallas_vg.py:93 (_vg_bwd_kernel)"),
    "K4": ("value", "diffudf_tpu_torch/csrc/value.cu",
           "diffudf_tpu/ops/pallas_value.py:22 (_value_kernel)"),
    "K5": ("min_distance", "diffudf_tpu_torch/csrc/min_distance.cu",
           "diffudf_tpu/ops/pallas_distance.py:28 (_min_dist_kernel)"),
}


def dp_by_path(dp, key):
    """Phase 17's launches of one kernel, by rank: the cut recipe on 2 ranks
    (``train_dp``) and the fallback step on 4 (``train_dp_fallback_step``)."""
    names = list(read_counts())
    i = names.index(key)
    return {"train_dp": [r[i] for r in dp["launches"]],
            "train_dp_fallback_step": [r[i] for r in dp["fallback"]["launches"]]}


def main():
    t_start = time.perf_counter()
    device_phase()
    build_phase()
    kernel_phase()
    with tempfile.TemporaryDirectory() as tmp:
        model_path = fixture_phase(tmp)
        stats, k1_mc_launches, _ = slice_phase(tmp, model_path)
        t = timing_phase(model_path, stats["dirs_points"])
        run = train_phase(tmp)
        tk = train_kernel_phase(run["params"], run["cfg_path"])
        render = render_phase(tmp)
        rk = render_kernel_phase(render["cfg"], render["model_path"], render["passes"][0])
        figs = figures_phase(tmp, run["data_dir"])
        dk = distance_kernel_phase(run["data_dir"], run["params"])
        mesh_run = mesh_train_phase(tmp, run)
        gt = gt_render_phase(tmp, mesh_run["data_dir"])
        pc = point_cloud_phase(tmp, run)
        enh = enhanced_phase(tmp, run, stats)
        dp = dp_train_phase(tmp, run)
        serving = sharded_serving_phase(tmp, model_path, run, render, pc)
    sharded = serving["launches"]
    rows = []
    for key, (name, source, replaces) in KERNELS.items():
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces}
        if key == "K1":
            # K1 runs on every path: its numbers are those at the extraction
            # shape (phase 6), bound_ms its FP32 FMA bound; phase 8's
            # are at the training shape and phase 12's at the figure's
            row.update(launches=run["launches"]["K1"],
                       launches_by_path={"generate_mc": k1_mc_launches,
                                         "train": run["launches"]["K1"],
                                         "generate_st": render["launches"]["K1"],
                                         "generate_df": figs["torus_pc.ply"]["launches"]["K1"],
                                         "train_mesh": mesh_run["launches"]["K1"],
                                         "generate_pc": pc["launches"]["K1"],
                                         "generate_mc_enhanced": enh["launches"]["K1"],
                                         **dp_by_path(dp, "K1"),
                                         **{p: v["K1"] for p, v in sharded.items()}},
                       max_abs_err=max(t["max_err"].values()), max_err=t["max_err"],
                       **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "tensor_bound_ms", "fp32_bound_ms", "bytes_moved",
                                            "bound_share")},
                       train_shape=tk["K1"],
                       figure_shape=dk["k1_figure"], pc_shape=pc["times"]["K1"])
        elif key == "K4":
            # the render's march runs the bf16 mode (fast_march); the f32
            # mode's numbers come beside them
            row.update(launches=render["launches"]["K4"], mode="bf16",
                       launches_by_path={"generate_st": render["launches"]["K4"],
                                         "generate_st_sharded":
                                             sharded["generate_st_sharded"]["K4"]},
                       **{k: rk["bf16"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                     "bound_by", "points", "buckets")},
                       f32=rk["f32"], march_share=rk["march_share"])
        elif key == "K5":
            # no single PyTorch call computes it: torch.cdist + amin (two
            # calls, over query chunks) is timed beside it
            row.update(launches=run["launches"]["K5"],
                       launches_by_path={"train": run["launches"]["K5"],
                                         "generate_df": figs["torus_pc.ply"]["launches"]["K5"],
                                         "train_mesh": mesh_run["launches"]["K5"],
                                         **dp_by_path(dp, "K5")},
                       **{k: dk[k] for k in ("max_abs_err", "witness_max_err",
                                             "expanded_form_max_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by", "issue_floor_ms", "queries",
                                             "cloud")},
                       cdist_amin_chunked_ms=dk["cdist_ms"])
        else:
            # phase 8's numbers; bound_ms is the 3xTF32 tensor bound, with
            # the FP32 FMA bound and the design's bytes
            row["launches"] = run["launches"][key]
            row["launches_by_path"] = {"train": run["launches"][key],
                                       "train_mesh": mesh_run["launches"][key],
                                       **dp_by_path(dp, key)}
            row.update(tk[key])
            if key == "K3a":
                row["launches_by_path"].update(
                    generate_pc=pc["launches"]["K3a"],
                    generate_mc_enhanced=enh["launches"]["K3a"],
                    generate_pc_sharded=sharded["generate_pc_sharded"]["K3a"])
                row["pc_shape"] = pc["times"]["K3a"]
        row["library_ms"] = None
        rows.append(row)
    print(f"[total] {time.perf_counter() - t_start:.2f} s; data-parallel training and the "
          f"sharded serving paths: {json.dumps({k: v for k, v in dp.items() if k != 'fallback'})}"
          f", {json.dumps({k: v for k, v in serving.items() if k != 'launches'})}")
    print(f"[total] the mesh-mode training and the GT "
          f"render: {json.dumps({k: v for k, v in mesh_run.items() if k != 'data_dir'})}, "
          f"{json.dumps(gt)}; the point cloud and the enhanced extraction: "
          f"{json.dumps({k: v for k, v in pc.items() if k not in ('times', 'cloud')})}, "
          f"{json.dumps(enh)}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
