#!/usr/bin/env python
"""K4 (``diffudf_tpu_torch/csrc/value.cu``) and K5 (``csrc/min_distance.cu``)
on one GPU:

    python scripts/march_kernel_check.py [--parent DIR] [--ablate]
        [--k5-variants [NAME ...]] [--k5-rounds N]

Builds both libraries and prints their ptxas reports.  K4, on a random-init
8x256 SIREN with x uniform in the cube: in both modes at the march's
buckets (65,536, 16,384, 4,096 and 1,024 points), the worst error against
the plain version over phase 10's limit of ``chip_smoke.py`` (K4_TOL +
RTOL |plain|), whether the first points of a larger launch (another tile)
give the same bits, the median of 20 CUDA-event-timed launches on weights
laid out once, the tile and the bytes of ``ValuePlan``, and the device time
of each kernel of a launch (``torch.profiler``).  K5: 262,144 plane queries
(``chip_smoke.py``'s figure plane at width 512) against 100,000 points of a
torus cut by that plane, the largest difference from the plain version and
from float64, and its times.

``--parent DIR``: DIR holds another commit's ``diffudf_tpu_torch/csrc`` (a
``git archive`` of the parent) whose ``value.cu`` and ``min_distance.cu``
have the interfaces before the tile design (K4: no tile or grid, W stacked
and cast on each launch; K5: no workspace).  Its K4 and K5 are built and
timed against this tree's in turns (parent, this, this, parent: medians of
20), and its K1 and K3a (``vgh.cu``, ``vg.cu``) are held to this tree's bit
for bit and timed in turns at the s1 step's shapes, and its K2 and K3b
(``vgh_bwd.cu``, ``vg.cu``) held to this tree's bit for bit.

``--ablate``: K4's bf16 mode built from a copy whose bf16_product skips its
k loop ("no products": what the first layer, the staging, the
activations, the head and the barriers cost); it gives no right result.

``--k5-variants [NAME ...]``: K5 built from patched copies (queries a
thread, threads a CTA, points a group, the inner loop's unrolling; and,
for timing alone, the min replaced by an add or the rank cut to two FMAs),
those named or all, each timed in turns with this tree's K5 (N rounds of
variant, this, this, variant; the mean of each side); the SM clock and
power that ``nvidia-smi`` reads during three seconds of K5 launches; and
the SASS opcode counts of K5's scan kernel (``cuobjdump -sass``).

Copies are built into the port's ignored build directory.
"""

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kernel_check_util import build, cuda_ms, kernel_times, ptxas_report  # noqa: E402
from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax  # noqa: E402
from diffudf_tpu_torch.ops import kernel_io as kio  # noqa: E402
from diffudf_tpu_torch.ops import min_distance, value, vg, vgh  # noqa: E402

HIDDEN = (256,) * 8
BUCKETS = (65536, 16384, 4096, 1024)
K4_TOL = {"f32": 1e-5, "bf16": 2e-3}  # chip_smoke.py's phase 10 gate
RTOL = 1e-4
K5_TOL = 1e-4
MODES = {"f32": None, "bf16": torch.bfloat16}
# the parent's value_launch (x, n, w1, b1, wh, bh, n_mm, wl, bl, w0, ww, h,
# mixed, out, stream) and min_distance_launch (q, nq, cloud, m, out, stream)
P = ctypes.c_void_p
OLD_VALUE_ARGTYPES = [P, ctypes.c_int, P, P, P, P, ctypes.c_int, P, P, ctypes.c_float,
                      ctypes.c_float, ctypes.c_int, ctypes.c_int, P, P]
OLD_K5_ARGTYPES = [P, ctypes.c_int64, P, ctypes.c_int64, P, P]
NO_PRODUCTS = (("  for (int p = 0; p < kp; ++p) {\n    cp_async_wait<kBfRing - 1>();",
                "  for (int p = 0; p < 0 * kp; ++p) {\n    cp_async_wait<kBfRing - 1>();"),)
MIN = "gmin[k] = fminf(gmin[k], rank(p, ax[k], ay[k], az[k]));"
RANK = "return __fmaf_rn(ax, c.x, __fmaf_rn(ay, c.y, __fmaf_rn(az, c.z, c.w)));"
K5_VARIANTS = {
    "8 queries a thread, 256 threads a CTA": (
        ("constexpr int kQPT = 4;", "constexpr int kQPT = 8;"),
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")),
    "256 threads a CTA": (("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),),
    "128 threads a CTA": (("constexpr int kThreads = 512;", "constexpr int kThreads = 128;"),),
    "groups of 32": (("constexpr int kGroup = 64;", "constexpr int kGroup = 32;"),),
    "group loop unrolled whole": (("#pragma unroll 16\n", "#pragma unroll\n"),),
    "add for min (timing only)": ((MIN, "gmin[k] = gmin[k] + rank(p, ax[k], ay[k], az[k]);"),),
    "two-FMA rank (timing only)": ((RANK, "return __fmaf_rn(ax, c.x, __fmaf_rn(ay, c.y, c.w));"),),
}


def sass_counts(lib_path, kernel):
    """{opcode: count} of ``kernel``'s SASS in the library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True).stdout
    counts, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if op:
                name = op.group(1).split(".")[0]
                counts[name] = counts.get(name, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def clocks_during(fn, seconds=3.0):
    """Sample nvidia-smi's SM clock, power and temperature while fn() runs
    back to back for ``seconds``; -> the samples' lines."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
                             "temperature.gpu", "--format=csv,noheader", "-lms", "250"],
                            stdout=subprocess.PIPE, text=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        n += 1
        if n % 50 == 0:
            torch.cuda.synchronize()
    end.record()
    end.synchronize()
    proc.terminate()
    out = proc.communicate()[0].strip().splitlines()
    return out, start.elapsed_time(end) / n


def new_value(lib):
    """A launcher of a value.cu with this tree's interface (K4 as built
    from ``lib``), on weights laid out by value.prepare."""
    lib.value_launch.argtypes, lib.value_launch.restype = value._ARGTYPES, ctypes.c_int

    def run(params, spec, x, dt, weights):
        n = x.shape[0]
        out = torch.empty(n, device=x.device, dtype=torch.float32)
        plan = value._plan(spec, n, dt is not None, x.device)
        w0, ww = kio.freqs(spec)
        rc = lib.value_launch(x.data_ptr(), n, weights.w1.data_ptr(), weights.b1.data_ptr(),
                              weights.w.data_ptr(), weights.bh.data_ptr(), plan.n_mm,
                              weights.wl.data_ptr(), weights.bl.data_ptr(), float(w0),
                              float(ww), plan.h, int(dt is not None), plan.tile, plan.grid,
                              out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out
    return run


def old_value(lib):
    """The parent's K4: W stacked and cast to bf16 on every launch."""
    lib.value_launch.argtypes, lib.value_launch.restype = OLD_VALUE_ARGTYPES, ctypes.c_int

    def run(params, spec, x, dt, weights=None):
        n = x.shape[0]
        out = torch.empty(n, device=x.device, dtype=torch.float32)
        w1, b1, wh, bh, wl, bl = kio.weights(params, x.device)
        if dt is not None:
            wh, wl = wh.to(torch.bfloat16), wl.to(torch.bfloat16)
        w0, ww = kio.freqs(spec)
        rc = lib.value_launch(x.data_ptr(), n, w1.data_ptr(), b1.data_ptr(), wh.data_ptr(),
                              bh.data_ptr(), len(params) - 2, wl.data_ptr(), bl.data_ptr(),
                              float(w0), float(ww), spec.hidden[0], int(dt is not None),
                              out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out
    return run


def torus_case(rng, width=512, m=100000, big=0.55, small=0.22):
    r = np.linspace(1.0, -1.0, width)
    zz, yy = np.meshgrid(r, r, indexing="xy")
    q = np.stack([np.zeros_like(zz), yy, zz], -1).reshape(-1, 3)
    u, v = rng.uniform(0, 2 * np.pi, (2, m))
    ring = big + small * np.cos(v)
    cloud = np.stack([small * np.sin(v), ring * np.cos(u), ring * np.sin(u)], 1)
    return (torch.as_tensor(q, dtype=torch.float32, device="cuda"),
            torch.as_tensor(cloud, dtype=torch.float32, device="cuda"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a directory holding another commit's csrc")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--k5-variants", nargs="*", metavar="NAME",
                    help="time K5's variants (those named, or all)")
    ap.add_argument("--k5-rounds", type=int, default=1,
                    help="rounds of variant / this / this / variant")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("march_kernel_check: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, lib in (("K4", value.build()), ("K5", min_distance.build())):
        print(f"{name} build:")
        ptxas_report(lib)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    spec = SirenSpec(hidden=HIDDEN)
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cuda")
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(-1, 1, (BUCKETS[0], 3)), dtype=torch.float32, device="cuda")
    this = new_value(value._lib())
    old = None
    if args.parent:
        csrc = os.path.join(args.parent, "diffudf_tpu_torch", "csrc")
        old_lib, path = build("parent_value", csrc, "value.cu")
        print("parent K4 build:")
        ptxas_report(path)
        old = old_value(old_lib)

    for mode, dt in MODES.items():
        weights = value.prepare(params, spec, compute_dtype=dt)
        full = this(params, spec, x, dt, weights)
        for n in BUCKETS:
            xb = x[:n].contiguous()
            got = this(params, spec, xb, dt, weights)
            torch.cuda.synchronize()
            want = value.value_reference(params, spec, xb, compute_dtype=dt)
            worst = float(((got - want).abs() / (K4_TOL[mode] + RTOL * want.abs())).max())
            plan = kio.value_plan(spec, n, dt is not None, sms)
            launch = lambda: this(params, spec, xb, dt, weights)  # noqa: E731
            ms = cuda_ms(launch, 20)
            print(f"K4 {mode} at {n} points: worst err/limit {worst:.3f}, max |K4 - plain| "
                  f"{float((got - want).abs().max()):.3e}, bits as in the 65,536-point launch "
                  f"{torch.equal(got, full[:n])}; tile {plan.tile}, {plan.grid} CTAs, W from L2 "
                  f"{plan.l2_bytes / 1e6:.1f} MB, device memory {plan.bytes_moved / 1e6:.3f} MB; "
                  f"{ms:.4f} ms (median of 20); device us: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in kernel_times(launch).items()),
                  flush=True)
            if old is not None:
                fns = (lambda: old(params, spec, xb, dt), launch)
                times = [cuda_ms(fns[i], 20) for i in (0, 1, 1, 0)]
                same = float((old(params, spec, xb, dt) - got).abs().max())
                print(f"  parent / this / this / parent: "
                      + " / ".join(f"{t:.4f}" for t in times)
                      + f" ms (medians of 20); max |parent - this| {same:.3e}", flush=True)

    if args.ablate:
        lib, path = build("value_no_products", os.path.join(REPO, "diffudf_tpu_torch", "csrc"),
                         "value.cu", NO_PRODUCTS)
        run = new_value(lib)
        weights = value.prepare(params, spec, compute_dtype=torch.bfloat16)
        for n in BUCKETS:
            xb = x[:n].contiguous()
            print(f"K4 bf16 no products at {n} points: "
                  f"{cuda_ms(lambda: run(params, spec, xb, torch.bfloat16, weights), 20):.4f} ms "
                  "(median of 20)", flush=True)

    q, cloud = torus_case(np.random.default_rng(2))
    got = min_distance.min_distance(q, cloud)
    torch.cuda.synchronize()
    want = min_distance.min_distance_reference(q, cloud)
    exact = min_distance.min_distance_reference(q.double(), cloud.double())
    launch = lambda: min_distance.min_distance(q, cloud)  # noqa: E731
    print(f"K5 at {len(q)} x {len(cloud)}: max |K5 - plain| {float((got - want).abs().max()):.3e}, "
          f"max |K5 - float64| {float((got.double() - exact).abs().max()):.3e} (limit {K5_TOL}); "
          f"bit-reproducible {torch.equal(got, launch())}; {cuda_ms(launch, 20):.4f} ms (median of "
          f"20); device us: " + ", ".join(f"{k} {v:.1f}" for k, v in kernel_times(launch).items()),
          flush=True)
    if args.k5_variants is not None:
        lib_path = min_distance.build()
        print("K5 scan kernel SASS opcodes: " + str(sass_counts(lib_path, "min_distance_kernel")))
        samples, ms = clocks_during(launch)
        print(f"K5 back to back for 3 s: {ms:.4f} ms a launch; nvidia-smi clocks.sm, "
              f"clocks.max.sm, power.draw, temperature: {samples}", flush=True)
        work = torch.empty(min_distance.workspace_floats(len(cloud), 1024), device="cuda")
        for tag, patches in K5_VARIANTS.items():
            if args.k5_variants and tag not in args.k5_variants:
                continue
            lib, path = build("k5_" + re.sub(r"\W+", "_", tag), os.path.join(REPO, "diffudf_tpu_torch",
                                                                         "csrc"),
                             "min_distance.cu", patches)
            fn = lib.min_distance_launch
            fn.argtypes, fn.restype = min_distance._ARGTYPES, ctypes.c_int

            def variant(fn=fn):
                out = torch.empty(len(q), device="cuda", dtype=torch.float32)
                rc = fn(q.data_ptr(), len(q), cloud.data_ptr(), len(cloud), work.data_ptr(),
                        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed with CUDA error {rc}")
                return out
            regs = re.findall(r"Used (\d+) registers", open(path[:-3] + ".log").read())
            same = torch.equal(variant(), got)
            times = [cuda_ms(f, 20) for _ in range(args.k5_rounds)
                     for f in (variant, launch, launch, variant)]
            mean = [float(np.mean(times[i::4] + times[3 - i::4])) for i in (0, 1)]
            print(f"K5 variant '{tag}' ({regs} registers): bits as this tree's {same}; "
                  f"{args.k5_rounds} rounds of variant / this / this / variant: "
                  + " / ".join(f"{t:.4f}" for t in times) + " ms (medians of 20); means: "
                  f"variant {mean[0]:.4f}, this {mean[1]:.4f} ms", flush=True)

    if args.parent:
        old_lib, path = build("parent_min_distance", csrc, "min_distance.cu")
        print("parent K5 build:")
        ptxas_report(path)
        fn = old_lib.min_distance_launch
        fn.argtypes, fn.restype = OLD_K5_ARGTYPES, ctypes.c_int

        def old_k5():
            out = torch.empty(len(q), device="cuda", dtype=torch.float32)
            rc = fn(q.data_ptr(), len(q), cloud.data_ptr(), len(cloud), out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed with CUDA error {rc}")
            return out
        print(f"  the two trees' K5 bit-identical {torch.equal(old_k5(), got)}; parent / this / "
              "this / parent: " + " / ".join(f"{cuda_ms(f, 20):.4f}" for f in
                                             (old_k5, launch, launch, old_k5))
              + " ms (medians of 20)", flush=True)

        # K1 and K3a: the parent's libraries against this tree's, bit for bit
        for name, main_src, mod, tile, cols, tf32, n in (
                ("K1", "vgh.cu", vgh, 8, 16, False, 9990), ("K3a", "vg.cu", vg, 16, 8, True, 19980)):
            old_lib, _ = build(f"parent_{main_src[:-3]}", csrc, main_src)
            fns = []
            for fn in (getattr(old_lib, f"{main_src[:-3]}_launch"),
                       getattr(mod._lib(), f"{main_src[:-3]}_launch")):
                fn.argtypes, fn.restype = kio.FWD_ARGTYPES, ctypes.c_int

                def run(fn=fn, n=n, cols=cols, tile=tile, tf32=tf32):
                    out = torch.empty((n, cols), device="cuda", dtype=torch.float32)
                    kio.launch_forward(fn, tile, tf32, params, spec, x[:n], out)
                    return out
                fns.append(run)
            same = torch.equal(fns[0](), fns[1]())
            times = [cuda_ms(fns[i], 20) for i in (0, 1, 1, 0)]
            print(f"{name} at {n} points: the two trees bit-identical {same}; parent / this / "
                  "this / parent: " + " / ".join(f"{t:.4f}" for t in times)
                  + " ms (medians of 20)", flush=True)

        # K2 and K3b: the two trees' gradients bit for bit
        old_vgh_bwd, _ = build("parent_vgh_bwd", csrc, "vgh_bwd.cu")
        old_vg, _ = build("parent_vg", csrc, "vg.cu")
        for name, old_fn, new_fn, tile, rows, c, n in (
                ("K2", old_vgh_bwd.vgh_bwd_launch, vgh._bwd_lib().vgh_bwd_launch, 8, 10, 16, 9990),
                ("K3b", old_vg.vg_bwd_launch, vg._lib().vg_bwd_launch, 16, 4, 8, 19980)):
            old_fn.argtypes, old_fn.restype = kio.BWD_ARGTYPES, ctypes.c_int
            cot = torch.as_tensor(rng.normal(size=(n, c)), dtype=torch.float32, device="cuda")
            cot[:, rows:] = 0
            grads = [torch.cat([t.reshape(-1) for layer in kio.launch_backward(
                fn, tile, rows, params, spec, x[:n], cot) for t in (layer["w"], layer["b"])])
                for fn in (old_fn, new_fn)]
            print(f"{name} at {n} rows: the two trees' gradients bit-identical "
                  f"{torch.equal(*grads)}", flush=True)


if __name__ == "__main__":
    main()
