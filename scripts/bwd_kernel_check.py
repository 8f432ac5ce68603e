#!/usr/bin/env python
"""K2 and K3b (``diffudf_tpu_torch/csrc/siren_bwd.cuh``) on one GPU, on a
random-init 8x256 SIREN at the s1 step's shapes (9,990 rows for K2, 19,980
for K3b) with unit-normal cotangents:

    python scripts/bwd_kernel_check.py

Builds both libraries and prints each kernel's ptxas report; then, per
kernel, the largest difference from its plain torch version, the kernel's
and the float32 plain version's distance from the float64 plain version
(max and RMS, as ``chip_smoke.py``'s WITNESS gate compares them), the
median of 10 CUDA-event-timed launches, and the device time of each of
the launch's four kernels from ``torch.profiler`` (mean of 5 launches).
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kernel_check_util import cuda_ms, kernel_times, ptxas_report  # noqa: E402
from diffudf_tpu_torch.fields.siren import (  # noqa: E402
    SirenSpec, flatten_params, init_siren, params_from_jax)
from diffudf_tpu_torch.ops import vg, vgh  # noqa: E402

HIDDEN = (256,) * 8
# (name, wrapper, plain version, library builder, rows, cotangent columns, R)
KERNELS = (("K2", vgh.vgh_bwd, vgh.vgh_bwd_reference, vgh.build_bwd, 9990, 16, 10),
           ("K3b", vg.vg_bwd, vg.vg_bwd_reference, vg.build, 19980, 8, 4))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bwd_kernel_check: needs a CUDA device")
    name_limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(name_limit)
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = SirenSpec(hidden=HIDDEN)
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cuda")
    p64 = [{k: v.double() for k, v in layer.items()} for layer in params]
    rng = np.random.default_rng(1)
    for name, fn, plain, build, n, cols, rows in KERNELS:
        print(f"{name} build:")
        ptxas_report(build())
        x = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32, device="cuda")
        cot = torch.as_tensor(rng.normal(size=(n, cols)), dtype=torch.float32, device="cuda")
        cot[:, rows:] = 0
        got = flatten_params(fn(params, spec, x, cot))
        torch.cuda.synchronize()
        want = flatten_params(plain(params, spec, x, cot))
        exact = flatten_params(plain(p64, spec, x.double(), cot.double()))
        e_k, e_p = (got.double() - exact).abs(), (want.double() - exact).abs()
        rms = (float(e_k.square().mean().sqrt()), float(e_p.square().mean().sqrt()))
        print(f"{name} at {n} rows: max |kernel - plain| {float((got - want).abs().max()):.3e}; "
              f"vs float64, kernel / plain: max {float(e_k.max()):.3e} / {float(e_p.max()):.3e} "
              f"({float(e_k.max() / e_p.max()):.2f}), RMS {rms[0]:.3e} / {rms[1]:.3e} "
              f"({rms[0] / rms[1]:.2f})")
        launch = lambda: fn(params, spec, x, cot)  # noqa: E731
        print(f"{name}: {cuda_ms(launch):.3f} ms (median of 10); device us a launch: "
              + ", ".join(f"{k} {v:.1f}" for k, v in kernel_times(launch).items()))


if __name__ == "__main__":
    main()
