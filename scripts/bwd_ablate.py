#!/usr/bin/env python
"""Where K2's time and accuracy go: variants of ``csrc/siren_bwd.cuh`` and
``csrc/siren_tile.cuh``, each built from a patched copy of the sources and
run on one GPU at the s1 step's shape (a random-init 8x256 SIREN, 9,990
rows, unit-normal cotangents):

    python scripts/bwd_ablate.py

  as built       the committed kernel;
  no promotion   the tensor cores' float32 sums carry the whole of K (each
                 product's two-k-step partial is not added into separate
                 float32 registers);
  no products    the tile kernel skips its k loop (its other work stays);
  no stores      the tile kernel does not write C and M-bar.

For each it prints the device time of the launch's kernels (torch.profiler,
mean of 5 launches) and the kernel's distance from the float64 plain
version against the float32 plain version's (max and RMS).  Only the
first two give a right gradient.  The copies are built into the port's
ignored build directory.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kernel_check_util import build, kernel_times  # noqa: E402
from diffudf_tpu_torch.fields.siren import (  # noqa: E402
    SirenSpec, flatten_params, init_siren, params_from_jax)
from diffudf_tpu_torch.ops import kernel_io as kio  # noqa: E402
from diffudf_tpu_torch.ops import vgh  # noqa: E402

# the promotion: a two-k-step partial in tmp, then added into acc
TILE_TMP = ("      float tmp[4][4];\n#pragma unroll\n      for (int ks = 0; ks < 2; ++ks) {\n"
            "        uint32_t ah[4], al[4];")
WBAR_TMP = ("        float tmp[4][4];\n#pragma unroll\n        for (int ks = 0; ks < 2; ++ks) {\n"
            "          uint32_t a[4], ah[4], al[4];")
NO_PROMOTION = (
    (TILE_TMP, TILE_TMP.replace("float tmp[4][4];", "float tmp[4][4];\n      for (int u = 0; u < 4; "
                                "++u) for (int c = 0; c < 4; ++c) tmp[u][c] = acc[(mt * 4 + u) * 4 "
                                "+ c];")),
    (WBAR_TMP, WBAR_TMP.replace("float tmp[4][4];", "float tmp[4][4];\n        for (int u = 0; u < "
                                "4; ++u) for (int c = 0; c < 4; ++c) tmp[u][c] = acc[mt][u][c];")),
    ("mma3x4(tmp, ah, al, bh[ks], bl[ks], ks == 0);", "mma3x4(tmp, ah, al, bh[ks], bl[ks], false);"),
    ("acc[(mt * 4 + u) * 4 + c] += tmp[u][c];", "acc[(mt * 4 + u) * 4 + c] = tmp[u][c];"),
    ("acc[mt][u][c] += tmp[u][c];", "acc[mt][u][c] = tmp[u][c];"),
)
NO_PRODUCTS = (("  for (int p = 0; p < kp; ++p) {\n", "  for (int p = 0; p < 0 * kp; ++p) {\n"),)
NO_STORES = (("        buf[kblock_at(base + 16 * i + 8 * (c >> 1) + g, j, h)] = acc[(i * 4 + u) * 4 + c];",
              "        if (acc[(i * 4 + u) * 4 + c] == 1.25e-30f)\n"
              "          buf[kblock_at(base + 16 * i + 8 * (c >> 1) + g, j, h)] = 0.0f;"),)
VARIANTS = {"as built": (), "no promotion": NO_PROMOTION, "no products": NO_PRODUCTS,
            "no stores": NO_STORES}


def launcher(tag, patches):
    """K2's launcher from patched copies of the sources."""
    lib, _ = build(f"ablate_{tag.replace(' ', '_')}", kio.CSRC, "vgh_bwd.cu", patches)
    lib.vgh_bwd_launch.argtypes = kio.BWD_ARGTYPES
    lib.vgh_bwd_launch.restype = ctypes.c_int
    return lib.vgh_bwd_launch


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bwd_ablate: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = SirenSpec(hidden=(256,) * 8)
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cuda")
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(-1, 1, (9990, 3)), dtype=torch.float32, device="cuda")
    cot = torch.as_tensor(rng.normal(size=(9990, 16)), dtype=torch.float32, device="cuda")
    cot[:, 10:] = 0
    want = flatten_params(vgh.vgh_bwd_reference(params, spec, x, cot)).double()
    p64 = [{k: v.double() for k, v in layer.items()} for layer in params]
    exact = flatten_params(vgh.vgh_bwd_reference(p64, spec, x.double(), cot.double()))
    e_p = (want - exact).abs()
    for tag, patches in VARIANTS.items():
        fn = launcher(tag, patches)
        launch = lambda: kio.launch_backward(fn, 8, 10, params, spec, x, cot)  # noqa: E731
        e_k = (flatten_params(launch()).double() - exact).abs()
        times = kernel_times(launch)
        print(f"{tag}: " + ", ".join(f"{k} {v:.1f} us" for k, v in times.items())
              + f"; vs float64, kernel / plain: max {float(e_k.max() / e_p.max()):.2f}, RMS "
              f"{float(e_k.square().mean().sqrt() / e_p.square().mean().sqrt()):.2f}", flush=True)


if __name__ == "__main__":
    main()
