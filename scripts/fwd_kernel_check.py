#!/usr/bin/env python
"""K1 and K3a (``diffudf_tpu_torch/csrc/siren_fwd.cuh``) on one GPU, on a
random-init 8x256 SIREN with x uniform in the cube:

    python scripts/fwd_kernel_check.py [--parent DIR] [--ablate]

Builds both libraries and prints their ptxas reports; then, for K1 at the
s1 step's 9,990 rows, the slice figure's 262,144 and the N=256 extraction's
711,714, and for K3a at the s1 step's 19,980: the largest difference from
the plain torch version, the kernel's and the float32 plain version's
distance from the float64 plain version (max and RMS of each output, as
``chip_smoke.py``'s WITNESS gate compares them), the median of 20
CUDA-event-timed launches and the device time of each of the launch's
kernels (``torch.profiler``, mean of 5 launches).

``--parent DIR``: DIR holds another commit's ``diffudf_tpu_torch/csrc``
(for example a ``git archive`` of the parent).  Its K1, K3a, K2 and K3b are
built too and timed against this tree's in turns (parent, this, this,
parent: medians of 20 each), K1 and K3a at the shapes above and K2 and K3b
at the training shapes, and the K2 and K3b gradients of the two trees are
compared bit for bit.

``--ablate``: K1 and K3a built from patched copies of the sources: "no
products" (K1's fma_product and K3a's tile_product skip their k loops: what
the elementwise layers, the staging, the head and the barriers cost), K3a
"no promotion" (the tensor cores' float32 sums carry the whole of K) and K1
"3xTF32" (K1 on K3a's tensor-core product, the design that phase 6's h6
element gate refused).  The "no products" copies give no right result.

Copies are built into the port's ignored build directory.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kernel_check_util import build, cuda_ms, kernel_times, ptxas_report  # noqa: E402
from diffudf_tpu_torch.fields.siren import (  # noqa: E402
    SirenSpec, flatten_params, init_siren, params_from_jax)
from diffudf_tpu_torch.ops import kernel_io as kio  # noqa: E402
from diffudf_tpu_torch.ops import vg, vgh  # noqa: E402

HIDDEN = (256,) * 8
# the argument list of the forward launchers before the tile design
OLD_FWD_ARGTYPES = [kio._P, ctypes.c_int, kio._P, kio._P, kio._P, kio._P, ctypes.c_int, kio._P,
                    kio._P, ctypes.c_float, ctypes.c_float, ctypes.c_int, kio._P, kio._P]

# tile_product's two-k-step partial, then added into acc
TMP = ("      float tmp[4][4];\n#pragma unroll\n      for (int ks = 0; ks < 2; ++ks) {\n"
       "        uint32_t ah[4], al[4];")
NO_PROMOTION = (
    (TMP, TMP.replace("float tmp[4][4];", "float tmp[4][4];\n      for (int u = 0; u < 4; ++u) "
                      "for (int c = 0; c < 4; ++c) tmp[u][c] = acc[(mt * 4 + u) * 4 + c];")),
    ("mma3x4(tmp, ah, al, bh[ks], bl[ks], ks == 0);", "mma3x4(tmp, ah, al, bh[ks], bl[ks], false);"),
    ("acc[(mt * 4 + u) * 4 + c] += tmp[u][c];", "acc[(mt * 4 + u) * 4 + c] = tmp[u][c];"),
)
NO_PRODUCTS = (("  for (int p = 0; p < kp; ++p) {\n", "  for (int p = 0; p < 0 * kp; ++p) {\n"),)
# fma_product's chunk loop, and K1's product
FMA_NO_PRODUCTS = (("  for (int c = 0; c < n_chunks; ++c) {\n",
                    "  for (int c = 0; c < 0 * n_chunks; ++c) {\n"),)
K1_TF32X3 = (("Product::kFp32>(", "Product::kTf32x3>("),)


def new_forward(fn, tile, cols, tf32):
    fn.argtypes, fn.restype = kio.FWD_ARGTYPES, ctypes.c_int

    def run(params, spec, x):
        out = torch.empty((x.shape[0], cols), device=x.device, dtype=torch.float32)
        kio.launch_forward(fn, tile, tf32, params, spec, x, out)
        return out
    return run


def old_forward(fn, cols):
    fn.argtypes, fn.restype = OLD_FWD_ARGTYPES, ctypes.c_int

    def run(params, spec, x):
        out = torch.empty((x.shape[0], cols), device=x.device, dtype=torch.float32)
        w1, b1, wh, bh, wl, bl = kio.weights(params, x.device)
        w0, ww = kio.freqs(spec)
        rc = fn(x.data_ptr(), x.shape[0], w1.data_ptr(), b1.data_ptr(), wh.data_ptr(),
                bh.data_ptr(), len(params) - 2, wl.data_ptr(), bl.data_ptr(), float(w0), float(ww),
                spec.hidden[0], out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out
    return run


def plain_outputs(plain, params, spec, x, chunk=131072):
    """The plain version's outputs as one (N, R) tensor, over chunks."""
    parts = [torch.cat([t.reshape(len(c), -1) for t in plain(params, spec, c)], 1)
             for c in x.split(chunk)]
    return torch.cat(parts)


def witness(name, got, want, exact, cols):
    """Print each output's distance from float64: kernel / plain."""
    line = []
    for k, (a, b) in cols.items():
        e_k = (got[:, a:b].double() - exact[:, a:b]).abs()
        e_p = (want[:, a:b].double() - exact[:, a:b]).abs()
        mx = float(e_k.max() / e_p.max())
        rms = float(e_k.square().mean().sqrt() / e_p.square().mean().sqrt())
        line.append(f"{k} max {float(e_k.max()):.3e} / {float(e_p.max()):.3e} ({mx:.2f}), "
                    f"RMS ratio {rms:.2f}")
    print(f"  {name} vs float64, kernel / plain: " + "; ".join(line), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a directory holding another commit's csrc")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fwd_kernel_check: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = SirenSpec(hidden=HIDDEN)
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cuda")
    p64 = [{k: v.double() for k, v in layer.items()} for layer in params]
    rng = np.random.default_rng(1)
    cols = {"K1": {"f": (0, 1), "g": (1, 4), "h6": (4, 10)}, "K3a": {"f": (0, 1), "g": (1, 4)}}
    plain = {"K1": vgh.vgh_reference, "K3a": vg.vg_reference}
    for name, lib in (("K1", vgh.build()), ("K3a", vg.build())):
        print(f"{name} build:")
        ptxas_report(lib)
    kernels = {"K1": new_forward(vgh._lib().vgh_launch, vgh._lib().vgh_tile(), 16, False),
               "K3a": new_forward(vg._lib().vg_launch, vg._lib().vg_tile(), 8, True)}
    xs = {}
    for name, n in (("K1", 9990), ("K1", 262144), ("K1", 711714), ("K3a", 19980)):
        x = xs[name, n] = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32,
                                          device="cuda")
        run = kernels[name]
        got = run(params, spec, x)
        torch.cuda.synchronize()
        want = plain_outputs(plain[name], params, spec, x)
        exact = plain_outputs(plain[name], p64, spec, x.double())
        r = cols[name]["h6" if name == "K1" else "g"][1]
        print(f"{name} at {n} points: max |kernel - plain| "
              f"{float((got[:, :r] - want).abs().max()):.3e}; zero columns "
              f"{bool((got[:, r:] == 0).all())}")
        witness(name, got, want, exact, cols[name])
        del want, exact
        launch = lambda: run(params, spec, x)  # noqa: E731
        print(f"  {cuda_ms(launch, 20):.3f} ms (median of 20); device us a launch: "
              + ", ".join(f"{k} {v:.1f}" for k, v in kernel_times(launch).items()), flush=True)

    if args.ablate:
        for name, tag, patches, tf32 in (("K1", "no products", FMA_NO_PRODUCTS, False),
                                         ("K1", "3xTF32", K1_TF32X3, True),
                                         ("K3a", "no products", NO_PRODUCTS, True),
                                         ("K3a", "no promotion", NO_PROMOTION, True)):
            main_src, c = ("vgh.cu", 16) if name == "K1" else ("vg.cu", 8)
            # K1 on 3xTF32 as the first round of this design built it: with
            # FMA contraction
            cmd = kio.nvcc_command() if tag == "3xTF32" else None
            lib, path = build(f"{name}_{tag.replace(' ', '_')}", kio.CSRC, main_src, patches, cmd)
            if tag == "3xTF32":
                print("K1 3xTF32 build:")
                ptxas_report(path)
            fn = lib.vgh_launch if name == "K1" else lib.vg_launch
            run = new_forward(fn, 8 if name == "K1" else 16, c, tf32)
            n = 9990 if name == "K1" else 19980
            x = xs[name, n]
            got = run(params, spec, x)
            want = plain_outputs(plain[name], params, spec, x)
            exact = plain_outputs(plain[name], p64, spec, x.double())
            print(f"{name} {tag} at {n} points: {cuda_ms(lambda: run(params, spec, x), 20):.3f} "
                  f"ms (median of 20)")
            witness(f"{name} {tag}", got, want, exact, cols[name])

    if args.parent:
        csrc = os.path.join(args.parent, "diffudf_tpu_torch", "csrc")
        old_vgh, path = build("parent_vgh", csrc, "vgh.cu", cmd=kio.nvcc_command())
        print("parent K1 build:")
        ptxas_report(path)
        old_vg, _ = build("parent_vg", csrc, "vg.cu")
        old_bwd, _ = build("parent_vgh_bwd", csrc, "vgh_bwd.cu")
        pairs = {"K1": (old_forward(old_vgh.vgh_launch, 16), kernels["K1"]),
                 "K3a": (old_forward(old_vg.vg_launch, 8), kernels["K3a"])}
        for (name, n), x in xs.items():
            old, new = pairs[name]
            times = [cuda_ms(lambda f=f: f(params, spec, x), 20) for f in (old, new, new, old)]
            print(f"{name} at {n} points, parent / this / this / parent: "
                  + " / ".join(f"{t:.3f}" for t in times) + " ms (medians of 20)", flush=True)
        old_bwd.vgh_bwd_launch.argtypes = old_vg.vg_bwd_launch.argtypes = kio.BWD_ARGTYPES
        old_bwd.vgh_bwd_launch.restype = old_vg.vg_bwd_launch.restype = ctypes.c_int
        for name, old_fn, new_fn, tile, rows, c, n in (
                ("K2", old_bwd.vgh_bwd_launch, vgh._bwd_lib().vgh_bwd_launch, 8, 10, 16, 9990),
                ("K3b", old_vg.vg_bwd_launch, vg._lib().vg_bwd_launch, 16, 4, 8, 19980)):
            x = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32, device="cuda")
            cot = torch.as_tensor(rng.normal(size=(n, c)), dtype=torch.float32, device="cuda")
            cot[:, rows:] = 0
            old = lambda: kio.launch_backward(old_fn, tile, rows, params, spec, x, cot)  # noqa: E731
            new = lambda: kio.launch_backward(new_fn, tile, rows, params, spec, x, cot)  # noqa: E731
            same = torch.equal(flatten_params(old()), flatten_params(new()))
            times = [cuda_ms(f, 20) for f in (old, new, new, old)]
            print(f"{name} at {n} rows: the two trees' gradients bit-identical {same}; parent / "
                  "this / this / parent: " + " / ".join(f"{t:.3f}" for t in times)
                  + " ms (medians of 20)", flush=True)


if __name__ == "__main__":
    main()
