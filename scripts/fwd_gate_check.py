#!/usr/bin/env python
"""Where K1's element gate of ``chip_smoke.py`` phase 6 stands, on one GPU:

    python scripts/fwd_gate_check.py [--parent DIR] [--variants]

Fits phase 4's sphere fixture (the same seed, so the same net) and takes
phase 6's input (711,714 points uniform in the cube, seed 3).  Then, for
each of f, g and h6, it holds against the float32 plain version, element
by element with phase 6's limit TOL + RTOL * |plain|, and against the
float64 plain version:

  kernel   K1 of this tree;
  parent   K1 built from DIR's ``diffudf_tpu_torch/csrc`` (``--parent``);
  ideal    a float32 forward whose every product is the float64 product of
           the float32 operands rounded once to float32 (the activations
           and the head as the plain version's): what a float32 kernel
           with correctly rounded products would give;
  plain    the float32 plain version itself against float64.

For each it prints the worst err/limit, the count of elements over the
limit, the worst of its distance from float64 over the same limit taken
at the float64 value, the largest and RMS distance from float64, and for
the worst element its |plain|, limit and the distances of the kernel and
the plain version from float64.  ``--variants`` also builds K1 from
patched copies of this tree's sources:

  contracted    built with nvcc's FMA contraction, as K2-K5 are;
  first_sum     built without it, the first layer's z written as
                x0 w0 + x1 w1 + x2 w2 + b (as before this design);
  both          both: the first build of this design;
  tf32x3        on the tensor-core product of K3a, 3xTF32 mma.sync
                promoted into float32 every two k-steps, built as "both"
                (the design that phase 6 refused);
  promote1      the same, each k-step's tensor-core sum added into float32
                registers;
  lolo          the same, the fourth TF32 product lo*lo added to the three.

Last, it times each K1 built here against this tree's, in turns (this,
other, other, this: medians of 20 CUDA-event-timed launches each).
"""

import argparse
import concurrent.futures
import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from fwd_kernel_check import new_forward, old_forward  # noqa: E402
from kernel_check_util import build, cuda_ms  # noqa: E402
from diffudf_tpu_torch.fields.siren import SirenSpec  # noqa: E402
from diffudf_tpu_torch.ops import kernel_io as kio  # noqa: E402
from diffudf_tpu_torch.ops import vgh  # noqa: E402
from diffudf_tpu_torch.train.checkpoint import load_params  # noqa: E402

N_POINTS = 711714  # phase 5's K1 points on the fixture (stage 3 of generate_mc)
COLS = {"f": (0, 1), "g": (1, 4), "h6": (4, 10)}


PROMOTE = """        mma3x4(tmp, ah, al, bh[ks], bl[ks], ks == 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[(mt * 4 + u) * 4 + c] += tmp[u][c];
      }
"""
LO_HI = """#pragma unroll
  for (int u = 0; u < 4; ++u) mma_tf32(d[u], al, bh[u][0], bh[u][1], first);
"""
K1_TF32X3 = ("Product::kFp32>(", "Product::kTf32x3>(")
FIRST_SUM = ("fmaf(xs[3 * t + 2], wc, fmaf(xs[3 * t + 1], wb, xs[3 * t] * wa)) + bj",
             "xs[3 * t] * wa + xs[3 * t + 1] * wb + xs[3 * t + 2] * wc + bj")
PROMOTE1 = (PROMOTE, """        mma3x4(tmp, ah, al, bh[ks], bl[ks], true);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[(mt * 4 + u) * 4 + c] += tmp[u][c];
        }
      }
""")
LOLO = (LO_HI, """#pragma unroll
  for (int u = 0; u < 4; ++u) mma_tf32(d[u], al, bl[u][0], bl[u][1], first);
#pragma unroll
  for (int u = 0; u < 4; ++u) mma_tf32(d[u], al, bh[u][0], bh[u][1], false);
""")
# name: (patches, built with FMA contraction, tensor-core product)
VARIANTS = {
    "contracted": ((), True, False),
    "first_sum": ((FIRST_SUM,), False, False),
    "both": ((FIRST_SUM,), True, False),
    "tf32x3": ((K1_TF32X3, FIRST_SUM), True, True),
    "promote1": ((K1_TF32X3, FIRST_SUM, PROMOTE1), True, True),
    "lolo": ((K1_TF32X3, FIRST_SUM, LOLO), True, True),
}


def chunked(fn, x, chunk=131072):
    return torch.cat([fn(c) for c in x.split(chunk)])


def as_rows(outs):
    return torch.cat([t.reshape(t.shape[0], -1) for t in outs], 1)


def rounded_product(a, w):
    """a @ w as the float64 product of the float32 operands rounded once."""
    return (a.double() @ w.double()).float()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fwd_gate_check: needs a CUDA device")
    chip_smoke.device_phase()
    spec = SirenSpec(hidden=chip_smoke.HIDDEN)
    with tempfile.TemporaryDirectory() as tmp:
        params = load_params(chip_smoke.fixture_phase(tmp), device="cuda")
    p64 = [{k: v.double() for k, v in layer.items()} for layer in params]
    x = torch.as_tensor(
        np.random.default_rng(3).uniform(-1, 1, (N_POINTS, 3)).astype(np.float32), device="cuda")
    plain = chunked(lambda c: as_rows(vgh.vgh_reference(params, spec, c)), x)
    exact = chunked(lambda c: as_rows(vgh.vgh_reference(p64, spec, c.double())), x)
    runs = {"kernel": as_rows(vgh.vgh(params, spec, x))[:, :10]}
    builds = {}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:  # one nvcc a copy
        if args.parent:
            parent = pool.submit(build, "gate_parent",
                                 os.path.join(args.parent, "diffudf_tpu_torch", "csrc"), "vgh.cu",
                                 cmd=kio.nvcc_command())
        variants = {name: (pool.submit(build, f"gate_{name}", kio.CSRC, "vgh.cu", patches,
                                       kio.nvcc_command() if contract else None), tf32)
                    for name, (patches, contract, tf32) in VARIANTS.items() if args.variants}
        if args.parent:
            builds["parent"] = old_forward(parent.result()[0].vgh_launch, 16)
        for name, (lib, tf32) in variants.items():
            builds[name] = new_forward(lib.result()[0].vgh_launch, 8, 16, tf32)
    for name, fn in builds.items():
        runs[name] = fn(params, spec, x)[:, :10]
    runs["ideal"] = chunked(
        lambda c: as_rows(vgh.vgh_reference(params, spec, c, product=rounded_product)), x)
    runs["plain"] = plain
    torch.cuda.synchronize()
    for k, (a, b) in COLS.items():
        p, e = plain[:, a:b], exact[:, a:b]
        limit = chip_smoke.TOL[k] + chip_smoke.RTOL * p.abs()
        e_p = (p.double() - e).abs()
        for name, got in runs.items():
            g = got[:, a:b]
            ratio = ((g.double() - e).abs() if name == "plain" else (g - p).abs()) / limit
            e_k = (g.double() - e).abs()
            ratio64 = e_k / (chip_smoke.TOL[k] + chip_smoke.RTOL * e.abs())
            i = int(ratio.argmax())
            print(f"{k} {name}: worst err/limit {float(ratio.max()):.3f} "
                  f"({'vs float64' if name == 'plain' else 'vs plain'}), over the limit "
                  f"{int((ratio > 1).sum())}; worst |{name} - float64| / (TOL + RTOL |float64|) "
                  f"{float(ratio64.max()):.3f}; vs float64 max {float(e_k.max()):.3e} RMS "
                  f"{float(e_k.square().mean().sqrt()):.3e}; worst element |plain| "
                  f"{float(p.flatten()[i].abs()):.3e} limit {float(limit.flatten()[i]):.3e}, "
                  f"vs float64 {name} {float(e_k.flatten()[i]):.3e} plain "
                  f"{float(e_p.flatten()[i]):.3e}", flush=True)
    del plain, exact, runs
    for name, fn in builds.items():
        times = [cuda_ms(lambda f=f: f(params, spec, x), 20)
                 for f in (vgh.vgh, fn, fn, vgh.vgh)]
        print(f"K1 at {N_POINTS} points, this / {name} / {name} / this: "
              + " / ".join(f"{t:.3f}" for t in times) + " ms (medians of 20)", flush=True)


if __name__ == "__main__":
    main()
