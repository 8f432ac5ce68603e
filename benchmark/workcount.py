"""Frozen work counts of the SIREN kernels and of a training step of each
stage, and the card's peaks: the yardstick the roofline and MFU metrics
divide by.

Work is the math the function needs, whatever implements it.  A forward
pass carries R rows a point (R = 10 for the value, gradient and packed
Hessian; 4 for the value and gradient) through one (h, h) product a hidden
layer, plus the first layer (one row from 3 inputs) and the head (R rows
to one output).  A VJP is two products a layer for each carry row (the
weights' gradient and the carry's cotangent), twice the forward's count.
A recompute of the forward inside a VJP does not count.  Bytes are each
input read once and each output written once.  Adam, the sampler and the
elementwise loss work are left out of the step's count.

The bound of a kernel is the larger of its operations at 165 TFLOP/s,
the 3xTF32 rate (495/3), the fastest at which an H100 forms
float32-accurate products whatever product a kernel runs, and its bytes at
3.35 TB/s (NVIDIA H100 SXM data sheet, dense, at 700 W).
"""

from __future__ import annotations

PEAK_FLOPS = 495e12 / 3  # float32-accurate products: three TF32 passes
PEAK_BYTES_PER_S = 3.35e12
F32 = 4

# carry rows a point, passes (1 forward, 2 VJP), output floats a point,
# whether the kernel reads a cotangent of the output's width and writes the
# weights' gradient
KERNELS = {
    "K1": {"rows": 10, "passes": 1, "out_cols": 16, "vjp": False},
    "K2": {"rows": 10, "passes": 2, "out_cols": 16, "vjp": True},
    "K3a": {"rows": 4, "passes": 1, "out_cols": 8, "vjp": False},
    "K3b": {"rows": 4, "passes": 2, "out_cols": 8, "vjp": True},
}


def param_count(hidden) -> int:
    dims = [3] + list(hidden) + [1]
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def forward_flops(n_points: int, hidden, rows: int) -> float:
    """FLOPs of a forward pass carrying ``rows`` rows a point through a SIREN
    of ``hidden`` widths (all equal)."""
    h, n_mm = hidden[0], len(hidden) - 1
    return float(n_points) * (2 * 3 * h + n_mm * rows * 2 * h * h + rows * 2 * h)


def kernel_flops(name: str, n_points: int, hidden) -> float:
    k = KERNELS[name]
    return k["passes"] * forward_flops(n_points, hidden, k["rows"])


def kernel_bytes(name: str, n_points: int, hidden) -> float:
    k = KERNELS[name]
    weights = F32 * param_count(hidden)
    # a point's x, and its output (forward) or its output's cotangent (VJP);
    # the weights read, and for a VJP their gradient written
    return float(n_points) * F32 * (3 + k["out_cols"]) + weights * (2 if k["vjp"] else 1)


def kernel_bound_s(name: str, n_points: int, hidden) -> float:
    """The least time the card could take for the kernel at ``n_points``."""
    return max(kernel_flops(name, n_points, hidden) / PEAK_FLOPS,
               kernel_bytes(name, n_points, hidden) / PEAK_BYTES_PER_S)


def step_flops(stage: str, n_on: int, n_off: int, hidden) -> float:
    """Model FLOPs of one step.  Stage 1: value, gradient and Hessian with
    their VJP on the surface rows, value and gradient with their VJP on the
    others.  Stage 2: the value with its VJP on the surface rows, the only
    rows its loss reads."""
    if stage == "s2":
        return 3 * forward_flops(n_on, hidden, 1)
    return (kernel_flops("K1", n_on, hidden) + kernel_flops("K2", n_on, hidden)
            + kernel_flops("K3a", n_off, hidden) + kernel_flops("K3b", n_off, hidden))
