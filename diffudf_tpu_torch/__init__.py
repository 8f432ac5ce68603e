"""diffudf_tpu_torch — the PyTorch/CUDA port of ``diffudf_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package keeps its module layout and
names, so each module here has its counterpart there.  It imports neither
``jax`` nor ``diffudf_tpu``.  The SIREN kernels (the fused f/∇f/H forward
and its VJP, the fused f/∇f forward and its VJP) are CUDA C++ (``csrc/``),
built with ``nvcc`` at first use; the mesh extractors are host numpy with
one native C++ module (``native/``), built with ``g++``.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
