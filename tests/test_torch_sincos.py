"""Port parity: shared-range-reduction sin/cos (``diffudf_tpu_torch.ops.sincos``
and its device header ``csrc/sincos.cuh``) against the JAX package's."""

import os.path as osp
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffudf_tpu.ops import sincos as jax_sincos
from diffudf_tpu_torch.ops import sincos as torch_sincos

torch.set_num_threads(2)


def _args():
    rng = np.random.default_rng(0)
    return np.concatenate([rng.uniform(-1, 1, 20000), rng.uniform(-300, 300, 20000),
                           np.arange(-8, 9) * np.pi]).astype(np.float32)


def test_fast_sincos_matches_jax():
    z = _args()
    s1, c1 = torch_sincos.fast_sincos(torch.from_numpy(z))
    s0, c0 = jax_sincos.fast_sincos(jnp.asarray(z))
    np.testing.assert_allclose(s1.numpy(), np.asarray(s0), rtol=0, atol=1e-7)
    np.testing.assert_allclose(c1.numpy(), np.asarray(c0), rtol=0, atol=1e-7)
    np.testing.assert_allclose(torch_sincos.fast_sin(torch.from_numpy(z)).numpy(),
                               np.asarray(jax_sincos.fast_sin(jnp.asarray(z))), rtol=0, atol=1e-7)


@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_fast_sincos_vs_float64(fn):
    z = _args()
    s, c = torch_sincos.fast_sincos(torch.from_numpy(z))
    got = (s if fn == "sin" else c).numpy()
    want = getattr(np, fn)(z.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_device_header_has_the_same_constants():
    """The CUDA header cannot be compiled here; its float constants must be
    those of the torch module (and so of the JAX package)."""
    path = osp.join(osp.dirname(torch_sincos.__file__), "..", "csrc", "sincos.cuh")
    with open(path) as fh:
        src = fh.read()
    body = src[src.index("namespace dudf"):]
    got = [float(v) for v in re.findall(r"(-?\d+\.\d+(?:e[-+]?\d+)?)f", body)]
    want = [torch_sincos._INV_TWO_PI, torch_sincos._TWO_PI_HI, torch_sincos._TWO_PI_MID,
            torch_sincos._TWO_PI_LO]
    want += list(torch_sincos._SIN_COEF[::-1]) + list(torch_sincos._COS_COEF[::-1])
    assert np.array_equal(np.float32(got), np.float32(want))
    assert "rintf(" in src and "roundf(" not in src
