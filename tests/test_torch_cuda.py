"""The port's CUDA kernels against their plain torch versions, on a GPU.

Marked ``cuda``; each test skips without a CUDA device.  This file imports
neither jax nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax
from diffudf_tpu_torch.ops import vgh as tv

# tests/test_pallas.py::TestPallasVGH::test_matches_reference
TOL = {"f": 1e-5, "g": 1e-4, "h6": 5e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,n", [((256,) * 8, 65536), ((64,) * 3, 1001)])
def test_vgh_kernel_matches_plain_version(hidden, n):
    """K1 against vgh_reference on the card, a ragged last tile included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    spec = SirenSpec(hidden=hidden)
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cuda")
    x = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (n, 3)), dtype=torch.float32,
                        device="cuda")
    before = tv.launches
    got = tv.vgh(params, spec, x)
    torch.cuda.synchronize()
    assert tv.launches == before + 1
    for k, a, b in zip(("f", "g", "h6"), got, tv.vgh_reference(params, spec, x)):
        assert float((a - b).abs().max()) <= TOL[k], k
