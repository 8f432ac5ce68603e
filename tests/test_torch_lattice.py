"""Port parity: grid extraction (``diffudf_tpu_torch.grid.lattice``) against
the reference golden and the JAX package's dense and sparse passes."""

import os.path as osp
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
from diffudf_tpu.grid import lattice as jlat
from diffudf_tpu_torch.autodiff.ops import value_grad
from diffudf_tpu_torch.fields.siren import SirenSpec, params_from_jax
from diffudf_tpu_torch.grid import lattice

torch.set_num_threads(2)

GOLDEN = osp.join(osp.dirname(__file__), "golden", "grid_rays_golden.npz")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def field(g):
    n_layers = sum(1 for k in g.files if re.fullmatch(r"w\d+", k))
    np_params = [{"w": g[f"w{i}"], "b": g[f"b{i}"]} for i in range(n_layers)]
    hidden = tuple(g[f"w{i}"].shape[1] for i in range(n_layers - 1))
    w0 = float(g["freq_w0"])
    return np_params, SirenSpec(hidden=hidden, w0=w0), JaxSpec(hidden=hidden, w0=w0)


def test_extract_fields_matches_reference_golden(g, field):
    """The asserts of tests/test_golden_grid_rays.py on the port."""
    np_params, spec, _ = field
    params = params_from_jax(np_params, "cpu")
    N, alpha = int(g["N"]), float(g["alpha"])
    udf, dirs = lattice.extract_fields(params, spec, N, "tanh", alpha)
    udf, dirs = udf.numpy(), dirs.numpy()

    diff = np.abs(udf - g["udf"])
    assert np.median(diff) < 1e-5, np.median(diff)
    assert diff.max() < 2e-3, diff.max()

    _, grad = value_grad(params, spec, lattice.lattice_points(N, device="cpu"))
    gnorm = torch.linalg.norm(grad, dim=-1).numpy().reshape(N, N, N)
    outside = gnorm >= lattice.GRAD_NORM_THRESHOLD
    assert outside.mean() > 0.15
    dots = np.sum(dirs * g["dirs"], axis=-1)
    assert (dots[outside] > 0.9999).mean() > 0.999, dots[outside].min()
    inside = ~outside
    if inside.any():
        n = np.linalg.norm(dirs[inside], axis=-1)
        np.testing.assert_allclose(n, 1.0, atol=1e-3)


def test_lattice_coordinates_match_jax():
    for N in (5, 33):
        pts = lattice.lattice_points(N, device="cpu")
        np.testing.assert_array_equal(pts.numpy(), np.asarray(jlat.lattice_points(N)))
        idx = np.array([0, 7, N ** 3 - 1, N * N + 3])
        np.testing.assert_array_equal(
            lattice._decode_points(torch.as_tensor(idx), N).numpy(), pts.numpy()[idx])


@pytest.mark.parametrize("N", [32, 33])  # 32: dense fallback (31 is prime); 33: stride 4
def test_extract_fields_sparse_matches_jax(field, N):
    np_params, spec, jspec = field
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
    stats = {}
    udf, dirs = lattice.extract_fields_sparse(params_from_jax(np_params, "cpu"), spec, N,
                                              "tanh", 100.0, stats=stats)
    udf0, dirs0 = jlat.extract_fields_sparse(jparams, jspec, N, "tanh", 100.0, deriv_dtype=None)
    assert udf.shape == (N, N, N) and dirs.shape == (N, N, N, 3)
    assert ("stage2_s" in stats) == (N == 33)
    diff = np.abs(udf - udf0)
    assert np.median(diff) < 1e-5 and diff.max() < 2e-3, (np.median(diff), diff.max())
    has = np.linalg.norm(dirs0, axis=-1) > 0
    assert (has == (np.linalg.norm(dirs, axis=-1) > 0)).mean() > 0.999
    assert has.sum() > 100
    dots = np.sum(dirs[has] * dirs0[has], axis=-1)
    assert (dots > 0.999).mean() > 0.99, np.sort(dots)[:5]
