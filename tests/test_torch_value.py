"""Port parity: the value kernel K4's plain version (``diffudf_tpu_torch.ops.
value``), the mixed value mode of ``autodiff.ops.value``, and the selection
of the SIREN kernels by width (``ops.kernel_io.kernel_spec_ok``).

On the CPU the K4 wrapper runs its plain version, which is held against the
JAX package's Pallas value kernel in interpret mode (patched as
tests/test_pallas.py does).  K4 itself is held against the plain version on
a GPU, in tests/test_torch_cuda.py."""

from unittest import mock

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffudf_tpu.ops.pallas_value as pval
from diffudf_tpu.autodiff.ops import value as jax_value
from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
from diffudf_tpu_torch.autodiff.ops import value as plain_value
from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax
from diffudf_tpu_torch.ops import evaluate, kernel_io
from diffudf_tpu_torch.ops import value as tval
from diffudf_tpu_torch.render import tracer

torch.set_num_threads(2)

# tests/test_pallas.py::TestPallasValue: f32 1e-5, bf16 2e-3 (absolute)
TOL = {"f32": 1e-5, "bf16": 2e-3}
DTYPES = {"f32": (None, None), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def net():
    """4x64 net and 1024 points, one tile of the Pallas kernel."""
    hidden = (64,) * 4
    np_params = init_siren(SirenSpec(hidden=hidden), np.random.default_rng(0))
    x = np.random.default_rng(1).uniform(-1, 1, (1024, 3)).astype(np.float32)
    return SirenSpec(hidden=hidden), JaxSpec(hidden=hidden), np_params, x


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_reference_matches_pallas_interpret(net, mode, monkeypatch):
    spec, jspec, np_params, x = net
    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pval.pl, "pallas_call", interp_call)
    tdt, jdt = DTYPES[mode]
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
    want = np.asarray(pval.value_pallas(jparams, jspec, jnp.asarray(x), tile=1024,
                                        compute_dtype=jdt))
    got = tval.value_reference(params_from_jax(np_params, "cpu"), spec, torch.from_numpy(x),
                               compute_dtype=tdt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[mode])


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_plain_value_matches_jax(net, mode):
    """``autodiff.ops.value`` (exact sin) against the JAX XLA value in both
    modes: the same rounding points, float32 sums in another order."""
    spec, jspec, np_params, x = net
    tdt, jdt = DTYPES[mode]
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
    want = np.asarray(jax_value(jparams, jspec, jnp.asarray(x), compute_dtype=jdt))
    got = plain_value(params_from_jax(np_params, "cpu"), spec, torch.from_numpy(x),
                      compute_dtype=tdt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[mode])


def test_wrapper_on_cpu_runs_the_plain_version(net):
    spec, _, np_params, x = net
    params = params_from_jax(np_params, "cpu")
    before = (tval.launches, tval.points)
    for dt in (None, torch.bfloat16):
        got = tval.value(params, spec, torch.from_numpy(x), compute_dtype=dt)
        assert torch.equal(got, tval.value_reference(params, spec, torch.from_numpy(x), dt))
    assert (tval.launches, tval.points) == before


def _cuda_points(n=8, dtype=torch.float32):
    """A stand-in for a CUDA tensor of points: the wrapper's checks read
    only its device, shape, type and layout."""
    x = mock.Mock(spec=torch.Tensor)
    x.device, x.dtype, x.ndim, x.shape = torch.device("cuda"), dtype, 2, (n, 3)
    x.is_contiguous.return_value = True
    return x


@pytest.mark.parametrize("case", ["width48", "width512", "relu", "ragged", "float16", "float64"])
def test_wrapper_raises_on_cuda_requests_it_cannot_take(case):
    """K4 launches or raises: each request below raises ValueError before
    any build or launch."""
    hidden = {"width48": (48,) * 3, "width512": (512,) * 3, "ragged": (64, 32)}.get(case, (64,) * 3)
    spec = SirenSpec(hidden=hidden, activation="relu" if case == "relu" else "sine")
    x = _cuda_points(dtype=torch.float64 if case == "float64" else torch.float32)
    dt = torch.float16 if case == "float16" else None
    with mock.patch.object(tval, "_lib", side_effect=AssertionError("built")):
        with pytest.raises(ValueError):
            tval.value([], spec, x, compute_dtype=dt)


@pytest.mark.parametrize("width,ok", [(32, True), (48, False), (64, True), (100, False),
                                      (256, True), (512, False)])
def test_kernel_selection_follows_the_width_limit(width, ok):
    """The F1 repair: every selector sends a width the CUDA kernels cannot
    take (not a multiple of 32, or above 256) to the plain path."""
    spec = SirenSpec(hidden=(width,) * 3)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert kernel_io.kernel_spec_ok(spec) is ok
    assert evaluate._kernel_ok(spec, True, cuda) is ok
    assert tracer._value_kernel_ok(spec, cuda) is ok
    assert not evaluate._kernel_ok(spec, True, cpu) and not tracer._value_kernel_ok(spec, cpu)
    assert not evaluate._kernel_ok(spec, False, cuda)
    assert not kernel_io.kernel_spec_ok(SirenSpec(hidden=(width,) * 3, activation="relu"))
    assert not kernel_io.kernel_spec_ok(SirenSpec(hidden=(width, 2 * width)))


@pytest.mark.parametrize("width", [48, 64, 256, 512])
def test_trainer_fuses_only_what_the_kernels_take(width):
    from diffudf_tpu_torch.config import TrainConfig
    from diffudf_tpu_torch.train.loop import Trainer

    spec = SirenSpec(hidden=(width,) * 2)
    sampler = mock.Mock(device=torch.device("cuda"))
    trainer = Trainer(spec, sampler, TrainConfig())
    fused = width in (64, 256)
    assert (trainer._vgh_op is not None) is fused and (trainer._vg_op is not None) is fused

