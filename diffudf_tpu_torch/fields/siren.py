"""SIREN coordinate MLP: the torch counterpart of ``diffudf_tpu/fields/siren.py``.

Parameters keep the JAX package's layout: a list of ``{'w': (in, out),
'b': (out,)}`` per layer, so one checkpoint (``train/checkpoint.py``) and one
set of numpy arrays feed both packages.  :class:`Siren` holds them as an
``nn.Module``; the functional entry points (``siren_apply`` here, the fused
derivatives in :mod:`..autodiff.ops`, the kernels in :mod:`..ops`) take the
plain list, which ``Siren.params()`` returns.

Init distributions (reference ``src/model.py:7-19,111-113``):
  * first linear:   W ~ U(-1/fan_in, 1/fan_in)
  * hidden linears: W ~ U(-sqrt(6/fan_in)/ww, sqrt(6/fan_in)/ww)
  * final linear:   same as hidden
  * all biases:     U(-1/sqrt(fan_in), 1/sqrt(fan_in))

Activations: ``sin(w0·z)`` on the first layer, ``sin(ww·z)`` on hidden layers
(``relu(w·z)`` in relu mode); the output head is affine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class SirenSpec:
    """Static architecture description; same fields and ``.spec.json`` as
    the JAX package's ``SirenSpec``."""

    n_in: int = 3
    n_out: int = 1
    hidden: tuple = (256,) * 8
    w0: float = 30.0
    ww: float | None = None
    activation: str = "sine"  # 'sine' | 'relu'

    def __post_init__(self):
        object.__setattr__(self, "hidden", tuple(int(h) for h in self.hidden))
        if self.activation not in ("sine", "relu"):
            raise ValueError(f"unknown activation {self.activation!r}")

    @property
    def freqs(self) -> tuple:
        """Per-layer frequency multipliers (first layer w0, then ww)."""
        ww = self.w0 if self.ww is None else self.ww
        if self.activation == "relu":
            # the reference uses ww for every relu layer, including the first
            return (ww,) * len(self.hidden)
        return (self.w0,) + (ww,) * (len(self.hidden) - 1)

    @property
    def layer_dims(self) -> tuple:
        return (self.n_in,) + self.hidden + (self.n_out,)


def init_siren(spec: SirenSpec, rng: np.random.Generator):
    """Initial parameters drawn from ``rng``: a list of numpy float32
    ``{'w': (in, out), 'b': (out,)}`` dicts, the JAX layout.

    The bounds are the JAX package's; the random stream is numpy's, so the
    values differ from ``jax.random`` for the same seed."""
    ww = spec.w0 if spec.ww is None else spec.ww
    dims = spec.layer_dims
    params = []
    for i in range(len(dims) - 1):
        fan_in, fan_out = dims[i], dims[i + 1]
        bound = 1.0 / fan_in if i == 0 else float(np.sqrt(6.0 / fan_in) / ww)
        w = rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32)
        b_bound = 1.0 / float(np.sqrt(fan_in))
        b = rng.uniform(-b_bound, b_bound, (fan_out,)).astype(np.float32)
        params.append({"w": w, "b": b})
    return params


def params_from_jax(params, device="cuda"):
    """JAX-layout params (numpy or anything ``np.asarray`` takes) -> list of
    float32 torch tensors on ``device``."""
    return [
        {k: torch.as_tensor(np.asarray(layer[k], np.float32), device=device)
         for k in ("w", "b")}
        for layer in params
    ]


def params_to_jax(params):
    """Torch params -> list of numpy float32 ``{'w', 'b'}`` dicts."""
    return [
        {k: layer[k].detach().to("cpu", torch.float32).numpy() for k in ("w", "b")}
        for layer in params
    ]


def flat_size(spec: SirenSpec) -> int:
    """Number of parameters of ``spec``."""
    dims = spec.layer_dims
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def param_count(params) -> int:
    """Number of values in ``params`` (torch tensors or numpy arrays)."""
    return sum(int(np.prod(p.shape)) for leaf in params for p in leaf.values())


def flatten_params(params) -> torch.Tensor:
    """Params -> one flat tensor in the order of ``jax.flatten_util.
    ravel_pytree`` over the JAX layout: layer by layer, ``b`` then ``w``
    (dict keys sorted), each row-major."""
    return torch.cat([layer[k].reshape(-1) for layer in params for k in ("b", "w")])


def unflatten_params(flat: torch.Tensor, spec: SirenSpec):
    """Inverse of :func:`flatten_params`: a list of ``{'w', 'b'}`` views of
    ``flat``."""
    dims = spec.layer_dims
    out, o = [], 0
    for a, b in zip(dims[:-1], dims[1:]):
        out.append({"b": flat[o:o + b], "w": flat[o + b:o + b + a * b].view(a, b)})
        o += b + a * b
    if o != flat.numel():
        raise ValueError(f"flat params hold {flat.numel()} values, the spec {o}")
    return out


def siren_apply(params, spec: SirenSpec, x: torch.Tensor) -> torch.Tensor:
    """Forward pass: ``(N, n_in) -> (N, n_out)``."""
    freqs = spec.freqs
    h = x
    for i, layer in enumerate(params[:-1]):
        z = h @ layer["w"] + layer["b"]
        if spec.activation == "sine":
            h = torch.sin(freqs[i] * z)
        else:
            h = torch.relu(freqs[i] * z)
    last = params[-1]
    return h @ last["w"] + last["b"]


class Siren(nn.Module):
    """The SIREN as a module; weights stored as (in, out) like the JAX package."""

    def __init__(self, spec: SirenSpec, params):
        super().__init__()
        self.spec = spec
        self.w = nn.ParameterList(
            nn.Parameter(torch.as_tensor(np.asarray(p["w"], np.float32)))
            for p in params)
        self.b = nn.ParameterList(
            nn.Parameter(torch.as_tensor(np.asarray(p["b"], np.float32)))
            for p in params)

    @classmethod
    def init(cls, spec: SirenSpec, rng: np.random.Generator) -> "Siren":
        return cls(spec, init_siren(spec, rng))

    def params(self):
        """The parameters as the JAX-layout list of ``{'w', 'b'}`` tensors."""
        return [{"w": w, "b": b} for w, b in zip(self.w, self.b)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return siren_apply(self.params(), self.spec, x)
