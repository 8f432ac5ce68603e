"""Checkpoints in the JAX package's formats (``diffudf_tpu/train/
checkpoint.py``), so a file written by either package loads in the other:

  * model artifacts: a flat ``.npz`` of ``layer{i}_w`` (in, out) and
    ``layer{i}_b`` arrays plus a ``.spec.json`` sidecar of the SirenSpec;
  * the resumable train state: one ``.npz`` with ``params`` and
    ``opt_state`` flat in float32, in the order ``jax.flatten_util.
    ravel_pytree`` gives the JAX params and optax's
    ``ScaleByAdamState(count, mu, nu)`` (the int32 count promoted to
    float32), the ``epoch``, and ``key``, a (2,) uint32 PRNG key.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil

import numpy as np
import torch

from ..fields.siren import SirenSpec, flatten_params, unflatten_params


def save_params(path: str, params, spec: SirenSpec | None = None):
    """Write params (torch tensors or numpy arrays, JAX layout) to ``path``."""
    flat = {}
    for i, layer in enumerate(params):
        for k in ("w", "b"):
            v = layer[k]
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            flat[f"layer{i}_{k}"] = np.asarray(v)
    np.savez(path, **flat)
    if spec is not None:
        with open(_spec_path(path), "w") as fh:
            json.dump(dataclasses.asdict(spec), fh)


def _spec_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".spec.json"


def load_params(path: str, device="cuda"):
    """-> list of ``{'w', 'b'}`` float32 tensors on ``device``."""
    with np.load(path) as data:
        n_layers = max(int(k[5 : k.index("_")]) for k in data.files) + 1
        return [
            {k: torch.as_tensor(data[f"layer{i}_{k}"], dtype=torch.float32, device=device)
             for k in ("w", "b")}
            for i in range(n_layers)
        ]


def load_spec(path: str) -> SirenSpec:
    with open(_spec_path(path)) as fh:
        d = json.load(fh)
    d["hidden"] = tuple(d["hidden"])
    return SirenSpec(**d)


def check_params_match_spec(params, spec: SirenSpec):
    """Raise a clear error when a checkpoint doesn't match the configured
    architecture (otherwise it surfaces as an opaque matmul shape error)."""
    dims = spec.layer_dims
    got = [int(p["w"].shape[0]) for p in params] + [int(params[-1]["w"].shape[1])]
    want = list(dims)
    if got != want or len(params) != len(dims) - 1:
        raise ValueError(
            f"checkpoint layer dims {got} do not match configured architecture "
            f"{want}; check hidden_layer_nodes in the config"
        )


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the step count and the two moments, each a
    list of ``{'w', 'b'}`` tensors like the params."""

    count: int
    mu: list
    nu: list


def save_train_state(path: str, params, opt_state: AdamState, epoch: int, key):
    """Full resumable state as one .npz, readable by the JAX package's
    ``load_train_state``."""
    flat_opt = torch.cat([
        torch.tensor([float(opt_state.count)], device=params[0]["w"].device),
        flatten_params(opt_state.mu), flatten_params(opt_state.nu)])
    np.savez(
        path,
        params=flatten_params(params).detach().cpu().numpy().astype(np.float32),
        opt_state=flat_opt.detach().cpu().numpy().astype(np.float32),
        epoch=np.asarray(epoch),
        key=np.asarray(key, np.uint32),
    )


def load_train_state(path: str, spec: SirenSpec, device="cuda"):
    """-> (params, AdamState, epoch, key (2,) uint32) from a file written by
    either package; tensors are float32 on ``device``."""
    with np.load(path) as data:
        flat_p = torch.as_tensor(data["params"], dtype=torch.float32, device=device)
        flat_o = torch.as_tensor(data["opt_state"], dtype=torch.float32, device=device)
        epoch, key = int(data["epoch"]), np.asarray(data["key"], np.uint32)
    n = flat_p.numel()
    if flat_o.numel() != 1 + 2 * n:
        raise ValueError(f"{path}: opt_state holds {flat_o.numel()} values, "
                         f"expected {1 + 2 * n} for {n} params")
    opt = AdamState(
        count=int(flat_o[0].item()),
        mu=unflatten_params(flat_o[1:1 + n].clone(), spec),
        nu=unflatten_params(flat_o[1 + n:].clone(), spec),
    )
    return unflatten_params(flat_p, spec), opt, epoch, key


def create_output_paths(checkpoint_path: str, experiment_name: str, overwrite: bool = False):
    """Mirror of reference ``src/util.py:10-22``: refuse to clobber unless asked."""
    full_path = os.path.join(".", checkpoint_path, experiment_name)
    if os.path.exists(full_path):
        if overwrite:
            shutil.rmtree(full_path)
        else:
            logging.warning("Output path exists. Not overwriting.")
            return full_path
    os.makedirs(os.path.join(full_path, "models"), exist_ok=True)
    os.makedirs(os.path.join(full_path, "reconstructions"), exist_ok=True)
    return full_path
