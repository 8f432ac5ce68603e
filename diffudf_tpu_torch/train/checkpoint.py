"""Model checkpoints in the JAX package's format (``diffudf_tpu/train/
checkpoint.py``): a flat ``.npz`` of ``layer{i}_w`` (in, out) and
``layer{i}_b`` arrays plus a ``.spec.json`` sidecar of the SirenSpec, so a
checkpoint written by either package loads in the other."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..fields.siren import SirenSpec


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
