"""Disk cache for the one-shot point-oracle build: the point part of
``diffudf_tpu/data/oracle_cache.py``, with the same key function and file
layout, so that a cache written by either package serves the other.

The candidate indices are a pure function of the preprocessed cloud and the
grid constants.  They are cached next to the preprocessed asset in
``<cache_path>.pc_cand.npz``, keyed by a SHA-1 of the exact cloud bytes plus
the grid geometry, so a changed cloud or changed constants rebuild.  Legacy
merged files (the field inside ``<cache_path>`` itself) are still read.
Writes are atomic (tmp + ``os.replace``) and best-effort: an unwritable
directory degrades to a warning, never an error.
"""

from __future__ import annotations

import hashlib
import os
import warnings
import zipfile

import numpy as np
import torch

from . import mesh_distance as md

_FORMAT_VERSION = 1


def _key(kind: str, data: np.ndarray, g: int, k: int, lo: float, hi: float) -> str:
    h = hashlib.sha1()
    h.update(
        f"{_FORMAT_VERSION}|{kind}|{data.shape}|{g}|{k}|{lo}|{hi}|".encode()
    )
    h.update(np.ascontiguousarray(data, np.float32).tobytes())
    return h.hexdigest()


def _field_path(path: str, field: str) -> str:
    return f"{path}.{field}.npz"


def _read_field(path: str, field: str, key: str) -> np.ndarray | None:
    if not path or not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if field + "_key" not in z.files:
                return None
            if str(z[field + "_key"]) == key:
                return z[field]
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:  # corrupt/foreign file: rebuild
        warnings.warn(f"oracle cache {path} unreadable ({e}); rebuilding")
    return None


def _load(path: str, field: str, key: str) -> np.ndarray | None:
    if not path:
        return None
    hit = _read_field(_field_path(path, field), field, key)
    if hit is not None:
        return hit
    # legacy single-file layout (read-only migration path)
    return _read_field(path, field, key)


def _store(path: str, field: str, key: str, idx: np.ndarray) -> None:
    """Write one oracle field to its own npz (concurrent-writer safe)."""
    if not path:
        return
    dst = _field_path(path, field)
    # np.savez appends ".npz" when the name lacks it: keep the suffix so the
    # tmp name is exactly what os.replace moves
    tmp = f"{dst}.{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, **{field: idx, field + "_key": np.asarray(key)})
        os.replace(tmp, dst)
    except OSError as e:
        warnings.warn(f"could not write oracle cache {dst}: {e}")
        try:
            os.remove(tmp)
        except OSError:
            pass


def cached_point_candidate_idx_host(cloud, cache_path: str | None) -> np.ndarray:
    """pc-oracle candidate *indices* with an optional disk cache, host side.

    cloud: (N, 3) host array.  Returns (g³, k) int32 numpy indices into
    the cloud (gather ``cloud[idx]`` for the coordinate table)."""
    pts = np.asarray(cloud, np.float32)
    g, k = md.CAND_GRID_G, md.CAND_PTS_K
    lo, hi = md.CAND_GRID_LO, md.CAND_GRID_HI
    key = _key("pc", pts, g, k, lo, hi)
    hit = _load(cache_path, "pc_cand", key)
    if hit is not None:
        return hit.astype(np.int32)
    idx = md.build_point_candidate_indices(pts)
    if cache_path:
        _store(cache_path, "pc_cand", key, idx)
    return idx


def cached_point_candidate_grid(cloud, cache_path: str | None, device="cuda") -> torch.Tensor:
    """``build_point_candidate_grid`` with an optional npz disk cache: the
    (g³, k, 3) float32 coordinate table on ``device``."""
    pts = np.asarray(cloud, np.float32)
    return torch.as_tensor(pts[cached_point_candidate_idx_host(pts, cache_path)], device=device)
