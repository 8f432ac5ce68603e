"""Disk cache for the one-shot oracle builds: the torch copy of
``diffudf_tpu/data/oracle_cache.py``, with the same key function and file
layout, so that a cache written by either package serves the other.

The candidate indices (:func:`.mesh_distance.build_candidate_grid` for a
mesh, :func:`.mesh_distance.build_point_candidate_indices` for a cloud) are
a pure function of the preprocessed geometry and the grid constants.  Each
is cached next to the preprocessed asset in its own file,
``<cache_path>.tri_cand.npz`` or ``<cache_path>.pc_cand.npz``, keyed by a
SHA-1 of the exact input bytes plus the grid geometry, so a changed input or
changed constants rebuild, and two writers of one asset never clobber each
other.  Legacy merged files (the field inside ``<cache_path>`` itself) are
still read.  Writes are atomic (tmp + ``os.replace``) and best-effort: an
unwritable directory degrades to a warning, never an error.

The ``*_host`` functions return numpy and touch no device: the background
build thread of :mod:`.async_build` runs them.
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


def cached_candidate_grid_host(tri_verts, cache_path: str | None) -> np.ndarray:
    """``build_candidate_grid`` with an optional npz disk cache, host side.

    tri_verts: (T, 3, 3) host array.  Returns the (g³, k) int32 candidate
    grid as numpy, loaded from ``cache_path`` when the stored SHA-1 of the
    triangle bytes and grid constants matches."""
    tv = np.asarray(tri_verts, np.float32)
    g, k = md.CAND_GRID_G, md.CAND_GRID_K
    lo, hi = md.CAND_GRID_LO, md.CAND_GRID_HI
    key = _key("tri", tv, g, k, lo, hi)
    hit = _load(cache_path, "tri_cand", key)
    if hit is not None:
        return hit.astype(np.int32)
    cand = md.build_candidate_grid(tv)
    if cache_path:
        _store(cache_path, "tri_cand", key, cand)
    return cand


def cached_candidate_grid(tri_verts, cache_path: str | None, device="cuda") -> torch.Tensor:
    """:func:`cached_candidate_grid_host` as an int32 tensor on ``device``."""
    return torch.as_tensor(cached_candidate_grid_host(tri_verts, cache_path), device=device)


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
