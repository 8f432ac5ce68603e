"""Background oracle builds overlapped with training: the torch copy of
``diffudf_tpu/data/async_build.py``.

The candidate-grid build (host ``cKDTree``, seconds) is host work, while
training is device work launched from a host loop.  So the build hides
behind training:

  1. training starts at once on an exact *bootstrap* oracle
     (``TrainingSampler.from_mesh_bootstrap``, the brute closest-point
     sweep in bounded blocks, or ``from_point_cloud_bootstrap``, the brute
     nearest-point sweep: one K5 launch a step on the card);
  2. a daemon thread runs the numpy/cKDTree build (the ``*_host``
     functions of :mod:`.oracle_cache`); it never touches the device;
  3. the trainer polls the handle before every epoch
     (``Trainer.run(sampler_update=…)``) and swaps the upgraded sampler
     in; the upgrade, which places the grid on the device, runs on the
     main thread.

Both bootstrap oracles are exact and the grid oracles they hand over to are
exact on their candidates, so when the swap lands changes the GT values only
within that guarantee (float32 association in mesh mode; in point-cloud mode
the table's documented error on a few far queries).  The batches come from
the same generator stream either way.  ``DIFFUDF_ORACLE_OVERLAP=0`` (read by
``cli.train``) restores build-then-train.

The JAX package builds a mesh synchronously above ``BOOT_TRI_MAX`` = 16,384
triangles, because its flat bootstrap sweep held O(Q·T) temporaries in TPU
memory.  The port's bootstrap sweep runs in blocks of a fixed size at any
triangle count, so every mesh overlaps and there is no cap.

A failed build degrades to a RuntimeWarning and the run finishes on the
bootstrap oracle: correct, slower a step.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings

import numpy as np
import torch

from .mesh_distance import build_triangle_table
from .oracle_cache import cached_candidate_grid_host, cached_point_candidate_idx_host
from .sampling import TrainingSampler


class OracleBuildHandle:
    """Handle to one background oracle build.

    ``poll()`` (main thread) returns the upgraded sampler exactly once, as
    soon as the build thread has finished; ``None`` while pending, after the
    handover, or if the build failed (warned once).  ``wait()`` blocks."""

    def __init__(self, build_fn, upgrade_fn):
        """``build_fn() -> host result`` runs on the thread (numpy only);
        ``upgrade_fn(host_result) -> TrainingSampler`` runs on the main
        thread at handover (device placement happens there)."""
        self._upgrade_fn = upgrade_fn
        self._result = None
        self._exc = None
        self._done = threading.Event()
        self.build_seconds: float | None = None  # the thread's wall time

        def run():
            t0 = time.perf_counter()
            try:
                self._result = build_fn()
            except Exception as e:  # surfaced as a warning by poll
                self._exc = e
            finally:
                self.build_seconds = time.perf_counter() - t0
                self._done.set()

        self._thread = threading.Thread(target=run, name="oracle-build", daemon=True)
        self._thread.start()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def poll(self):
        if not self._done.is_set():
            return None
        if self._exc is not None:
            warnings.warn(
                f"background oracle build failed ({self._exc!r}); training continues on "
                f"the exact bootstrap oracle (slower per step)", RuntimeWarning)
            self._exc = None
            return None
        if self._result is None:
            return None
        result, self._result = self._result, None
        return self._upgrade_fn(result)

    def wait(self, timeout: float | None = None):
        """Block until the build finishes, then hand over (or None)."""
        self._done.wait(timeout)
        return self.poll()


def overlapped_mesh_sampler(points, normals, tri_verts, batch_size, percentiles,
                            stddev=0.01, cache_path: str | None = None, device="cuda"):
    """(bootstrap sampler, handle) for mesh mode: training can start now;
    the coordinate-table sampler arrives through ``handle.poll()``."""
    real = np.asarray(tri_verts, np.float32)
    boot = TrainingSampler.from_mesh_bootstrap(points, normals, real, batch_size,
                                               percentiles, stddev, device=device)

    def build():
        return cached_candidate_grid_host(real, cache_path)

    def upgrade(cand):
        table = build_triangle_table(boot.tri_verts, cand)
        return dataclasses.replace(boot, tri_verts=None, tri_table=table)

    return boot, OracleBuildHandle(build, upgrade)


def overlapped_pc_sampler(points, normals, batch_size, percentiles, stddev=0.01,
                          cache_path: str | None = None, device="cuda"):
    """(bootstrap sampler, handle) for point-cloud mode."""
    pts = np.asarray(points, np.float32)
    boot = TrainingSampler.from_point_cloud_bootstrap(pts, normals, batch_size, percentiles,
                                                      stddev, device=device)

    def build():
        return cached_point_candidate_idx_host(pts, cache_path)

    def upgrade(idx):
        return dataclasses.replace(boot, pc_candidates=torch.as_tensor(pts[idx], device=device))

    return boot, OracleBuildHandle(build, upgrade)
