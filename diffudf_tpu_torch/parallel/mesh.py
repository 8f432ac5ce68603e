"""The data-parallel group: the torch counterpart of
``diffudf_tpu/parallel/mesh.py``.

The JAX package shards batch, grid and ray axes over a 1-D device mesh in
one process.  PyTorch's idiom is one process per device, so the mesh
becomes a ``torch.distributed`` process group of ``size`` ranks, and a
:class:`DataGroup` is one rank's view of it: its rank, the group size, its
device and the backend.

Only two collectives are used, ``all_reduce`` (SUM) and ``broadcast``:
gloo supports both on CUDA tensors, so one code path serves the CPU tests,
several ranks sharing one GPU and one rank per GPU.  Gathering rows is an
all-reduce of a full-size buffer into which each rank writes its own block
(:meth:`DataGroup.gather_rows`), and the differentiable all-reduce is
:class:`_AllReduceSum` (SUM forward, SUM backward).

A group of one rank has no process group, and every method is a no-op,
as the JAX helpers degrade on a single device.

:func:`run_group` launches a group: the calling process becomes rank 0 and
starts ranks 1..n-1 with the ``spawn`` start method; each runs the same
module-level function, and the caller gets rank 0's result.  Rendezvous goes
through a ``FileStore`` in a fresh temporary directory (no TCP port to
pick).  A process started by ``torchrun`` joins that launcher's group
instead.  Nothing here starts a process or opens a file at import.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import shutil
import sys
import tempfile
import threading
import traceback

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective (and the rendezvous) may wait for the other ranks
# before it raises; rank 0 alone writes checkpoints, figures and meshes
# while the others wait at their next collective
TIMEOUT_S = 1800
# seconds rank 0 waits for the other ranks to exit after its own work
JOIN_S = 300


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank's view of the data-parallel group.

    ``backend`` is None when no process group exists (a group of one):
    every collective is then a no-op."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    backend: str | None = None

    def shard_rows(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows: blocks of
        ceil(n / size) rows, the last ones shorter or empty."""
        per = -(-n // self.size)
        lo = min(self.rank * per, n)
        return slice(lo, min(lo + per, n))

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, a new tensor; differentiable
        (its backward sums the incoming gradients over the ranks)."""
        if self.backend is None:
            return t
        return _AllReduceSum.apply(t)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` overwritten in place by rank ``src``'s values; -> ``t``."""
        if self.backend is not None:
            dist.broadcast(t, src)
        return t

    def gather_rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The (n, ...) tensor whose block :meth:`shard_rows` ``(n)`` is each
        rank's ``t``: an all-reduce of a buffer of −0.0 (x + −0.0 = x for
        every float x, signed zeros included), so every rank gets the bits
        an all-gather would give.  Bool rows travel as uint8."""
        if self.backend is None:
            return t
        rows = self.shard_rows(n)
        if t.shape[0] != rows.stop - rows.start:
            raise ValueError(f"gather_rows: rank {self.rank} holds {t.shape[0]} rows, its "
                             f"block of {n} has {rows.stop - rows.start}")
        src = t.to(torch.uint8) if t.dtype == torch.bool else t
        fill = -0.0 if src.is_floating_point() else 0
        buf = torch.full((n, *t.shape[1:]), fill, dtype=src.dtype, device=t.device)
        buf[rows] = src
        dist.all_reduce(buf)
        return buf.bool() if t.dtype == torch.bool else buf

    def per_rank(self, values) -> np.ndarray:
        """(size, k) float64 host array: row r holds rank r's ``values``
        (k numbers); every rank gets it."""
        v = torch.as_tensor(np.asarray(values, np.float64).reshape(1, -1), device=self.device)
        return self.gather_rows(v, self.size).cpu().numpy()

    def all_true(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank (gloo reduces it on the
        host, so the device is not synchronised)."""
        if self.backend is None:
            return bool(flag)
        t = torch.tensor([float(flag)], device="cpu" if self.backend == "gloo" else self.device)
        dist.all_reduce(t)
        return int(t.item()) == self.size


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce forward, SUM all-reduce of the gradient backward.

    Every rank computes the same loss from the summed value, so the
    backward hands each rank ``size`` times its share of the gradient of
    that one loss; the trainer divides its gradient all-reduce by ``size``."""

    @staticmethod
    def forward(ctx, t):
        out = t.detach().contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def single(device="cpu") -> DataGroup:
    """The group of one rank on ``device``: every collective a no-op."""
    return DataGroup(0, 1, torch.device(device), None)


def visible_devices(device) -> int:
    """How many ranks "all visible devices" means for ``device``: the
    launcher's world size under ``torchrun``, else the CUDA devices, or one
    for the CPU (as the JAX package's ``data_mesh()`` takes every device of
    its backend)."""
    env = _torchrun_env()
    if env is not None:
        return env[1]
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def group_devices(device, n: int) -> list:
    """The default devices of an ``n``-rank group on ``device``'s kind:
    ``cuda:0..n-1``, or ``device`` for every rank on the CPU."""
    if torch.device(device).type == "cuda":
        return [f"cuda:{i}" for i in range(n)]
    return [str(device)] * n


def pick_backend(devices) -> str:
    """``nccl`` when every rank has a CUDA device of its own, else ``gloo``
    (the CPU, or ranks sharing a GPU: NCCL refuses two ranks on one)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def init_group(rank: int, size: int, device, backend: str | None = None,
               store_path: str | None = None, timeout_s: float = TIMEOUT_S) -> DataGroup:
    """Join (or, at rank 0, start) the default process group; -> this
    rank's :class:`DataGroup`.  ``store_path`` names the ``FileStore``
    file; without it the ``env://`` variables of a launcher apply.  The
    rendezvous and every collective raise after ``timeout_s`` seconds."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or pick_backend([device])
    timeout = datetime.timedelta(seconds=timeout_s)
    if store_path is not None:
        store = dist.FileStore(store_path, size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, rank=rank, world_size=size, timeout=timeout)
    return DataGroup(rank, size, device, backend)


def close_group():
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, size, store_path, device, backend, fn, args, threads, timeout_s):
    """Ranks 1..n-1 of :func:`run_group`: join, run ``fn``, leave; a failure
    prints its traceback and exits with code 1, which rank 0 reports."""
    torch.set_num_threads(threads)
    code = 0
    try:
        group = init_group(rank, size, device, backend, store_path, timeout_s)
        fn(group, *args)
    except BaseException:  # noqa: BLE001  (reported through the exit code)
        traceback.print_exc()
        code = 1
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        try:
            close_group()
        except Exception:  # noqa: BLE001  (already failing or leaving)
            pass
    os._exit(code)


def _torchrun_env() -> tuple[int, int, int] | None:
    """(rank, world size, local rank) of a process a launcher started."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        return rank, world, int(os.environ.get("LOCAL_RANK", rank))
    return None


def _failed(procs) -> list:
    return [(r, p.exitcode) for r, p in procs if p.exitcode not in (None, 0)]


def _start_rank0(size, store_path, device, backend, procs, timeout_s) -> DataGroup:
    """Rank 0's rendezvous, on a helper thread, while this thread watches
    the other ranks: a rank that dies before it joins raises here at once
    instead of after the rendezvous timeout."""
    out = {}

    def join():
        try:
            out["group"] = init_group(0, size, device, backend, store_path, timeout_s)
        except Exception as e:  # noqa: BLE001  (re-raised below)
            out["error"] = e

    t = threading.Thread(target=join, name="group-rendezvous", daemon=True)
    t.start()
    while t.is_alive():
        t.join(0.2)
        dead = _failed(procs)
        if dead:
            raise RuntimeError(f"data-parallel group of {size}: rank(s) {dead} (rank, exit "
                               f"code) died before the group started")
    if "error" in out:
        raise RuntimeError(f"data-parallel group of {size} did not start") from out["error"]
    return out["group"]


def _spread_rank(group, fn, kwargs):
    return fn(device=group.device, group=group, **kwargs)


def spread(fn, device, n: int = 0, **kwargs):
    """Run ``fn(device=..., group=..., **kwargs)`` on the ranks that
    ``device`` and ``n`` name; -> rank 0's result (this rank's under a
    launcher such as ``torchrun``).

    ``n`` ≥ 2 asks for ``n`` ranks (:func:`group_devices`: ``cuda:0..n-1``,
    or ``n`` gloo ranks on the CPU), and raises ValueError when ``device``
    names a CUDA index other than 0.  ``n`` = 1 runs on ``device`` alone.
    ``n`` = 0 takes every visible device (:func:`visible_devices`) when
    ``device`` names no index (``"cuda"``), and the one device it names
    otherwise (``"cuda:1"``), so one run per GPU stays on its GPU.  Under a
    launcher the launcher's group decides.  ``fn`` is module-level."""
    env = _torchrun_env()
    launched = env is not None and env[1] > 1
    dev = torch.device(device)
    if n == 0:
        n = visible_devices(device) if launched or dev.index is None else 1
    if n == 1 and not launched:
        return fn(device=device, group=single(device), **kwargs)
    if dev.index not in (None, 0) and not launched:
        raise ValueError(f"{n} ranks run on {group_devices(device, n)}: device {device} "
                         f"cannot lead them; name cuda or cuda:0, or ask for one rank")
    return run_group(_spread_rank, n, (fn, kwargs), devices=group_devices(device, n))


def run_group(fn, n: int, args=(), devices=None, timeout_s: float = TIMEOUT_S):
    """Run ``fn(group, *args)`` on ``n`` ranks; -> rank 0's result.

    ``fn`` is a module-level function (the other ranks import it).  The
    calling process is rank 0; ranks 1..n-1 are new processes (``spawn``),
    which get pickled copies of ``args``.  ``devices`` (default
    :func:`group_devices` of CUDA, or the CPU when CUDA is absent) names
    each rank's device; the backend follows :func:`pick_backend`.  ``n=1``
    runs ``fn`` here on a group of one, with no process group.

    In a process a launcher such as ``torchrun`` started (``RANK`` and
    ``WORLD_SIZE`` set), ``n`` must equal the world size: the process joins
    the launcher's group (once) and runs ``fn`` as its own rank, on
    ``cuda:LOCAL_RANK`` (or the CPU when ``devices`` name the CPU); every
    rank returns its own result.

    Raises RuntimeError when a rank fails to start, fails or exits with an
    error, and when the group cannot have ``n`` ranks; nothing carries on
    with fewer ranks than asked for.  A rank that stops answering makes the
    others' rendezvous or collective raise after ``timeout_s`` seconds, and
    rank 0 waits at most that long (and at most ``JOIN_S``) for the others
    to exit.
    """
    if n < 1:
        raise ValueError(f"run_group: n must be >= 1, got {n}")
    env = _torchrun_env()
    if env is not None and env[1] > 1:
        rank, world, local = env
        if n != world:
            raise RuntimeError(f"run_group: {n} ranks asked for in a launcher's group of {world}")
        cuda = torch.device(devices[0]).type == "cuda" if devices else torch.cuda.is_available()
        device = f"cuda:{local}" if cuda else "cpu"
        if dist.is_initialized():
            group = DataGroup(rank, world, torch.device(device), dist.get_backend())
        else:
            group = init_group(rank, world, device, "nccl" if cuda else "gloo",
                               timeout_s=timeout_s)
        return fn(group, *args)

    if devices is None:
        devices = group_devices("cuda" if torch.cuda.is_available() else "cpu", n)
    devices = [str(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"run_group: {len(devices)} devices for {n} ranks")
    if n == 1:
        return fn(single(devices[0]), *args)
    if torch.device(devices[0]).type == "cuda" and torch.cuda.device_count() < len(
            {torch.device(d).index for d in devices}):
        raise RuntimeError(f"run_group: {devices} asked for, {torch.cuda.device_count()} "
                           f"CUDA device(s) visible")
    if dist.is_initialized():
        raise RuntimeError("run_group: this process is already in a process group")

    backend = pick_backend(devices)
    tmp = tempfile.mkdtemp(prefix="diffudf_group_")
    store_path = os.path.join(tmp, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [(r, ctx.Process(target=_rank_main, name=f"diffudf-rank{r}",
                             args=(r, n, store_path, devices[r], backend, fn, args,
                                   torch.get_num_threads(), timeout_s)))
             for r in range(1, n)]
    ok = False
    try:
        for _, p in procs:
            p.start()
        group = _start_rank0(n, store_path, devices[0], backend, procs, timeout_s)
        try:
            result = fn(group, *args)
        finally:
            close_group()
        for _, p in procs:
            p.join(min(JOIN_S, timeout_s))
        dead = _failed(procs) + [(r, "still running") for r, p in procs if p.is_alive()]
        if dead:
            raise RuntimeError(f"data-parallel group of {n}: rank(s) {dead} (rank, exit code) "
                               f"failed")
        ok = True
        return result
    finally:
        if not ok:
            close_group()
            for _, p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
