"""CLI: train a DUDF field from a preprocessed mesh or point cloud, on the GPU.

The torch counterpart of ``diffudf_tpu/cli/train.py``:

    python -m diffudf_tpu_torch.cli.train <config.json> [device_ordinal] [--resume]
        [--device cpu] [--mesh N]

``setup_train`` follows the JAX package's pipeline: output dirs and
``params.json``, the sampler and its oracle (by default built on a host
thread behind the first epochs, :mod:`..data.async_build`), staged
training, per-chunk checkpoints (best / current / periodic),
``losses.csv``, the final model, the slice figure of the best params at
width 512 (``distance_fields.png`` and ``pred_grad.png``: one K1 launch, and
the plane's GT distances: the triangle table in mesh mode, the brute
nearest-point distance to the cloud in point-cloud mode, one K5 launch) and
the final marching-cubes reconstructions (``cli/generate_mc.py::run_mc``).
Mesh input (``<dataset>_t.obj``) by default, point-cloud input with
``"onlyPCloud": true``.

``--mesh N`` trains data-parallel on N ranks (``cuda:0..N-1``, or N gloo
ranks with ``--device cpu``; :mod:`..parallel.mesh`), as the JAX CLI's
``--mesh`` trains over N devices, and ``--mesh 1`` pins one device.
Without ``--mesh``, a run with no ``device_ordinal`` takes every visible
GPU (one on the CPU), and a run that names one trains on that GPU alone,
so one experiment per GPU stays on its GPU; ``--mesh N`` ≥ 2 with an
ordinal other than 0 raises.  Under ``torchrun`` each process is one rank
of the launcher's group.  Rank 0 alone writes files and prints.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time

import numpy as np
import torch

from ..config import TrainConfig
from ..data.async_build import overlapped_mesh_sampler, overlapped_pc_sampler
from ..data.mesh_distance import (point_cloud_distance, point_triangle_distance_pruned,
                                  point_triangle_distance_table, triangles_from_mesh)
from ..data.mesh_io import load_mesh, load_point_cloud
from ..data.sampling import TrainingSampler
from ..parallel.mesh import spread
from ..train import checkpoint as ckpt
from ..train.loop import Trainer
from ..utils.metrics import ScalarLogger
from .generate_df import slice_figure

SLICE_WIDTH = 512  # the figure's plane samples a side (JAX ``train.py:287-292``)
# seconds a rank other than 0 waits for rank 0 to write the oracle cache
CACHE_WAIT_S = 600.0


def _cache_path(cfg: TrainConfig):
    """The oracle cache beside the preprocessed asset, or None under
    ``DIFFUDF_ORACLE_CACHE=0``."""
    if os.environ.get("DIFFUDF_ORACLE_CACHE", "1") == "0":
        return None
    return cfg.dataset + "_oracle_cache.npz"


def _load_inputs(cfg: TrainConfig):
    """-> (cloud, triangles (T, 3, 3) host array or None, mesh or None)."""
    pc = load_point_cloud(cfg.dataset + "_pc.ply")
    if pc.normals is None:
        raise ValueError(f"{cfg.dataset}_pc.ply has no normals")
    if cfg.only_pcloud:
        return pc, None, None
    mesh = load_mesh(cfg.dataset + "_t.obj")
    return pc, mesh.vertices[mesh.faces], mesh


def build_sampler(cfg: TrainConfig, device="cuda", cache_writer: bool = True):
    """Load ``<dataset>_pc.ply`` (and ``<dataset>_t.obj`` in mesh mode) and
    build the sampler with its candidate-grid oracle.

    The one-shot build is cached on disk next to the preprocessed asset
    (``<dataset>_oracle_cache.npz.{tri,pc}_cand.npz``, content hashed,
    shared with the JAX package; see :mod:`..data.oracle_cache`).  Set
    ``DIFFUDF_ORACLE_CACHE=0`` to disable.  ``cache_writer=False`` (the
    data-parallel ranks other than 0) waits for another process to write
    the cache.  -> (sampler, cloud, mesh or None)."""
    pc, tris, mesh = _load_inputs(cfg)
    kw = dict(cache_path=_cache_path(cfg), device=device,
              cache_wait_s=0.0 if cache_writer else CACHE_WAIT_S)
    if tris is None:
        sampler = TrainingSampler.from_point_cloud(
            pc.points, pc.normals, cfg.batch_size, cfg.sampling_percentiles, **kw)
    else:
        sampler = TrainingSampler.from_mesh(
            pc.points, pc.normals, tris, cfg.batch_size, cfg.sampling_percentiles, **kw)
    return sampler, pc, mesh


def build_sampler_overlapped(cfg: TrainConfig, device="cuda", cache_writer: bool = True):
    """Like :func:`build_sampler`, but the candidate-grid build runs on a
    host thread while training starts at once on an exact bootstrap oracle
    (:mod:`..data.async_build`).  -> (bootstrap sampler, cloud, mesh or
    None, handle); pass ``handle.poll`` as ``Trainer.run(sampler_update=…)``."""
    pc, tris, mesh = _load_inputs(cfg)
    kw = dict(cache_path=_cache_path(cfg), device=device,
              cache_wait_s=0.0 if cache_writer else CACHE_WAIT_S)
    if tris is None:
        sampler, handle = overlapped_pc_sampler(
            pc.points, pc.normals, cfg.batch_size, cfg.sampling_percentiles, **kw)
    else:
        sampler, handle = overlapped_mesh_sampler(
            pc.points, pc.normals, tris, cfg.batch_size, cfg.sampling_percentiles, **kw)
    return sampler, pc, mesh, handle


def gt_plane_distances(pc, mesh, samples: torch.Tensor, sampler=None) -> torch.Tensor:
    """Unsigned GT distances of the slice plane's samples (for the figure),
    on the samples' device.

    Mesh mode: the training sampler's coordinate table when it holds one
    (the candidate sets the training GT used), else the pruned sweep over
    the mesh's triangles (float32 centroid ranking).  Point-cloud mode: the
    brute nearest-point distance to the full cloud (K5 on CUDA); the pc
    candidate table is not reused, since it has no off-surface exactness
    guarantee (the JAX package measured up to 1.6e-2 plane error with it)."""
    if sampler is not None and sampler.tri_table is not None:
        return point_triangle_distance_table(samples, sampler.tri_table).abs()
    if mesh is not None:
        tris = triangles_from_mesh(mesh.vertices, mesh.faces, device=samples.device)
        return point_triangle_distance_pruned(samples, tris).abs()
    cloud = torch.as_tensor(np.asarray(pc.points, np.float32), device=samples.device)
    return point_cloud_distance(samples, cloud).abs()


def generate_final_meshes(params, spec, cfg: TrainConfig, out_dir: str, stats=None):
    """Final reconstruction(s), reference naming (``train.py:430-448``)."""
    from .generate_mc import run_mc

    algorithm = "both" if cfg.gt_mode == "tanh" else "siren"
    return run_mc(
        params, spec, cfg.gt_mode, cfg.resolution,
        osp.join(out_dir, "mc_mesh_best.obj"), cfg.alpha, algorithm,
        quality=cfg.quality, stats=stats,
    )


def setup_train(cfg: TrainConfig, make_meshes: bool = True, verbose: bool = True,
                resume: bool = False, device="cuda", stats=None,
                overlap_oracle: bool | None = None, n_mesh_devices: int = 0, group=None):
    """Programmatic entry.

    ``n_mesh_devices`` N ≥ 2 trains data-parallel on N ranks
    (:func:`..parallel.mesh.spread` over ``cuda:0..N-1``, or N gloo ranks
    on the CPU; :class:`..train.loop.Trainer` with a group), and raises
    ValueError when ``device`` names a CUDA index other than 0; 1 pins
    ``device``; 0 (the default) takes every visible GPU when ``device`` is
    ``"cuda"``, as the JAX package takes every device, and the one GPU
    ``device`` names otherwise (``"cuda:1"`` trains on cuda:1 alone).
    Batch groups that do not divide N take
    the slower fallback step (a RuntimeWarning).  ``group``: run as this
    rank of a group the caller started.  Rank 0 alone writes the output
    directory, checkpoints, ``losses.csv``, the TensorBoard events, the
    figure and the meshes, and prints; the other ranks return
    ``(training seconds, None, state)``.

    ``resume=True`` continues an interrupted run from
    ``models/train_state.npz`` (params, optimizer state, epoch and key; a
    file written by either package).

    ``overlap_oracle`` (default: on unless ``DIFFUDF_ORACLE_OVERLAP=0``)
    runs the candidate-grid build on a host thread behind the first epochs,
    which train on an exact bootstrap oracle until the swap
    (:mod:`..data.async_build`).

    ``stats``: when given a dict, it receives ``oracle_s`` (loading the
    inputs and building the sampler: with the overlap, only the bootstrap
    sampler), ``oracle_build_s`` (the candidate-grid build: the thread's
    wall time with the overlap), ``swap_epoch`` (the epoch the grid oracle
    took over, None if it never did, or without the overlap),
    ``bootstrap_epochs`` (epochs trained on the bootstrap oracle),
    ``train_s`` and per stage ``<stage>_s`` and ``<stage>_steps`` (chunk
    seconds with the device synchronised at each chunk's end, and updates),
    the figure's seconds under ``figure`` and under ``mesh`` the
    extraction's stats (:func:`.generate_mc.run_mc`).

    Returns ``(training_time_seconds, meshes, state)``:
    ``training_time_seconds`` counts sampler construction (the oracle build
    included, however much of it the overlap did not hide) through the last
    chunk, minus per-chunk callback work, the JAX package's accounting;
    ``meshes`` is the ``(meshMU, meshCAP)`` pair, a mesh in siren mode, or
    None when ``make_meshes`` is off.
    """
    if group is None:
        return spread(setup_train, device, n_mesh_devices, cfg=cfg, make_meshes=make_meshes,
                      verbose=verbose, resume=resume, stats=stats,
                      overlap_oracle=overlap_oracle)
    main_rank = group.rank == 0
    verbose = verbose and main_rank
    if stats is None:
        stats = {}
    full_path = osp.join(".", cfg.checkpoint_path, cfg.experiment_name)
    if main_rank:
        full_path = ckpt.create_output_paths(cfg.checkpoint_path, cfg.experiment_name)
        with open(osp.join(full_path, "params.json"), "w") as fh:
            json.dump(cfg.to_dict(), fh, indent=4)

    if overlap_oracle is None:
        overlap_oracle = os.environ.get("DIFFUDF_ORACLE_OVERLAP", "1") != "0"
    t_pipeline = time.perf_counter()
    handle = None
    if overlap_oracle:
        sampler, pc, mesh, handle = build_sampler_overlapped(cfg, device=device,
                                                             cache_writer=main_rank)
    else:
        sampler, pc, mesh = build_sampler(cfg, device=device, cache_writer=main_rank)
    stats["oracle_s"] = time.perf_counter() - t_pipeline
    spec = cfg.network.to_spec()

    trainer = Trainer(spec, sampler, cfg, group=group)
    state = trainer.init_state()
    start_epoch = 0
    models_dir = osp.join(full_path, "models")
    recon_dir = osp.join(full_path, "reconstructions")
    resume_path = osp.join(models_dir, "train_state.npz")
    if resume and osp.exists(resume_path):
        params, opt_state, start_epoch, key = ckpt.load_train_state(resume_path, spec, device)
        state = trainer.init_state(key=key, params=params)
        state.opt_state = opt_state
        best_path = osp.join(models_dir, "model_best.npz")
        if osp.exists(best_path):
            state.best_params = ckpt.load_params(best_path, device=device)
        if verbose:
            print(f"Resuming from epoch {start_epoch}")
    elif cfg.network.pretrained_dict not in (None, "None", ""):
        params = ckpt.load_params(cfg.network.pretrained_dict, device=device)
        state = trainer.init_state(params=params)

    # losses.csv and the TensorBoard events (summaries/)
    logger = ScalarLogger(full_path, tensorboard=True) if main_rank else None

    def on_chunk(epoch_end, st, logs):
        start = epoch_end - len(logs["epoch_loss"])
        for name, vals in logs.items():
            logger.log_array(name, start, vals)
        ckpt.save_params(osp.join(models_dir, "model_current.npz"), st.params, spec)
        ckpt.save_params(osp.join(models_dir, "model_best.npz"), st.best_params, spec)
        ckpt.save_train_state(osp.join(models_dir, "train_state.npz"),
                              st.params, st.opt_state, epoch_end, st.key)
        if cfg.epochs_to_checkpoint and epoch_end % cfg.epochs_to_checkpoint == 0 \
                and epoch_end < cfg.num_epochs:
            ckpt.save_params(osp.join(models_dir, f"model_{epoch_end}.npz"), st.params, spec)
            if cfg.resolution:
                # periodic reconstruction (reference ``train.py:252-269``);
                # runs in the callback, so it is excluded from train_time
                from .generate_mc import run_mc

                if verbose:
                    print("Generating mesh")
                with torch.no_grad():
                    run_mc(st.params, spec, cfg.gt_mode, cfg.resolution,
                           osp.join(recon_dir, f"mc_mesh_{epoch_end}.obj"), cfg.alpha,
                           "both" if cfg.gt_mode == "tanh" else "siren", quality=cfg.quality)
        if verbose:
            print(f"Epoch: {epoch_end} - Loss: {float(logs['epoch_loss'][-1]):.6f}"
                  f" - Learning Rate: {float(logs['lr'][-1]):.3e}", flush=True)

    state, _, train_time = trainer.run(
        state=state, start_epoch=start_epoch, callback=on_chunk if main_rank else None,
        sampler_update=handle.poll if handle else None)
    pipeline_time = time.perf_counter() - t_pipeline - trainer.callback_seconds
    stats["train_s"] = train_time
    swap = trainer.last_swap_epoch
    stats["swap_epoch"] = swap
    if handle is None:
        stats["oracle_build_s"], stats["bootstrap_epochs"] = stats["oracle_s"], 0
    else:
        stats["bootstrap_epochs"] = (cfg.num_epochs if swap is None else swap) - start_epoch
        # the figure reads the grid oracle if the build ended after training
        sampler = trainer.sampler if swap is not None else (handle.poll() or sampler)
        stats["oracle_build_s"] = handle.build_seconds
        if verbose:
            if swap is not None:
                print(f"GT oracle table swapped in at epoch {swap} (build "
                      f"{handle.build_seconds:.1f}s, hidden behind training)")
            else:
                print("GT oracle build outlasted training, or failed; the run completed on "
                      "the exact bootstrap oracle")
    for lo, hi, stage, secs in trainer.chunk_seconds:
        stats[f"{stage}_s"] = stats.get(f"{stage}_s", 0.0) + secs
        stats[f"{stage}_steps"] = stats.get(f"{stage}_steps", 0) + (hi - lo) * cfg.batches_per_epoch
    if not main_rank:
        return pipeline_time, None, state

    # losses.csv (reference ``train.py:394-395``; ';' separator)
    logger.flush_csv("losses.csv", exclude=("lr", "epoch_loss"))
    logger.close()
    ckpt.save_params(osp.join(models_dir, "model_final.npz"), state.params, spec)

    if verbose:
        print("Generating distance field slices")
    stats["figure"] = slice_figure(state.best_params, spec,
                                   lambda samples: gt_plane_distances(pc, mesh, samples, sampler),
                                   cfg.gt_mode, cfg.alpha, SLICE_WIDTH, recon_dir)

    meshes = None
    if make_meshes and cfg.resolution:
        if verbose:
            print("Generating mesh")
        stats["mesh"] = {}
        meshes = generate_final_meshes(state.best_params, spec, cfg, recon_dir, stats["mesh"])
    return pipeline_time, meshes, state


def main(argv=None):
    """Run the CLI; -> (what :func:`setup_train` returns, its ``stats``)."""
    parser = argparse.ArgumentParser(
        usage="python -m diffudf_tpu_torch.cli.train path_to_experiment.json [device]")
    parser.add_argument("experiment_path", type=str)
    parser.add_argument("device_ordinal", type=int, nargs="?", default=None,
                        help="CUDA device ordinal: train on that GPU alone (default: every "
                             "visible GPU, or the --mesh N first ones)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from models/train_state.npz")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for a run without a GPU)")
    parser.add_argument("--mesh", type=int, default=0, metavar="N",
                        help="data-parallel training on N ranks (cuda:0..N-1, or N CPU "
                             "ranks with --device cpu); N=1 pins one device. Default: "
                             "every visible GPU, or the one device_ordinal names.")
    args = parser.parse_args(argv)
    cfg = TrainConfig.from_json(args.experiment_path)
    # float32 means float32: no TF32 rounding of matmul or convolution inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = args.device
    if device == "cuda" and args.device_ordinal is not None:
        device = f"cuda:{args.device_ordinal}"
    stats = {}
    result = setup_train(cfg, resume=args.resume, device=device, stats=stats,
                         n_mesh_devices=args.mesh)
    if int(os.environ.get("RANK", "0")) == 0:  # one line under torchrun
        print(f"Training time (incl. GT-oracle build): {result[0]:.1f}s")
        print("Stats: " + json.dumps(stats))
    return result, stats


if __name__ == "__main__":
    main()
