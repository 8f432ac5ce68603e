"""CLI: train a DUDF field from a preprocessed point cloud, on the GPU.

The torch counterpart of ``diffudf_tpu/cli/train.py``:

    python -m diffudf_tpu_torch.cli.train <config.json> [device_ordinal] [--resume] [--device cpu]

``setup_train`` follows the JAX package's pipeline: output dirs and
``params.json``, the sampler and its oracle, staged training, per-chunk
checkpoints (best / current / periodic), ``losses.csv``, the final model,
the slice figure of the best params at width 512 (``distance_fields.png``
and ``pred_grad.png``: one K1 launch, and the brute nearest-point distance
of the plane to the cloud, one K5 launch) and the final marching-cubes
reconstructions (``cli/generate_mc.py::run_mc``).  Point-cloud input
(``"onlyPCloud": true``) only: the mesh-input oracle, the overlapped oracle
build and data parallelism are not ported yet, and a mesh-mode config
raises NotImplementedError.
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
from ..data.mesh_distance import point_cloud_distance
from ..data.mesh_io import load_point_cloud
from ..data.sampling import TrainingSampler
from ..train import checkpoint as ckpt
from ..train.loop import Trainer
from ..utils.metrics import ScalarLogger
from .generate_df import slice_figure

SLICE_WIDTH = 512  # the figure's plane samples a side (JAX ``train.py:287-292``)


def build_sampler(cfg: TrainConfig, device="cuda"):
    """Load ``<dataset>_pc.ply`` and build the point-cloud sampler.

    The one-shot candidate-grid oracle build is cached on disk next to the
    preprocessed asset (``<dataset>_oracle_cache.npz.pc_cand.npz``, content
    hashed, shared with the JAX package; see :mod:`..data.oracle_cache`).
    Set ``DIFFUDF_ORACLE_CACHE=0`` to disable.  -> (sampler, cloud)."""
    if not cfg.only_pcloud:
        raise NotImplementedError(
            "mesh-input training (the triangle oracle) is not ported yet: set "
            "\"onlyPCloud\": true (ROADMAP.md, 'Modules to port', item 'Mesh-input oracle')")
    cache = cfg.dataset + "_oracle_cache.npz"
    if os.environ.get("DIFFUDF_ORACLE_CACHE", "1") == "0":
        cache = None
    pc = load_point_cloud(cfg.dataset + "_pc.ply")
    if pc.normals is None:
        raise ValueError(f"{cfg.dataset}_pc.ply has no normals")
    sampler = TrainingSampler.from_point_cloud(
        pc.points, pc.normals, cfg.batch_size, cfg.sampling_percentiles,
        cache_path=cache, device=device,
    )
    return sampler, pc


def gt_plane_distances(cfg: TrainConfig, pc, samples: torch.Tensor) -> torch.Tensor:
    """Unsigned GT distances of the slice plane's samples (for the figure),
    on the samples' device.

    pc mode: the brute nearest-point distance to the full cloud (K5 on
    CUDA), as the JAX package's pc branch; the pc-mode candidate table is
    not reused, since it has no off-surface exactness guarantee (the JAX
    package measured up to 1.6e-2 plane error with it).  The mesh branches
    (the triangle table, the pruned sweep) wait for the mesh-input oracle."""
    if not cfg.only_pcloud:
        raise NotImplementedError(
            "the mesh-input slice distances are not ported yet (ROADMAP.md, "
            "'Modules to port', item 'Mesh-input oracle')")
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
                resume: bool = False, device="cuda", stats=None):
    """Programmatic entry.

    ``resume=True`` continues an interrupted run from
    ``models/train_state.npz`` (params, optimizer state, epoch and key; a
    file written by either package).

    ``stats``: when given a dict, it receives ``oracle_s`` (sampler and
    oracle build), ``train_s`` and per stage ``<stage>_s`` and
    ``<stage>_steps`` (chunk seconds with the device synchronised at each
    chunk's end, and updates), and under ``mesh`` the extraction's stats
    (:func:`.generate_mc.run_mc`).

    Returns ``(training_time_seconds, meshes, state)``:
    ``training_time_seconds`` counts sampler construction (the oracle build
    included) through the last chunk, minus per-chunk callback work,
    the JAX package's accounting; ``meshes`` is the ``(meshMU, meshCAP)``
    pair, a mesh in siren mode, or None when ``make_meshes`` is off.
    """
    if stats is None:
        stats = {}
    full_path = ckpt.create_output_paths(cfg.checkpoint_path, cfg.experiment_name)
    with open(osp.join(full_path, "params.json"), "w") as fh:
        json.dump(cfg.to_dict(), fh, indent=4)

    t_pipeline = time.perf_counter()
    sampler, pc = build_sampler(cfg, device=device)
    stats["oracle_s"] = time.perf_counter() - t_pipeline
    spec = cfg.network.to_spec()

    trainer = Trainer(spec, sampler, cfg)
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

    # losses.csv only: TensorBoard event files are not written
    logger = ScalarLogger(full_path, tensorboard=False)

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

    state, _, train_time = trainer.run(state=state, start_epoch=start_epoch, callback=on_chunk)
    pipeline_time = time.perf_counter() - t_pipeline - trainer.callback_seconds
    stats["train_s"] = train_time
    for lo, hi, stage, secs in trainer.chunk_seconds:
        stats[f"{stage}_s"] = stats.get(f"{stage}_s", 0.0) + secs
        stats[f"{stage}_steps"] = stats.get(f"{stage}_steps", 0) + (hi - lo) * cfg.batches_per_epoch

    # losses.csv (reference ``train.py:394-395``; ';' separator)
    logger.flush_csv("losses.csv", exclude=("lr", "epoch_loss"))
    logger.close()
    ckpt.save_params(osp.join(models_dir, "model_final.npz"), state.params, spec)

    if verbose:
        print("Generating distance field slices")
    stats["figure"] = slice_figure(state.best_params, spec,
                                   lambda samples: gt_plane_distances(cfg, pc, samples),
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
    parser.add_argument("device_ordinal", type=int, nargs="?", default=0,
                        help="CUDA device ordinal (reference-CLI parity)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from models/train_state.npz")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for a run without a GPU)")
    args = parser.parse_args(argv)
    cfg = TrainConfig.from_json(args.experiment_path)
    # float32 means float32: no TF32 rounding of matmul or convolution inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = f"cuda:{args.device_ordinal}" if args.device == "cuda" else args.device
    stats = {}
    result = setup_train(cfg, resume=args.resume, device=device, stats=stats)
    print(f"Training time (incl. GT-oracle build): {result[0]:.1f}s")
    print("Stats: " + json.dumps(stats))
    return result, stats


if __name__ == "__main__":
    main()
