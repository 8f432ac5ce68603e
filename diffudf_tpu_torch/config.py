"""Typed experiment configuration, JSON-compatible with the reference schemas:
the torch package's copy of ``diffudf_tpu/config.py``, with the same keys and
defaults.

``deriv_dtype`` and ``use_pallas`` are accepted and have no effect here: the
training path always runs the fused f32 kernels (K1/K2 on the surface rows,
K3a/K3b on the others) on a GPU and their plain versions on the CPU, as the
JAX package's TPU path never reads ``deriv_dtype``.

The reference drives everything through raw JSON dicts + scattered ``.get()``
defaults (``train.py:285-356``, ``configs/*.json``).  Here the same keys load
into a frozen dataclass so every consumer sees one typed object; defaults
match the reference's (``warmup_epochs=0``, ``warmup_lr=1e-4``,
``resolution=256``, ``activation='sine'`` …).
"""

from __future__ import annotations

import dataclasses
import json

from .fields.siren import SirenSpec


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    hidden_layer_nodes: tuple = (256,) * 8
    w0: float = 30.0
    ww: float | None = None
    pretrained_dict: str = "None"
    activation: str = "sine"

    def to_spec(self) -> SirenSpec:
        return SirenSpec(
            n_in=3,
            n_out=1,
            hidden=tuple(self.hidden_layer_nodes),
            w0=self.w0,
            ww=self.ww,
            activation=self.activation,
        )


QUALITY_NAMES = ("parity", "default", "enhanced")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    dataset: str = ""
    experiment_name: str = "experiment"
    checkpoint_path: str = "results"
    num_epochs: int = 3000
    s1_epochs: int = 2000
    warmup_epochs: int = 0
    warmup_lr: float = 1e-4
    batch_size: int = 30000
    sampling_percentiles: tuple = (0.333, 0.666)
    batches_per_epoch: int = 1
    epochs_to_checkpoint: int = 0
    gt_mode: str = "tanh"
    loss_s1_weights: tuple = (1e4, 1e4, 1e4, 1e3)
    loss_s2_weights: tuple = (1e5, 1e5)
    loss_weights: tuple = (3e3, 1e2, 1e2, 5e1)  # siren-mode weights
    alpha: float = 1.0
    optimizer_type: str = "adam"
    lr_s1: float = 1e-5
    lr_s2: float = 1e-7
    lr: float = 1e-4  # siren-mode lr
    network: NetworkConfig = dataclasses.field(default_factory=NetworkConfig)
    resolution: int = 256
    only_pcloud: bool = False
    seed: int = 123
    # extraction quality preset for the post-train reconstructions:
    # "parity" (reference-exact extraction), "default" (shipping cleanup
    # knobs), "enhanced" (N>=385 + vertex reprojection + Taubin 10) — see
    # cli.generate_mc.QUALITY_PRESETS (whose keys must stay in sync with
    # QUALITY_NAMES below; validated at parse time so a typo fails before
    # the training run, not after it)
    quality: str = "default"

    def __post_init__(self):
        if self.quality not in QUALITY_NAMES:
            raise ValueError(
                f"Invalid quality {self.quality!r}; expected one of "
                f"{QUALITY_NAMES}"
            )

    # the JAX package's switches for its XLA path (bf16 derivative carries)
    # and its Pallas kernels; kept for the schema, read by nothing here
    deriv_dtype: str = "bfloat16"
    use_pallas: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        """Load a reference-schema JSON dict (``configs/train_cfg.json``)."""
        net = d.get("network", {})
        opt = d.get("optimizer", {})
        return cls(
            dataset=d.get("dataset", ""),
            experiment_name=d.get("experiment_name", "experiment"),
            checkpoint_path=d.get("checkpoint_path", "results"),
            num_epochs=d.get("num_epochs", 3000),
            s1_epochs=d.get("s1_epochs", 2000),
            warmup_epochs=d.get("warmup_epochs", 0),
            warmup_lr=d.get("warmup_lr", 1e-4),
            batch_size=d.get("batch_size", 30000),
            sampling_percentiles=tuple(d.get("sampling_percentiles", (0.333, 0.666))),
            batches_per_epoch=d.get("batches_per_epoch", 1),
            epochs_to_checkpoint=d.get("epochs_to_checkpoint", 0),
            gt_mode=d.get("gt_mode", "tanh"),
            loss_s1_weights=tuple(d.get("loss_s1_weights", (1e4, 1e4, 1e4, 1e3))),
            loss_s2_weights=tuple(d.get("loss_s2_weights", (1e5, 1e5))),
            loss_weights=tuple(d.get("loss_weights", (3e3, 1e2, 1e2, 5e1))),
            alpha=d.get("alpha", 1.0),
            optimizer_type=opt.get("type", "adam"),
            lr_s1=opt.get("lr_s1", 1e-5),
            lr_s2=opt.get("lr_s2", 1e-7),
            lr=opt.get("lr", 1e-4),
            network=NetworkConfig(
                hidden_layer_nodes=tuple(net.get("hidden_layer_nodes", (256,) * 8)),
                w0=net.get("w0", 30.0),
                ww=net.get("ww", None),
                pretrained_dict=net.get("pretrained_dict", "None"),
                activation=net.get("activation", "sine"),
            ),
            resolution=d.get("resolution", 256),
            only_pcloud=d.get("onlyPCloud", False),
            seed=d.get("seed", 123),
            deriv_dtype=d.get("deriv_dtype", "bfloat16"),
            quality=d.get("quality", "default"),
        )

    @classmethod
    def from_json(cls, path: str) -> "TrainConfig":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    def to_dict(self) -> dict:
        """Back to the reference JSON schema (for params.json provenance)."""
        return {
            "dataset": self.dataset,
            "experiment_name": self.experiment_name,
            "checkpoint_path": self.checkpoint_path,
            "num_epochs": self.num_epochs,
            "s1_epochs": self.s1_epochs,
            "warmup_epochs": self.warmup_epochs,
            "warmup_lr": self.warmup_lr,
            "batch_size": self.batch_size,
            "sampling_percentiles": list(self.sampling_percentiles),
            "batches_per_epoch": self.batches_per_epoch,
            "epochs_to_checkpoint": self.epochs_to_checkpoint,
            "gt_mode": self.gt_mode,
            "loss_s1_weights": list(self.loss_s1_weights),
            "loss_s2_weights": list(self.loss_s2_weights),
            "loss_weights": list(self.loss_weights),
            "alpha": self.alpha,
            "optimizer": {
                "type": self.optimizer_type,
                "lr_s1": self.lr_s1,
                "lr_s2": self.lr_s2,
                "lr": self.lr,
            },
            "network": {
                "hidden_layer_nodes": list(self.network.hidden_layer_nodes),
                "w0": self.network.w0,
                "ww": self.network.ww,
                "pretrained_dict": self.network.pretrained_dict,
                "activation": self.network.activation,
            },
            "resolution": self.resolution,
            "onlyPCloud": self.only_pcloud,
            "seed": self.seed,
            "quality": self.quality,
        }
