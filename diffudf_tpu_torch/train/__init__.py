"""Losses, the learning-rate schedule, the trainer and its checkpoint
files (the JAX package's ``train`` names)."""

from . import checkpoint
from .loop import Trainer, TrainState
from .losses import loss_s1, loss_s2, loss_siren
from .schedule import lr_for_epoch

__all__ = [
    "loss_s1",
    "loss_s2",
    "loss_siren",
    "lr_for_epoch",
    "TrainState",
    "Trainer",
    "checkpoint",
]
