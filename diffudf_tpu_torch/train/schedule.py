"""Learning-rate schedule: warmup → stage-1 constant → stage-2 cosine decay.
The torch counterpart of ``diffudf_tpu/train/schedule.py``, in float32 as
there.

Reference semantics (``train.py:167-191``):
  * epoch < warmup_epochs:            lr = warmup_lr
  * warmup_epochs ≤ epoch < s1_epochs: lr = lr_s1
  * epoch ≥ s1_epochs:                lr = lr_s2 · ½(1 + cos(π·t)),
    t = (epoch − s1_epochs)/(num_epochs − s1_epochs) ∈ [0, 1]

The stage-2 formula is the intended cosine decay over t ∈ [0, 1], with the
same endpoint values as the reference's absolute-epoch form (see the JAX
module).  ``epoch`` may be an int or a tensor; the result is a float32
tensor of its shape.
"""

from __future__ import annotations

import math

import torch


def _f32(epoch):
    return torch.as_tensor(epoch, dtype=torch.float32)


def lr_for_epoch(
    epoch,
    *,
    num_epochs: int,
    s1_epochs: int,
    warmup_epochs: int,
    warmup_lr: float,
    lr_s1: float,
    lr_s2: float,
):
    epoch = _f32(epoch)
    base = torch.where(epoch < warmup_epochs, _f32(warmup_lr), _f32(lr_s1))
    s2_span = max(num_epochs - s1_epochs, 1)
    t = torch.clamp((epoch - s1_epochs) / s2_span, 0.0, 1.0)
    cosine = 0.5 * (1.0 + torch.cos(math.pi * t)) * lr_s2
    return torch.where(epoch >= s1_epochs, cosine, base)


def lr_for_epoch_siren(epoch, *, warmup_epochs: int, warmup_lr: float, lr: float):
    """Single-stage siren schedule (``train.py:44-54``)."""
    epoch = _f32(epoch)
    return torch.where(epoch < warmup_epochs, _f32(warmup_lr), _f32(lr))
