"""Ground-truth field transforms g(d) and their inverses d = g⁻¹(f): the
torch counterpart of ``diffudf_tpu/fields/transforms.py``.

  * ``tanh``:    g(d) = d·tanh(α·d)          |∇g| = tanh(αd) + αd(1-tanh²(αd))
  * ``squared``: g(d) = α·d²                 |∇g| = 2αd
  * ``siren``:   g(d) = d (signed SDF)       |∇g| = 1

``inverse_map`` maps a predicted field value back to a Euclidean step length
(reference ``src/inverses.py:3-22``), with the JAX package's one deviation:
for ``tanh`` the square root's argument is clamped to 0 instead of going NaN.
"""

from __future__ import annotations

import torch

VALID_MODES = ("tanh", "squared", "siren")


def _check(mode: str):
    if mode not in VALID_MODES:
        raise ValueError(f"gt_mode must be one of {VALID_MODES}, got {mode!r}")


def gt_transform(mode: str, d, alpha: float):
    """g(d): the target field value at ground-truth distance d."""
    _check(mode)
    if mode == "tanh":
        return d * torch.tanh(alpha * d)
    if mode == "squared":
        return alpha * d * d
    return d


def gt_grad_norm(mode: str, d, alpha: float):
    """|∇g|(d): target gradient norm at distance d (d taken as unsigned)."""
    _check(mode)
    if mode == "tanh":
        t = torch.tanh(alpha * d)
        return torch.abs(t + alpha * d * (1.0 - t * t))
    if mode == "squared":
        return 2.0 * alpha * d
    return torch.ones_like(d)


def inverse_map(mode: str, f, alpha: float, min_step: float = 0.01):
    """Euclidean step length from a predicted field value f."""
    _check(mode)
    if mode == "tanh":
        safe = torch.sqrt(torch.clamp(f, min=0.0) / alpha)
        return torch.where(f < 1.0 / alpha, safe, f)
    if mode == "squared":
        fill = torch.full_like(f, min_step)
        return torch.where(f > 0, torch.sqrt(torch.clamp(f, min=0.0)), fill) / alpha ** 0.5
    return torch.where(f > 0, f, torch.full_like(f, min_step))
