from .siren import Siren, SirenSpec, init_siren, params_from_jax, params_to_jax, siren_apply
from .transforms import gt_grad_norm, gt_transform, inverse_map

__all__ = [
    "Siren",
    "SirenSpec",
    "init_siren",
    "params_from_jax",
    "params_to_jax",
    "siren_apply",
    "gt_transform",
    "gt_grad_norm",
    "inverse_map",
]
