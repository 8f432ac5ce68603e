"""Platform-numerics fingerprint for result provenance: the torch
counterpart of ``diffudf_tpu/utils/drift.py``.

3000 chaotic training epochs amplify ULP-level differences (kernel builds,
library versions, the card) into a different, equally converged minimum,
so normal-consistency endpoints of full runs carry a platform band.
``fingerprint()`` makes the band observable in seconds: a deterministic
200-epoch stage-1 run on a synthetic sphere cloud through the port's
Trainer (the kernels K1, K2, K3a and K3b on the GPU), whose final loss and
parameter checksum are bit-stable on a fixed platform.  ``cli.quantitative``
stamps every ``results.csv`` with it (sidecar ``results_provenance.json``),
with the torch and CUDA versions and the GPU's name in place of the JAX
package's service fields.
"""

from __future__ import annotations

import datetime


def fingerprint(epochs: int = 200, batch: int = 30000, device="cuda") -> dict:
    """-> provenance record {date, platform, device, torch, cuda, epochs,
    final_loss, param_sum}."""
    import numpy as np
    import torch

    from ..config import TrainConfig
    from ..data.sampling import TrainingSampler
    from ..fields.siren import SirenSpec
    from ..train.loop import Trainer

    rng = np.random.default_rng(7)
    pts = rng.normal(size=(20000, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    normals = pts.copy()
    pts = (0.7 * pts).astype(np.float32)

    cfg = TrainConfig(num_epochs=epochs, s1_epochs=epochs, warmup_epochs=0, batch_size=batch,
                      alpha=10.0, seed=123, lr_s1=1e-5, lr_s2=1e-7)
    spec = SirenSpec(hidden=(256,) * 8)
    sampler = TrainingSampler.from_point_cloud(pts, normals, cfg.batch_size,
                                               cfg.sampling_percentiles, device=device)
    state, _, _ = Trainer(spec, sampler, cfg).run()
    param_sum = float(sum(t.detach().double().sum().item()
                          for layer in state.best_params for t in layer.values()))
    dev = torch.device(device)
    return {
        "date": datetime.date.today().isoformat(),
        "platform": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "epochs": epochs,
        "final_loss": float(state.best_loss),
        "param_sum": param_sum,
    }
