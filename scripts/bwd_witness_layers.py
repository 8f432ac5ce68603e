#!/usr/bin/env python
"""K2's and K3b's distance from the float64 plain version, layer by layer,
on the torus that ``chip_smoke.py`` phase 7 trains, with phase 8's inputs
(a batch of the run's sampler and the s1 loss's own cotangents):

    python scripts/bwd_witness_layers.py

Trains the 3000-epoch torus recipe through ``cli.train.main`` (about a
minute on an H100) in a temporary directory, then prints, for every
layer's b and W, the largest float64 value and the kernel's and the
float32 plain version's largest distance from it, and the ratio of their
RMS distances: the per-layer view of ``chip_smoke.py``'s WITNESS gate,
which holds the flat gradient's max and RMS ratios to 2.0.
"""

import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main():
    chip_smoke.device_phase()
    chip_smoke.build_phase()
    from diffudf_tpu_torch.cli import train
    from diffudf_tpu_torch.config import TrainConfig
    from diffudf_tpu_torch.ops import vg, vgh
    from diffudf_tpu_torch.train.losses import loss_s1

    with tempfile.TemporaryDirectory() as tmp:
        run = chip_smoke.train_phase(tmp)
        params = run["params"]
        cfg = TrainConfig.from_json(run["cfg_path"])
        spec = cfg.network.to_spec()
        sampler, _, _ = train.build_sampler(cfg)
        pts, nrm, sdf = sampler.sample(torch.Generator(device="cuda").manual_seed(7))
        n_on = sampler.sizes.on_surface
        surf, off = pts[:n_on].contiguous(), pts[n_on:].contiguous()
        outs = [t.detach().clone().requires_grad_(True) for t in
                vgh.vgh_reference(params, spec, surf) + vg.vg_reference(params, spec, off)]
        terms = loss_s1(params, spec, pts, nrm, sdf, cfg.loss_s1_weights, cfg.alpha,
                        n_surface=n_on, vgh_fn=lambda *a: tuple(outs[:3]),
                        vg_fn=lambda *a: tuple(outs[3:]))
        cf, cg, ch, cfo, cgo = torch.autograd.grad(sum(terms.values()), outs)
        cot16 = torch.cat([cf[:, None], cg, ch, torch.zeros_like(ch)], dim=1).contiguous()
        cot8 = torch.cat([cfo[:, None], cgo, torch.zeros_like(cfo)[:, None].expand(-1, 4)],
                         dim=1).contiguous()
        p64 = [{k: v.double() for k, v in layer.items()} for layer in params]
        for name, fn, plain, x, cot in (("K2", vgh.vgh_bwd, vgh.vgh_bwd_reference, surf, cot16),
                                        ("K3b", vg.vg_bwd, vg.vg_bwd_reference, off, cot8)):
            got, want = fn(params, spec, x, cot), plain(params, spec, x, cot)
            exact = plain(p64, spec, x.double(), cot.double())
            torch.cuda.synchronize()
            for i, (g, w, e) in enumerate(zip(got, want, exact)):
                for k in ("b", "w"):
                    e_k, e_p = (g[k].double() - e[k]).abs(), (w[k].double() - e[k]).abs()
                    rms = float(e_k.square().mean().sqrt() / e_p.square().mean().sqrt())
                    print(f"{name} layer {i} {k}: max |float64| {float(e[k].abs().max()):.3e}; "
                          f"kernel / plain max {float(e_k.max()):.3e} / {float(e_p.max()):.3e} "
                          f"({float(e_k.max() / e_p.max()):.2f}); RMS ratio {rms:.2f}", flush=True)


if __name__ == "__main__":
    main()
