"""The plain reference against the port's CPU path on a tiny net and batch:
the normalised mesh and the cloud on it, the oracle distances, the SIREN's
value and derivatives, the s1 and s2 terms, their gradients and the Adam
update, and one run of the checked steps of each stage on each oracle
held to the cell's limits."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from bench_tiny import CELLS, REPO, tiny_cell

from benchmark import checks, reference
from benchmark.drivers import train
from diffudf_tpu_torch.autodiff.ops import hess_from_packed, value, value_grad_hessian_packed
from diffudf_tpu_torch.data.mesh_distance import point_cloud_distance, point_triangle_distance
from diffudf_tpu_torch.fields.siren import SirenSpec
from diffudf_tpu_torch.train.checkpoint import AdamState
from diffudf_tpu_torch.train.loop import adam_update
from diffudf_tpu_torch.train.losses import loss_s1, loss_s2

SPEC = SirenSpec(hidden=(32, 32, 32), w0=30.0)


def _params(seed=0):
    return train.init_params(SPEC.hidden, SPEC.w0, seed, "cpu")


def _pairs(params):
    return [(layer["w"], layer["b"]) for layer in params]


def test_cloud_distance_matches_the_port():
    g = torch.Generator().manual_seed(1)
    cloud, q = torch.rand((2000, 3), generator=g) * 2 - 1, torch.rand((300, 3), generator=g) * 2 - 1
    ours = reference.cloud_distance(q, cloud).float()
    torch.testing.assert_close(ours, point_cloud_distance(q, cloud), rtol=0, atol=2e-7)


def test_triangle_distance_matches_the_port():
    g = torch.Generator().manual_seed(2)
    tris = torch.rand((64, 3, 3), generator=g) * 1.6 - 0.8
    q = torch.rand((500, 3), generator=g) * 2 - 1
    ours = reference.triangle_distance(q, tris).float()
    torch.testing.assert_close(ours, point_triangle_distance(q, tris), rtol=0, atol=1e-6)
    # a query's distance to a triangle it lies on is 0; to its vertex plane
    # beyond the vertex, the vertex distance
    t = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]])
    pts = torch.tensor([[0.2, 0.2, 0.0], [0.2, 0.2, 0.5], [-1.0, -1.0, 0.0], [2.0, 0.0, 0.0]])
    torch.testing.assert_close(reference.triangle_distance(pts, t).float(),
                               torch.tensor([0.0, 0.5, 2 ** 0.5, 1.0]))


def test_siren_derivatives_match_the_port():
    params = _params()
    x = torch.rand((200, 3), generator=torch.Generator().manual_seed(3)) * 2 - 1
    f, g, hm = reference.siren_derivatives(_pairs(params), x, SPEC.w0, hessian=True)
    pf, pg, ph6 = value_grad_hessian_packed(params, SPEC, x)
    torch.testing.assert_close(f, pf, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(g, pg, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(hm, hess_from_packed(ph6), rtol=1e-4, atol=5e-2)
    f2, g2, none = reference.siren_derivatives(_pairs(params), x, SPEC.w0, hessian=False)
    assert none is None
    torch.testing.assert_close(f2, f) and torch.testing.assert_close(g2, g)


def _batch(n_on=60, n_off=120, seed=4):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((n_on + n_off, 3), generator=g) * 2 - 1
    nrm = torch.nn.functional.normalize(torch.randn((n_on + n_off, 3), generator=g), dim=1)
    nrm[n_on:] = 0
    sdf = torch.cat([torch.zeros(n_on), torch.rand(n_off, generator=g) * 0.5])[:, None]
    return pts, nrm, sdf, n_on


def test_s1_terms_gradient_and_adam_match_the_port():
    params = _params(5)
    pts, nrm, sdf, n_on = _batch()
    weights, alpha = (1e4, 1e4, 1e4, 1e3), 10.0
    leaves = [t.clone().requires_grad_(True) for t in train.leaves(params)]
    terms, grads = reference.s1_loss_and_grad(leaves, pts, nrm, sdf, n_on, weights, alpha,
                                              SPEC.w0)
    p = [{"w": leaves[2 * i].detach().clone().requires_grad_(True),
          "b": leaves[2 * i + 1].detach().clone().requires_grad_(True)} for i in range(4)]
    port = loss_s1(p, SPEC, pts, nrm, sdf, weights, alpha, n_surface=n_on)
    port_terms = torch.stack([port[k] for k in ("sdf_on_surf", "sdf_off_surf",
                                                "hessian_constraint", "grad_constraint")])
    np.testing.assert_allclose(terms.numpy(), port_terms.detach().double().numpy(), rtol=2e-5)
    port_grads = torch.autograd.grad(port_terms.sum(), train.leaves(p))
    for a, b in zip(grads, port_grads):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3 * float(b.abs().max()))
    # one Adam step of each from the same state and gradient
    zeros = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in p]
    adam_update(p, port_grads, AdamState(0, zeros, [{k: v.clone() for k, v in z.items()}
                                                     for z in zeros]), 1e-4)
    moments = [(torch.zeros_like(t), torch.zeros_like(t)) for t in leaves]
    reference.adam_step(leaves, port_grads, moments, 1, 1e-4, 0.9, 0.999, 1e-8)
    for a, b in zip(leaves, train.leaves(p)):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=3e-7, atol=1e-9)  # an ulp


def test_s2_terms_and_gradient_match_the_port():
    params = _params(6)
    pts, nrm, sdf, n_on = _batch(seed=7)
    weights = (1e5, 1e5)
    leaves = [t.clone().requires_grad_(True) for t in train.leaves(params)]
    terms, grads = reference.s2_loss_and_grad(leaves, pts, sdf, weights, SPEC.w0)
    torch.testing.assert_close(reference.siren_value(_pairs(params), pts, SPEC.w0),
                               value(params, SPEC, pts), rtol=1e-5, atol=1e-6)
    p = [{"w": leaves[2 * i].detach().clone().requires_grad_(True),
          "b": leaves[2 * i + 1].detach().clone().requires_grad_(True)} for i in range(4)]
    port = loss_s2(p, SPEC, pts, nrm, sdf, weights, 100.0)
    port_terms = torch.stack([port["sdf_on_surf"], port["std_on_surf"]])
    np.testing.assert_allclose(terms.numpy(), port_terms.detach().double().numpy(), rtol=2e-5)
    port_grads = torch.autograd.grad(port_terms.sum(), train.leaves(p))
    for a, b in zip(grads, port_grads):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4 * float(b.abs().max()))


def test_the_recipes_learning_rate():
    r = train.recipe(tiny_cell(CELLS[0]).config)
    assert reference.learning_rate(r, 0) == r["warmup_lr"] == 1e-4
    assert reference.learning_rate(r, 1999) == r["lr_s1"] == 1e-5
    assert reference.learning_rate(r, 2000) == pytest.approx(1e-7, rel=1e-12)
    assert reference.learning_rate(r, 2500) == pytest.approx(0.5e-7, rel=1e-9)
    assert reference.learning_rate(r, 2999) == pytest.approx(0.0, abs=1e-12)


def test_the_reference_normalises_the_mesh_and_holds_the_cloud_to_it(tmp_path):
    """The program's preprocessed mesh is the reference's normalisation of
    the source to the digits it writes; its cloud lies on that mesh, each
    point with its triangle's normal; a cloud moved off the mesh, or with
    a normal turned, reads far off."""
    from diffudf_tpu_torch.cli.preprocess import preprocess_mesh

    src = os.path.join(REPO, "benchmark", "data", "torus.obj")
    name = preprocess_mesh(str(tmp_path), src, 2000, seed=5)
    ours = reference.normalized_triangles(src)
    theirs = reference.read_obj_triangles(str(tmp_path / (name + "_t.obj")))
    assert np.abs(theirs - ours).max() < 1e-8
    pts, nrm = reference.read_ply_points(str(tmp_path / (name + "_pc.ply")))
    pts, nrm, tris = torch.as_tensor(pts), torch.as_tensor(nrm), torch.as_tensor(ours)
    assert float(reference.cloud_off_mesh(pts, nrm, tris).max()) < 1e-6
    moved = reference.cloud_off_mesh(pts + torch.tensor([1e-3, 0, 0]), nrm, tris)
    assert float(moved.max()) > 5e-4
    turned = nrm.clone()
    turned[0] = torch.nn.functional.normalize(nrm[0] + torch.tensor([0.0, 0.0, 0.1]), dim=0)
    assert float(reference.cloud_off_mesh(pts[:1], turned[:1], tris)[0]) > 1e-3


@pytest.mark.parametrize("name", CELLS)
def test_checked_steps_hold_to_the_reference(name):
    """The driver's checked steps on the tiny cell, on the cell's oracle,
    against the reference: every number within the cell's limit."""
    cell = tiny_cell(name)
    prep = train.prepare(cell, "cpu")
    assert prep.sampler.oracle == ("pointcloud" if "pc" in name else "mesh")
    _, _, _, epoch, first = train.start(cell, prep, 2**31 + 77, "cpu")
    assert epoch == cell.traffic["first_epoch"] + train.CHECKED_STEPS
    data, data_gap = train.reference_data(cell, prep, "cpu")
    ref_b, ref = train.reference_steps(cell, data, first, "cpu")
    numbers = checks.gaps(dataclasses.asdict(first), ref, first.batches, ref_b,
                          cell.traffic["stage"])
    numbers["data_gap"] = data_gap
    assert numbers["batch_gap"] == 0.0 and data_gap < 1e-6
    ok, table = checks.verdict(numbers, cell.limits)
    assert ok, table
