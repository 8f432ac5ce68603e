"""Port parity: the render slice of ``diffudf_tpu_torch`` — camera, shading
and its RdYlBu colormap, curvature, the sphere tracer, hit attributes and
the ``generate_st`` CLI — against the JAX package and the reference goldens
in ``tests/golden/``, on shared numpy inputs, on the CPU.

There the march takes the plain value (exact ``torch.sin``, as the JAX XLA
march on the CPU) and the hit attributes the plain Taylor-mode functions;
K4 and K1 are held against their plain versions on a GPU
(tests/test_torch_cuda.py)."""

import json
import os.path as osp
import re

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from diffudf_tpu.autodiff import curvature as jcurv
from diffudf_tpu.cli import generate_st as jst
from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
from diffudf_tpu.render import camera as jcam
from diffudf_tpu.render import tracer as jtr
from diffudf_tpu_torch.autodiff import curvature as tcurv
from diffudf_tpu_torch.autodiff.ops import value_grad_hessian_packed
from diffudf_tpu_torch.cli import generate_st as tst
from diffudf_tpu_torch.fields.siren import SirenSpec
from diffudf_tpu_torch.render import camera as tcam
from diffudf_tpu_torch.render import png, shading
from diffudf_tpu_torch.render import tracer as ttr
from diffudf_tpu_torch.train.checkpoint import save_params

torch.set_num_threads(2)

GOLDEN = osp.join(osp.dirname(__file__), "golden")


def _golden_field(name):
    """(golden arrays, torch params, torch spec, jax params, jax spec)."""
    g = np.load(osp.join(GOLDEN, name))
    n = sum(1 for k in g.files if re.fullmatch(r"w\d+", k))
    np_params = [{"w": g[f"w{i}"], "b": g[f"b{i}"]} for i in range(n)]
    hidden = tuple(g[f"w{i}"].shape[1] for i in range(n - 1))
    w0 = float(g["freq_w0"])
    tparams = [{k: torch.from_numpy(v) for k, v in p.items()} for p in np_params]
    jparams = [{k: jnp.asarray(v) for k, v in p.items()} for p in np_params]
    return g, tparams, SirenSpec(hidden=hidden, w0=w0), jparams, JaxSpec(hidden=hidden, w0=w0)


@pytest.fixture(scope="module")
def st():
    return _golden_field("st_image_golden.npz")


def _st_configs(g):
    nc = json.loads(bytes(g["network_config"]).decode())
    rc = json.loads(bytes(g["rendering_config"]).decode())
    rc["fast_march"] = False  # the float32 parity march, as the golden test runs it
    return nc, rc


# ---- camera -----------------------------------------------------------------

CAMERAS = [[0.8939, 0.7, 2.86], [0.0, 0.0, 2.0], [0.0, -3.0, 0.0], [2.0, 2.0, 3.5]]


@pytest.mark.parametrize("cam", CAMERAS)
def test_numpy_camera_is_the_jax_camera(cam):
    """The float64 functions are copies: equal to the bit."""
    rays = tcam.world_rays(24, 16, 60, cam, 0.3)
    np.testing.assert_array_equal(rays, jcam.world_rays(24, 16, 60, cam, 0.3))
    np.testing.assert_array_equal(tcam.look_at_rotation(cam), jcam.look_at_rotation(cam))
    for got, want in zip(tcam.cube_entry_points(rays, cam), jcam.cube_entry_points(rays, cam)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cam", CAMERAS)
def test_device_camera_matches_jax(cam):
    """float32 on both sides: valid masks equal, rays within 1e-6 (unit
    vectors) and entry points within 1e-5 (d·t + cam, t up to about 4)."""
    got = tcam.camera_rays_device(48, 32, 120, cam, 0.37, device="cpu")
    want = [np.asarray(a) for a in jcam.camera_rays_device(48, 32, 120, cam, 0.37)]
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=1e-5)
    assert want[2].any() and not want[2].all()


# ---- shading ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "shiny", "cmap"])
def test_shading_matches_reference_golden(case):
    """atol 1e-12, as tests/test_golden_shading.py holds the JAX copy."""
    g = np.load(osp.join(GOLDEN, "shading_golden.npz"))
    cmap = g[f"{case}_color_map"] if f"{case}_color_map" in g else None
    args = (g[f"{case}_hits"], g[f"{case}_samples"], g[f"{case}_normals"])
    phong = shading.phong_shading(g["light"], int(g[f"{case}_shininess"]), *args, color_map=cmap)
    ward = shading.ward_reflectance(g["light"], g["camera"], *args, 0.2, 0.2,
                                    g[f"{case}_pc1"], g[f"{case}_pc2"], color_map=cmap)
    np.testing.assert_allclose(phong, g[f"{case}_phong"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(ward, g[f"{case}_ward"], rtol=0, atol=1e-12)


def test_colormap_is_matplotlibs_rdylbu():
    """Equal to the bit on a dense sweep, the edges, out-of-range values and
    NaN, in float32 (the curvature's type) and float64."""
    x = np.concatenate([np.linspace(0, 1, 10001), [-0.5, -1e-9, 1.0, 1.0 + 1e-9, 3.0, np.nan],
                        np.random.default_rng(0).random(1000)])
    cmap = matplotlib.colormaps["RdYlBu"]
    for dt in (np.float64, np.float32):
        np.testing.assert_array_equal(shading.rdylbu(x.astype(dt)), cmap(x.astype(dt))[:, :3])


def test_png_writer_round_trips_through_pil(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


# ---- curvature --------------------------------------------------------------

def test_curvature_matches_jax_on_random_inputs():
    """The same (∇f, H) through both packages: float32, relative 1e-5 of
    each quantity's scale (the determinants and norms sum in other orders)."""
    rng = np.random.default_rng(0)
    grad = rng.normal(size=(256, 3)).astype(np.float32)
    a = rng.normal(size=(256, 3, 3)).astype(np.float32)
    hess = (a + a.transpose(0, 2, 1)).astype(np.float32)
    tg, th, jg, jh = torch.from_numpy(grad), torch.from_numpy(hess), jnp.asarray(grad), jnp.asarray(hess)

    def close(got, want):
        got = [got] if isinstance(got, torch.Tensor) else got
        for a_, b_ in zip(got, want if isinstance(want, tuple) else [want]):
            b_ = np.asarray(b_)
            np.testing.assert_allclose(a_.numpy(), b_, rtol=0, atol=1e-5 * np.abs(b_).max())

    n = grad / np.linalg.norm(grad, axis=1, keepdims=True)

    def everything(c, g_, h_, n_):
        return (c.divergence(h_), c.mean_curvature(g_, h_), c.gaussian_curvature(g_, h_),
                c.principal_curvatures(g_, h_), c.principal_directions(g_, h_)[:2],
                c.shape_operator_curvatures(h_, n_, "mean"),
                c.shape_operator_curvatures(h_, n_, "gaussian"))

    # one jit on the JAX side: a single compile instead of one per primitive
    want = jax.jit(lambda *a: everything(jcurv, *a))(jg, jh, jnp.asarray(n))
    for got_k, want_k in zip(everything(tcurv, tg, th, torch.from_numpy(n)), want):
        close(got_k, want_k)
    _, _, u = tcurv.principal_directions(tg, th)
    np.testing.assert_array_equal(u.numpy(), np.asarray(jcurv.principal_directions(jg, jh)[2]))


def test_curvature_matches_reference_golden():
    """tests/test_golden_losses.py's tolerances: mean curvature rtol 2e-3
    plus 2e-3 of its range; principal directions by |cos|."""
    g, params, spec, _, _ = _golden_field("field_losses_golden.npz")
    _, grad, h6 = value_grad_hessian_packed(params, spec, torch.from_numpy(g["pts"][0]))
    from diffudf_tpu_torch.autodiff.ops import hess_from_packed

    hess = hess_from_packed(h6)
    np.testing.assert_allclose(tcurv.mean_curvature(grad, hess).numpy(), g["mean_curv"],
                               rtol=2e-3, atol=2e-3 * np.abs(g["mean_curv"]).max())
    t1, t2, _ = tcurv.principal_directions(grad, hess)

    def unit(a):
        return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-30)

    for ours, ref in ((t1.numpy(), g["pdir1"]), (t2.numpy(), g["pdir2"])):
        cos = np.abs(np.sum(unit(ours) * unit(ref), axis=-1))
        assert np.median(1.0 - cos) < 1e-6
        assert (cos > 0.999).mean() > 0.97, (cos > 0.999).mean()


# ---- tracer -----------------------------------------------------------------

def test_trace_rays_matches_reference_golden():
    """tests/test_golden_grid_rays.py's criteria for the float32 march."""
    g, params, spec, _, _ = _golden_field("grid_rays_golden.npz")
    pos, hits, _ = ttr.trace_rays(
        params, spec, g["ray_origins"], g["ray_dirs"], np.ones(len(g["ray_origins"]), bool),
        gt_mode="tanh", alpha=float(g["alpha"]), surface_threshold=float(g["surface_threshold"]),
        max_iterations=int(g["max_iterations"]), fast=False)
    pos, hits, ref_hits = pos.numpy(), hits.numpy(), g["hit_mask"]
    assert ref_hits.sum() > 50
    assert (hits == ref_hits).mean() > 0.97
    both = hits & ref_hits
    d = np.linalg.norm(pos[both] - g["hit_positions"][both], axis=1)
    assert np.median(d) < 1e-4 and (d < 5e-3).mean() > 0.95


@pytest.mark.parametrize("relaxation", [1.0, 1.5])
def test_compacted_march_matches_jax(st, relaxation):
    """The same rays through both compacted marches (float32, exact sin):
    the same iteration count and hit set, hit positions within 1e-4 (the
    median criterion of tests/test_golden_grid_rays.py: float32 sums in
    another order, accumulated over up to 60 steps)."""
    g, params, spec, jparams, jspec = st
    nc, rc = _st_configs(g)
    kw = dict(gt_mode=nc["gt_mode"], alpha=nc["alpha"], surface_threshold=rc["surface_threshold"],
              max_iterations=rc["max_iterations"], fast=False, relaxation=relaxation)
    pos, hits, it = ttr.trace_rays_compacted(params, spec, g["t0"], g["rays"], g["mask"], **kw)
    jpos, jhits, jit = jtr.trace_rays_compacted(jparams, jspec, g["t0"].copy(), g["rays"].copy(),
                                                g["mask"].copy(), **kw)
    assert it == jit and hits.sum() > 100
    np.testing.assert_array_equal(hits, jhits)
    np.testing.assert_allclose(pos[hits], jpos[hits], rtol=0, atol=1e-4)
    if relaxation == 1.0:
        np.testing.assert_array_equal(hits, g["hits"])


def test_pipelined_count_read_and_warmup_change_nothing(st):
    """A stale active count only over-sizes the bucket: the pipelined
    count read marches the same rays to the same hits; the warm-up rounds
    run on no active ray."""
    g, params, spec, _, _ = st
    nc, rc = _st_configs(g)
    kw = dict(gt_mode=nc["gt_mode"], alpha=nc["alpha"], surface_threshold=rc["surface_threshold"],
              max_iterations=rc["max_iterations"], fast=False)
    ttr.warmup_compacted(params, spec, len(g["t0"]), **kw)
    pos, hits, it = ttr.trace_rays_compacted(params, spec, g["t0"], g["rays"], g["mask"], **kw)
    ppos, phits, pit = ttr.trace_rays_compacted(params, spec, g["t0"], g["rays"], g["mask"],
                                                pipeline_below=1.0, **kw)
    np.testing.assert_array_equal(phits, hits)
    # larger buckets may block the plain matmuls differently: 1e-6
    np.testing.assert_allclose(ppos[hits], pos[hits], rtol=0, atol=1e-6)
    assert pit >= it


@pytest.fixture(scope="module")
def hit_points(st):
    """The golden render's hit points, padded to 512 rows."""
    g, params, spec, _, _ = st
    nc, rc = _st_configs(g)
    pos, hits, _ = ttr.trace_rays_compacted(
        params, spec, g["t0"], g["rays"], g["mask"], gt_mode=nc["gt_mode"], alpha=nc["alpha"],
        surface_threshold=rc["surface_threshold"], max_iterations=rc["max_iterations"],
        fast=False)
    pts = np.zeros((512, 3), np.float32)
    pts[:hits.sum()] = pos[hits]
    return pts, int(hits.sum())


@pytest.mark.parametrize("mode", ["none", "mean", "gaussian"])
def test_hit_attributes_match_jax(st, hit_points, mode):
    """tile=512 on both sides; the closed-form eigensolver is the same, the
    float32 Hessians differ in the last bits.  Normals within 1e-5 up to
    sign.  pc1 and pc2 span the tangent plane, and where its two
    eigenvalues nearly coincide each direction is ill-set: held by |cos|
    as tests/test_golden_losses.py holds principal directions.  Curvature
    within 1e-5 of its largest magnitude over the hits (float32 sums of a
    derivative of the normal field, one order above the Hessian)."""
    g, params, spec, jparams, jspec = st
    pts, n_hit = hit_points
    got = ttr.hit_attributes(params, spec, torch.from_numpy(pts), curvature_mode=mode, tile=512)
    got = {k: v.numpy()[:n_hit] for k, v in got.items()}
    want = jtr.hit_attributes(jparams, jspec, jnp.asarray(pts), curvature_mode=mode, tile=512)
    want = {k: np.asarray(v)[:n_hit] for k, v in want.items()}
    cos = {k: np.sum(got[k] * want[k], axis=1) for k in ("normals", "pc1", "pc2")}
    np.testing.assert_allclose(got["normals"] * np.sign(cos["normals"])[:, None],
                               want["normals"], rtol=0, atol=1e-5)
    for k in ("pc1", "pc2"):
        assert np.median(1.0 - np.abs(cos[k])) < 1e-6 and (np.abs(cos[k]) > 0.999).mean() > 0.97
    scale = max(np.abs(want["curvature"]).max(), 1.0)
    np.testing.assert_allclose(got["curvature"], want["curvature"], rtol=0, atol=1e-5 * scale)


# ---- the slice as a whole ---------------------------------------------------

VARIANTS = {
    "phong_none": {"reflection_method": "blinn-phong", "plot_curvatures": "none"},
    "phong_mean": {"reflection_method": "blinn-phong", "plot_curvatures": "mean"},
    "ward_gaussian": {"reflection_method": "ward", "plot_curvatures": "gaussian"},
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_render_pass_matches_reference_golden(st, variant):
    """tests/test_golden_st_image.py's tolerances: per-pixel max 5e-3, 99th
    percentile 1e-3; the hit set equal.  phong_none also against the JAX
    package's pass on the same inputs (the curvature variants reach JAX
    through test_hit_attributes_match_jax)."""
    g, params, spec, jparams, jspec = st
    nc, rc = _st_configs(g)
    rc = dict(rc, **VARIANTS[variant])
    stats = {}
    colors = tst.create_projectional_image(params, spec, g["rays"], g["t0"], g["mask"], nc, rc,
                                           stats=stats)
    assert stats["hits"] == g["hits"].sum() and stats["k4_launches"] == 0
    refs = [g[f"colors_{variant}"].reshape(-1, 3)]
    if variant == "phong_none":
        refs.append(np.asarray(jst.create_projectional_image(
            jparams, jspec, g["rays"].copy(), g["t0"].copy(), g["mask"].copy(), nc, rc)))
    for ref in refs:
        err = np.abs(colors - ref).max(axis=1)
        assert float(err.max()) < 5e-3, float(err.max())
        assert float(np.quantile(err, 0.99)) < 1e-3
        np.testing.assert_array_equal((colors < 1).any(axis=1), (ref < 1).any(axis=1))


@pytest.mark.parametrize("device_camera", [True, False])
def test_generate_st_cli_writes_the_png(st, tmp_path, device_camera):
    """A 24x16 two-pass render through ``main`` on the CPU, with the float32
    torch camera or the float64 numpy one: the PNG reads back through PIL
    as the returned pixels, and the pass records add up."""
    g, params, spec, _, _ = st
    model = str(tmp_path / "model.npz")
    save_params(model, params, spec)
    nc, rc = _st_configs(g)
    rc.update(width=24, height=16, fov=60, sample_rate=2, output_path=str(tmp_path / "st.png"),
              device_camera=device_camera)
    cfg = {"network_config": dict(nc, model_path=model, hidden_layer_nodes=list(spec.hidden),
                                  w0=spec.w0), "rendering_config": rc}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    img, stats = tst.main([str(path), "--device", "cpu"])
    assert img.shape == (16, 24, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(Image.open(rc["output_path"])), img)
    assert len(stats["passes"]) == 2 and all(p["hits"] > 0 for p in stats["passes"])
    assert (img < 255).any() and (img == 255).any()
