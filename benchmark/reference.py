"""Plain PyTorch reference of the DUDF training steps, stage 1 and stage 2.

It follows the published recipe (DUDF, arXiv:2402.08876; the reference
implementation's ``src/preprocess_mesh.py``, ``src/dataset.py``,
``loss_functions.py:106-155`` and ``train.py``) and imports nothing of the
program under test: it normalises the source mesh itself, holds the
program's preprocessed files to it, draws the batch from the generator
state the harness handed the program, works out the ground-truth distances
by brute force, and runs the SIREN, the loss, its gradient and Adam in
float32 with TF32 off (``tf32=True`` is the lower-precision control).

The SIREN's value, gradient and Hessian are carried forward through the
layers (Taylor mode); autograd takes the gradient of the loss with respect
to the parameters.  The Hessian normal is the eigenvector of the largest
eigenvalue from ``torch.linalg.eigh``, taken in float64.  Every loss term is a sum over rows
divided by the batch size, so the rows go through in blocks and the
gradients add up.  Stage 2's loss is the mean and the standard deviation
of the value over the surface rows, which do not add up by blocks: its
batch goes through whole.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

BLOCK_ROWS = 8192  # rows a block of the SIREN, the loss and its gradient
DIST_BLOCK = 128  # queries a block of the brute distances


# --- the data set, read without the program ------------------------------------


def read_ply_points(path: str):
    """Binary little-endian PLY of float x y z [nx ny nz] -> (points (N, 3),
    normals (N, 3) or None), float32."""
    with open(path, "rb") as fh:
        data = fh.read()
    end = data.index(b"end_header") + len(b"end_header")
    end = data.index(b"\n", end) + 1
    header = data[:end].decode("ascii").split("\n")
    props = [line.split() for line in header if line.startswith("property")]
    if "format binary_little_endian 1.0" not in header or any(
            p[1] not in ("float", "float32") for p in props):
        raise ValueError(f"{path}: not a binary little-endian PLY of floats")
    n = next(int(line.split()[2]) for line in header if line.startswith("element vertex"))
    names = [p[-1] for p in props]
    arr = np.frombuffer(data[end:end + 4 * n * len(names)], "<f4").reshape(n, len(names))
    cols = {p: arr[:, i] for i, p in enumerate(names)}
    pts = np.stack([cols["x"], cols["y"], cols["z"]], 1).astype(np.float32)
    nrm = (np.stack([cols["nx"], cols["ny"], cols["nz"]], 1).astype(np.float32)
           if "nx" in cols else None)
    return pts, nrm


def read_obj(path: str):
    """OBJ vertices (V, 3) float64 and faces (F, 3) int64, fan-triangulated."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) for t in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                faces += [[idx[0], idx[k], idx[k + 1]] for k in range(1, len(idx) - 1)]
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def normalized_triangles(path: str) -> np.ndarray:
    """The source mesh as the published preprocessing leaves it
    (``src/preprocess_mesh.py``): the vertices' centroid moved to the origin,
    then scaled by 1 / (1.1 max |coordinate|) into [-1, 1]^3 with a 10%
    margin.  -> (T, 3, 3) float64."""
    verts, faces = read_obj(path)
    verts = verts - verts.mean(axis=0)
    verts = verts / (1.1 * np.abs(verts).max())
    return verts[faces]


def read_obj_triangles(path: str) -> np.ndarray:
    """OBJ triangles as written, (T, 3, 3) float64."""
    verts, faces = read_obj(path)
    return verts[faces]


def triangle_normals(tris: torch.Tensor) -> torch.Tensor:
    """Unit face normals (T, 3) of triangles (T, 3, 3)."""
    n = torch.linalg.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-300)


def cloud_off_mesh(points: torch.Tensor, normals: torch.Tensor, tris: torch.Tensor,
                   parallel: float = 1e-5) -> torch.Tensor:
    """For each cloud point, its distance to the nearest triangle whose face
    normal is parallel to the point's normal (|cos| >= 1 - ``parallel``), by
    brute force in float64: 0 to rounding for a point sampled on the mesh
    with its triangle's normal; infinite where no triangle's normal
    matches."""
    q, tris = points.double(), tris.double()
    nrm = normals.double()
    nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True).clamp_min(1e-300)
    tn = triangle_normals(tris)
    a, b, c = (tris[None, :, i] for i in range(3))
    out = []
    for i in range(0, q.shape[0], DIST_BLOCK):
        d2 = _closest_sq(q[i:i + DIST_BLOCK, None, :], a, b, c)
        match = (nrm[i:i + DIST_BLOCK] @ tn.T).abs() >= 1.0 - parallel
        out.append(torch.where(match, d2, torch.full_like(d2, float("inf"))).amin(1).sqrt())
    return torch.cat(out) if out else q.new_zeros(0)


# --- the batch -------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Split:
    """Rows of a batch: [on the surface | far, uniform in the box | near]."""

    on: int
    far: int
    near: int

    @classmethod
    def of(cls, batch_size: int, percentiles) -> "Split":
        on = int(batch_size * percentiles[0])
        off = int(batch_size * percentiles[1])
        return cls(on, off // 2, off - off // 2)

    @property
    def total(self) -> int:
        return self.on + self.far + self.near


def cloud_distance(q: torch.Tensor, cloud: torch.Tensor) -> torch.Tensor:
    """Nearest-point distance of each query to the cloud, by brute force in
    float64."""
    q, cloud = q.double(), cloud.double()
    out = [torch.sqrt(((q[i:i + DIST_BLOCK, None, :] - cloud[None]) ** 2).sum(-1).amin(1))
           for i in range(0, q.shape[0], DIST_BLOCK)]
    return torch.cat(out) if out else q.new_zeros(0)


def _dot(a, b):
    return (a * b).sum(-1)


def _closest_sq(p, a, b, c):
    """Squared distance from p (Q, 1, 3) to triangles (1, T, 3) each: the
    closest point by Voronoi region of the triangle (Ericson, Real-Time
    Collision Detection, 5.1.5)."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2

    def safe(num, den):
        return num / torch.where(den == 0, torch.ones_like(den), den)

    denom = safe(torch.ones_like(va), va + vb + vc)
    x = a + ab * (vb * denom)[..., None] + ac * (vc * denom)[..., None]  # inside
    cases = [  # later entries win: vertices, then edges, over the interior
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
         b + (c - b) * safe(d4 - d3, (d4 - d3) + (d5 - d6))[..., None]),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + ac * safe(d2, d2 - d6)[..., None]),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + ab * safe(d1, d1 - d3)[..., None]),
        ((d6 >= 0) & (d5 <= d6), c.expand_as(x)),
        ((d3 >= 0) & (d4 <= d3), b.expand_as(x)),
        ((d1 <= 0) & (d2 <= 0), a.expand_as(x)),
    ]
    for mask, point in cases:
        x = torch.where(mask[..., None], point, x)
    return ((p - x) ** 2).sum(-1)


def triangle_distance(q: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Unsigned distance of each query to the nearest triangle, by brute force
    over every triangle in float64."""
    q, tris = q.double(), tris.double()
    a, b, c = (tris[None, :, i] for i in range(3))
    out = [torch.sqrt(_closest_sq(q[i:i + DIST_BLOCK, None, :], a, b, c).amin(1))
           for i in range(0, q.shape[0], DIST_BLOCK)]
    return torch.cat(out) if out else q.new_zeros(0)


def draw_batch(gen_state, data, split: Split, stddev: float, device):
    """One batch from a generator in ``gen_state``: the recipe's draws in its
    order (surface rows from the cloud, far rows uniform in [-1, 1]^3, near
    rows a surface row moved along its normal by N(0, stddev^2)), with the
    GT distances worked out by brute force: 0 on the surface; the nearest
    cloud point (far rows) and the offset (near rows) for a cloud; the
    nearest triangle (far and near rows) for a mesh.
    -> (points (B, 3), normals (B, 3), sdf (B, 1)), float32."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    cloud, normals = data["cloud"], data["normals"]
    surf_idx = torch.randint(0, cloud.shape[0], (split.on,), generator=gen, device=device)
    surf, surf_n = cloud[surf_idx], normals[surf_idx]
    far = torch.rand((split.far, 3), generator=gen, device=device) * 2.0 - 1.0
    near_sel = torch.randint(0, split.on, (split.near,), generator=gen, device=device)
    offset = stddev * torch.randn((split.near, 1), generator=gen, device=device)
    near = surf[near_sel] + surf_n[near_sel] * offset
    if data.get("triangles") is not None:
        off_sdf = triangle_distance(torch.cat([far, near]), data["triangles"])
    else:
        off_sdf = torch.cat([cloud_distance(far, cloud), offset[:, 0].abs().double()])
    points = torch.cat([surf, far, near])
    nrm = torch.cat([surf_n, torch.zeros((split.far + split.near, 3), device=device)])
    sdf = torch.cat([torch.zeros(split.on, device=device, dtype=torch.float64), off_sdf])
    return points, nrm, sdf.float()[:, None]


# --- the SIREN and the losses ----------------------------------------------------

_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def siren_derivatives(params, x, w0: float, hessian: bool):
    """f (N,), grad f (N, 3) and, with ``hessian``, the Hessian (N, 3, 3) of
    the sine SIREN ``params`` [(W (in, out), b (out,)), ...] at x (N, 3),
    carried forward layer by layer."""
    w1, b1 = params[0]
    n, h = x.shape[0], w1.shape[1]
    z = x @ w1 + b1
    jz = w1[None].expand(n, 3, h)  # d z / d x_i
    hz = None
    for k in range(len(params)):
        if k:
            w, b = params[k]
            z = a @ w + b
            jz = (j.reshape(-1, j.shape[-1]) @ w).view(n, 3, -1)
            hz = (hh.reshape(-1, hh.shape[-1]) @ w).view(n, 6, -1) if hessian else None
        if k == len(params) - 1:
            break
        s, c = torch.sin(w0 * z), torch.cos(w0 * z)
        d1, d2 = w0 * c, -w0 * w0 * s
        a = s
        j = d1[:, None] * jz
        if hessian:
            quad = torch.stack([jz[:, p] * jz[:, q] for p, q in _PAIRS], 1)
            hh = d2[:, None] * quad + (0 if hz is None else d1[:, None] * hz)
    f, g = z[:, 0], jz[:, :, 0]
    if not hessian:
        return f, g, None
    h6 = hz[:, :, 0]
    hm = torch.stack([h6[:, [0, 1, 2]], h6[:, [1, 3, 4]], h6[:, [2, 4, 5]]], 1)
    return f, g, hm


def siren_value(params, x, w0: float):
    """f (N,) of the sine SIREN ``params`` at x (N, 3)."""
    a = x
    for w, b in params[:-1]:
        a = torch.sin(w0 * (a @ w + b))
    w, b = params[-1]
    return (a @ w + b)[:, 0]


def _cosine(a, b):
    na = torch.clamp(torch.linalg.norm(a, dim=-1), min=1e-8)
    nb = torch.clamp(torch.linalg.norm(b, dim=-1), min=1e-8)
    return (a * b).sum(-1) / (na * nb)


def s1_block_terms(params, pts, nrm, sdf, batch_rows: int, weights, alpha, w0, surface: bool,
                   eig_dtype=torch.float64):
    """The four stage-1 terms' shares of one block of rows, each a sum over the
    block over ``batch_rows``: (|f| on the surface, |tdf - f| off it, the
    Hessian normal against the GT normal on the surface, |grad f| against the
    tanh field's slope)."""
    udf = sdf[:, 0]
    on = udf == 0
    f, g, hm = siren_derivatives(params, pts, w0, hessian=surface)
    zero = torch.zeros_like(f)
    tan = torch.tanh(alpha * udf)
    tdf = udf * tan
    t_on = torch.where(on, f.abs(), zero).sum() / batch_rows * weights[0]
    t_off = torch.where(~on, (tdf - f).abs(), zero).sum() / batch_rows * weights[1]
    if surface:
        # in float64: the eigenvector's derivative divides by the gap between
        # the two largest eigenvalues, which float32 resolves poorly on rows
        # where they nearly meet
        top = torch.linalg.eigh(hm.to(eig_dtype)).eigenvectors[..., :, 2].to(hm.dtype)
        align = 1.0 - _cosine(nrm, top).abs()
        t_h = torch.where(on, align, zero).sum() / batch_rows * weights[2]
    else:
        t_h = f.new_zeros(())
    target = (tan + udf * alpha * (1.0 - tan * tan)).abs()
    t_g = (torch.linalg.norm(g, dim=-1) - target).abs().sum() / batch_rows * weights[3]
    return torch.stack([t_on, t_off, t_h, t_g])


def s1_loss_and_grad(leaves, pts, nrm, sdf, n_on: int, weights, alpha, w0,
                     eig_dtype=torch.float64):
    """-> (terms (4,) float64 on the host, gradient of their sum, one tensor
    a leaf) over the whole batch, in blocks of rows."""
    params = [(leaves[2 * i], leaves[2 * i + 1]) for i in range(len(leaves) // 2)]
    rows = pts.shape[0]
    terms = torch.zeros(4, dtype=torch.float64, device=pts.device)
    grads = [torch.zeros_like(t) for t in leaves]
    for lo, hi, surface in ([(i, min(i + BLOCK_ROWS, n_on), True)
                             for i in range(0, n_on, BLOCK_ROWS)]
                            + [(i, min(i + BLOCK_ROWS, rows), False)
                               for i in range(n_on, rows, BLOCK_ROWS)]):
        t = s1_block_terms(params, pts[lo:hi], nrm[lo:hi], sdf[lo:hi], rows, weights,
                           alpha, w0, surface, eig_dtype)
        for acc, gr in zip(grads, torch.autograd.grad(t.sum(), leaves)):
            acc += gr
        terms += t.detach().double()
    return terms.cpu(), grads


def s2_loss_and_grad(leaves, pts, sdf, weights, w0):
    """Stage 2's terms (|mean f| and the standard deviation of f, Bessel
    corrected, over the surface rows; float64 on the host) and the gradient
    of their sum, one tensor a leaf."""
    params = [(leaves[2 * i], leaves[2 * i + 1]) for i in range(len(leaves) // 2)]
    f = siren_value(params, pts[sdf[:, 0] == 0], w0)
    t = torch.stack([f.mean().abs() * weights[0], f.std() * weights[1]])
    grads = torch.autograd.grad(t.sum(), leaves)
    return t.detach().double().cpu(), list(grads)


def learning_rate(recipe: dict, epoch: int) -> float:
    """The recipe's rate (``train.py``): ``warmup_lr`` before
    ``warmup_epochs``, then ``lr_s1`` to ``s1_epochs``, then ``lr_s2``
    times (1 + cos(pi epoch / (num_epochs - s1_epochs))) / 2."""
    if epoch >= recipe["s1_epochs"]:
        span = recipe["num_epochs"] - recipe["s1_epochs"]
        return recipe["lr_s2"] * 0.5 * (1.0 + math.cos(math.pi * epoch / span))
    return recipe["warmup_lr"] if epoch < recipe["warmup_epochs"] else recipe["lr_s1"]


@contextlib.contextmanager
def matmul_tf32(on: bool):
    """Float32 products in TF32 (``on``) or in full float32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def follow(params0, batches, recipe: dict, stage: str, first_epoch: int, w0: float, device,
           tf32: bool = False, rows=None, eig_dtype=torch.float64):
    """Train from ``params0`` (host float32 arrays, leaves in the program's
    order: W then b, layer by layer) through ``batches`` (points, normals,
    sdf, n_on) with the ``stage``'s loss ("s1" or "s2") and Adam, one step
    each.  ``rows`` (optional, a function of
    the batch's row count) keeps only those rows of each batch, the mean
    then over them.  ``eig_dtype`` is the precision of the Hessian's
    eigenvectors (float32: the witness of a plain float32 path).  -> dict:
    ``terms`` (steps, terms + 1) float64 (the terms and their sum), ``grad1``
    the first step's gradient, ``delta1`` the parameters' change in the
    first step and ``delta`` over all the steps, each a list of host float64
    arrays."""
    leaves = [torch.tensor(np.asarray(p), dtype=torch.float32, device=device,
                           requires_grad=True) for p in params0]
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in leaves]
    weights = [float(w) for w in recipe[f"loss_{stage}_weights"]]
    terms, grad1, delta1 = [], None, None
    with matmul_tf32(tf32):
        for k, (pts, nrm, sdf, n_on) in enumerate(batches):
            if rows is not None:
                keep = rows(pts.shape[0]).to(pts.device)
                n_on = int((keep < n_on).sum())
                pts, nrm, sdf = pts[keep], nrm[keep], sdf[keep]
            if stage == "s1":
                t, grads = s1_loss_and_grad(leaves, pts, nrm, sdf, n_on, weights,
                                            float(recipe["alpha"]), w0, eig_dtype)
            else:
                t, grads = s2_loss_and_grad(leaves, pts, sdf, weights, w0)
            terms.append(torch.cat([t, t.sum()[None]]).numpy())
            if grad1 is None:
                grad1 = [g.double().cpu().numpy() for g in grads]
            adam_step(leaves, grads, moments, k + 1, learning_rate(recipe, first_epoch + k),
                      recipe["adam_b1"], recipe["adam_b2"], recipe["adam_eps"])
            if delta1 is None:
                delta1 = _change(leaves, params0)
    return {"terms": np.stack(terms), "grad1": grad1, "delta1": delta1,
            "delta": _change(leaves, params0)}


@torch.no_grad()
def adam_step(leaves, grads, moments, t: int, lr: float, b1: float, b2: float, eps: float):
    """Step ``t`` (from 1) of Adam (Kingma and Ba, Algorithm 1) in place:
    ``moments`` holds each leaf's (m, v)."""
    for p, g, (m, v) in zip(leaves, grads, moments):
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        m_hat = m / (1.0 - b1 ** t)
        v_hat = v / (1.0 - b2 ** t)
        p.sub_(lr * m_hat / (v_hat.sqrt() + eps))


def _change(leaves, params0):
    return [(p.detach().double().cpu().numpy() - np.asarray(p0, np.float64))
            for p, p0 in zip(leaves, params0)]
