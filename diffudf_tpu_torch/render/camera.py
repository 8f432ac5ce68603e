"""Pinhole camera: pixel rays, look-at orientation, domain-cube entry points.
The torch counterpart of ``diffudf_tpu/render/camera.py``.

Two implementations of the same camera:

  * the float64 numpy functions below, copied exactly from the JAX package
    (the golden suites pin them);
  * :func:`camera_rays_device` — the same math in float32 torch on the
    render's device, so the rays and entry points never cross to the host.
    Float32 rays differ from the float64 path at ~1e-7 relative, which can
    flip borderline silhouette hits.
"""

from __future__ import annotations

import numpy as np
import torch


def pixel_rays(width: int, height: int, fov_degrees: float, noise: float = 0.5):
    """(H·W, 3) camera-space ray directions through each pixel (z = −1)."""
    nx = (np.arange(width) + noise) / width
    ny = (np.arange(height) + noise) / height
    sx = 2 * nx - 1
    sy = 2 * ny - 1
    aspect = width / height
    t = np.tan(np.radians(fov_degrees) / 2)
    cx, cy = np.meshgrid(sx * aspect * t, sy * t, indexing="xy")
    rays = np.stack([cx, cy, -np.ones_like(cx)], axis=-1)
    return rays.reshape(-1, 3)


def look_at_rotation(camera_position: np.ndarray) -> np.ndarray:
    """Rotation turning −ẑ toward the origin from ``camera_position``;
    column 3 (the +z image axis) maps to the direction from the camera
    toward the origin, in every branch."""
    b = -np.asarray(camera_position, dtype=np.float64)
    b = b / np.linalg.norm(b)
    if np.isclose(b[2], -1.0):  # camera on +z axis
        return np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
    if np.isclose(b[2], 1.0):  # camera on -z axis
        return np.eye(3)
    up = np.array([0.0, 1.0, 0.0]) - (np.array([0.0, 1.0, 0.0]) @ b) * b
    n = np.linalg.norm(up)
    if n < 1e-6:  # camera on (or near) the ±y axis: y-up is degenerate
        up = np.array([0.0, 0.0, 1.0]) - (np.array([0.0, 0.0, 1.0]) @ b) * b
        n = np.linalg.norm(up)
    up /= n
    right = np.cross(up, b)
    return np.vstack([right, up, b]).T


def world_rays(width, height, fov, camera_position, noise: float = 0.5):
    """Unit world-space ray directions from the camera through each pixel:
    a proper pinhole, each ray through the camera centre (the JAX package's
    documented deviation from the reference's origin-converging rays)."""
    cam = np.asarray(camera_position, dtype=np.float64)
    R = look_at_rotation(cam)
    p = pixel_rays(width, height, fov, noise)
    # camera forward is +z in the look-at basis; pixel_rays uses z = −1
    d = p * np.array([1.0, 1.0, -1.0])
    d = (R @ d.T).T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d


def cube_entry_points(ray_dirs: np.ndarray, camera_position, planes=None):
    """Entry point of each ray into the axis-aligned domain cube.

    -> (start_positions (N, 3), valid_mask (N,)): intersect the 6 face
    planes, keep intersections inside the cube (±1.001 tolerance), take the
    nearest non-negative t.  A ray whose only intersections lie behind the
    camera is invalid; entry points are nudged inside the open cube.
    """
    cam = np.asarray(camera_position, dtype=np.float64)
    p_pos = planes if planes is not None else [1, -1, 1, -1, 1, -1]
    plane_normals = np.array(
        [[1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1]],
        dtype=np.float64,
    )
    plane_points = np.array(
        [
            [p_pos[0], 0, 0], [p_pos[1], 0, 0],
            [0, p_pos[2], 0], [0, p_pos[3], 0],
            [0, 0, p_pos[4]], [0, 0, p_pos[5]],
        ],
        dtype=np.float64,
    ) - cam

    num = np.sum(plane_points * plane_normals, axis=-1)  # (6,)
    den = ray_dirs @ plane_normals.T  # (N, 6)
    safe_den = np.where(np.abs(den) < 1e-5, 1.0, den)
    ds = num[None, :] / safe_den

    hits = ray_dirs[:, None, :] * ds[..., None] + cam  # (N, 6, 3)
    inside = np.all((hits >= -1.001) & (hits <= 1.001), axis=-1) & (np.abs(den) > 1e-5)
    ds = np.where((ds >= 0) & inside, ds, np.inf)
    t_entry = ds.min(axis=-1)
    valid = inside.any(axis=-1) & np.isfinite(t_entry)
    start = np.zeros_like(ray_dirs)
    start[valid] = ray_dirs[valid] * t_entry[valid, None] + cam
    start[valid] = np.clip(start[valid], -1.0 + 1e-5, 1.0 - 1e-5)
    return start, valid


def camera_rays_device(width, height, fov_degrees, camera_position,
                       noise: float = 0.5, planes=None, device="cuda"):
    """On-device camera: -> (rays (H·W, 3), entry points (H·W, 3), valid
    (H·W,)) float32 / bool tensors on ``device``.

    The semantics of :func:`world_rays` + :func:`cube_entry_points` in
    float32; the 3×3 look-at rotation stays host float64 (nine
    data-independent scalars).  The rotation is spelled out elementwise and
    the plane dots are component picks, as the JAX package writes them: no
    matrix product, so no TF32 or bf16 rounding of the rays can creep in.
    """
    f32 = dict(dtype=torch.float32, device=device)
    cam_np = np.asarray(camera_position, dtype=np.float64)
    cam = torch.as_tensor(cam_np, **f32)
    rot = torch.as_tensor(look_at_rotation(cam_np), **f32)
    noise = torch.tensor(noise, **f32)

    # pixel grid (pixel_rays semantics)
    nx = (torch.arange(width, **f32) + noise) / width
    ny = (torch.arange(height, **f32) + noise) / height
    sx = 2.0 * nx - 1.0
    sy = 2.0 * ny - 1.0
    aspect = width / height
    t = float(np.tan(np.radians(fov_degrees) / 2).astype(np.float32))
    cx, cy = torch.meshgrid(sx * aspect * t, sy * t, indexing="xy")
    p = torch.stack([cx, cy, -torch.ones_like(cx)], dim=-1).reshape(-1, 3)

    # world rays: flip z, rotate, normalise
    d = p * torch.tensor([1.0, 1.0, -1.0], **f32)
    d = d[:, 0:1] * rot[:, 0][None, :] + d[:, 1:2] * rot[:, 1][None, :] + d[:, 2:3] * rot[:, 2][None, :]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)

    # cube entry (cube_entry_points semantics)
    p_pos = planes if planes is not None else (1, -1, 1, -1, 1, -1)
    plane_normals = torch.tensor(
        [[1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1]], **f32)
    plane_points = torch.tensor(
        [[p_pos[0], 0, 0], [p_pos[1], 0, 0], [0, p_pos[2], 0],
         [0, p_pos[3], 0], [0, 0, p_pos[4]], [0, 0, p_pos[5]]], **f32) - cam
    num = torch.sum(plane_points * plane_normals, dim=-1)  # (6,)
    # the plane normals are axis-aligned unit vectors: each dot is a pick
    den = torch.stack([d[:, 0], d[:, 0], d[:, 1], d[:, 1], d[:, 2], d[:, 2]], dim=-1)
    safe_den = torch.where(torch.abs(den) < 1e-5, 1.0, den)
    ds = num[None, :] / safe_den
    hits = d[:, None, :] * ds[..., None] + cam  # (N, 6, 3)
    inside = torch.all((hits >= -1.001) & (hits <= 1.001), dim=-1) & (torch.abs(den) > 1e-5)
    ds = torch.where((ds >= 0) & inside, ds, torch.inf)
    t_entry = torch.min(ds, dim=-1).values
    valid = torch.any(inside, dim=-1) & torch.isfinite(t_entry)
    start = torch.where(valid[:, None], d * torch.where(valid, t_entry, 0.0)[:, None] + cam, 0.0)
    start = torch.where(valid[:, None], torch.clamp(start, -1.0 + 1e-5, 1.0 - 1e-5), start)
    return d, start, valid
