"""Minimal, dependency-free mesh IO: a numpy copy of the ``Mesh`` class and
the OBJ / PLY mesh writers (and OBJ reader) of ``diffudf_tpu/data/mesh_io.py``.

Host-side by design: IO never touches the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray  # (F, 3) int64
    vertex_normals: np.ndarray | None = None

    @property
    def center(self) -> np.ndarray:
        return self.vertices.mean(axis=0)

    def transform(self, T: np.ndarray) -> "Mesh":
        v = self.vertices @ T[:3, :3].T + T[:3, 3]
        return Mesh(v, self.faces, self.vertex_normals)

    def compute_vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals (open3d ``compute_vertex_normals``
        analogue, used for Chamfer normal-consistency eval)."""
        v, f = self.vertices, self.faces
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, f[:, k], fn)
        norms = np.linalg.norm(vn, axis=1, keepdims=True)
        vn = np.divide(vn, norms, out=np.zeros_like(vn), where=norms > 1e-20)
        self.vertex_normals = vn
        return vn

    def face_areas_normals(self):
        v, f = self.vertices, self.faces
        c = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        areas = 0.5 * np.linalg.norm(c, axis=1)
        norms = np.linalg.norm(c, axis=1, keepdims=True)
        normals = np.divide(c, norms, out=np.zeros_like(c), where=norms > 1e-20)
        return areas, normals


# --- OBJ ---------------------------------------------------------------------


def load_obj(path: str) -> Mesh:
    verts, normals, faces = [], [], []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vn "):
                parts = line.split()
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, dtype=np.float64)
    f = np.asarray(faces, dtype=np.int64) if faces else np.zeros((0, 3), np.int64)
    vn = np.asarray(normals, dtype=np.float64) if len(normals) == len(verts) else None
    return Mesh(v, f, vn)


def save_obj(path: str, mesh: Mesh):
    with open(path, "w") as fh:
        fh.write("# diffudf_tpu mesh\n")
        for v in mesh.vertices:
            fh.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        if mesh.vertex_normals is not None:
            for n in mesh.vertex_normals:
                fh.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for f in mesh.faces:
            fh.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")


# --- PLY ---------------------------------------------------------------------


def save_mesh(path: str, mesh: Mesh):
    if path.endswith(".obj"):
        return save_obj(path, mesh)
    if path.endswith(".ply"):
        n, f = len(mesh.vertices), len(mesh.faces)
        with open(path, "wb") as fh:
            header = (
                f"ply\nformat binary_little_endian 1.0\nelement vertex {n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {f}\nproperty list uchar int vertex_indices\nend_header\n"
            )
            fh.write(header.encode("ascii"))
            fh.write(mesh.vertices.astype("<f4").tobytes())
            faces = mesh.faces.astype("<i4")
            counts = np.full((f, 1), 3, dtype=np.uint8)
            rec = np.zeros(f, dtype=[("c", "u1"), ("v", "<i4", (3,))])
            rec["c"] = counts[:, 0]
            rec["v"] = faces
            fh.write(rec.tobytes())
        return
    raise ValueError(f"unsupported mesh format: {path}")
