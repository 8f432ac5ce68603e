"""Minimal, dependency-free OBJ / PLY IO: a numpy copy of
``diffudf_tpu/data/mesh_io.py`` (``Mesh``, ``PointCloudData``, the OBJ
reader and writer, the PLY readers (ascii and binary_little_endian, x/y/z
[+ nx/ny/nz], optional faces) and writers).

Host-side by design: IO never touches the device.
"""

from __future__ import annotations

import dataclasses
import struct

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


@dataclasses.dataclass
class PointCloudData:
    points: np.ndarray  # (N, 3)
    normals: np.ndarray | None = None

    @property
    def center(self) -> np.ndarray:
        return self.points.mean(axis=0)

    def transform(self, T: np.ndarray) -> "PointCloudData":
        p = self.points @ T[:3, :3].T + T[:3, 3]
        n = self.normals
        if n is not None:
            # normals transform by the (unscaled) rotation part; our
            # transforms are center+uniform-scale so direction is preserved
            R = T[:3, :3]
            n = n @ R.T
            norms = np.linalg.norm(n, axis=1, keepdims=True)
            n = np.divide(n, norms, out=np.zeros_like(n), where=norms > 1e-20)
        return PointCloudData(p, n)


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

_PLY_TYPES = {
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "char": ("b", 1), "int8": ("b", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
}


def _read_ply(path: str):
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, type, is_list, count_type)])
        while True:
            line = fh.readline().decode("ascii").strip()
            if line.startswith("comment") or not line:
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                elements.append((name, int(cnt), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append((parts[4], parts[3], True, parts[2]))
                else:
                    elements[-1][2].append((parts[2], parts[1], False, None))
            elif line == "end_header":
                break
        data = {}
        if fmt == "ascii":
            for name, cnt, props in elements:
                rows = []
                for _ in range(cnt):
                    toks = fh.readline().split()
                    if any(p[2] for p in props):  # list property (faces)
                        n = int(toks[0])
                        rows.append([float(t) for t in toks[1 : 1 + n]])
                    else:
                        rows.append([float(t) for t in toks[: len(props)]])
                data[name] = (props, rows)
        elif fmt == "binary_little_endian":
            for name, cnt, props in elements:
                if not any(p[2] for p in props):
                    fmt_str = "<" + "".join(_PLY_TYPES[p[1]][0] for p in props)
                    size = struct.calcsize(fmt_str)
                    raw = fh.read(size * cnt)
                    arr = np.frombuffer(
                        raw,
                        dtype=np.dtype([(p[0], "<" + _PLY_TYPES[p[1]][0]) for p in props]),
                        count=cnt,
                    )
                    rows = [arr[p[0]].astype(np.float64) for p in props]
                    data[name] = (props, np.stack(rows, axis=-1))
                else:
                    rows = []
                    count_type, item_type = props[0][3], props[0][1]
                    cfmt, csz = _PLY_TYPES[count_type]
                    ifmt, isz = _PLY_TYPES[item_type]
                    for _ in range(cnt):
                        n = struct.unpack("<" + cfmt, fh.read(csz))[0]
                        vals = struct.unpack("<" + str(n) + ifmt, fh.read(isz * n))
                        rows.append(list(vals))
                    data[name] = (props, rows)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return data


def load_ply_points(path: str) -> PointCloudData:
    data = _read_ply(path)
    props, rows = data["vertex"]
    names = [p[0] for p in props]
    arr = np.asarray(rows, dtype=np.float64)
    pts = arr[:, [names.index(c) for c in ("x", "y", "z")]]
    normals = None
    if all(c in names for c in ("nx", "ny", "nz")):
        normals = arr[:, [names.index(c) for c in ("nx", "ny", "nz")]]
    return PointCloudData(pts, normals)


def save_ply_points(path: str, pc: PointCloudData, binary: bool = True):
    n = len(pc.points)
    has_n = pc.normals is not None
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_n:
        header += ["property float nx", "property float ny", "property float nz"]
    header.append("end_header")
    cols = [pc.points]
    if has_n:
        cols.append(pc.normals)
    arr = np.concatenate(cols, axis=1).astype(np.float32)
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            fh.write(arr.tobytes())
        else:
            np.savetxt(fh, arr, fmt="%.8f")


def load_ply_mesh(path: str) -> Mesh:
    data = _read_ply(path)
    props, rows = data["vertex"]
    names = [p[0] for p in props]
    arr = np.asarray(rows, dtype=np.float64)
    pts = arr[:, [names.index(c) for c in ("x", "y", "z")]]
    faces = np.zeros((0, 3), np.int64)
    if "face" in data:
        fl = data["face"][1]
        tris = []
        for row in fl:
            idx = [int(i) for i in row]
            for k in range(1, len(idx) - 1):
                tris.append([idx[0], idx[k], idx[k + 1]])
        faces = np.asarray(tris, dtype=np.int64)
    return Mesh(pts, faces)


# --- dispatching front doors -------------------------------------------------


def load_mesh(path: str) -> Mesh:
    if path.endswith(".obj"):
        return load_obj(path)
    if path.endswith(".ply"):
        return load_ply_mesh(path)
    raise ValueError(f"unsupported mesh format: {path}")


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


def load_point_cloud(path: str) -> PointCloudData:
    if path.endswith(".ply"):
        return load_ply_points(path)
    raise ValueError(f"unsupported point cloud format: {path}")


def save_point_cloud(path: str, pc: PointCloudData):
    if path.endswith(".ply"):
        return save_ply_points(path, pc)
    raise ValueError(f"unsupported point cloud format: {path}")
