"""Mesh database: BOP models_info + PLY vertex clouds.

The port's own copy of `suo_slam_tpu/data/mesh.py` (numpy only): a
standalone PLY reader (ascii / binary little-endian vertex positions and
faces, which covers every BOP model file) and a mesh DB whose point clouds
pad into one dense [n_obj, P_max, 3] array + count vector, so the ADD/ADD-S
metrics (`eval/meter.py`, kernel K10) run over all objects at once. The
ADD point clouds are a seeded uniform subsample of at most 4096 vertices.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

_PLY_DTYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply_vertices(path: str) -> np.ndarray:
    """Read vertex (x, y, z) from an ascii or binary_little_endian PLY."""
    return load_ply(path)[0]


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Read (vertices [V, 3] f32, faces [F, 3] int32 | None) from PLY.

    Minimal reader for BOP model files. Extra vertex properties are
    skipped; polygon faces are fan-triangulated.
    """
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply", f"{path} is not a PLY file"
        fmt = None
        elements = []  # (name, count, [(prop_name, type_str, is_list, list_len_type)])
        cur = None
        while True:
            line = f.readline()
            assert line, f"Unexpected EOF in header of {path}"
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                cur = (tok[1].decode(), int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == b"property":
                if tok[1] == b"list":
                    cur[2].append((tok[4].decode(), tok[3].decode(), True, tok[2].decode()))
                else:
                    cur[2].append((tok[2].decode(), tok[1].decode(), False, None))
            elif tok[0] == b"end_header":
                break

        assert fmt in ("ascii", "binary_little_endian"), f"Unsupported PLY format {fmt}"
        verts = None
        faces = None
        for name, count, props in elements:
            if name == "vertex":
                idx = {p[0]: j for j, p in enumerate(props)}
                assert all(k in idx for k in ("x", "y", "z")), f"PLY {path} missing xyz"
                if fmt == "ascii":
                    rows = []
                    for _ in range(count):
                        vals = f.readline().split()
                        rows.append(
                            [float(vals[idx["x"]]), float(vals[idx["y"]]), float(vals[idx["z"]])]
                        )
                    verts = np.asarray(rows, np.float32)
                else:
                    assert not any(p[2] for p in props), "list property in vertex element"
                    codes = [_PLY_DTYPES[p[1]][0] for p in props]
                    size = struct.calcsize("<" + "".join(codes))
                    buf = f.read(size * count)
                    sdt = np.dtype(
                        {"names": [p[0] for p in props], "formats": ["<" + c for c in codes]}
                    )
                    arr = np.frombuffer(buf, dtype=sdt, count=count)
                    verts = np.stack(
                        [arr["x"], arr["y"], arr["z"]], axis=-1
                    ).astype(np.float32)
            elif name == "face" and any(p[2] for p in props):
                tris = []
                if fmt == "ascii":
                    for _ in range(count):
                        vals = f.readline().split()
                        k = int(vals[0])
                        poly = [int(v) for v in vals[1 : 1 + k]]
                        for t in range(1, k - 1):  # fan triangulation
                            tris.append([poly[0], poly[t], poly[t + 1]])
                else:
                    for _ in range(count):
                        for _, type_str, is_list, list_len_type in props:
                            if is_list:
                                lcode, lsize = _PLY_DTYPES[list_len_type]
                                k = struct.unpack("<" + lcode, f.read(lsize))[0]
                                icode, isize = _PLY_DTYPES[type_str]
                                poly = struct.unpack("<" + icode * k, f.read(isize * k))
                                for t in range(1, k - 1):
                                    tris.append([poly[0], poly[t], poly[t + 1]])
                            else:
                                _, isize = _PLY_DTYPES[type_str]
                                f.read(isize)
                faces = np.asarray(tris, np.int32) if tris else None
            else:
                # skip this element's data
                if fmt == "ascii":
                    for _ in range(count):
                        f.readline()
                else:
                    for _ in range(count):
                        for _, type_str, is_list, list_len_type in props:
                            if is_list:
                                lcode, lsize = _PLY_DTYPES[list_len_type]
                                n = struct.unpack("<" + lcode, f.read(lsize))[0]
                                _, isize = _PLY_DTYPES[type_str]
                                f.read(isize * n)
                            else:
                                _, isize = _PLY_DTYPES[type_str]
                                f.read(isize)
        assert verts is not None, f"No vertex element in {path}"
        return verts, faces


class MeshDb:
    """Per-object mesh info with dense padded arrays.

    Attributes (numpy):
      obj_ids: sorted list of BOP object ids.
      diameter[o], is_symmetric[o], has_continuous_sym[o]: [n_obj] arrays
        indexed by obj_id - 1.
      points: dict obj_id -> [P_i, 3] float32 (mm).
    """

    def __init__(self, model_dir: str, max_points: int | None = 4096, seed: int = 0):
        with open(os.path.join(model_dir, "models_info.json")) as f:
            info = json.load(f)
        self.model_dir = model_dir
        self.obj_ids = sorted(int(k) for k in info)
        n = max(self.obj_ids)
        self.diameter = np.zeros((n,), np.float32)
        self.is_symmetric = np.zeros((n,), bool)
        self.has_continuous_sym = np.zeros((n,), bool)
        self.continuous_sym = {}
        self.points = {}
        self.verts_full = {}
        self.faces = {}  # obj_id -> [F, 3] int32 triangles or None
        rng = np.random.default_rng(seed)
        for obj_id in self.obj_ids:
            mi = info[str(obj_id)]
            disc = len(mi.get("symmetries_discrete", [])) > 0
            cont = len(mi.get("symmetries_continuous", [])) > 0
            self.diameter[obj_id - 1] = mi["diameter"]
            self.is_symmetric[obj_id - 1] = disc or cont
            self.has_continuous_sym[obj_id - 1] = cont
            self.continuous_sym[obj_id] = mi.get("symmetries_continuous", [])
            pts, faces = load_ply(os.path.join(model_dir, f"obj_{obj_id:06d}.ply"))
            self.verts_full[obj_id] = pts
            self.faces[obj_id] = faces
            if max_points is not None and pts.shape[0] > max_points:
                # uniform subsample for the ADD metrics (deterministic)
                sel = rng.choice(pts.shape[0], max_points, replace=False)
                pts = pts[np.sort(sel)]
            self.points[obj_id] = pts

    def points_padded(self):
        """([n_obj, P_max, 3] f32, [n_obj] int32 counts) dense arrays,
        row o = obj_id o+1 (missing ids get zero points)."""
        n = len(self.diameter)
        pmax = max(p.shape[0] for p in self.points.values())
        out = np.zeros((n, pmax, 3), np.float32)
        cnt = np.zeros((n,), np.int32)
        for obj_id, pts in self.points.items():
            out[obj_id - 1, : pts.shape[0]] = pts
            cnt[obj_id - 1] = pts.shape[0]
        return out, cnt


def load_mesh_db(model_dir: str, max_points: int | None = 4096) -> MeshDb:
    return MeshDb(model_dir, max_points=max_points)
