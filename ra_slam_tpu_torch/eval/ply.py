"""Minimal PLY triangle-mesh I/O in numpy (counterpart of
`ra_slam_tpu/eval/ply.py`; no open3d/plyfile dependency).

Supports what the ScanNet eval path needs: reading
`*_vh_clean_2.labels.ply` (binary or ascii vertices with x/y/z
[+ color] + `label` property, plus triangle faces) and writing
binary meshes with per-vertex colors for visual comparison.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


@dataclasses.dataclass
class PlyMesh:
    vertices: np.ndarray  # [V, 3] float
    faces: np.ndarray  # [F, 3] int
    vertex_props: Dict[str, np.ndarray]  # all per-vertex properties by name

    @property
    def labels(self) -> Optional[np.ndarray]:
        return self.vertex_props.get("label")


def _parse_header(f) -> Tuple[str, List[Tuple[str, int, list]]]:
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[Tuple[str, int, list]] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tok = line.decode("ascii").strip().split()
        if not tok or tok[0] == "comment":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append(("scalar", tok[1], tok[2]))
        elif tok[0] == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing format line")
    return fmt, elements


def load_ply(path: str) -> PlyMesh:
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        endian = "<" if fmt != "binary_big_endian" else ">"
        data: Dict[str, Dict[str, np.ndarray]] = {}

        for name, count, props in elements:
            if fmt == "ascii":
                data[name] = _read_ascii_element(f, count, props)
            else:
                data[name] = _read_binary_element(f, count, props, endian)

    vdata = data.get("vertex", {})
    verts = np.stack(
        [vdata["x"], vdata["y"], vdata["z"]], axis=-1
    ).astype(np.float64)
    fdata = data.get("face", {})
    faces = fdata.get(
        "vertex_indices", fdata.get("vertex_index", np.zeros((0, 3), np.int32))
    )
    props = {k: v for k, v in vdata.items() if k not in ("x", "y", "z")}
    return PlyMesh(vertices=verts, faces=np.asarray(faces, np.int32), vertex_props=props)


def _read_binary_element(f, count: int, props, endian: str):
    simple = all(p[0] == "scalar" for p in props)
    if simple:
        dt = np.dtype([(p[2], endian + _PLY_DTYPES[p[1]]) for p in props])
        arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
        return {n: np.ascontiguousarray(arr[n]) for n in arr.dtype.names}
    # list properties (faces): assume one uniform list per row
    out_rows = []
    for _ in range(count):
        row = []
        for p in props:
            if p[0] == "list":
                cnt_dt = np.dtype(endian + _PLY_DTYPES[p[1]])
                val_dt = np.dtype(endian + _PLY_DTYPES[p[2]])
                (n,) = np.frombuffer(f.read(cnt_dt.itemsize), dtype=cnt_dt)
                vals = np.frombuffer(f.read(val_dt.itemsize * int(n)), dtype=val_dt)
                row.append(vals)
            else:
                dt = np.dtype(endian + _PLY_DTYPES[p[1]])
                (v,) = np.frombuffer(f.read(dt.itemsize), dtype=dt)
                row.append(v)
        out_rows.append(row)
    name = props[0][3] if props[0][0] == "list" else props[0][2]
    return {name: np.array([r[0] for r in out_rows])}


def _read_ascii_element(f, count: int, props):
    cols: Dict[str, list] = {}
    for _ in range(count):
        tok = f.readline().decode("ascii").split()
        i = 0
        for p in props:
            if p[0] == "list":
                n = int(tok[i])
                vals = [float(v) for v in tok[i + 1 : i + 1 + n]]
                cols.setdefault(p[3], []).append(vals)
                i += 1 + n
            else:
                cols.setdefault(p[2], []).append(float(tok[i]))
                i += 1
    return {k: np.array(v) for k, v in cols.items()}


def save_ply(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_colors: Optional[np.ndarray] = None,  # [V, 3] float 0..1 or uint8
    vertex_labels: Optional[np.ndarray] = None,  # [V] int
) -> None:
    """Write a binary-little-endian PLY triangle mesh."""
    v = np.asarray(vertices, np.float32)
    fcs = np.asarray(faces, np.int32)
    n, m = len(v), len(fcs)

    props = ["property float x", "property float y", "property float z"]
    vdt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if vertex_colors is not None:
        c = np.asarray(vertex_colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
        props += [f"property uchar {ch}" for ch in ("red", "green", "blue")]
        vdt += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if vertex_labels is not None:
        props.append("property ushort label")
        vdt.append(("label", "<u2"))

    vrec = np.empty(n, dtype=np.dtype(vdt))
    vrec["x"], vrec["y"], vrec["z"] = v[:, 0], v[:, 1], v[:, 2]
    if vertex_colors is not None:
        vrec["red"], vrec["green"], vrec["blue"] = c[:, 0], c[:, 1], c[:, 2]
    if vertex_labels is not None:
        vrec["label"] = np.asarray(vertex_labels, np.uint16)

    frec = np.empty(m, dtype=np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    frec["n"] = 3
    frec["i"] = fcs

    header = "\n".join(
        [
            "ply",
            "format binary_little_endian 1.0",
            f"element vertex {n}",
            *props,
            f"element face {m}",
            "property list uchar int vertex_indices",
            "end_header",
        ]
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii") + b"\n")
        f.write(vrec.tobytes())
        f.write(frec.tobytes())
