"""File I/O: PFM depth maps, MVSNet cam.txt / pair.txt, PLY meshes.

A numpy copy of the JAX package's ``data/io.py``: the same readers and
writers, byte for byte the same files. Malformed input raises
``ValueError``.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np


# --------------------------------------------------------------------------
# PFM
# --------------------------------------------------------------------------


def read_pfm(path) -> Tuple[np.ndarray, float]:
    """Read a PFM image; returns (data upright, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline().decode("utf-8")
        m = re.match(r"^(\d+)\s(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)


def write_pfm(path, data: np.ndarray, scale: float = 1.0) -> None:
    data = np.asarray(data, np.float32)
    color = data.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())       # negative scale: little-endian
        np.flipud(data).astype("<f").tofile(f)


# --------------------------------------------------------------------------
# MVSNet camera / pair files
# --------------------------------------------------------------------------


def _floats(text: str) -> np.ndarray:
    return np.array(text.split(), np.float32)


def read_cam_file(path) -> Dict[str, np.ndarray]:
    """Parse an MVSNet {:08d}_cam.txt.

    Returns dict with 'extrinsic' (4,4), 'intrinsic' (3,3), 'depth_min',
    'depth_interval', 'depth_row' (the raw line-11 floats).
    """
    lines = Path(path).read_text().splitlines()
    extrinsic = _floats(" ".join(lines[1:5])).reshape(4, 4)
    intrinsic = _floats(" ".join(lines[7:10])).reshape(3, 3)
    row = [float(x) for x in lines[11].split()]
    return {
        "extrinsic": extrinsic,
        "intrinsic": intrinsic,
        "depth_min": row[0],
        "depth_interval": row[1],
        "depth_row": np.array(row, np.float32),
    }


def write_cam_file(path, extrinsic: np.ndarray, intrinsic: np.ndarray,
                   depth_row) -> None:
    """Write an MVSNet cam.txt."""
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for r in np.asarray(extrinsic).reshape(4, 4):
            f.write(" ".join(f"{v:.6f}" for v in r) + "\n")
        f.write("\nintrinsic\n")
        for r in np.asarray(intrinsic).reshape(3, 3):
            f.write(" ".join(f"{v:.6f}" for v in r) + "\n")
        f.write("\n" + " ".join(f"{v:.6f}" for v in np.atleast_1d(depth_row)) + "\n")


def read_pair_file(path) -> List[Tuple[int, List[int]]]:
    """Parse pair.txt -> [(ref_view, [scored src views...]), ...]."""
    lines = Path(path).read_text().splitlines()
    n = int(lines[0])
    out = []
    for i in range(n):
        ref = int(lines[1 + 2 * i])
        toks = lines[2 + 2 * i].split()
        out.append((ref, [int(x) for x in toks[1::2]]))
    return out


def write_pair_file(path, pairs: List[Tuple[int, List[Tuple[int, float]]]]) -> None:
    """Write pair.txt from [(ref, [(src, score), ...]), ...]."""
    with open(path, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref, srcs in pairs:
            f.write(f"{ref}\n{len(srcs)} ")
            f.write(" ".join(f"{v} {s:.4f}" for v, s in srcs) + "\n")


# --------------------------------------------------------------------------
# PLY (binary little-endian + ascii read; binary write)
# --------------------------------------------------------------------------


def write_ply(path, vertices: np.ndarray, faces: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None) -> None:
    """Write a binary PLY mesh/point cloud.

    vertices (N,3) float; faces (M,3) int optional; colors (N,3) uint8 optional.
    """
    vertices = np.asarray(vertices, np.float32)
    n = len(vertices)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green", "property uchar blue"]
        if faces is not None:
            hdr += [f"element face {len(faces)}",
                    "property list uchar int vertex_indices"]
        hdr += ["end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if colors is not None:
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = vertices
            rec["rgb"] = np.asarray(colors, np.uint8)
            rec.tofile(f)
        else:
            vertices.astype("<f4").tofile(f)
        if faces is not None:
            rec = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
            rec["n"] = 3
            rec["idx"] = np.asarray(faces, np.int32)
            rec.tofile(f)


_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
}


def read_ply(path) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Read a PLY file -> (vertices (N,3), faces (M,3) or None, colors or None).

    Supports ascii and binary_little_endian with float/double vertex xyz and
    optional uchar rgb; faces as uchar/int list of 3.
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elems = []  # (name, count, [(prop_type, prop_name) or ('list', ...)])
        cur = None
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: PLY header has no end_header")
            line = raw.strip().decode()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elems.append(cur)
            elif line.startswith("property"):
                toks = line.split()
                if toks[1] == "list":
                    cur[2].append(("list", toks[2], toks[3], toks[4]))
                else:
                    cur[2].append((toks[1], toks[2]))
            elif line == "end_header":
                break

        verts = faces = colors = None
        if fmt == "ascii":
            text = f.read().decode().split()
            pos = 0
            for name, cnt, props in elems:
                if name == "vertex":
                    width = len(props)
                    arr = np.array(text[pos:pos + cnt * width], dtype=np.float64)
                    arr = arr.reshape(cnt, width)
                    pos += cnt * width
                    names = [p[1] for p in props]
                    verts = arr[:, [names.index(c) for c in "xyz"]].astype(np.float32)
                    if "red" in names:
                        colors = arr[:, [names.index(c) for c in
                                         ("red", "green", "blue")]].astype(np.uint8)
                elif name == "face":
                    idx = []
                    for _ in range(cnt):
                        k = int(text[pos])
                        pos += 1
                        idx.append([int(text[pos + j]) for j in range(k)])
                        pos += k
                    faces = np.array(idx, np.int32)
            return verts, faces, colors

        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
        for name, cnt, props in elems:
            if name == "vertex":
                dtype = np.dtype([(p[1], "<" + _PLY_TYPES[p[0]]) for p in props])
                rec = np.fromfile(f, dtype=dtype, count=cnt)
                verts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
                if "red" in dtype.names:
                    colors = np.stack([rec["red"], rec["green"], rec["blue"]],
                                      axis=1).astype(np.uint8)
            elif name == "face":
                p = props[0]
                dtype = np.dtype([("n", "<" + _PLY_TYPES[p[1]]),
                                  ("idx", "<" + _PLY_TYPES[p[2]], 3)])
                rec = np.fromfile(f, dtype=dtype, count=cnt)
                faces = rec["idx"].astype(np.int32)
        return verts, faces, colors
