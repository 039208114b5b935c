"""COLMAP sparse-model readers (text and binary) and the MVSNet export.

A numpy copy of the JAX package's ``data/colmap.py`` (reference
colmap2mvsnet.py): read cameras, images and points3D, score each view pair
by the triangulation angles of their shared points (calc_score,
colmap2mvsnet.py:385), take each view's depth range from its visible
points, and write ``cams/{:08d}_cam.txt`` and ``pair.txt`` (at the top of
the output folder, as the JAX package writes it; ``GeneralFit`` reads
``cams/pair.txt``).

The COLMAP file formats are public (colmap/src/colmap/scene/reconstruction_io.cc);
the readers are implementations of the documented layouts.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# camera model id -> (name, #params). Params order follows COLMAP docs.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def K(self) -> np.ndarray:
        p = self.params
        K = np.eye(3, dtype=np.float64)
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            K[0, 0] = K[1, 1] = p[0]
            K[0, 2], K[1, 2] = p[1], p[2]
        else:  # PINHOLE-family: fx fy cx cy ...
            K[0, 0], K[1, 1], K[0, 2], K[1, 2] = p[0], p[1], p[2], p[3]
        return K


@dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    point3d_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    @property
    def R(self) -> np.ndarray:
        return qvec_to_rotmat(self.qvec)

    @property
    def w2c(self) -> np.ndarray:
        E = np.eye(4, dtype=np.float64)
        E[:3, :3] = self.R
        E[:3, 3] = self.tvec
        return E

    @property
    def center(self) -> np.ndarray:
        return -self.R.T @ self.tvec


def qvec_to_rotmat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


# ---------------------------------------------------------------------------
# text readers
# ---------------------------------------------------------------------------

def read_cameras_text(path) -> Dict[int, Camera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            out[int(e[0])] = Camera(int(e[0]), e[1], int(e[2]), int(e[3]),
                                    np.array([float(x) for x in e[4:]]))
    return out


def read_images_text(path) -> Dict[int, Image]:
    out = {}
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.strip().startswith("#")]
    for i in range(0, len(lines), 2):
        e = lines[i].split()
        img = Image(int(e[0]), np.array([float(x) for x in e[1:5]]),
                    np.array([float(x) for x in e[5:8]]), int(e[8]),
                    " ".join(e[9:]))
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        ids = np.array([int(pts[j]) for j in range(2, len(pts), 3)], np.int64)
        img.point3d_ids = ids[ids >= 0]
        out[img.id] = img
    return out


def read_points3d_text(path) -> Dict[int, np.ndarray]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            out[int(e[0])] = np.array([float(e[1]), float(e[2]), float(e[3])])
    return out


# ---------------------------------------------------------------------------
# binary readers
# ---------------------------------------------------------------------------

def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path) -> Dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            out[cid] = Camera(cid, name, int(w), int(h), params)
    return out


def read_images_binary(path) -> Dict[int, Image]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.float64
                                 ).reshape(n_pts, 3) if n_pts else np.zeros((0, 3))
            ids = data[:, 2].view(np.int64) if n_pts else np.zeros(0, np.int64)
            img = Image(iid, qvec, tvec, cam_id, name.decode())
            img.point3d_ids = ids[ids >= 0]
            out[iid] = img
    return out


def read_points3d_binary(path) -> Dict[int, np.ndarray]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            f.read(3)          # rgb
            f.read(8)          # error
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
            out[pid] = xyz
    return out


def read_model(sparse_dir: str):
    """Auto-detect text vs binary model files."""
    def pick(base):
        for ext in (".bin", ".txt"):
            p = os.path.join(sparse_dir, base + ext)
            if os.path.exists(p):
                return p, ext
        raise FileNotFoundError(f"{base}.txt/.bin not in {sparse_dir}")

    p, ext = pick("cameras")
    cameras = read_cameras_binary(p) if ext == ".bin" else read_cameras_text(p)
    p, ext = pick("images")
    images = read_images_binary(p) if ext == ".bin" else read_images_text(p)
    p, ext = pick("points3D")
    points = read_points3d_binary(p) if ext == ".bin" else read_points3d_text(p)
    return cameras, images, points


# ---------------------------------------------------------------------------
# MVSNet export (colmap2mvsnet.py semantics)
# ---------------------------------------------------------------------------

def pair_score(img_a: Image, img_b: Image, points: Dict[int, np.ndarray],
               theta0: float = 5.0, sigma1: float = 1.0, sigma2: float = 10.0
               ) -> float:
    """Shared-point angle score (colmap2mvsnet.py calc_score): sum over
    common 3D points of a piecewise gaussian in the triangulation angle."""
    common = np.intersect1d(img_a.point3d_ids, img_b.point3d_ids)
    if len(common) == 0:
        return 0.0
    ca, cb = img_a.center, img_b.center
    score = 0.0
    for pid in common:
        p = points.get(int(pid))
        if p is None:
            continue
        va, vb = ca - p, cb - p
        cosang = np.dot(va, vb) / max(np.linalg.norm(va) * np.linalg.norm(vb), 1e-12)
        theta = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
        sigma = sigma1 if theta <= theta0 else sigma2
        score += np.exp(-((theta - theta0) ** 2) / (2 * sigma ** 2))
    return float(score)


def depth_range(img: Image, points: Dict[int, np.ndarray],
                n_depths: int = 192, interval_scale: float = 1.0
                ) -> Tuple[float, float]:
    """(depth_min, depth_interval) from the view's visible points
    (colmap2mvsnet.py depth range block): robust 1%/99% z percentiles."""
    zs = []
    R, t = img.R, img.tvec
    for pid in img.point3d_ids:
        p = points.get(int(pid))
        if p is not None:
            zs.append(float((R @ p + t)[2]))
    if not zs:
        return 0.1, 0.01
    zs = np.sort(np.array(zs))
    d_min = float(np.percentile(zs, 1)) * 0.75
    d_max = float(np.percentile(zs, 99)) * 1.25
    interval = (d_max - d_min) / (n_depths - 1) / interval_scale
    return max(d_min, 1e-4), interval


def export_mvsnet(sparse_dir: str, out_dir: str, n_src: int = 10,
                  n_depths: int = 192, interval_scale: float = 1.0) -> None:
    """Write cams/{:08d}_cam.txt + pair.txt in MVSNet layout."""
    from . import io

    cameras, images, points = read_model(sparse_dir)
    os.makedirs(os.path.join(out_dir, "cams"), exist_ok=True)

    # images keyed by a dense index in name order (colmap ids can be sparse)
    order = sorted(images.values(), key=lambda im: im.name)
    for idx, img in enumerate(order):
        cam = cameras[img.camera_id]
        dmin, dint = depth_range(img, points, n_depths, interval_scale)
        io.write_cam_file(
            os.path.join(out_dir, "cams", f"{idx:08d}_cam.txt"),
            img.w2c.astype(np.float32), cam.K.astype(np.float32),
            [dmin, dint],
        )

    pairs = []
    for i, a in enumerate(order):
        scores = []
        for j, b in enumerate(order):
            if i == j:
                continue
            scores.append((j, pair_score(a, b, points)))
        scores.sort(key=lambda s: -s[1])
        pairs.append((i, scores[:n_src]))
    io.write_pair_file(os.path.join(out_dir, "pair.txt"), pairs)
