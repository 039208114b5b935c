"""A camera path between the render views, and frames of a mesh along it.

Counterpart of the JAX package's ``postproc/trajectory.py`` (reference
render_trajectory_dtu.py:57-77: Slerp between the render cameras;
render_trajectory_open3d.py:21-51: an offscreen render per pose): each
frame casts one ray per pixel against the mesh through the port's BVH
(``postproc/raycast.py``) and shades the first hit (Lambert on the face
normal, or the face's mean vertex colour). Frames are written as PNGs
(``data/image.write_png``): the port carries no video encoder.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ..data.image import write_png


def interpolate_poses(w2cs: Sequence[np.ndarray], n_frames: int = 240,
                      closed: bool = False) -> List[np.ndarray]:
    """``n_frames`` world-to-camera matrices: rotations Slerped and camera
    centres interpolated linearly between consecutive cameras (back to the
    first with ``closed``). Returns (4, 4) float32 matrices."""
    from scipy.spatial.transform import Rotation, Slerp

    w2cs = [np.asarray(p, np.float64) for p in w2cs]
    if closed:
        w2cs = w2cs + [w2cs[0]]
    n_seg = len(w2cs) - 1
    if n_seg < 1:
        raise ValueError("a trajectory needs at least two cameras")

    keys = Rotation.from_matrix(np.stack([p[:3, :3] for p in w2cs]))
    slerp = Slerp(np.arange(len(w2cs), dtype=np.float64), keys)
    centers = np.stack([-p[:3, :3].T @ p[:3, 3] for p in w2cs])
    out = []
    for t in np.linspace(0, n_seg, n_frames):
        rot = slerp([t]).as_matrix()[0]
        i = min(int(np.floor(t)), n_seg - 1)
        a = t - i
        c = (1 - a) * centers[i] + a * centers[i + 1]
        e = np.eye(4)
        e[:3, :3] = rot
        e[:3, 3] = -rot @ c
        out.append(e.astype(np.float32))
    return out


def render_mesh_frame(inter, verts: np.ndarray, faces: np.ndarray,
                      w2c: np.ndarray, K: np.ndarray, wh,
                      light_dir=(0.3, -0.5, 0.8),
                      colors: Optional[np.ndarray] = None,
                      bg: float = 1.0) -> np.ndarray:
    """One frame seen by camera ``w2c`` with intrinsics ``K`` at ``wh`` (W,
    H): each pixel centre's ray to its first hit in ``inter`` (a
    ``RayMeshIntersector`` of the mesh), shaded ``0.25 + 0.75 |n . l|``
    times grey 0.75 or the face's mean vertex colour, ``bg`` where it
    misses. Returns (H, W, 3) uint8."""
    w, h = wh
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5, np.ones(h * w)], axis=0)
    k_inv = np.linalg.inv(np.asarray(K)[:3, :3])
    c2w = np.linalg.inv(np.asarray(w2c, np.float64))
    d = c2w[:3, :3] @ (k_inv @ pix)
    d = (d / np.linalg.norm(d, axis=0)).T.astype(np.float32)
    o = np.tile(c2w[:3, 3].astype(np.float32), (h * w, 1))

    tri, _ = inter.intersects_first(o, d)
    img = np.full((h * w, 3), bg, np.float32)
    hit = tri >= 0
    if hit.any():
        f = faces[tri[hit]]
        p0, p1, p2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
        n = np.cross(p1 - p0, p2 - p0)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        ld = np.asarray(light_dir, np.float64)
        ld = ld / np.linalg.norm(ld)
        lam = 0.25 + 0.75 * np.abs(n @ ld)
        base = (colors[f].mean(axis=1) / 255.0 if colors is not None
                else np.full((hit.sum(), 3), 0.75))
        img[hit] = base * lam[:, None]
    return (np.clip(img, 0, 1).reshape(h, w, 3) * 255).astype(np.uint8)


def render_trajectory(verts: np.ndarray, faces: np.ndarray,
                      w2cs: Sequence[np.ndarray], K: np.ndarray,
                      wh=(400, 300), n_frames: int = 240,
                      out_dir: Optional[str] = None,
                      colors: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """The frames of the mesh along ``interpolate_poses(w2cs, n_frames)``;
    with ``out_dir``, also written there as ``{i:04d}.png``."""
    from .raycast import RayMeshIntersector

    inter = RayMeshIntersector(verts, faces)
    frames = [render_mesh_frame(inter, verts, faces, p, K, wh, colors=colors)
              for p in interpolate_poses(w2cs, n_frames)]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for i, frame in enumerate(frames):
            write_png(os.path.join(out_dir, f"{i:04d}.png"), frame)
    return frames
