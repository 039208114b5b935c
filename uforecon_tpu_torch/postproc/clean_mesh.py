"""Mesh cleaning: mask-visibility filter + frustum ray-cast filter.

A numpy copy of the JAX package's ``postproc/clean_mesh.py``; the mask
dilation is a numpy copy of ``cv2.getStructuringElement(MORPH_ELLIPSE)`` +
``cv2.dilate``, and the first hits come from the native BVH
(``postproc/raycast.py``).

Reference parity (evaluation/clean_mesh.py):
  1. `clean_mesh_faces_by_mask` (clean_mesh.py:106-173): project every vertex
     into each view's object mask — dilated with an 11px ellipse and padded
     to (W+2, H+2) — and keep vertices visible in > minimal_vis views; faces
     survive only if all three vertices survive.
  2. `clean_mesh_faces_outside_frustum` (clean_mesh.py:216-267): cast a ray
     from every masked pixel of every view through the mesh (first hit via
     the native BVH, replacing pyembree), keep only faces some ray hits,
     then keep connected components with >= 500 faces.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def ellipse_kernel(size: int) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))``."""
    r = c = size // 2
    k = np.zeros((size, size), np.uint8)
    for i in range(size):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) / (r * r)))) if r else 0
            k[i, max(c - dx, 0):min(c + dx + 1, size)] = 1
    return k


def dilate(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.dilate`` of a binary mask (outside the image counts as 0)."""
    h, w = mask.shape
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    pad = np.zeros((h + kh - 1, w + kw - 1), bool)
    pad[ay:ay + h, ax:ax + w] = mask
    out = np.zeros((h, w), bool)
    for i, j in zip(*np.nonzero(kernel)):
        out |= pad[i:i + h, j:j + w]
    return out


def dilate_mask(mask: np.ndarray, kernel: int = 11,
                pad_to: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Binary mask -> dilated (11px ellipse) and padded by 1px border
    (reference clean_mesh.py:119-127 pads 1600x1200 masks to 1602x1202)."""
    m = dilate(np.asarray(mask) > 0, ellipse_kernel(kernel))
    if pad_to is not None:
        ph, pw = pad_to
        out = np.zeros((ph, pw), bool)
        oy = (ph - m.shape[0]) // 2
        ox = (pw - m.shape[1]) // 2
        out[oy:oy + m.shape[0], ox:ox + m.shape[1]] = m
        m = out
    return m


def project_points(points: np.ndarray, intrinsic: np.ndarray,
                   w2c: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """World points -> pixel coords (x, y) and camera z."""
    cam = (w2c[:3, :3] @ points.T + w2c[:3, 3:])
    z = cam[2]
    pix = intrinsic[:3, :3] @ cam
    with np.errstate(divide="ignore", invalid="ignore"):
        xy = pix[:2] / np.maximum(pix[2], 1e-9)
    return xy.T, z


def clean_mesh_faces_by_mask(
    verts: np.ndarray, faces: np.ndarray,
    masks: Sequence[np.ndarray],
    intrinsics: Sequence[np.ndarray],
    w2cs: Sequence[np.ndarray],
    minimal_vis: int = 1,
    mask_dilated_size: int = 11,
) -> Tuple[np.ndarray, np.ndarray]:
    """Keep faces whose vertices are visible inside > minimal_vis view masks."""
    vis_count = np.zeros(len(verts), np.int32)
    for mask, K, E in zip(masks, intrinsics, w2cs):
        m = dilate_mask(mask, mask_dilated_size,
                        pad_to=(mask.shape[0] + 2, mask.shape[1] + 2))
        xy, z = project_points(verts, np.asarray(K), np.asarray(E))
        # +1 offset for the padding border
        xi = np.round(xy[:, 0]).astype(np.int64) + 1
        yi = np.round(xy[:, 1]).astype(np.int64) + 1
        ok = (z > 0) & (xi >= 0) & (yi >= 0) & (xi < m.shape[1]) & (yi < m.shape[0])
        inside = np.zeros(len(verts), bool)
        inside[ok] = m[yi[ok], xi[ok]]
        vis_count += inside.astype(np.int32)
    keep_vert = vis_count > minimal_vis
    keep_face = keep_vert[faces].all(axis=1)
    return _compact(verts, faces[keep_face])


def _compact(verts: np.ndarray, faces: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop unreferenced vertices; reindex faces."""
    used = np.unique(faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def face_connected_components(faces: np.ndarray) -> np.ndarray:
    """Label faces by connectivity through shared vertices (union-find).

    The reference uses trimesh's facets/connected components
    (clean_mesh.py:249-267); vertex-shared connectivity is a superset of
    edge-shared and matches for closed surfaces.
    """
    n_f = len(faces)
    if n_f == 0:
        return np.zeros(0, np.int64)
    n_v = int(faces.max()) + 1
    parent = np.arange(n_v + n_f, dtype=np.int64)  # verts then faces

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for fi in range(n_f):
        fid = n_v + fi
        for v in faces[fi]:
            ra, rb = find(fid), find(v)
            if ra != rb:
                parent[rb] = ra
    labels = np.array([find(n_v + i) for i in range(n_f)])
    _, labels = np.unique(labels, return_inverse=True)
    return labels


def clean_mesh_faces_outside_frustum(
    verts: np.ndarray, faces: np.ndarray,
    masks: Sequence[np.ndarray],
    intrinsics: Sequence[np.ndarray],
    w2cs: Sequence[np.ndarray],
    min_component_faces: int = 500,
    ray_stride: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Keep only faces hit by a ray through some masked pixel, then keep
    connected components >= min_component_faces."""
    from .raycast import RayMeshIntersector

    inter = RayMeshIntersector(verts, faces)
    hit_faces = np.zeros(len(faces), bool)
    for mask, K, E in zip(masks, intrinsics, w2cs):
        m = np.asarray(mask) > 0
        ys, xs = np.nonzero(m)
        if ray_stride > 1:
            ys, xs = ys[::ray_stride], xs[::ray_stride]
        if len(ys) == 0:
            continue
        Ki = np.linalg.inv(np.asarray(K)[:3, :3])
        c2w = np.linalg.inv(np.asarray(E))
        pix = np.stack([xs + 0.5, ys + 0.5, np.ones(len(xs))], axis=0)
        d_cam = Ki @ pix
        d_world = c2w[:3, :3] @ d_cam
        d_world = (d_world / np.linalg.norm(d_world, axis=0)).T
        o_world = np.tile(c2w[:3, 3], (len(xs), 1))
        tri, _ = inter.intersects_first(o_world.astype(np.float32),
                                        d_world.astype(np.float32))
        hit_faces[tri[tri >= 0]] = True

    verts2, faces2 = _compact(verts, faces[hit_faces])
    if len(faces2) == 0:
        return verts2, faces2
    labels = face_connected_components(faces2)
    counts = np.bincount(labels)
    keep = counts[labels] >= min(min_component_faces, counts.max())
    return _compact(verts2, faces2[keep])


def clean_mesh(
    verts: np.ndarray, faces: np.ndarray,
    masks: Sequence[np.ndarray],
    intrinsics: Sequence[np.ndarray],
    w2cs: Sequence[np.ndarray],
    minimal_vis: int = 1,
    mask_dilated_size: int = 11,
    min_component_faces: int = 500,
    ray_stride: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full pipeline: mask filter then frustum filter (clean_mesh.py:282-328)."""
    verts, faces = clean_mesh_faces_by_mask(
        verts, faces, masks, intrinsics, w2cs,
        minimal_vis=minimal_vis, mask_dilated_size=mask_dilated_size)
    if len(faces) == 0:
        return verts, faces
    return clean_mesh_faces_outside_frustum(
        verts, faces, masks, intrinsics, w2cs,
        min_component_faces=min_component_faces, ray_stride=ray_stride)
