"""Geometric-consistency depth fusion (MVSNet-style point-cloud path).

A numpy copy of the JAX package's ``fusion/depth_fusion.py``.

Host-side rewrite of the reference depth fusion
(reference: code1/utils/depth_fusion.py:55-231, byte-identical duplicate in
encoder_utils/). For each reference view: reproject its depth into every
source view and back; a pixel is consistent when the round-trip pixel error
is < 1 px and the relative depth error is < 1% (check_geometric_consistency,
depth_fusion.py:75-90). Keep pixels consistent in >= geo_mask_thres views,
average the reprojected depths, back-project to world, concatenate into one
point cloud.

The cv2.remap calls of the reference become vectorized numpy bilinear
sampling; the per-view python loop stays (tiny: n_views <= 5).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Bilinear sample img (H, W) at float pixel coords; 0 outside."""
    h, w = img.shape
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    wx = x - x0
    wy = y - y0

    def at(yy, xx):
        v = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        out = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return out * v

    return (
        at(y0, x0) * (1 - wx) * (1 - wy)
        + at(y0, x0 + 1) * wx * (1 - wy)
        + at(y0 + 1, x0) * (1 - wx) * wy
        + at(y0 + 1, x0 + 1) * wx * wy
    )


def reproject(depth_ref, intr_ref, ext_ref, depth_src, intr_src, ext_src):
    """Project ref depth into src, sample src depth, project back.

    Returns (depth_reprojected, x2d_reprojected, y2d_reprojected,
    x2d_src, y2d_src) — reference reproject_with_depth semantics
    (depth_fusion.py:20-72).
    """
    h, w = depth_ref.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xs = xs.astype(np.float64)
    ys = ys.astype(np.float64)

    Ki = np.linalg.inv(intr_ref[:3, :3])
    pts_cam = (Ki @ np.stack([xs, ys, np.ones_like(xs)]).reshape(3, -1)) * depth_ref.reshape(1, -1)
    T = ext_src @ np.linalg.inv(ext_ref)
    pts_src = T[:3, :3] @ pts_cam + T[:3, 3:]
    z_src = pts_src[2]
    pix_src = intr_src[:3, :3] @ pts_src
    x_src = (pix_src[0] / np.where(z_src == 0, 1, z_src)).reshape(h, w)
    y_src = (pix_src[1] / np.where(z_src == 0, 1, z_src)).reshape(h, w)

    sampled = _bilinear(depth_src.astype(np.float64), x_src, y_src)

    # back-project the sampled src depth to ref
    Ks = np.linalg.inv(intr_src[:3, :3])
    pts_src2 = (Ks @ np.stack([x_src, y_src, np.ones_like(x_src)]).reshape(3, -1)) * sampled.reshape(1, -1)
    Tinv = ext_ref @ np.linalg.inv(ext_src)
    pts_ref = Tinv[:3, :3] @ pts_src2 + Tinv[:3, 3:]
    z_re = pts_ref[2].reshape(h, w)
    pix_re = intr_ref[:3, :3] @ pts_ref
    zsafe = np.where(pts_ref[2] == 0, 1, pts_ref[2])
    x_re = (pix_re[0] / zsafe).reshape(h, w)
    y_re = (pix_re[1] / zsafe).reshape(h, w)
    return z_re, x_re, y_re, x_src, y_src


def check_geometric_consistency(depth_ref, intr_ref, ext_ref,
                                depth_src, intr_src, ext_src,
                                pix_thresh: float = 1.0,
                                depth_thresh: float = 0.01):
    """Mask of ref pixels consistent with one src view
    (depth_fusion.py:75-90)."""
    h, w = depth_ref.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z_re, x_re, y_re, x_src, y_src = reproject(
        depth_ref, intr_ref, ext_ref, depth_src, intr_src, ext_src
    )
    dist = np.sqrt((x_re - xs) ** 2 + (y_re - ys) ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(z_re - depth_ref) / np.where(depth_ref == 0, 1, depth_ref)
    mask = (dist < pix_thresh) & (rel < depth_thresh) & (depth_ref > 0)
    z_re = np.where(mask, z_re, 0.0)
    return mask, z_re, x_src, y_src


def filter_depth_maps(
    entries: Sequence[Dict],
    geo_mask_thres: int = 2,
    pix_thresh: float = 1.0,
    depth_thresh: float = 0.01,
    rgb_images: Optional[Sequence[np.ndarray]] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray], List[np.ndarray]]:
    """Fuse a set of per-view depth entries into a world point cloud.

    Args:
      entries: list of {"depth": HxW, "extrinsic": 4x4 w2c, "intrinsic": 3x3}.

    Returns (points (N, 3), colors or None, per-view keep masks).
    """
    n = len(entries)
    points, colors, masks = [], [], []
    for r in range(n):
        dr = np.asarray(entries[r]["depth"], np.float64)
        ir = np.eye(4)
        ir[:3, :3] = entries[r]["intrinsic"][:3, :3]
        er = np.asarray(entries[r]["extrinsic"], np.float64)

        geo_count = np.zeros(dr.shape, np.int32)
        depth_sum = dr.copy()
        for s in range(n):
            if s == r:
                continue
            ds = np.asarray(entries[s]["depth"], np.float64)
            isrc = np.eye(4)
            isrc[:3, :3] = entries[s]["intrinsic"][:3, :3]
            es = np.asarray(entries[s]["extrinsic"], np.float64)
            m, z_re, _, _ = check_geometric_consistency(
                dr, ir, er, ds, isrc, es, pix_thresh, depth_thresh
            )
            geo_count += m.astype(np.int32)
            depth_sum += z_re
        depth_avg = depth_sum / (geo_count + 1)
        keep = (geo_count >= geo_mask_thres) & (dr > 0)
        masks.append(keep)

        h, w = dr.shape
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        Ki = np.linalg.inv(ir[:3, :3])
        d = depth_avg[keep]
        pix = np.stack([xs[keep], ys[keep], np.ones(keep.sum())])
        cam = (Ki @ pix) * d
        c2w = np.linalg.inv(er)
        world = (c2w[:3, :3] @ cam + c2w[:3, 3:]).T
        points.append(world.astype(np.float32))
        if rgb_images is not None:
            colors.append(np.asarray(rgb_images[r])[keep])

    pts = np.concatenate(points, axis=0)
    cols = np.concatenate(colors, axis=0) if colors else None
    return pts, cols, masks
