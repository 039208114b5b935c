"""Camera geometry: host-side NDC/ray helpers (numpy) and the projection
used inside the render loop (torch).

Counterpart of the JAX package's ``ops/camera.py`` (reference
code1/misc/camera.py:351-407, code1/dataset/dtu_train.py:460-479).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def load_K_Rt_from_P(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Decompose a 3x4 projection matrix into intrinsics and c2w pose.

    Equivalent of the reference's cv2.decomposeProjectionMatrix path
    (dtu_train.py:56-77) implemented with an RQ decomposition so the data
    layer has no OpenCV dependency. Returns (intrinsics 4x4, c2w pose 4x4).
    """
    from scipy.linalg import rq

    P = np.asarray(P, dtype=np.float64)[:3, :4]
    M = P[:, :3]
    K, R = rq(M)
    # Fix signs so that diag(K) > 0 (cv2.decomposeProjectionMatrix convention).
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    D = np.diag(signs)
    K = K @ D
    R = D @ R
    if np.linalg.det(R) < 0:
        R = -R
    # Camera center: right null space of P.
    _, _, vh = np.linalg.svd(P)
    c = vh[-1]
    c = c[:3] / c[3]
    K = K / K[2, 2]
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K.astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T.astype(np.float32)  # c2w rotation
    pose[:3, 3] = c.astype(np.float32)
    return intrinsics, pose


def ndc_normalize_matrix(img_w: int, img_h: int) -> np.ndarray:
    """Pixel -> NDC matrix mapping pixel 0 -> -1 and (size-1) -> +1."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 1.0 / ((img_w - 1) / 2.0)
    m[0, 2] = -1.0
    m[1, 1] = 1.0 / ((img_h - 1) / 2.0)
    m[1, 2] = -1.0
    return m


def homo_pixel_grid(img_w: int, img_h: int) -> np.ndarray:
    """(4, H*W) homogeneous NDC pixel grid [x_ndc, y_ndc, 1, 1]."""
    h_line = np.linspace(0, img_h - 1, img_h) * 2 / (img_h - 1) - 1
    w_line = np.linspace(0, img_w - 1, img_w) * 2 / (img_w - 1) - 1
    h_mesh, w_mesh = np.meshgrid(h_line, w_line, indexing="ij")
    ones = np.ones(img_h * img_w)
    return np.stack(
        [w_mesh.reshape(-1), h_mesh.reshape(-1), ones, ones], axis=0
    ).astype(np.float32)


def build_rays(pose_inv: np.ndarray, homo_pixel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Camera origin and unit ray directions from an inverse NDC pose.

    Returns (ray_o (3,), ray_d (3, H*W))."""
    ray_o = pose_inv[:3, -1]
    ray_d = (pose_inv @ homo_pixel)[:3] - ray_o[:, None]
    ray_d = ray_d / np.linalg.norm(ray_d, axis=0, keepdims=True)
    return ray_o.astype(np.float32), ray_d.astype(np.float32)


def cam_ray_d(intrinsics_ndc_inv: np.ndarray, homo_pixel: np.ndarray) -> np.ndarray:
    """Unit ray directions in the camera frame (3, H*W).

    Reference: dtu_train.py:477-479.
    """
    d = (intrinsics_ndc_inv @ homo_pixel)[:3]
    return (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)


def view_frustum_points(
    min_depth: float, max_depth: float, img_hw: Sequence[int],
    intr: np.ndarray, c2w: np.ndarray,
) -> np.ndarray:
    """8 world-space frustum corner points (3, 8).

    Reference: scene_transform.py:14-47.
    """
    im_h, im_w = int(img_hw[0]), int(img_hw[1])
    xs = np.array([0, 0, im_w, im_w, 0, 0, im_w, im_w], dtype=np.float64)
    ys = np.array([0, im_h, 0, im_h, 0, im_h, 0, im_h], dtype=np.float64)
    ds = np.array([min_depth] * 4 + [max_depth] * 4, dtype=np.float64)
    pts_cam = np.stack(
        [
            (xs - intr[0, 2]) * ds / intr[0, 0],
            (ys - intr[1, 2]) * ds / intr[1, 1],
            ds,
        ]
    )
    pts_h = np.concatenate([pts_cam, np.ones((1, 8))], axis=0)
    return (np.asarray(c2w, dtype=np.float64) @ pts_h)[:3].astype(np.float32)


def get_boundingbox(
    img_hw: Sequence[int],
    intrinsics: Sequence[np.ndarray],
    extrinsics: Sequence[np.ndarray],
    near_fars: Sequence[Sequence[float]],
) -> Tuple[np.ndarray, float, np.ndarray]:
    """Union bounding box of all view frusta -> (center, radius, bounds).

    Reference: scene_transform.py:60-107.
    """
    bnds = np.zeros((3, 2), dtype=np.float64)
    bnds[:, 0] = np.inf
    bnds[:, 1] = -np.inf
    for i in range(len(intrinsics)):
        c2w = np.linalg.inv(np.asarray(extrinsics[i], dtype=np.float64))
        pts = view_frustum_points(
            near_fars[i][0], near_fars[i][1], img_hw, np.asarray(intrinsics[i]), c2w
        )
        bnds[:, 0] = np.minimum(bnds[:, 0], pts.min(axis=1))
        bnds[:, 1] = np.maximum(bnds[:, 1], pts.max(axis=1))
    center = (bnds[:, 0] + bnds[:, 1]) / 2.0
    radius = float((bnds[:, 1] - bnds[:, 0]).max() / 2.0)
    return center.astype(np.float32), radius, bnds.astype(np.float32)


def cal_scale_mat(
    img_hw, intrinsics, extrinsics, near_fars, factor: float = 1.1
) -> Tuple[np.ndarray, float]:
    """Scene normalization matrix and 1/radius scale factor.

    Reference: dtu_train.py:299-307.
    """
    center, radius, _ = get_boundingbox(img_hw, intrinsics, extrinsics, near_fars)
    radius = radius * factor
    scale_mat = np.diag([radius, radius, radius, 1.0]).astype(np.float32)
    scale_mat[:3, 3] = center
    return scale_mat, float(1.0 / radius)


def project_points_ndc(
    poses: torch.Tensor,
    points: torch.Tensor,
    near_far: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project world points through NDC camera matrices, all views at once.

    Args:
      poses: (NV, 4, 4) NDC projection matrices.
      points: (..., 3) world points shared across views.
      near_far: optional (near, far); when given the depth channel is
        normalised to [-1, 1].

    Returns:
      xy (NV, ..., 2), xyz (NV, ..., 3) and valid (NV, ...), the mask of
      points with positive depth.
    """
    pts = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    nv = poses.shape[0]
    flat = pts.reshape(-1, 4)
    proj = torch.einsum("vij,nj->vni", poses, flat).reshape(
        (nv,) + points.shape[:-1] + (4,))
    depth = proj[..., 2]
    valid = (depth > 0).to(points.dtype)
    safe = torch.where(depth == 0.0, torch.full_like(depth, 1e-8), depth)
    xy = proj[..., :2] / safe[..., None]
    if near_far is not None:
        near, far = near_far
        z = (depth - near) / (far - near) * 2.0 - 1.0
    else:
        z = depth
    xyz = torch.cat([xy, z[..., None]], dim=-1)
    return xy, xyz, valid
