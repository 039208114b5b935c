"""Camera geometry: host-side NDC/ray helpers (numpy) and the projection
used inside the render loop (torch).

Counterpart of the JAX package's ``ops/camera.py`` (reference
code1/misc/camera.py:351-407, code1/dataset/dtu_train.py:460-479).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


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
