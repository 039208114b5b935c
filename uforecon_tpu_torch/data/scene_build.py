"""Shared scene normalisation: unit-sphere scale matrix, NDC poses, rays
and multi-stage MVS projection matrices.

A numpy copy of the JAX package's ``data/scene_build.py`` (reference
dtu_train.py:402-495, dtu_test_sparse.py:311-436).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..ops import camera


def build_proj_matrices_ms(w2cs_rel: np.ndarray, intrinsics: np.ndarray) -> Dict[str, np.ndarray]:
    """Multi-stage MVS projection stacks.

    slot 0 = extrinsic (reference-relative w2c), slot 1 = intrinsic scaled by
    1/4, 1/2, 1 per stage (reference dtu_train.py:378-397).
    Returns stage -> (V, 2, 4, 4).
    """
    v = len(w2cs_rel)
    base = np.zeros((v, 2, 4, 4), np.float32)
    for i in range(v):
        base[i, 0] = w2cs_rel[i]
        k = np.eye(4, dtype=np.float32)
        k[:3, :3] = intrinsics[i][:3, :3]
        k[:2] /= 4.0
        base[i, 1] = k
    out = {"stage1": base}
    for s, mult in (("stage2", 2.0), ("stage3", 4.0)):
        p = base.copy()
        p[:, 1, :2] *= mult
        out[s] = p
    return out


def scale_scene(
    intrinsics: np.ndarray,       # (V, 4, 4) or (V, 3, 3)
    w2cs_rel: np.ndarray,         # (V, 4, 4) reference-relative w2c
    raw_near_fars: np.ndarray,    # (V, 2)
    img_hw: Sequence[int],
    render_w2cs_rel: Optional[np.ndarray] = None,
    bbox_factor: float = 1.1,
) -> Dict[str, np.ndarray]:
    """Normalize the scene to a unit sphere and rebuild all camera tensors.

    Returns dict with scale_mat, scale_factor, w2cs, c2ws, near_fars,
    intrinsics (4x4), proj_matrices_ms, and (if render poses given)
    render_w2cs / render_c2ws.
    """
    v = len(w2cs_rel)
    intr4 = np.zeros((v, 4, 4), np.float32)
    for i in range(v):
        intr4[i] = np.eye(4, dtype=np.float32)
        intr4[i][:3, :3] = np.asarray(intrinsics[i])[:3, :3]

    scale_mat, scale_factor = camera.cal_scale_mat(
        img_hw, intr4, w2cs_rel, raw_near_fars, factor=bbox_factor
    )

    def rescale(w2c_set):
        new_w2cs, new_c2ws, new_nf = [], [], []
        for i in range(v):
            P = (intr4[i] @ w2c_set[i] @ scale_mat)[:3, :4]
            _, c2w = camera.load_K_Rt_from_P(P)
            w2c = np.linalg.inv(c2w)
            new_w2cs.append(w2c)
            new_c2ws.append(c2w)
            dist = float(np.linalg.norm(c2w[:3, 3]))
            new_nf.append([0.95 * (dist - 1.0), 1.05 * (dist + 1.0)])
        return (np.stack(new_w2cs).astype(np.float32),
                np.stack(new_c2ws).astype(np.float32),
                np.array(new_nf, np.float32))

    w2cs, c2ws, near_fars = rescale(w2cs_rel)
    out = {
        "scale_mat": scale_mat,
        "scale_factor": np.float32(scale_factor),
        "w2cs": w2cs,
        "c2ws": c2ws,
        "near_fars": near_fars,
        "intrinsics": intr4,
        "proj_matrices": build_proj_matrices_ms(w2cs_rel, intr4),
    }
    if render_w2cs_rel is not None:
        rw2cs, rc2ws, _ = rescale(render_w2cs_rel)
        out["render_w2cs"] = rw2cs
        out["render_c2ws"] = rc2ws
    return out


def build_ndc_and_rays(
    intrinsics4: np.ndarray,   # (V, 4, 4)
    w2cs: np.ndarray,          # (V, 4, 4) scaled-scene w2c
    ref_w2c_for_rays: np.ndarray,  # (4, 4) pose the rays are cast from
    ref_intrinsic4: np.ndarray,    # (4, 4)
    img_wh: Sequence[int],
) -> Dict[str, np.ndarray]:
    """NDC projection matrices, reference rays and camera-frame rays.

    Reference: dtu_train.py:456-479 / dtu_test_sparse.py:405-429.
    """
    w, h = int(img_wh[0]), int(img_wh[1])
    norm = camera.ndc_normalize_matrix(w, h)
    poses = np.stack([norm @ intrinsics4[i] @ w2cs[i] for i in range(len(w2cs))])
    poses_inv = np.stack([np.linalg.inv(p) for p in poses]).astype(np.float32)

    ref_pose = (norm @ ref_intrinsic4 @ ref_w2c_for_rays).astype(np.float32)
    ref_pose_inv = np.linalg.inv(ref_pose).astype(np.float32)

    hp = camera.homo_pixel_grid(w, h)
    ray_o, ray_d = camera.build_rays(ref_pose_inv, hp)
    cam_rd = camera.cam_ray_d(
        np.linalg.inv(norm @ ref_intrinsic4).astype(np.float32), hp
    )
    return {
        "poses_ndc": poses.astype(np.float32),
        "poses_ndc_inv": poses_inv,
        "ref_pose": ref_pose,
        "ref_pose_inv": ref_pose_inv,
        "ray_o": ray_o,
        "ray_d": ray_d.T,        # (H*W, 3)
        "cam_ray_d": cam_rd.T,   # (H*W, 3)
    }


def depth_values_from_cam(depth_min: float, depth_interval: float,
                          ndepths: int = 192,
                          interval_scale: float = 1.06) -> np.ndarray:
    """MVS depth hypotheses in mm (reference dtu_train.py:229,372-374 —
    including the 1.06 interval widening)."""
    step = depth_interval * interval_scale
    return (depth_min + np.arange(ndepths, dtype=np.float32) * step)
