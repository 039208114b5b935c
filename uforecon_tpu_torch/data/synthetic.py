"""A synthetic test sample at DTU scale, made from a seed.

The repo's default DTU configuration at full width without the DTU data:
800x640 views ~660 mm from the object, depth hypotheses from 425 mm at
2.5 x 1.06 mm, near/far 425/900 mm, the scene scaled so that a 300 mm
radius is 1, random images. The dict is the reference-format test sample
that ``data/convert.py scene_inputs_from_sample`` reads. ``chip_smoke.py``
renders it with seeded random weights.
"""
from __future__ import annotations

import numpy as np

from ..ops import camera

SEED = 0


def look_at(eye):
    eye = np.asarray(eye, np.float64)
    z = -eye / np.linalg.norm(eye)
    x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    e = np.eye(4)
    e[:3, :3] = np.stack([x, y, z])
    e[:3, 3] = -e[:3, :3] @ eye
    return e


def dtu_scale_sample(w=800, h=640, n_views=3, n_depth=192, seed: int = SEED) -> dict:
    """One reference-format test sample at DTU scale: 800x640, cameras
    ~660 mm from the object, depth hypotheses from 425 mm at 2.5 x 1.06 mm,
    near/far 425/900 mm, the scene scaled so a 300 mm radius is 1."""
    rng = np.random.default_rng(seed)
    radius_mm = 300.0
    f = 1446.0
    k4 = np.eye(4)
    k4[:3, :3] = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    norm = camera.ndc_normalize_matrix(w, h)
    e_mm, e_s, poses = [], [], []
    for i in range(n_views):
        ang = 0.15 * i
        e = look_at([660.0 * np.sin(ang), 30.0 * i, -660.0 * np.cos(ang)])
        es = e.copy()
        es[:3, 3] /= radius_mm
        e_mm.append(e)
        e_s.append(es)
        poses.append(norm @ k4 @ es)
    e_mm, e_s, poses = (np.stack(a).astype(np.float32) for a in (e_mm, e_s, poses))
    poses_inv = np.stack([np.linalg.inv(p) for p in poses]).astype(np.float32)
    proj = {}
    base = np.zeros((n_views, 2, 4, 4), np.float32)
    base[:, 0] = e_mm
    base[:, 1] = k4
    base[:, 1, :2] /= 4.0
    for s, mult in (("stage1", 1.0), ("stage2", 2.0), ("stage3", 4.0)):
        p = base.copy()
        p[:, 1, :2] *= mult
        proj[s] = p
    hp = camera.homo_pixel_grid(w, h)
    ray_o, ray_d = camera.build_rays(poses_inv[0], hp)
    cam_d = np.linalg.inv(k4[:3, :3]) @ hp[:3]
    cam_ray_d = (cam_d / np.linalg.norm(cam_d, axis=0)).T.astype(np.float32)
    imgs = rng.random((n_views, h, w, 3)).astype(np.float32)
    near, far = 425.0 / radius_mm, 900.0 / radius_mm
    return {
        "source_imgs": imgs, "ref_img": imgs[0], "w2cs": e_s,
        "intrinsics": np.tile(k4[None, :3, :3], (n_views, 1, 1)).astype(np.float32),
        "near_fars": np.tile([[near, far]], (n_views, 1)).astype(np.float32),
        "proj_matrices": proj,
        "depth_values_org_scale": (425.0 + np.arange(n_depth) * 2.5 * 1.06).astype(np.float32),
        "scale_mat": np.diag([radius_mm, radius_mm, radius_mm, 1.0]).astype(np.float32),
        "scale_factor": np.float32(1.0 / radius_mm),
        "ref_pose_inv": poses_inv[0], "source_poses": poses,
        "source_poses_inv": poses_inv, "ray_o": ray_o, "ray_d": ray_d.T.copy(),
        "cam_ray_d": cam_ray_d, "meta": "dtu-scan1-00000000", "start_idx": 0,
    }
