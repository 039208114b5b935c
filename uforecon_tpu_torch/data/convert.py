"""Sample dict -> device SceneInputs + host render extras.

Counterpart of the JAX package's ``data/convert.py``. The sample dict is the
reference-format contract the JAX data layer produces (reference
dtu_train.py:442-497, the JAX package's ``data/dtu_test.py`` __getitem__);
``start_idx`` is 0 at test (the reference view is a source view) and 1 at
train. The extras carry what training reads too (``ref_img``,
``depths_h``, ``depths_mm``), as the JAX converter's do.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..device import DEFAULT, resolve_device
from ..models.uforecon import SceneInputs


def scene_inputs_from_sample(sample: Dict, device=DEFAULT) -> Tuple[SceneInputs, Dict]:
    """Scene tensors on ``device`` (the card unless the caller asks for the
    CPU) and the host-side render extras."""
    device = resolve_device(device)
    s_idx = int(sample.get("start_idx", 1))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    poses_inv = np.asarray(sample["source_poses_inv"])
    near_fars = np.asarray(sample["near_fars"])
    scene = SceneInputs(
        source_imgs=t(sample["source_imgs"]),
        source_poses=t(sample["source_poses"]),
        src_cam_pos=t(poses_inv[:, :3, -1]),
        ref_cam_pos=t(np.asarray(sample["ref_pose_inv"])[:3, -1]),
        src_w2cs=t(np.asarray(sample["w2cs"])[s_idx:]),
        near=t(near_fars[0, 0]),
        far=t(near_fars[0, 1]),
        ray_o=t(sample["ray_o"]),
        proj_matrices={k: t(v) for k, v in sample["proj_matrices"].items()},
        depth_values=t(sample["depth_values_org_scale"]),
        scale_factor=t(sample["scale_factor"]),
    )
    extras = {
        "ray_d": np.asarray(sample["ray_d"], np.float32),          # (H*W, 3)
        "cam_ray_d": np.asarray(sample["cam_ray_d"], np.float32),  # (H*W, 3)
        "scale_mat": np.asarray(sample["scale_mat"]),
        "meta": sample.get("meta", ""),
        "hw": np.asarray(sample["ref_img"]).shape[:2],
        "extrinsic_render_view": np.asarray(
            sample.get("extrinsic_render_view", sample["w2cs"][0])),
        "intrinsic_render_view": np.asarray(
            sample.get("intrinsic_render_view", sample["intrinsics"][0])),
        # training: the reference view's pixels and ground-truth depths
        # (ray distances in scene units, and raw z-depths in mm)
        "ref_img": np.asarray(sample["ref_img"], np.float32),
        "depths_h": (np.asarray(sample["depths_h"], np.float32)
                     if "depths_h" in sample else None),
        "depths_mm": (np.asarray(sample["depths_mm"], np.float32)
                      if "depths_mm" in sample else None),
    }
    return scene, extras
