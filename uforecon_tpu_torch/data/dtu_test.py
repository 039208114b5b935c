"""DTU sparse-view test dataset (depth-map rendering path).

Counterpart of the JAX package's ``data/dtu_test.py`` ``DtuFitSparse``
(reference code1/dataset/dtu_test_sparse.py:75-436): the same sample dict
from the same files. Images go through ``data/image.py`` (a PNG decoder and
a copy of ``cv2.resize``) in place of OpenCV. Per scan: load the n_views
cameras/images of the chosen view list, re-reference all poses to the first
view, normalise the scene to a unit sphere, and emit one sample per render
view. Render poses are offset 25 mm along camera x (the reference's
virtual-view trick, dtu_test_sparse.py:88,269-271).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from . import io
from .image import imread_rgb, resize_linear
from .scene_build import build_ndc_and_rays, depth_values_from_cam, scale_scene
from ..ops import camera

SET1_VIEW_LIST = [43, 42, 44, 33, 34, 32, 45, 23, 41, 24, 31]


def _imread_rgb(path, out_wh):
    """(H, W, 3) float32 RGB in [0, 1], as cv2.imread + cv2.resize / 255."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return (resize_linear(imread_rgb(path), out_wh) / 255.0).astype(np.float32)


class DtuFitSparse:
    """Per-scan test dataset; __len__ == n_views (renders each input view)."""

    def __init__(
        self,
        root_dir: str,
        scan_id: Optional[str],
        n_views: int = 3,
        img_wh: Sequence[int] = (800, 640),
        original_img_wh: Sequence[int] = (1600, 1200),
        near: float = 425.0,
        far: float = 900.0,
        set: int = 0,
        test_view_pair: Optional[Sequence[int]] = None,
        ndepths: int = 192,
        offset_dist: float = 25.0,
    ):
        self.root_dir = root_dir
        self.scan_id = scan_id
        self.n_views = n_views
        self.img_wh = list(img_wh)
        self.ndepths = ndepths
        self.offset_dist = offset_dist

        view_list = list(test_view_pair) if set == 0 else SET1_VIEW_LIST
        self.view_ids = view_list[:n_views]

        data_dir = os.path.join(root_dir, scan_id) if scan_id else root_dir
        scale_x = img_wh[0] / original_img_wh[0]
        scale_y = img_wh[1] / original_img_wh[1]

        # -- load cameras ---------------------------------------------------
        Ps, images = [], []
        self.depth_min = self.depth_interval = None
        for vid in self.view_ids:
            cam = io.read_cam_file(os.path.join(root_dir, "cameras", f"{vid:08d}_cam.txt"))
            k4 = np.eye(4, dtype=np.float32)
            k4[:3, :3] = cam["intrinsic"]
            Ps.append(k4 @ cam["extrinsic"])
            self.depth_min = cam["depth_min"]
            self.depth_interval = cam["depth_interval"]
            images.append(_imread_rgb(os.path.join(data_dir, "image", f"{vid:06d}.png"), img_wh))
        self.images = np.stack(images)  # (V, H, W, 3)

        ref_w2c = np.linalg.inv(camera.load_K_Rt_from_P(Ps[0][:3, :4])[1])

        intrs, w2cs_rel, render_w2cs_rel = [], [], []
        self.w2cs_original, self.render_w2cs_original = [], []
        for P in Ps:
            intr, c2w = camera.load_K_Rt_from_P(P[:3, :4])
            w2c = np.linalg.inv(c2w)
            render_c2w = c2w.copy()
            render_c2w[:3, 3] += render_c2w[:3, 0] * offset_dist
            render_w2c = np.linalg.inv(render_c2w)
            intr = intr.copy()
            intr[0] *= scale_x
            intr[1] *= scale_y
            intrs.append(intr)
            w2cs_rel.append(w2c @ np.linalg.inv(ref_w2c))
            render_w2cs_rel.append(render_w2c @ np.linalg.inv(ref_w2c))
            self.w2cs_original.append(w2c)
            self.render_w2cs_original.append(render_w2c)

        raw_near_fars = np.tile([near, far], (len(Ps), 1)).astype(np.float32)
        self.scaled = scale_scene(
            np.stack(intrs), np.stack(w2cs_rel), raw_near_fars,
            img_hw=[img_wh[1], img_wh[0]],
            render_w2cs_rel=np.stack(render_w2cs_rel),
        )
        self.trans_mat = np.linalg.inv(ref_w2c).astype(np.float32)

    def __len__(self) -> int:
        return self.n_views

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        render_idx = idx % self.n_views
        sc = self.scaled
        intr4 = sc["intrinsics"]

        nd = build_ndc_and_rays(
            intr4, sc["w2cs"],
            ref_w2c_for_rays=sc["render_w2cs"][render_idx],
            ref_intrinsic4=intr4[render_idx],
            img_wh=self.img_wh,
        )
        sample = {
            "scale_mat": sc["scale_mat"],
            "scale_factor": sc["scale_factor"],
            "trans_mat": self.trans_mat,
            "extrinsic_render_view": self.render_w2cs_original[render_idx].astype(np.float32),
            "intrinsic_render_view": intr4[render_idx][:3, :3],
            "w2cs": sc["w2cs"],
            "intrinsics": intr4[:, :3, :3],
            "proj_matrices": sc["proj_matrices"],
            "depth_values_org_scale": depth_values_from_cam(
                self.depth_min, self.depth_interval, self.ndepths
            ),
            "near_fars": sc["near_fars"],
            "ref_img": self.images[render_idx],
            "source_imgs": self.images,
            "ref_pose": nd["ref_pose"],
            "ref_pose_inv": nd["ref_pose_inv"],
            "source_poses": nd["poses_ndc"],
            "source_poses_inv": nd["poses_ndc_inv"],
            "ray_o": nd["ray_o"],
            "ray_d": nd["ray_d"],
            "cam_ray_d": nd["cam_ray_d"],
            "meta": "%s-%s-%08d" % (os.path.basename(self.root_dir.rstrip("/")),
                                     self.scan_id, render_idx),
            "start_idx": 0,
        }
        return sample
