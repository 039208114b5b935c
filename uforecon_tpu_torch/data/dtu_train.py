"""DTU training / validation dataset.

A numpy copy of the JAX package's ``data/dtu_train.py`` ``MVSDataset``
(reference code1/dataset/dtu_train.py:80-498): the same sample dict from
the same files. Per meta (scan, light, ref view, source views): the
rectified images (``data/image.py`` in place of PIL) and the raw PFM
depths, halved then cropped [44:556, 80:720] to 512x640
(dtu_train.py:249-254); poses re-referenced to the reference view, the
scene normalised, rays built.

The halving is ``cv2.resize(..., fx=0.5, fy=0.5, INTER_NEAREST)``, which
keeps the EVEN rows and columns: ``depth[::2, ::2]`` (``image.
resize_nearest`` copies PIL's rule, which keeps the odd ones).

View selection: 'best' takes the pair file's ranking; 'random' draws
n_views - 1 of the other 48 views per meta (dtu_train.py:190-196) from
``random.Random(seed)``, as the JAX package does.
"""
from __future__ import annotations

import os
import random
from typing import Dict, List, Sequence

import numpy as np

from . import io
from .image import imread_rgb
from .scene_build import build_ndc_and_rays, depth_values_from_cam, scale_scene

NUM_DTU_VIEWS = 49


class MVSDataset:
    def __init__(
        self,
        root_dir: str,
        split: str,
        split_filepath: str,
        pair_filepath: str,
        n_views: int = 5,
        img_wh: Sequence[int] = (640, 512),
        test_ref_views: Sequence[int] = (),
        view_selection_type: str = "best",
        ndepths: int = 192,
        seed: int = 0,
    ):
        if img_wh[0] % 32 or img_wh[1] % 32:
            raise ValueError(f"img_wh {tuple(img_wh)} must be multiples of 32")
        self.root_dir = root_dir
        self.split = split
        self.n_views = n_views
        self.img_wh = list(img_wh)
        self.test_ref_views = list(test_ref_views)
        self.view_selection_type = view_selection_type
        self.ndepths = ndepths
        self._rng = random.Random(seed)

        with open(split_filepath) as f:
            self.scans = [line.rstrip() for line in f if line.strip()]
        self.pairs = io.read_pair_file(pair_filepath)
        self.metas = self._build_metas()

        # cameras of all 49 views (dtu_train.py:235-243)
        self.all_intrinsics: List[np.ndarray] = []
        self.all_extrinsics: List[np.ndarray] = []
        self.all_near_fars: List[List[float]] = []
        for vid in range(NUM_DTU_VIEWS):
            cam = io.read_cam_file(
                os.path.join(root_dir, "Cameras", "train", f"{vid:08d}_cam.txt"))
            intr = np.eye(4, dtype=np.float32)
            intr[:3, :3] = cam["intrinsic"]
            intr[:2] *= 4.0  # the provided intrinsics are 4x downsampled
            self.all_intrinsics.append(intr)
            self.all_extrinsics.append(cam["extrinsic"])
            self.all_near_fars.append([cam["depth_min"],
                                       cam["depth_min"] + cam["depth_interval"] * 192])
            self.depth_min = cam["depth_min"]
            self.depth_interval = cam["depth_interval"]

    def _build_metas(self):
        metas = []
        light_idxs = range(7) if "train" in self.split else [3]
        for light in light_idxs:
            for scan in self.scans:
                for ref_view, src_views in self.pairs:
                    srcs = list(src_views)
                    if self.view_selection_type == "random":
                        cand = [i for i in range(NUM_DTU_VIEWS) if i != ref_view]
                        srcs = self._rng.sample(cand, self.n_views - 1)
                    elif self.view_selection_type != "best":
                        raise ValueError(f"view_selection_type "
                                         f"{self.view_selection_type!r}: best | random")
                    if self.split != "train" and self.test_ref_views:
                        if ref_view not in self.test_ref_views:
                            continue
                        srcs = list(self.test_ref_views)
                    metas.append((scan, light, ref_view, srcs))
        return metas

    def __len__(self):
        return len(self.metas)

    @staticmethod
    def _read_depth(path) -> np.ndarray:
        depth, _ = io.read_pfm(path)                    # (1200, 1600)
        return np.ascontiguousarray(depth[::2, ::2][44:556, 80:720], np.float32)

    @staticmethod
    def _read_image(path) -> np.ndarray:
        return imread_rgb(path).astype(np.float32) / 255.0

    def __getitem__(self, idx: int) -> Dict:
        scan, light, ref_view, src_views = self.metas[idx % len(self.metas)]
        if self.split == "train":
            view_ids = [ref_view] + list(src_views[: self.n_views - 1])
        else:
            view_ids = [ref_view] + list(src_views)

        w2c_ref_inv = np.linalg.inv(self.all_extrinsics[ref_view])
        imgs, depths, intrs, w2cs_rel, nfs = [], [], [], [], []
        for vid in view_ids:
            imgs.append(self._read_image(os.path.join(
                self.root_dir, "Rectified", f"{scan}_train",
                f"rect_{vid + 1:03d}_{light}_r5000.png")))
            depth_path = os.path.join(self.root_dir, "Depths_raw", scan,
                                      f"depth_map_{vid:04d}.pfm")
            if os.path.exists(depth_path):
                depths.append(self._read_depth(depth_path))
            else:
                depths.append(np.zeros((self.img_wh[1], self.img_wh[0]), np.float32))
            intrs.append(self.all_intrinsics[vid])
            w2cs_rel.append(self.all_extrinsics[vid] @ w2c_ref_inv)
            nfs.append(self.all_near_fars[vid])

        imgs = np.stack(imgs)
        sc = scale_scene(np.stack(intrs), np.stack(w2cs_rel), np.array(nfs, np.float32),
                         img_hw=[self.img_wh[1], self.img_wh[0]])
        nd = build_ndc_and_rays(sc["intrinsics"], sc["w2cs"],
                                ref_w2c_for_rays=sc["w2cs"][0],
                                ref_intrinsic4=sc["intrinsics"][0], img_wh=self.img_wh)

        # GT depths in scene units divided by the camera-ray z, so that the
        # loss compares ray distances (dtu_train.py:481-490)
        cam_rd_z = nd["cam_ray_d"][:, 2].reshape(1, self.img_wh[1], self.img_wh[0])
        depths_h = np.stack(depths) * sc["scale_factor"] / cam_rd_z

        return {
            "images": imgs,
            "ref_img": imgs[0],
            "source_imgs": imgs[1:],
            "w2cs": sc["w2cs"],
            "c2ws": sc["c2ws"],
            "intrinsics": sc["intrinsics"][:, :3, :3],
            # all V views; index 0 (the reference view) gives the rays'
            # near/far (model.py:416-421)
            "near_fars": sc["near_fars"],
            # the MVS path sees the SOURCE views only at train (start_idx 1,
            # dtu_train.py:378-384)
            "proj_matrices": {k: p[1:] for k, p in sc["proj_matrices"].items()},
            "depth_values_org_scale": depth_values_from_cam(
                self.depth_min, self.depth_interval, self.ndepths),
            "depths_h": depths_h,
            "depths_mm": np.stack(depths),       # raw mm, MVS pretraining
            "scale_mat": sc["scale_mat"],
            "scale_factor": sc["scale_factor"],
            "trans_mat": w2c_ref_inv.astype(np.float32),
            "ref_pose": nd["ref_pose"],
            "ref_pose_inv": nd["ref_pose_inv"],
            "source_poses": nd["poses_ndc"][1:],
            "source_poses_inv": nd["poses_ndc_inv"][1:],
            "ray_o": nd["ray_o"],
            "ray_d": nd["ray_d"],
            "cam_ray_d": nd["cam_ray_d"],
            "meta": f"{scan}_light{light}_refview{ref_view}",
            "start_idx": 1,
        }
