"""GeneralFit: the custom-scene test dataset (BlendedMVS, MVImgNet, COLMAP
exports).

Counterpart of the JAX package's ``data/general_fit.py`` (reference
code1/dataset/general_fit.py:34-403): the same sample dict from the same
files, with ``data/image.py`` (its baseline-JPEG decoder and its copy of
``cv2.resize``) in place of OpenCV. Per reference view of the scan's
``cams/pair.txt`` (or of an explicit ``test_ref_view`` list): the images
(``blended_images/{vid:08d}_masked.jpg`` at 768x576 for ``blendedmvs``,
``images/{vid:08d}.jpg`` at 960x544 for every other ``dataset``, the CLI's
default ``dtu`` included), optional foreground masks
(``masks/{vid:08d}_mask.jpg``, divided by 254 as in the reference), near/far
from line 11 of the cam file (first and last entries; 400/900 for
``mvimage`` only), no render-pose offset, and ``meta``
``"{root}-{scan}-refview{N}"``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from . import io
from .image import imread_gray, imread_rgb, resize_linear
from .scene_build import build_ndc_and_rays, depth_values_from_cam, scale_scene
from ..ops import camera


class GeneralFit:
    def __init__(
        self,
        root_dir: str,
        scan_id: str,
        n_views: int = 3,
        test_ref_view: Optional[Sequence[int]] = None,
        dataset: str = "blendedmvs",   # blendedmvs | mvimage
        use_mask: bool = False,
        ndepths: int = 192,
        clip_wh: Sequence[int] = (0, 0),
        img_wh: Optional[Sequence[int]] = None,
    ):
        self.root_dir = root_dir
        self.scan_id = scan_id
        self.n_views = n_views
        self.dataset = dataset
        self.use_mask = use_mask
        self.ndepths = ndepths
        self.data_dir = os.path.join(root_dir, scan_id)
        # each view decoded once: every sample of a --test_ref_view set reads
        # the same files, and the baseline-JPEG decoder runs on the host
        self._views: Dict[int, tuple] = {}
        # the reference's sizes (general_fit.py:59-62); img_wh overrides them
        if img_wh:
            self.img_wh = list(img_wh)
        else:
            self.img_wh = [768, 576] if dataset == "blendedmvs" else [960, 544]

        pairs = io.read_pair_file(os.path.join(self.data_dir, "cams", "pair.txt"))
        self.metas = []
        for ref, srcs in pairs:
            if test_ref_view:
                if ref not in test_ref_view:
                    continue
                srcs = list(test_ref_view)
            self.metas.append((ref, srcs))

    def __len__(self):
        return len(self.metas)

    def _image_path(self, vid: int) -> str:
        if self.dataset == "blendedmvs":
            return os.path.join(self.data_dir, "blended_images", f"{vid:08d}_masked.jpg")
        return os.path.join(self.data_dir, "images", f"{vid:08d}.jpg")

    def _mask_path(self, vid: int) -> str:
        return os.path.join(self.data_dir, "masks", f"{vid:08d}_mask.jpg")

    def _load_view(self, vid: int):
        if vid not in self._views:
            self._views[vid] = self._read_view(vid)
        return self._views[vid]

    def _read_view(self, vid: int):
        cam = io.read_cam_file(os.path.join(self.data_dir, "cams", f"{vid:08d}_cam.txt"))
        row = cam["depth_row"]
        near, far = float(row[0]), float(row[-1])
        if self.dataset == "mvimage":
            near, far = 400.0, 900.0
        k4 = np.eye(4, dtype=np.float32)
        k4[:3, :3] = cam["intrinsic"]
        P = k4 @ cam["extrinsic"]

        path = self._image_path(vid)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        img = imread_rgb(path)
        oh, ow = img.shape[:2]
        img = resize_linear(img, self.img_wh) / 255.0
        if self.use_mask and os.path.exists(self._mask_path(vid)):
            m = resize_linear(imread_gray(self._mask_path(vid)), self.img_wh) / 254.0
            img = img * m[..., None]
        img = img.astype(np.float32)

        scale_x = self.img_wh[0] / ow
        scale_y = self.img_wh[1] / oh
        return P, img, (near, far), (scale_x, scale_y), cam

    def __getitem__(self, idx: int) -> Dict:
        ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + [v for v in src_views if v != ref_view]
        view_ids = view_ids[: self.n_views]

        loaded = [self._load_view(v) for v in view_ids]
        P_ref = loaded[0][0]
        ref_w2c = np.linalg.inv(camera.load_K_Rt_from_P(P_ref[:3, :4])[1])

        imgs, intrs, w2cs_rel, nfs = [], [], [], []
        depth_min = depth_interval = None
        for P, img, (near, far), (sx, sy), cam in loaded:
            intr, c2w = camera.load_K_Rt_from_P(P[:3, :4])
            w2c = np.linalg.inv(c2w)
            intr = intr.copy()
            intr[0] *= sx
            intr[1] *= sy
            imgs.append(img)
            intrs.append(intr)
            w2cs_rel.append(w2c @ np.linalg.inv(ref_w2c))
            nfs.append([near, far])
            depth_min = cam["depth_min"]
            depth_interval = cam["depth_interval"]

        imgs = np.stack(imgs)
        sc = scale_scene(
            np.stack(intrs), np.stack(w2cs_rel), np.array(nfs, np.float32),
            img_hw=[self.img_wh[1], self.img_wh[0]],
        )
        nd = build_ndc_and_rays(
            sc["intrinsics"], sc["w2cs"],
            ref_w2c_for_rays=sc["w2cs"][0],
            ref_intrinsic4=sc["intrinsics"][0],
            img_wh=self.img_wh,
        )
        return {
            "scale_mat": sc["scale_mat"],
            "scale_factor": sc["scale_factor"],
            "trans_mat": np.linalg.inv(ref_w2c).astype(np.float32),
            "extrinsic_render_view": np.linalg.inv(
                camera.load_K_Rt_from_P(P_ref[:3, :4])[1]
            ).astype(np.float32),
            "intrinsic_render_view": sc["intrinsics"][0][:3, :3],
            "w2cs": sc["w2cs"],
            "intrinsics": sc["intrinsics"][:, :3, :3],
            "proj_matrices": sc["proj_matrices"],
            "depth_values_org_scale": depth_values_from_cam(
                depth_min, depth_interval, self.ndepths
            ),
            "near_fars": sc["near_fars"],
            "ref_img": imgs[0],
            "source_imgs": imgs,
            "ref_pose": nd["ref_pose"],
            "ref_pose_inv": nd["ref_pose_inv"],
            "source_poses": nd["poses_ndc"],
            "source_poses_inv": nd["poses_ndc_inv"],
            "ray_o": nd["ray_o"],
            "ray_d": nd["ray_d"],
            "cam_ray_d": nd["cam_ray_d"],
            "meta": "%s-%s-refview%d" % (
                os.path.basename(self.root_dir.rstrip("/")), self.scan_id, ref_view
            ),
            "start_idx": 0,
        }
