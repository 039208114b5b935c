"""A synthetic BlendedMVS-style scan: posed views of a textured sphere.

    python -m uforecon_tpu_torch.script.make_general_fixture ROOT [SCAN]

A numpy copy of the repository's ``script/make_general_fixture.py`` (which
needs OpenCV and the JAX package): the same sphere, cameras, cam files and
``pair.txt``, 5 views at 768x576, in the GeneralFit layout
(reference general_fit.py:44, 59-62):

    {root}/{scan}/cams/pair.txt
    {root}/{scan}/cams/{vid:08d}_cam.txt
    {root}/{scan}/blended_images/{vid:08d}_masked.jpg
    {root}/{scan}/masks/{vid:08d}_mask.jpg

The images and masks are baseline JPEGs from ``data/image.write_jpeg``
(quality 95, 4:4:4), so the pixels a decoder returns differ from the
original script's OpenCV-written files by the two encoders' rounding; the
rendered arrays (``render``) are the same.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.image import write_jpeg
from ..data.io import write_cam_file, write_pair_file
from .make_dtu_fixture import look_at

N_VIEWS = 5
W, H = 768, 576
CENTER = np.array([0.0, 0.0, 600.0])
RADIUS = 120.0
FOCAL = 1400.0


def intrinsic() -> np.ndarray:
    return np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1.0]])


def extrinsics():
    """The views' world-to-camera matrices, on a ring around the sphere."""
    rng = np.random.default_rng(11)
    out = []
    for vid in range(N_VIEWS):
        ang = 2 * np.pi * vid / N_VIEWS
        eye = CENTER + np.array(
            [420 * np.sin(ang), -180 + 40 * rng.random(), -420 * np.cos(ang)])
        out.append(look_at(eye, CENTER))
    return out


def render(e: np.ndarray, k: np.ndarray):
    """Raytrace the textured sphere: (rgb (H, W, 3) uint8, hit mask (H, W))."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], -1)
    dirs_c = pix @ np.linalg.inv(k).T
    r = e[:3, :3]
    eye = -r.T @ e[:3, 3]
    dirs = dirs_c @ r
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    oc = eye - CENTER
    b = dirs @ oc
    c = oc @ oc - RADIUS ** 2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit &= t > 0
    p = eye + t[..., None] * dirs
    n = (p - CENTER) / RADIUS
    u = np.arctan2(n[..., 0], n[..., 2])
    v = np.arccos(np.clip(n[..., 1], -1, 1))
    tex = 0.5 + 0.25 * np.sin(12 * u) * np.sin(10 * v) + 0.15 * np.sin(37 * u * v)
    light = np.clip(n @ np.array([0.4, -0.5, -0.76]), 0.1, 1.0)
    img = np.zeros((H, W, 3))
    img[..., 0] = np.where(hit, tex * light, 0.0)
    img[..., 1] = np.where(hit, (1 - tex) * light, 0.0)
    img[..., 2] = np.where(hit, 0.5 * light, 0.0)
    rng = np.random.default_rng(0)
    img += 0.02 * rng.standard_normal(img.shape) * hit[..., None]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), hit


def main(argv=None):
    p = argparse.ArgumentParser("uforecon_tpu_torch.script.make_general_fixture")
    p.add_argument("root", nargs="?", default="general_fixture")
    p.add_argument("scan", nargs="?", default="scan_sphere")
    a = p.parse_args(argv)
    base = os.path.join(a.root, a.scan)
    for d in ("cams", "blended_images", "masks"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    for vid, e in enumerate(extrinsics()):
        # MVSNet line 11: depth_min interval n_depth depth_max (GeneralFit's
        # near/far are its first and last entries)
        write_cam_file(os.path.join(base, "cams", f"{vid:08d}_cam.txt"),
                       e, intrinsic(), [425.0, 2.5, 192.0, 905.0])
        img, mask = render(e, intrinsic())
        write_jpeg(os.path.join(base, "blended_images", f"{vid:08d}_masked.jpg"), img)
        write_jpeg(os.path.join(base, "masks", f"{vid:08d}_mask.jpg"),
                   (mask * 255).astype(np.uint8))
        print("wrote view", vid, flush=True)
    pairs = [(r, [(s, 10.0 - k) for k, s in enumerate(
        [v for v in range(N_VIEWS) if v != r])]) for r in range(N_VIEWS)]
    write_pair_file(os.path.join(base, "cams", "pair.txt"), pairs)
    print("wrote", os.path.join(base, "cams", "pair.txt"), flush=True)


if __name__ == "__main__":
    main()
