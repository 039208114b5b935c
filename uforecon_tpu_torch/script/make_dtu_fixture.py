"""Synthetic DTU fixtures: posed views of a textured sphere at mm scales.

    python -m uforecon_tpu_torch.script.make_dtu_fixture ROOT \\
        [--views 23 24 33 1 16 36] [--wh 1600 1200]

A numpy copy of the repository's ``script/make_dtu_fixture.py`` (which
needs OpenCV and the JAX package), writing through ``data/io.py`` and
``data/image.py``: ``{root}/cameras/{vid:08d}_cam.txt`` (in DTU's
1600x1200 pixel frame, depth_min 425 mm, interval 2.5 mm) and
``{root}/scan24/image/{vid:06d}.png`` at ``--wh``, raytraced with the
intrinsics scaled to that size, for the chosen views: any of the original
six (23 24 33 1 16 36, on a ring around the sphere) and of DTU's
evaluation set 1 (``data/dtu_test.SET1_VIEW_LIST``: ``--views 43 42 44
33 34 32 45 23 41 24 31``). The ids set 1 adds sit on a second, higher
ring, each with a camera of its own. At 1600x1200 the six
original views hold the same cameras and pixels as the original script's.

``write_train_layout`` writes the DTU training layout instead (which
``data/dtu_train.py`` reads): the same
cameras and sphere, ``Cameras/train/{vid:08d}_cam.txt`` for all 49 view
ids (the intrinsics of the 640x512 training crop divided by 4, as DTU's;
ids outside the fixture repeat the first view's camera),
``Rectified/{scan}_train/rect_{vid+1:03d}_{light}_r5000.png`` at 640x512
for the 7 lights, ``Depths_raw/{scan}/depth_map_{vid:04d}.pfm`` at
1600x1200 (the crop's pixels at the even rows and columns the loader keeps
after halving, offset by (80, 44)), depth_min 300 mm (the sphere's near
side is ~340 mm away), and ``lists/train.txt``,
``lists/val.txt`` and ``pairs.txt`` (each view a reference, the others its
sources, nearest first).

``sphere_depth`` gives the z-depth of the fixture's sphere seen through a
camera, at the pixel coordinates the extract layout uses (pixel (x, y) at
x, y), 0 where a ray misses it, and ``sphere_points`` the points it hits:
analytic depth maps to fuse, and the surface to score the mesh against.
"""
from __future__ import annotations

import argparse
import os
from typing import Sequence

import numpy as np

from ..data.dtu_test import SET1_VIEW_LIST
from ..data.image import write_png
from ..data.io import write_cam_file

VIEWS = (23, 24, 33, 1, 16, 36)
# the ids of DTU's evaluation set 1 that VIEWS lacks, in that list's
# order: a second ring of cameras
SET1_EXTRA = tuple(v for v in SET1_VIEW_LIST if v not in VIEWS)
ALL_VIEWS = VIEWS + SET1_EXTRA
WH = (1600, 1200)                      # DTU's image size; the cameras' frame
CENTER = np.array([0.0, 0.0, 600.0])   # sphere centre, mm
RADIUS = 120.0
FOCAL = 2900.0


def look_at(eye, target):
    eye = np.asarray(eye, np.float64)
    z = target - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, -1.0, 0.0])
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(z, [1.0, 0.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    e = np.eye(4)
    e[:3, :3] = np.stack([x, y, z])
    e[:3, 3] = -e[:3, :3] @ eye
    return e


def intrinsic(wh: Sequence[int] = WH) -> np.ndarray:
    """The fixture's intrinsics at image size ``wh``."""
    k = np.array([[FOCAL, 0, WH[0] / 2], [0, FOCAL, WH[1] / 2], [0, 0, 1.0]])
    k[0] *= wh[0] / WH[0]
    k[1] *= wh[1] / WH[1]
    return k


def cameras() -> dict:
    """View id -> w2c extrinsic: the six views on a ring around the sphere,
    then set 1's other ids on a higher ring between them, as far from the
    centre (~450 mm); the six come from the first draws, as they always
    did."""
    rng = np.random.default_rng(7)
    out = {}
    for i, vid in enumerate(VIEWS):
        ang = 2 * np.pi * i / len(VIEWS)
        eye = CENTER + np.array(
            [420 * np.sin(ang), -180 + 40 * rng.random(), -420 * np.cos(ang)])
        out[vid] = look_at(eye, CENTER)
    for i, vid in enumerate(SET1_EXTRA):
        ang = 2 * np.pi * (i + 0.5) / len(SET1_EXTRA)
        eye = CENTER + np.array(
            [380 * np.sin(ang), -260 + 40 * rng.random(), -380 * np.cos(ang)])
        out[vid] = look_at(eye, CENTER)
    return out


def _hit(e, k, xs, ys):
    """Ray-sphere hits through pixel coordinates (xs, ys): (hit, t, dirs, eye)."""
    pix = np.stack([xs, ys, np.ones_like(xs)], -1)
    dirs = pix @ np.linalg.inv(k).T @ e[:3, :3]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    eye = -e[:3, :3].T @ e[:3, 3]
    oc = eye - CENTER
    b = dirs @ oc
    disc = b * b - (oc @ oc - RADIUS ** 2)
    t = -b - np.sqrt(np.maximum(disc, 0))
    return (disc > 0) & (t > 0), t, dirs, eye


def render(e: np.ndarray, k: np.ndarray, w: int, h: int) -> np.ndarray:
    """CPU raytrace of the textured sphere over a plain background, (h, w, 3)
    uint8 RGB (pixel centres at +0.5)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    hit, t, dirs, eye = _hit(e, k, xs + 0.5, ys + 0.5)
    p = eye + t[..., None] * dirs
    n = (p - CENTER) / RADIUS
    u = np.arctan2(n[..., 0], n[..., 2])
    v = np.arccos(np.clip(n[..., 1], -1, 1))
    tex = 0.5 + 0.25 * np.sin(12 * u) * np.sin(10 * v) + 0.15 * np.sin(37 * u * v)
    light = np.clip(n @ np.array([0.4, -0.5, -0.76]), 0.1, 1.0)
    img = np.zeros((h, w, 3))
    img[..., 0] = np.where(hit, tex * light, 0.08)
    img[..., 1] = np.where(hit, (1 - tex) * light, 0.1)
    img[..., 2] = np.where(hit, 0.5 * light, 0.12)
    img += 0.02 * np.random.default_rng(0).standard_normal(img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def sphere_depth(w2c: np.ndarray, k: np.ndarray, w: int, h: int) -> np.ndarray:
    """(h, w) float32 z-depth in mm of the sphere through camera (w2c, k),
    pixel (x, y) at coordinates (x, y); 0 where the ray misses."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    w2c = np.asarray(w2c, np.float64)
    hit, t, dirs, eye = _hit(w2c, np.asarray(k, np.float64)[:3, :3], xs, ys)
    p = eye + t[..., None] * dirs
    z = p @ w2c[2, :3] + w2c[2, 3]
    return np.where(hit, z, 0.0).astype(np.float32)


def sphere_points(w2c: np.ndarray, k: np.ndarray, w: int, h: int) -> np.ndarray:
    """(N, 3) world points in mm where the rays of pixel coordinates
    (x, y) through camera (w2c, k) hit the sphere: the surface that view
    sees."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    hit, t, dirs, eye = _hit(np.asarray(w2c, np.float64),
                             np.asarray(k, np.float64)[:3, :3], xs, ys)
    return (eye + t[hit][:, None] * dirs[hit]).astype(np.float32)


TRAIN_WH = (640, 512)
TRAIN_FOCAL = 600.0
TRAIN_DEPTH_RANGE = (300.0, 2.5)       # depth_min, interval (mm): 300-780 mm


def write_train_layout(root: str, views: Sequence[int] = VIEWS, scan: str = "scan24",
                       lights: int = 7) -> dict:
    """Write the DTU training layout of the fixture (see the module
    docstring); returns the paths of its train list, val list and pair
    file."""
    from ..data.io import write_pfm

    extrinsics = cameras()
    # the 640x512 training crop (the sphere ~300 px across) and the full
    # 1600x1200 frame whose halved image it is cut from, at offset (80, 44)
    k_crop = np.array([[TRAIN_FOCAL, 0, 320.0], [0, TRAIN_FOCAL, 256.0], [0, 0, 1.0]])
    k_full = k_crop.copy()
    k_full[0, 2] += 80
    k_full[1, 2] += 44
    k_full[:2] *= 2
    k_cam = k_crop.copy()
    k_cam[:2] /= 4
    for d in ("Cameras/train", f"Rectified/{scan}_train", f"Depths_raw/{scan}", "lists"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for vid in range(49):
        e = extrinsics[vid if vid in views else views[0]]
        write_cam_file(os.path.join(root, "Cameras", "train", f"{vid:08d}_cam.txt"),
                       e, k_cam, TRAIN_DEPTH_RANGE)
    for vid in views:
        e = extrinsics[vid]
        img = render(e, k_crop, *TRAIN_WH)
        for light in range(lights):
            write_png(os.path.join(root, "Rectified", f"{scan}_train",
                                   f"rect_{vid + 1:03d}_{light}_r5000.png"), img)
        write_pfm(os.path.join(root, "Depths_raw", scan, f"depth_map_{vid:04d}.pfm"),
                  sphere_depth(e, k_full, *WH))
    paths = {"train": os.path.join(root, "lists", "train.txt"),
             "val": os.path.join(root, "lists", "val.txt"),
             "pair": os.path.join(root, "pairs.txt")}
    for k in ("train", "val"):
        with open(paths[k], "w") as f:
            f.write(scan + "\n")
    centre = {v: -extrinsics[v][:3, :3].T @ extrinsics[v][:3, 3] for v in views}
    lines = [str(len(views))]
    for ref in views:
        srcs = sorted((v for v in views if v != ref),
                      key=lambda v: np.linalg.norm(centre[v] - centre[ref]))
        lines += [str(ref), f"{len(srcs)} " + " ".join(
            f"{v} {100.0 - i:.1f}" for i, v in enumerate(srcs))]
    with open(paths["pair"], "w") as f:
        f.write("\n".join(lines) + "\n")
    return paths


def main(argv=None):
    p = argparse.ArgumentParser("uforecon_tpu_torch.script.make_dtu_fixture")
    p.add_argument("root", nargs="?", default="dtu_fixture")
    p.add_argument("--views", type=int, nargs="+", default=list(VIEWS),
                   choices=ALL_VIEWS, help="which views to write (default the six)")
    p.add_argument("--wh", type=int, nargs=2, default=list(WH),
                   help="size W H of the written images")
    a = p.parse_args(argv)
    os.makedirs(os.path.join(a.root, "cameras"), exist_ok=True)
    os.makedirs(os.path.join(a.root, "scan24", "image"), exist_ok=True)
    extrinsics = cameras()
    for vid in a.views:
        e = extrinsics[vid]
        write_cam_file(os.path.join(a.root, "cameras", f"{vid:08d}_cam.txt"),
                       e, intrinsic(), [425.0, 2.5])
        write_png(os.path.join(a.root, "scan24", "image", f"{vid:06d}.png"),
                  render(e, intrinsic(a.wh), *a.wh))
        print("wrote view", vid, flush=True)


if __name__ == "__main__":
    main()
