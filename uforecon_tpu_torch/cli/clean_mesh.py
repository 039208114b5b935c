"""Mesh cleaning CLI: {out_dir}/mesh/{scan}.ply -> {out_dir}/mesh/final/{scan}.ply.

    python -m uforecon_tpu_torch.cli.clean_mesh --out_dir OUT --root_dir DTU_TEST \\
        --n_view 3 --test_ref_view 23 24 33 --test_scan scan24 --ray_stride 4

Counterpart of the JAX package's ``cli/clean_mesh.py`` with its flags plus
``--device`` (the cleaning runs on the host; ``cuda``, the default, still
requires a card, as every entry point of the port does): loads each scan's
fused mesh, the per-view object masks from the DTU test root
({scan}/mask/{vid:03d}.png, PNGs read by ``data/image.py`` as PIL's
``convert("L")`` + NEAREST resize), and the view cameras; applies the
mask-visibility and frustum ray-cast filters. Views without mask files
fall back to full-frame masks.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import io
from ..data.image import read_png, resize_nearest, to_gray
from ..device import resolve_device
from ..eval.dtu_eval import DTU_EVAL_SCANS
from ..postproc.clean_mesh import clean_mesh


def _load_view_data(root_dir: str, scan: str, view_ids, img_wh):
    masks, intrs, w2cs = [], [], []
    sx = img_wh[0] / 1600.0
    sy = img_wh[1] / 1200.0
    for vid in view_ids:
        cam = io.read_cam_file(
            os.path.join(root_dir, "cameras", f"{vid:08d}_cam.txt"))
        K = cam["intrinsic"].copy()
        K[0] *= sx
        K[1] *= sy
        intrs.append(K)
        w2cs.append(cam["extrinsic"])

        mask = None
        for cand in (f"{vid:03d}.png", f"{vid:08d}.png", f"{vid:06d}.png"):
            p = os.path.join(root_dir, scan, "mask", cand)
            if os.path.exists(p):
                mask = resize_nearest(to_gray(read_png(p)), img_wh) > 127
                break
        if mask is None:
            mask = np.ones((img_wh[1], img_wh[0]), bool)
        masks.append(mask)
    return masks, intrs, w2cs


def run_scan(out_dir: str, root_dir: str, scan: str, view_ids,
             img_wh=(800, 640), minimal_vis: int = 1,
             min_component_faces: int = 500, ray_stride: int = 1) -> str:
    mesh_path = os.path.join(out_dir, "mesh", f"{scan}.ply")
    if not os.path.exists(mesh_path):
        raise FileNotFoundError(f"missing {mesh_path}")
    verts, faces, _ = io.read_ply(mesh_path)
    if faces is None or not len(faces):
        raise FileNotFoundError(f"{mesh_path} has no faces")

    masks, intrs, w2cs = _load_view_data(root_dir, scan, view_ids, list(img_wh))
    v2, f2 = clean_mesh(verts, faces, masks, intrs, w2cs,
                        minimal_vis=minimal_vis,
                        min_component_faces=min_component_faces,
                        ray_stride=ray_stride)

    final_dir = os.path.join(out_dir, "mesh", "final")
    os.makedirs(final_dir, exist_ok=True)
    out_path = os.path.join(final_dir, f"{scan}.ply")
    io.write_ply(out_path, v2, faces=f2)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser("uforecon_tpu_torch.cli.clean_mesh")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--root_dir", type=str, required=True,
                   help="DTU test root (cameras/ + {scan}/mask/)")
    p.add_argument("--n_view", type=int, default=3)
    p.add_argument("--test_ref_view", type=int, nargs="+", default=[1, 16, 36])
    p.add_argument("--img_wh", type=int, nargs=2, default=[800, 640])
    p.add_argument("--minimal_vis", type=int, default=1)
    p.add_argument("--min_component_faces", type=int, default=500)
    p.add_argument("--ray_stride", type=int, default=1,
                   help=">1 subsamples frustum rays for speed")
    p.add_argument("--test_scan", type=str, default="")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    resolve_device(a.device)

    scans = [a.test_scan] if a.test_scan else [f"scan{s}" for s in DTU_EVAL_SCANS]
    views = a.test_ref_view[: a.n_view]
    for scan in scans:
        try:
            path = run_scan(a.out_dir, a.root_dir, scan, views,
                            img_wh=tuple(a.img_wh), minimal_vis=a.minimal_vis,
                            min_component_faces=a.min_component_faces,
                            ray_stride=a.ray_stride)
            print(f"{scan}: wrote {path}")
        except FileNotFoundError as e:
            print(f"{scan}: skipped ({e})")


if __name__ == "__main__":
    main()
