"""Geometric-consistency depth fusion CLI -> pcd_fusion/{scan}.ply.

    python -m uforecon_tpu_torch.cli.depth_fusion --out_dir OUT --n_view 3 \\
        --test_scan scan24

Counterpart of the JAX package's ``cli/depth_fusion.py`` with its flags
plus ``--device`` (the fusion runs on the host; ``cuda``, the default,
still requires a card, as every entry point of the port does). Colours come
from the rgb previews (``rgb/{scan}/*.png``) where every view has one.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.image import read_png
from ..data.io import write_ply
from ..device import resolve_device
from ..eval.dtu_eval import DTU_EVAL_SCANS
from ..fusion.depth_fusion import filter_depth_maps
from ..fusion.tsdf import load_depth_entry


def run_scan(out_dir: str, scan: str, n_view: int, geo_mask_thres: int,
             pix_thresh: float, depth_thresh: float) -> str:
    depth_dir = os.path.join(out_dir, "depth")
    entries, rgbs = [], []
    for name in range(n_view):
        e = load_depth_entry(depth_dir, scan, name)
        if e is None:
            continue
        entries.append(e)
        rgb = None
        for cand in (f"{name:08d}.png", f"{name}.png", f"refview{name}.png"):
            p = os.path.join(out_dir, "rgb", scan, cand)
            if os.path.exists(p):
                rgb = read_png(p)
                break
        rgbs.append(rgb)
    if not entries:
        raise FileNotFoundError(f"no depth maps for {scan} under {depth_dir}")

    use_rgb = all(r is not None for r in rgbs)
    pts, cols, masks = filter_depth_maps(
        entries, geo_mask_thres=geo_mask_thres, pix_thresh=pix_thresh,
        depth_thresh=depth_thresh, rgb_images=rgbs if use_rgb else None)

    # per-view masks mirror the reference's mask dumps (depth_fusion.py:150)
    mask_dir = os.path.join(out_dir, "mask", scan)
    os.makedirs(mask_dir, exist_ok=True)
    for i, m in enumerate(masks):
        np.save(os.path.join(mask_dir, f"{i:08d}_geo.npy"), m)

    pcd_dir = os.path.join(out_dir, "pcd_fusion")
    os.makedirs(pcd_dir, exist_ok=True)
    out_path = os.path.join(pcd_dir, f"{scan}.ply")
    write_ply(out_path, pts, colors=cols)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser("uforecon_tpu_torch.cli.depth_fusion")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--n_view", type=int, default=3)
    p.add_argument("--geo_mask_thres", type=int, default=2)
    p.add_argument("--pix_thresh", type=float, default=1.0)
    p.add_argument("--depth_thresh", type=float, default=0.01)
    p.add_argument("--test_scan", type=str, default="")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    resolve_device(a.device)

    scans = [a.test_scan] if a.test_scan else [f"scan{s}" for s in DTU_EVAL_SCANS]
    for scan in scans:
        try:
            path = run_scan(a.out_dir, scan, a.n_view, a.geo_mask_thres,
                            a.pix_thresh, a.depth_thresh)
            print(f"{scan}: wrote {path}")
        except FileNotFoundError as e:
            print(f"{scan}: skipped ({e})")


if __name__ == "__main__":
    main()
