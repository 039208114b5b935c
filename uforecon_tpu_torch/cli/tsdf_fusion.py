"""TSDF fusion CLI: depth-map directory -> mesh/{scan}.ply + pcd/{scan}.ply.

    python -m uforecon_tpu_torch.cli.tsdf_fusion --out_dir OUT --n_view 3 \\
        --voxel_size 4 --test_scan scan24 [--device cpu]

Counterpart of the JAX package's ``cli/tsdf_fusion.py`` with its flags plus
``--device``: per scan, fuse the rendered depth maps into a TSDF volume on
the card (``fusion/tsdf.py``), extract the iso-surface, write mesh and
point cloud. Without ``--test_scan`` it runs the 15 DTU test scans.
"""
from __future__ import annotations

import argparse
import os

from ..data.io import write_ply
from ..device import resolve_device
from ..eval.dtu_eval import DTU_EVAL_SCANS
from ..fusion.tsdf import fuse_scan


def run_scan(out_dir: str, scan: str, n_view: int, voxel_size: float,
             margin: float, depth_scale: float = 1.0, device="cuda") -> str:
    res = fuse_scan(out_dir, scan, n_view, voxel_size=voxel_size,
                    margin=margin, depth_scale=depth_scale,
                    rgb_dir=os.path.join(out_dir, "rgb"), device=device)
    mesh_dir = os.path.join(out_dir, "mesh")
    pcd_dir = os.path.join(out_dir, "pcd")
    os.makedirs(mesh_dir, exist_ok=True)
    os.makedirs(pcd_dir, exist_ok=True)
    mesh_path = os.path.join(mesh_dir, f"{scan}.ply")
    write_ply(mesh_path, res["verts"], faces=res["faces"], colors=res["colors"])
    write_ply(os.path.join(pcd_dir, f"{scan}.ply"), res["verts"], colors=res["colors"])
    return mesh_path


def main(argv=None):
    p = argparse.ArgumentParser("uforecon_tpu_torch.cli.tsdf_fusion")
    p.add_argument("--out_dir", type=str, required=True,
                   help="directory holding depth/{scan}/*.npy")
    p.add_argument("--n_view", type=int, default=3)
    p.add_argument("--voxel_size", type=float, default=1.5)
    p.add_argument("--margin", type=float, default=5.0)
    p.add_argument("--depth_scale", type=float, default=1.0)
    p.add_argument("--dataset", type=str, default="dtu")
    p.add_argument("--test_scan", type=str, default="",
                   help="single scan name; default: the 15-scan DTU list")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the TSDF volume is integrated")
    a = p.parse_args(argv)
    resolve_device(a.device)

    scans = [a.test_scan] if a.test_scan else [f"scan{s}" for s in DTU_EVAL_SCANS]
    for scan in scans:
        try:
            path = run_scan(a.out_dir, scan, a.n_view, a.voxel_size, a.margin,
                            a.depth_scale, device=a.device)
            print(f"{scan}: wrote {path}")
        except FileNotFoundError as e:
            print(f"{scan}: skipped ({e})")


if __name__ == "__main__":
    main()
