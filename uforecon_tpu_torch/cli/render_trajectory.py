"""Frames of a reconstructed DTU mesh along a path between the render views.

    python -m uforecon_tpu_torch.cli.render_trajectory --out_dir OUT \\
        --root_dir DTU_TEST --test_scan scan24 --test_ref_view 23 24 33 \\
        [--n_frames 240] [--img_wh 800 600] [--video PATH] [--fps 30]

Counterpart of the JAX package's ``cli/render_trajectory.py`` (reference
render_trajectory_dtu.py): reads ``{out_dir}/mesh/final/{scan}.ply`` (or
``mesh/{scan}.ply``) and the cameras of the reference views, with the
intrinsics scaled from 1600x1200 to ``--img_wh``, and writes the frames of
``postproc/trajectory.render_trajectory``. It takes the JAX command line
unchanged, but where the JAX package encodes ``--video`` (default
``{out_dir}/video/{scan}.mp4``) through imageio, which the port does not
use, the port writes the frames as PNGs to the directory of that name
without its extension (``{out_dir}/video/{scan}/``); ``--fps``, the
video's frame rate, goes unused.
"""
from __future__ import annotations

import argparse
import os

from ..data import io
from ..postproc.trajectory import render_trajectory


def main(argv=None):
    p = argparse.ArgumentParser("uforecon_tpu_torch.cli.render_trajectory")
    p.add_argument("--out_dir", type=str, required=True,
                   help="output dir holding mesh/{scan}.ply (or mesh/final)")
    p.add_argument("--root_dir", type=str, required=True,
                   help="DTU test root with cameras/*.txt")
    p.add_argument("--test_scan", type=str, required=True)
    p.add_argument("--test_ref_view", type=int, nargs="+", default=[23, 24, 33])
    p.add_argument("--n_frames", type=int, default=240)
    p.add_argument("--img_wh", type=int, nargs=2, default=[800, 600])
    p.add_argument("--fps", type=int, default=30,
                   help="the JAX package's video frame rate; unused: the port writes "
                        "frames")
    p.add_argument("--video", type=str, default="",
                   help="video path (default {out_dir}/video/{scan}.mp4): the PNG "
                        "frames go to this path without its extension")
    a = p.parse_args(argv)

    candidates = (os.path.join(a.out_dir, "mesh", "final", f"{a.test_scan}.ply"),
                  os.path.join(a.out_dir, "mesh", f"{a.test_scan}.ply"))
    mesh_path = next((c for c in candidates if os.path.exists(c)), None)
    if mesh_path is None:
        raise FileNotFoundError(f"no mesh for {a.test_scan} under {a.out_dir}/mesh")
    verts, faces, colors = io.read_ply(mesh_path)

    w2cs, K = [], None
    sx, sy = a.img_wh[0] / 1600.0, a.img_wh[1] / 1200.0
    for vid in a.test_ref_view:
        cam = io.read_cam_file(os.path.join(a.root_dir, "cameras", f"{vid:08d}_cam.txt"))
        w2cs.append(cam["extrinsic"])
        K = cam["intrinsic"].copy()
        K[0] *= sx
        K[1] *= sy

    video = a.video or os.path.join(a.out_dir, "video", f"{a.test_scan}.mp4")
    frames_dir = os.path.splitext(video)[0]
    render_trajectory(verts, faces, w2cs, K, wh=tuple(a.img_wh), n_frames=a.n_frames,
                      out_dir=frames_dir, colors=colors)
    print(f"wrote {a.n_frames} frames to {frames_dir}")


if __name__ == "__main__":
    main()
