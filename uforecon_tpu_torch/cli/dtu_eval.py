"""DTU chamfer evaluation CLI -> eval_final.log.

    python -m uforecon_tpu_torch.cli.dtu_eval --mesh_dir OUT/mesh/final \\
        --dataset_dir DTU_SAMPLESET --log_dir .

Counterpart of the JAX package's ``cli/dtu_eval.py`` with its flags plus
``--device`` (the scoring runs on the host; ``cuda``, the default, still
requires a card, as every entry point of the port does): score meshes
against the DTU SampleSet ground truth, log ``scan: N d2s s2d mean`` lines
and the final averages.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..device import resolve_device
from ..eval.dtu_eval import DTU_EVAL_SCANS, eval_mesh_against_dtu


def main(argv=None):
    p = argparse.ArgumentParser("uforecon_tpu_torch.cli.dtu_eval")
    p.add_argument("--mesh_dir", type=str, required=True,
                   help="directory with scan meshes ({scan}.ply or scan{N}.ply)")
    p.add_argument("--dataset_dir", type=str, required=True,
                   help="DTU SampleSet MVS Data root (Points/stl + ObsMask)")
    p.add_argument("--log_dir", type=str, default=".")
    p.add_argument("--downsample_density", type=float, default=0.2)
    p.add_argument("--max_dist", type=float, default=20.0)
    p.add_argument("--patch", type=float, default=60.0)
    p.add_argument("--scans", type=int, nargs="+", default=DTU_EVAL_SCANS)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    resolve_device(a.device)

    os.makedirs(a.log_dir, exist_ok=True)
    log_path = os.path.join(a.log_dir, "eval_final.log")

    def log(line):
        # the lines the JAX CLI's root logger writes (log_to_csv reads them)
        with open(log_path, "a") as f:
            f.write(f"INFO:root:{line}\n")
        print(line)

    results = []
    for scan in a.scans:
        mesh_path = None
        for cand in (f"scan{scan}.ply", f"scan{scan}_clean.ply"):
            c = os.path.join(a.mesh_dir, cand)
            if os.path.exists(c):
                mesh_path = c
                break
        if mesh_path is None:
            print(f"scan{scan}: mesh not found, skipping")
            continue
        r = eval_mesh_against_dtu(
            mesh_path, scan, a.dataset_dir,
            downsample_density=a.downsample_density,
            max_dist=a.max_dist, patch=a.patch)
        log(f"scan: {scan} {r['acc']:.4f} {r['comp']:.4f} {r['overall']:.4f}")
        results.append((scan, r))

    if results:
        d2s = float(np.mean([r["acc"] for _, r in results]))
        s2d = float(np.mean([r["comp"] for _, r in results]))
        overall = float(np.mean([r["overall"] for _, r in results]))
        log(f"mean: {d2s:.4f} {s2d:.4f} {overall:.4f}")
    return results


if __name__ == "__main__":
    main()
