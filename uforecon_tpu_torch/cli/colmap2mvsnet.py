"""COLMAP sparse model -> MVSNet cams and pair.txt (reference colmap2mvsnet.py):

    python -m uforecon_tpu_torch.cli.colmap2mvsnet --dense_folder DENSE \\
        --save_folder OUT [--n_src 10] [--max_d 192] [--interval_scale 1]

Counterpart of the JAX package's ``cli/colmap2mvsnet.py``: reads
``DENSE/sparse`` (or ``DENSE`` itself) as text or binary, writes
``OUT/cams/{:08d}_cam.txt`` and ``OUT/pair.txt`` (``data/colmap.py``).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("colmap2mvsnet")
    p.add_argument("--dense_folder", type=str, required=True,
                   help="folder containing sparse/ (COLMAP model)")
    p.add_argument("--save_folder", type=str, required=True)
    p.add_argument("--n_src", type=int, default=10)
    p.add_argument("--max_d", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.0)
    a = p.parse_args(argv)

    import os

    from ..data.colmap import export_mvsnet

    sparse = os.path.join(a.dense_folder, "sparse")
    if not os.path.isdir(sparse):
        sparse = a.dense_folder
    export_mvsnet(sparse, a.save_folder, n_src=a.n_src, n_depths=a.max_d,
                  interval_scale=a.interval_scale)
    print(f"wrote MVSNet cams + pair.txt to {a.save_folder}")


if __name__ == "__main__":
    main()
