"""Training on DTU, and depth maps of DTU scans or custom captures, on a CUDA card.

Training (without ``--extract_geometry``; ``script/train_dtu.sh``'s flags):

    python -m uforecon_tpu_torch.cli.run --max_epochs 16 --batch_size 1 \\
        --uforecon_lr 0.0001 --train_ray_num 1024 --train_n_view 5 \\
        --view_selection_type best --volume_type correlation --volume_reso 96 \\
        --mvs_depth_guide 1 --depth_pos_encoding --explicit_similarity \\
        --root_dir DTU_TRAIN --logdir LOGDIR [--debug] [--val_only] [--device cpu]

runs ``pipeline/fit.py``: ``--val_only`` one validation pass, ``--debug``
3 steps then one validation and a checkpoint, else ``fit`` over
``--max_epochs``. Checkpoints go to ``{logdir}/{exp_name}/ckpt/step_N.pt``
and load with ``--load_ckpt``.

Depth maps (the port's ``--extract_geometry``):

    python -m uforecon_tpu_torch.cli.run --extract_geometry --set 0 \\
        --volume_type correlation --volume_reso 96 --depth_pos_encoding \\
        --mvs_depth_guide 1 --explicit_similarity --test_n_view 3 \\
        --test_ray_num 800 --test_ref_view 23 24 33 --root_dir DTU_TEST \\
        --out_dir OUT --test_scan scan24 [--load_ckpt FILE] [--device cpu]

A custom capture (BlendedMVS, MVImgNet, or a COLMAP model exported by
``cli/colmap2mvsnet.py``) with ``--test_general``:

    python -m uforecon_tpu_torch.cli.run --extract_geometry --test_general \\
        --dataset blendedmvs [--use_mask] --root_dir ROOT --test_scan SCAN \\
        --test_n_view 3 --test_ref_view 0 1 2 --volume_type correlation \\
        --depth_pos_encoding --mvs_depth_guide 1 --explicit_similarity \\
        --out_dir OUT [--extract_similarity --sim_reso 128 --sim_threshold 0.99]

Counterpart of the JAX package's ``cli/run.py`` ``run_train`` and
``run_extract`` with its flags (``config.config_from_args``). Extraction
renders one DTU scan, or the 15-scan DTU protocol when ``--test_scan`` is
empty or ``scan1``, or with ``--test_general`` the one scan
``--test_scan`` of ``data/general_fit.GeneralFit`` (each reference view of
its ``pair.txt``, or of ``--test_ref_view``). Each scan's depth maps go to
``{out_dir}/depth/{scan}/`` (``pipeline/extract.py``), with one line
``"{scan}: {views} views, {rays/s} rays/s"``, after the first scan's a line
with what the run resolved: the volume path (merged or per-stage
correlation volumes, the feature grid, or no volume) and the kernel
precision. The model flags are the JAX package's (``--volume_type``,
``--volume_reso``, ``--mvs_depth_guide``, ``--depth_pos_encoding``,
``--use_dir_srdf``, ``--explicit_similarity``; any ``--test_sample_*``);
training takes the default configuration only. With ``--extract_similarity`` each scan's first sample
also gives the mean-similarity field at ``--sim_reso`` and its mesh at
``--sim_threshold``, ``{out_dir}/similarity/{scan}.ply``. Its defaults are
the JAX package's (merged volumes, bf16 volumes and gather sources,
``fast`` kernels); ``--volume_merge never --volume_dtype float32
--image_gather_dtype float32 --kernel_precision highest`` renders the exact
path.
"""
from __future__ import annotations

import os
import sys
import time
import warnings
from typing import Dict, Iterator, List, Tuple

from ..config import Config, config_from_args
from ..convert import init_weights, load_weights
from ..data.convert import scene_inputs_from_sample
from ..data.dtu_test import DtuFitSparse
from ..data.general_fit import GeneralFit
from ..data.io import write_ply
from ..device import resolve_device
from ..eval.dtu_eval import DTU_EVAL_SCANS
from ..models.uforecon import UFORecon
from ..pipeline.extract import (extract_geometry_for_dataset, extract_similarity_field,
                                similarity_mesh)
from ..pipeline.fit import fit, validate_only

# DTU eval protocol scan list (reference main.py:150)
TEST_SCANS = DTU_EVAL_SCANS


def scan_list(cfg: Config) -> List[str]:
    if cfg.test_scan and cfg.test_scan != "scan1":
        return [cfg.test_scan]
    return [f"scan{s}" for s in TEST_SCANS]


def datasets(cfg: Config) -> Iterator[Tuple[str, object]]:
    """(scan, dataset) of each scan to render: the GeneralFit scan with
    ``--test_general``, else the DTU scans of ``scan_list``."""
    if cfg.test_general:
        yield cfg.test_scan, GeneralFit(
            root_dir=cfg.root_dir, scan_id=cfg.test_scan, n_views=cfg.test_n_view,
            dataset=cfg.dataset, use_mask=cfg.use_mask,
            test_ref_view=list(cfg.test_ref_view) or None,
            img_wh=list(cfg.img_wh) or None)
        return
    kw = {"img_wh": list(cfg.img_wh)} if cfg.img_wh else {}
    for scan in scan_list(cfg):
        yield scan, DtuFitSparse(root_dir=cfg.root_dir, scan_id=scan,
                                 n_views=cfg.test_n_view, set=cfg.set,
                                 test_view_pair=list(cfg.test_ref_view), **kw)


def volume_path(cfg: Config, merged: bool) -> str:
    """The volume path a run took, as its resolved line names it."""
    if cfg.correlation_volume:
        return "merged volumes" if merged else "per-stage volumes"
    return "feature grid" if cfg.feature_grid else "no volume"


def run_extract(cfg: Config, device="cuda") -> Dict[str, Dict[str, float]]:
    """Render every view of every scan of ``cfg`` (and with
    ``--extract_similarity`` each scan's similarity mesh); returns each
    scan's extract statistics (``similarity_s``: the field's seconds)."""
    device = resolve_device(device)
    model = UFORecon(cfg)
    if cfg.load_ckpt:
        load_weights(model, cfg.load_ckpt)
        print(f"loaded checkpoint {cfg.load_ckpt}", flush=True)
    else:
        warnings.warn("no --load_ckpt given: rendering with random weights",
                      stacklevel=2)
        init_weights(model, cfg.seed)
    model.to(device)
    stats = {}
    for scan, ds in datasets(cfg):
        stats[scan] = s = extract_geometry_for_dataset(
            model, ds, out_dir=cfg.out_dir, device=device, seed=cfg.seed)
        if len(stats) == 1:
            print(f"resolved: {volume_path(cfg, s['merged'])}, "
                  f"kernel_precision {s['kernel_precision']}",
                  flush=True)
        print(f"{scan}: {s['views']} views, {s['rays_per_sec']:.0f} rays/s",
              flush=True)
        if cfg.extract_similarity:
            scene, _ = scene_inputs_from_sample(ds[0], device)
            t0 = time.perf_counter()
            field = extract_similarity_field(model, scene, reso=cfg.sim_reso)
            s["similarity_s"] = time.perf_counter() - t0
            verts, faces = similarity_mesh(field, threshold=cfg.sim_threshold)
            out = os.path.join(cfg.out_dir, "similarity", f"{scan}.ply")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            write_ply(out, verts, faces=faces if len(faces) else None)
            print(f"similarity field -> {out} ({len(verts)} verts)", flush=True)
    return stats


def run_train(cfg: Config, device="cuda"):
    """Train (``fit``), or with ``--val_only`` validate, on ``device``:
    the validation metrics, or the final ``TrainState``."""
    if cfg.val_only:         # reference main.py:222 trainer.validate(...)
        return validate_only(cfg, device=device)
    if cfg.debug:            # a smoke run: 3 steps, one loader thread (main.py:107)
        return fit(cfg, max_steps=3, val_every=3, log_every=1, n_workers=1,
                   device=device)
    return fit(cfg, device=device)


def main(argv=None):
    cfg, device = config_from_args(argv)
    if cfg.extract_geometry:
        return run_extract(cfg, device)
    return run_train(cfg, device)


if __name__ == "__main__":
    main(sys.argv[1:])
