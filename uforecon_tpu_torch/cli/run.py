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

Several cards (``--mesh_shape``, the JAX flag): extraction splits each
view's rays over ``min(mesh_shape[0], cards)`` ranks, training its ray
batch over ``prod(mesh_shape)`` (``parallel/sharding.py``; the JAX CLI's
rules, ``cli/run.py:27`` and ``pipeline/fit.py:303``); training raises if
the machine has fewer cards. With ``--device cpu`` the ranks are CPU
processes over gloo. Under ``torchrun --nproc_per_node N`` the ranks are
torchrun's, and its ``WORLD_SIZE`` must be N; outside torchrun the CLI
starts its N ranks itself. Rank 0 prints, writes the depth maps, logs and checkpoints.

Counterpart of the JAX package's ``cli/run.py`` ``run_train`` and
``run_extract`` with its flags (``config.config_from_args``). Extraction
renders one DTU scan, or the 15-scan DTU protocol when ``--test_scan`` is
empty or ``scan1``, or with ``--test_general`` the one scan
``--test_scan`` of ``data/general_fit.GeneralFit`` (each reference view of
its ``pair.txt``, or of ``--test_ref_view``). Each scan's depth maps go to
``{out_dir}/depth/{scan}/`` (``pipeline/extract.py``), with one line
``"{scan}: {views} views, {rays/s} rays/s"``, after the first scan's a line
with what the run resolved: the volume path (merged or per-stage
correlation volumes, the feature grid, or no volume), the kernel
precision, the point head (``--point_head``) and the NeuS epilogue
(``--fused_neus_epilogue``). The model flags are the JAX package's (``--volume_type``,
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

import math
import os
import sys
import time
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ..config import Config, config_from_args
from ..convert import init_weights, load_weights
from ..data.convert import scene_inputs_from_sample
from ..data.dtu_test import DtuFitSparse
from ..data.general_fit import GeneralFit
from ..data.io import write_ply
from ..device import resolve_device
from ..eval.dtu_eval import DTU_EVAL_SCANS
from ..models.uforecon import UFORecon
from ..parallel import sharding
from ..pipeline.extract import (extract_geometry_for_dataset, extract_similarity_field,
                                similarity_mesh)
from ..pipeline.fit import fit, validate_only
from ..pipeline.trainer import TrainState
from ..utils.logging import Log

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


def mesh_size(cfg: Config, device="cuda", cards: Optional[int] = None) -> int:
    """The ranks ``--mesh_shape`` resolves to: extraction
    ``min(mesh_shape[0], cards)`` (JAX's ``cli/run.py:27``; on the CPU
    ``mesh_shape[0]`` processes), training ``prod(mesh_shape)`` (JAX's
    ``fit.py:303``), which raises if the machine has fewer ``cards`` (JAX
    takes the devices it has and still splits the rays by the product);
    ``--val_only`` one (JAX's validates on one device). ``cards``: default
    the CUDA cards present."""
    on_card = torch.device(device).type == "cuda"
    if cards is None:
        cards = torch.cuda.device_count() if on_card else None
    if cfg.val_only and not cfg.extract_geometry:
        return 1
    if cfg.extract_geometry:
        n = cfg.mesh_shape[0]
        return min(n, cards) if on_card else n
    n = math.prod(cfg.mesh_shape)
    if on_card and n > cards:
        raise ValueError(f"--mesh_shape {','.join(map(str, cfg.mesh_shape))}: training "
                         f"takes {n} cards and this machine has {cards}")
    return n


def _mesh_words(cfg: Config, device, n: int) -> str:
    on_card = torch.device(device).type == "cuda"
    unit = "card" if on_card else "cpu rank"
    return (f"--mesh_shape {','.join(map(str, cfg.mesh_shape))} -> {n} "
            f"{unit}{'s' if n > 1 else ''}")


def run_extract(cfg: Config, device="cuda") -> Dict[str, Dict[str, float]]:
    """Render every view of every scan of ``cfg`` (and with
    ``--extract_similarity`` each scan's similarity mesh); returns each
    scan's extract statistics (``similarity_s``: the field's seconds). In a
    process group every rank renders its share of each view's rays and
    rank 0 prints and writes the files and the similarity mesh."""
    device = resolve_device(device)
    main_rank = sharding.rank() == 0
    model = UFORecon(cfg)
    if cfg.load_ckpt:
        load_weights(model, cfg.load_ckpt)
        if main_rank:
            print(f"loaded checkpoint {cfg.load_ckpt}", flush=True)
    else:
        if main_rank:
            warnings.warn("no --load_ckpt given: rendering with random weights",
                          stacklevel=2)
        init_weights(model, cfg.seed)
    model.to(device)
    stats = {}
    for scan, ds in datasets(cfg):
        stats[scan] = s = extract_geometry_for_dataset(
            model, ds, out_dir=cfg.out_dir, device=device, seed=cfg.seed)
        if not main_rank:
            continue
        if len(stats) == 1:
            print(f"resolved: {volume_path(cfg, s['merged'])}, "
                  f"kernel_precision {s['kernel_precision']}, point_head {cfg.point_head}, "
                  f"fused_neus_epilogue {cfg.fused_neus_epilogue}, "
                  f"{_mesh_words(cfg, device, sharding.world_size())}", flush=True)
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
    the validation metrics, or the final ``TrainState``. In a process
    group ``fit`` is data parallel."""
    if sharding.rank() == 0:
        Log.info(f"resolved: {_mesh_words(cfg, device, sharding.world_size())}")
    if cfg.val_only:         # reference main.py:222 trainer.validate(...)
        return validate_only(cfg, device=device)
    if cfg.debug:            # a smoke run: 3 steps, one loader thread (main.py:107)
        return fit(cfg, max_steps=3, val_every=3, log_every=1, n_workers=1,
                   device=device)
    return fit(cfg, device=device)


def run(cfg: Config, device="cuda"):
    return run_extract(cfg, device) if cfg.extract_geometry else run_train(cfg, device)


def _rank_main(device, cfg: Config):
    """One rank of a run the CLI started: rank 0's result (a training run
    returns its step and weights, which the parent puts back into a
    ``TrainState``)."""
    out = run(cfg, device)
    if sharding.rank():
        return None
    if isinstance(out, TrainState):
        return {"step": out.step, "state_dict": {k: v.cpu() for k, v in
                                                 out.model.state_dict().items()}}
    return out


def main(argv=None):
    """Parse the flags and run on the ranks ``--mesh_shape`` resolves to
    (``mesh_size``): in this process for one, those of ``torchrun`` where
    it started this many (any other ``WORLD_SIZE`` raises), else as many
    new processes (rank 0's result is returned; a training run's
    ``TrainState`` holds its step and weights on the CPU, without the
    optimizer)."""
    cfg, device = config_from_args(argv)
    resolve_device(device)
    n = mesh_size(cfg, device)
    given = sharding.torchrun_world()
    if given is not None and given != n:
        raise ValueError(f"{_mesh_words(cfg, device, n)}, and torchrun started "
                         f"WORLD_SIZE={given} processes: start as many as --mesh_shape "
                         f"resolves to")
    if n == 1:
        return run(cfg, device)
    if given == n:
        dev = sharding.start_from_env(device)
        try:
            return run(cfg, dev)
        finally:
            sharding.stop()
    if torch.device(device).type == "cuda":
        from ..ops import cuda_build

        cuda_build.extension()     # built once here; the ranks load it
    out = sharding.spawn(_rank_main, n, (cfg,), device)[0]
    if isinstance(out, dict) and "state_dict" in out:
        model = UFORecon(cfg)
        model.load_state_dict(out["state_dict"])
        return TrainState(model, None, out["step"])
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
