"""Geometry extraction: render every view's depth map to disk.

Counterpart of the JAX package's ``pipeline/extract.py``; writes the same
layout, which ``tsdf_fusion.py`` reads:
    {out_dir}/depth/{scan}/{name}.npy   {"depth": HxW mm, "extrinsic", "intrinsic"}
    {out_dir}/depth/{scan}/{name}.png   normalised preview   (previews only)
    {out_dir}/rgb/{scan}/{name}.jpg                          (previews only)
PIL is imported only when previews are written.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.convert import scene_inputs_from_sample
from ..device import DEFAULT
from ..models.uforecon import UFORecon
from .renderer import SceneRenderer


def save_depth_outputs(out_dir: str, scan: str, name: str,
                       depth_mm: np.ndarray, rgb: np.ndarray,
                       extrinsic: np.ndarray, intrinsic: np.ndarray,
                       previews: bool = True) -> None:
    os.makedirs(os.path.join(out_dir, "depth", scan), exist_ok=True)
    np.save(os.path.join(out_dir, "depth", scan, f"{name}.npy"),
            {"depth": depth_mm, "extrinsic": extrinsic, "intrinsic": intrinsic})
    if not previews:
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("depth/rgb previews need PIL (pillow); pass "
                           "previews=False to write the .npy depth maps only") from e
    os.makedirs(os.path.join(out_dir, "rgb", scan), exist_ok=True)
    os.makedirs(os.path.join(out_dir, scan, "depth"), exist_ok=True)
    # previews only: robust to NaN/inf depths (e.g. random weights)
    dvis = np.nan_to_num(depth_mm, nan=0.0, posinf=0.0, neginf=0.0)
    dmax = max(float(dvis.max()), 1e-6)
    dpng = np.clip((dvis / dmax) * 255, 0, 255).astype(np.uint8)
    Image.fromarray(dpng).save(os.path.join(out_dir, scan, "depth", f"{name}.png"))
    Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(
        os.path.join(out_dir, "rgb", scan, f"{name}.jpg"))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def extract_geometry_for_dataset(model: UFORecon, dataset,
                                 out_dir: Optional[str] = None,
                                 device=DEFAULT, seed: int = 0,
                                 previews: bool = True) -> Dict[str, float]:
    """Render all views of one per-scan dataset (any list-like of
    reference-format sample dicts) and write the depth layout, on the card
    unless the caller asks for ``device="cpu"``; without a card it raises.

    Returns the view and ray counts, the encode and render seconds summed
    over views (host clock, each ending in a device synchronise) and
    rays/s over the render time. Kernel builds happen at the first launch,
    inside the first view's render time."""
    out_dir = out_dir or model.cfg.out_dir
    renderer = SceneRenderer(model, device=device)
    gen = torch.Generator(device=renderer.device)
    gen.manual_seed(seed)
    total_rays = 0
    t_enc = t_ren = 0.0
    for i in range(len(dataset)):
        sample = dataset[i]
        scene, extras = scene_inputs_from_sample(sample, renderer.device)
        t0 = time.perf_counter()
        enc = model.encode(scene)
        _sync(renderer.device)
        t1 = time.perf_counter()
        out = renderer.render_depth_view(scene, enc, extras, gen)
        t2 = time.perf_counter()       # render_rays ends in a host copy
        t_enc += t1 - t0
        t_ren += t2 - t1
        total_rays += extras["ray_d"].shape[0]
        parts = str(extras["meta"]).split("-")
        save_depth_outputs(out_dir, parts[1], parts[-1], out["depth"], out["rgb"],
                           extras["extrinsic_render_view"],
                           extras["intrinsic_render_view"], previews=previews)
    return {"views": len(dataset), "rays": total_rays, "encode_s": t_enc,
            "render_s": t_ren, "rays_per_sec": total_rays / max(t_ren, 1e-9)}
