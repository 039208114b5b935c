"""Geometry extraction: render every view's depth map to disk.

Counterpart of the JAX package's ``pipeline/extract.py``; writes the same
depth layout, which the fusion tools read:
    {out_dir}/depth/{scan}/{name}.npy   {"depth": HxW mm, "extrinsic", "intrinsic"}
    {out_dir}/{scan}/depth/{name}.png   normalised depth preview  (previews)
    {out_dir}/rgb/{scan}/{name}.png     rgb preview               (previews)
The previews are PNGs written by ``data/image.py`` (the JAX package writes
the rgb preview as a JPEG through PIL). The port's fusion tools read the
rgb previews as colours.

``extract_similarity_field`` and ``similarity_mesh`` are the
``--extract_similarity`` path: the mean explicit-similarity field of one
view set over a grid, and its iso-surface.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.convert import scene_inputs_from_sample
from ..data.image import write_png
from ..device import DEFAULT
from ..models.ray_transformer import query_similarity
from ..models.uforecon import EncoderOutputs, SceneInputs, UFORecon
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
    os.makedirs(os.path.join(out_dir, "rgb", scan), exist_ok=True)
    os.makedirs(os.path.join(out_dir, scan, "depth"), exist_ok=True)
    # previews only: robust to NaN/inf depths (e.g. random weights)
    dvis = np.nan_to_num(depth_mm, nan=0.0, posinf=0.0, neginf=0.0)
    dmax = max(float(dvis.max()), 1e-6)
    write_png(os.path.join(out_dir, scan, "depth", f"{name}.png"),
              np.clip((dvis / dmax) * 255, 0, 255).astype(np.uint8))
    write_png(os.path.join(out_dir, "rgb", scan, f"{name}.png"),
              (np.clip(rgb, 0, 1) * 255).astype(np.uint8))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def extract_geometry_for_dataset(model: UFORecon, dataset,
                                 out_dir: Optional[str] = None,
                                 device=DEFAULT, seed: int = 0,
                                 previews: bool = True,
                                 draws: Optional[Sequence] = None) -> Dict[str, float]:
    """Render all views of one per-scan dataset (any list-like of
    reference-format sample dicts) and write the depth layout, on the card
    unless the caller asks for ``device="cpu"``; without a card it raises.
    In a process group (``parallel/sharding.py``) every rank renders its
    share of each view's rays and rank 0 writes the files.

    Draws come from a generator seeded with ``seed``, or from ``draws``:
    per view, one ``(u_coarse, u_fine)`` pair per ray chunk (see
    ``SceneRenderer.render_rays``).

    Returns the view and ray counts, the encode and render seconds summed
    over views (host clock, each ending in a device synchronise), the JAX
    package's rays/s: every view's rays over the time from the end of
    the first view's render to the end of the loop (so the kernel builds
    and first-call costs of view 0 are outside it; with one view it times
    only that view's file writes; on rank 0 of a process group, every
    rank's rays, as rank 0's render ends when it has gathered them), and
    what the run resolved: whether the
    encodings merged their volumes (``merged``, from the encodings; None
    without a view) and the head kernels' ``kernel_precision``."""
    out_dir = out_dir or model.cfg.out_dir
    renderer = SceneRenderer(model, device=device)
    gen = torch.Generator(device=renderer.device)
    gen.manual_seed(seed)
    total_rays = 0
    t_enc = t_ren = 0.0
    t_start = None
    merged = None
    for i in range(len(dataset)):
        sample = dataset[i]
        scene, extras = scene_inputs_from_sample(sample, renderer.device)
        t0 = time.perf_counter()
        enc = model.encode(scene)
        _sync(renderer.device)
        t1 = time.perf_counter()
        merged = "merged" in enc.volumes
        out = renderer.render_depth_view(scene, enc, extras, gen,
                                         None if draws is None else draws[i])
        t2 = time.perf_counter()       # render_rays ends in a host copy
        t_start = t2 if t_start is None else t_start
        t_enc += t1 - t0
        t_ren += t2 - t1
        total_rays += extras["ray_d"].shape[0]
        if out is None:             # a rank other than 0 renders only
            continue
        parts = str(extras["meta"]).split("-")
        save_depth_outputs(out_dir, parts[1], parts[-1], out["depth"], out["rgb"],
                           extras["extrinsic_render_view"],
                           extras["intrinsic_render_view"], previews=previews)
    elapsed = max(time.perf_counter() - (t_start or time.perf_counter()), 1e-9)
    return {"views": len(dataset), "rays": total_rays, "encode_s": t_enc,
            "render_s": t_ren, "rays_per_sec": total_rays / elapsed,
            "merged": merged,
            "kernel_precision": model.kernel_precision}


@torch.no_grad()
def similarity_field_chunk(scene: SceneInputs, enc: EncoderOutputs, points: torch.Tensor,
                           n_groups: int = 8) -> torch.Tensor:
    """The mean pairwise similarity at ``points`` (P, 3), on their device:
    ``query_similarity``'s 8-group cosine averaged over the groups, -1
    where a view sees a point at a depth that is not positive. The pair
    maps are sampled from float32, as in JAX (no ``image_gather_dtype``
    here), and the cosine takes the grouped-cosine wrapper, JAX's
    ``fused='auto'``: the kernel for the card's tensors
    (``ops/fused_similarity.py``, which raises if it cannot launch), its
    plain version for the CPU's. Returns (P,)."""
    sim, _, valid = query_similarity(points[None], scene.source_poses, enc.aug0, enc.aug1,
                                     int(scene.source_imgs.shape[0]), n_groups=n_groups,
                                     fused="auto")
    return torch.where(valid[:, 0].all(dim=0), sim[0].mean(dim=-1),
                       torch.full_like(sim[0, :, 0], -1.0))


def similarity_grid(reso: int, bound: float = 1.0) -> np.ndarray:
    """The field's points, (reso^3, 3) float32 over [-bound, bound]^3 in
    ``ij`` order."""
    axis = np.linspace(-bound, bound, reso, dtype=np.float32)
    return np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)


@torch.no_grad()
def extract_similarity_field(model: UFORecon, scene: SceneInputs, reso: int = 128,
                             chunk: int = 65536, bound: float = 1.0) -> np.ndarray:
    """The mean pairwise-similarity field over a reso^3 grid in
    [-bound, bound]^3 (the JAX package's ``extract_similarity_field``;
    reference model.py:844-911): encode once, then
    ``similarity_field_chunk`` in chunks of ``chunk`` points, the last one
    padded. Returns (reso, reso, reso) float32."""
    enc = model.encode(scene)
    grid = similarity_grid(reso, bound)
    out = np.empty(len(grid), np.float32)
    for s in range(0, len(grid), chunk):
        blk = grid[s:s + chunk]
        n = len(blk)
        if n < chunk:
            blk = np.concatenate([blk, np.zeros((chunk - n, 3), np.float32)])
        pts = torch.as_tensor(blk, device=scene.source_poses.device)
        out[s:s + n] = similarity_field_chunk(scene, enc, pts,
                                              model.cfg.cos_n_group)[:n].cpu().numpy()
    return out.reshape(reso, reso, reso)


def similarity_mesh(field: np.ndarray, threshold: float = 0.99, bound: float = 1.0):
    """Marching cubes of the similarity field at ``threshold`` (the
    reference's mcubes level 0.99, model.py:880), the surface where the
    similarity falls below it; vertices mapped back to [-bound, bound]^3.
    Returns (vertices (N, 3), faces (M, 3))."""
    from ..fusion.marching import marching_cubes

    verts, faces = marching_cubes(-np.asarray(field), level=-threshold)
    if len(verts):
        verts = verts / (field.shape[0] - 1) * (2 * bound) - bound
    return verts, faces
