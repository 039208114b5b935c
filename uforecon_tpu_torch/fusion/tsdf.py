"""TSDF fusion: depth maps -> truncated signed distance volume -> mesh.

Counterpart of the JAX package's ``fusion/tsdf.py`` (reference
tsdf_fusion.py:20-356, the vectorised CPU path 267-310):

    voxel -> world -> camera -> pixel; depth_diff = depth(pix) - cam_z;
    valid if depth > 0 and depth_diff >= -trunc_margin;
    dist = clip(depth_diff / trunc, max=1);
    running weighted average of tsdf (and color).

The integration is torch ops over the whole voxel grid on the volume's
device (the card unless the caller asks for the CPU), with the JAX
arithmetic in the same order; the volume stays there across views and only
``get_volume`` copies it to the host. In JAX this step is plain XLA, not a
Pallas kernel, so plain torch ops are its port.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.image import read_png
from ..device import DEFAULT, resolve_device
from ..ops import camera as cam_ops
from .marching import marching_cubes


class TSDFVolume:
    """Volumetric TSDF on one device."""

    def __init__(self, vol_bnds: np.ndarray, voxel_size: float,
                 margin: float = 5.0, use_color: bool = True, device=DEFAULT):
        vol_bnds = np.array(vol_bnds, np.float32)     # a copy: adjusted below
        if vol_bnds.shape != (3, 2):
            raise ValueError(f"vol_bnds must be (3, 2), got {vol_bnds.shape}")
        self.device = resolve_device(device)
        self.voxel_size = float(voxel_size)
        self.trunc_margin = margin * self.voxel_size

        self.vol_dim = np.ceil(
            (vol_bnds[:, 1] - vol_bnds[:, 0]) / self.voxel_size).astype(int)
        vol_bnds[:, 1] = vol_bnds[:, 0] + self.vol_dim * self.voxel_size
        self.vol_bnds = vol_bnds
        self.origin = vol_bnds[:, 0].copy()
        self.use_color = use_color

        dims = tuple(int(d) for d in self.vol_dim)
        self.tsdf = torch.ones(dims, dtype=torch.float32, device=self.device)
        self.weight = torch.zeros(dims, dtype=torch.float32, device=self.device)
        self.color = (torch.zeros(dims + (3,), dtype=torch.float32, device=self.device)
                      if use_color else None)

    def integrate(self, depth_im: np.ndarray, intr: np.ndarray,
                  c2w: np.ndarray, color_im: Optional[np.ndarray] = None,
                  obs_weight: float = 1.0) -> None:
        """Fuse one depth map (H, W) in the same units as voxel_size."""
        w2c = np.linalg.inv(np.asarray(c2w, np.float32))

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        color = (t(color_im) if color_im is not None else torch.zeros(
            tuple(depth_im.shape) + (3,), dtype=torch.float32, device=self.device))
        with torch.no_grad():
            self.tsdf, self.weight, self.color = _integrate_step(
                self.tsdf, self.weight, self.color, t(depth_im), color,
                t(np.asarray(intr)[:3, :3]), t(w2c), obs_weight,
                origin=self.origin, voxel_size=self.voxel_size,
                trunc=self.trunc_margin, use_color=self.use_color)

    # -- outputs ----------------------------------------------------------
    def get_volume(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.tsdf.cpu().numpy(), self.weight.cpu().numpy()

    def get_mesh(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Extract the zero iso-surface -> (verts world, faces, colors)."""
        tsdf, _ = self.get_volume()
        # marching cubes = reference triangulation (tsdf_fusion.py:325)
        verts, faces = marching_cubes(tsdf, level=0.0)
        verts_world = verts * self.voxel_size + self.origin
        colors = None
        if self.use_color and len(verts):
            cvol = self.color.cpu().numpy()
            idx = np.clip(np.round(verts).astype(int), 0,
                          np.array(self.vol_dim) - 1)
            colors = np.clip(cvol[idx[:, 0], idx[:, 1], idx[:, 2]], 0, 255
                             ).astype(np.uint8)
        return verts_world.astype(np.float32), faces, colors

    def get_point_cloud(self) -> np.ndarray:
        """Surface point cloud = mesh vertices (reference pcd output)."""
        verts, _, _ = self.get_mesh()
        return verts


def _integrate_step(tsdf, weight, color, depth_im, color_im, intr, w2c,
                    obs_weight, *, origin, voxel_size, trunc, use_color):
    """One view into the volume: the JAX package's ``_integrate_step``."""
    dev = tsdf.device
    nx, ny, nz = tsdf.shape
    h, w = depth_im.shape

    def axis(n, o):
        return (torch.tensor(float(o), dtype=torch.float32, device=dev)
                + torch.arange(n, dtype=torch.float32, device=dev)
                * torch.tensor(voxel_size, dtype=torch.float32, device=dev))

    xs, ys, zs = axis(nx, origin[0]), axis(ny, origin[1]), axis(nz, origin[2])
    # world -> camera, broadcast without materialising the (N, 3) matrix
    r, tr = w2c[:3, :3], w2c[:3, 3]
    cam = (xs[:, None, None, None] * r[:, 0]
           + ys[None, :, None, None] * r[:, 1]
           + zs[None, None, :, None] * r[:, 2]
           + tr)                                       # (nx, ny, nz, 3)

    z = cam[..., 2]
    invalid_z = z <= 0
    zsafe = torch.where(invalid_z, torch.ones_like(z), z)
    # round half to even, as jnp.round; bounds tested on the rounded floats
    px = torch.round(intr[0, 0] * cam[..., 0] / zsafe + intr[0, 2])
    py = torch.round(intr[1, 1] * cam[..., 1] / zsafe + intr[1, 2])
    inb = (~invalid_z) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    pxc = px.clamp(0, w - 1).long()
    pyc = py.clamp(0, h - 1).long()
    d = depth_im[pyc, pxc]
    depth_diff = d - z

    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which rounds apart from the JAX package's division
    trunc = torch.tensor(trunc, dtype=torch.float32, device=dev)
    valid = inb & (d > 0) & (depth_diff >= -trunc)
    dist = torch.clamp(depth_diff / trunc, max=1.0)

    w_new = torch.where(valid, weight + obs_weight, weight)
    denom = torch.clamp(w_new, min=1e-9)
    tsdf_new = torch.where(valid, (weight * tsdf + obs_weight * dist) / denom, tsdf)
    color_new = color
    if use_color and color is not None:
        c = color_im[pyc, pxc]
        color_new = torch.where(
            valid[..., None],
            (weight[..., None] * color + obs_weight * c) / denom[..., None],
            color)
    return tsdf_new, w_new, color_new


# --------------------------------------------------------------------------
# Scan-level fusion (reference save_tsdf, tsdf_fusion.py:447-505)
# --------------------------------------------------------------------------


def load_depth_entry(depth_dir: str, scan: str, name) -> Optional[Dict]:
    """Read {out_dir}/depth/{scan}/{name}.npy accepting both reference naming
    conventions ('refview{N}' and zero-padded ids)."""
    if isinstance(name, int):
        cands = [f"refview{name}.npy", f"{name:08d}.npy"]
    else:
        cands = [f"{name}.npy"]
    for c in cands:
        p = os.path.join(depth_dir, scan, c)
        if os.path.exists(p):
            return np.load(p, allow_pickle=True).item()
    return None


def scan_entries(out_dir: str, scan: str, n_views: int,
                 names: Optional[Sequence] = None) -> List[Tuple[object, Dict]]:
    """(name, depth entry) of each view of ``scan`` found under
    ``{out_dir}/depth``. Raises ``FileNotFoundError`` when there is none."""
    depth_dir = os.path.join(out_dir, "depth")
    entries = []
    for name in (names if names is not None else list(range(n_views))):
        e = load_depth_entry(depth_dir, scan, name)
        if e is not None:
            entries.append((name, e))
    if not entries:
        raise FileNotFoundError(f"no depth maps found for {scan} in {depth_dir}")
    return entries


def scan_bounds(entries, depth_scale: float = 1.0) -> np.ndarray:
    """(3, 2) volume bounds: the union of the view frusta between each
    depth map's nearest and 99th-percentile depth (tsdf_fusion.py:458-475)."""
    bnds = np.zeros((3, 2), np.float32)
    bnds[:, 0], bnds[:, 1] = np.inf, -np.inf
    for _, e in entries:
        depth = e["depth"] * depth_scale
        intr = np.asarray(e["intrinsic"])
        c2w = np.linalg.inv(np.asarray(e["extrinsic"]))
        pos = depth > 0
        dmax = float(np.percentile(depth[pos], 99)) if pos.any() else 1.0
        pts = cam_ops.view_frustum_points(
            max(float(depth[pos].min()) if pos.any() else 0.1, 1e-3),
            dmax, depth.shape, intr, c2w)
        bnds[:, 0] = np.minimum(bnds[:, 0], pts.min(axis=1))
        bnds[:, 1] = np.maximum(bnds[:, 1], pts.max(axis=1))
    return bnds


def fuse_scan(
    out_dir: str,
    scan: str,
    n_views: int,
    voxel_size: float = 1.5,
    margin: float = 5.0,
    depth_scale: float = 1.0,
    rgb_dir: Optional[str] = None,
    names: Optional[Sequence] = None,
    device=DEFAULT,
) -> Dict[str, np.ndarray]:
    """Fuse all rendered depth maps of one scan and extract the mesh.

    Reads the depth-map layout written by ``pipeline/extract.py`` (colours
    from ``{rgb_dir}/{scan}/{name}.png`` or ``refview{name}.png`` where
    present) and returns {verts, faces, colors, bounds}. Raises
    ``FileNotFoundError`` when the scan has no depth map."""
    entries = scan_entries(out_dir, scan, n_views, names)
    vol = TSDFVolume(scan_bounds(entries, depth_scale), voxel_size,
                     margin=margin, device=device)
    for name, e in entries:
        color = None
        if rgb_dir is not None:
            for cand in (f"{name}.png", f"refview{name}.png"):
                p = os.path.join(rgb_dir, scan, cand)
                if os.path.exists(p):
                    color = read_png(p).astype(np.float32)
                    break
        vol.integrate(e["depth"] * depth_scale, np.asarray(e["intrinsic"]),
                      np.linalg.inv(np.asarray(e["extrinsic"])), color_im=color)

    verts, faces, colors = vol.get_mesh()
    return {"verts": verts, "faces": faces, "colors": colors,
            "bounds": vol.vol_bnds}
