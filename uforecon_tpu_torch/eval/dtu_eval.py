"""DTU chamfer-distance evaluation.

A numpy + scipy copy of the JAX package's ``eval/dtu_eval.py``, a rewrite
of the reference evaluator
(reference: evaluation/dtu_eval.py:31-193). Protocol (identical scoring
math; BASELINE.md "chamfer scoring params"):

  1. densify the mesh by triangle-area-proportional surface sampling so
     sample spacing <= downsample density (reference sample_single_tri via
     mp.Pool, dtu_eval.py:12-21,87-91 — vectorized numpy here);
  2. radius-downsample at 0.2 mm using a KD-tree (dtu_eval.py:107-115);
  3. crop to the scan's ObsMask (+patch margin 60, dtu_eval.py:119-131);
  4. accuracy  d2s = mean NN distance (clipped at max_dist=20) data->GT;
     completeness s2d = mean NN distance GT->data, restricted above the
     ground plane Plane{scan}.mat (dtu_eval.py:147-155);
  5. overall = (d2s + s2d) / 2.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

DTU_EVAL_SCANS = [24, 37, 40, 55, 63, 65, 69, 83, 97, 105, 106, 110, 114, 118, 122]


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray,
                        density: float) -> np.ndarray:
    """Densify a mesh, protocol-exact to the reference (dtu_eval.py:64-91 +
    sample_single_tri:12-21), vectorized over triangles:

      * zero-area triangles dropped;
      * per-triangle area-corrected spacing thr = density*sqrt(l1*l2/area2),
        edge counts n_i = floor(l_i/thr);
      * barycentric sample grid at mid-cell offsets
        k = (mgrid[:n1+1,:n2+1]+0.5)/n, kept where k1+k2 < 1;
      * output = original vertices + all triangle samples.
    """
    verts = np.asarray(verts, np.float64)
    if len(faces) == 0:
        return verts
    tri = verts[np.asarray(faces)]            # (M, 3, 3)
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    l1 = np.linalg.norm(v1, axis=1)
    l2 = np.linalg.norm(v2, axis=1)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=1)
    nz = area2 > 0
    v1, v2, t0, l1, l2, area2 = v1[nz], v2[nz], tri[nz, 0], l1[nz], l2[nz], area2[nz]

    thr = density * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr).astype(np.int64)
    n2 = np.floor(l2 / thr).astype(np.int64)

    out = [verts]
    # group triangles by (n1, n2) so each group samples one barycentric grid
    key = n1 * 1_000_000 + n2
    for k in np.unique(key):
        sel = key == k
        kn1 = int(n1[sel][0])
        kn2 = int(n2[sel][0])
        c0, c1 = np.mgrid[: kn1 + 1, : kn2 + 1].astype(np.float64) + 0.5
        c0 /= max(kn1, 1e-7)
        c1 /= max(kn2, 1e-7)
        inside = (c0 + c1) < 1.0
        u, v = c0[inside], c1[inside]
        if len(u) == 0:
            continue
        pts = (
            t0[sel][:, None]
            + u[None, :, None] * v1[sel][:, None]
            + v[None, :, None] * v2[sel][:, None]
        ).reshape(-1, 3)
        out.append(pts)
    return np.concatenate(out, axis=0)


def radius_downsample(points: np.ndarray, radius: float,
                      shuffle_rng=None) -> np.ndarray:
    """Greedy radius downsampling, protocol-exact (dtu_eval.py:103-115):
    shuffle first, then in order keep a point iff it has not been killed by
    an earlier kept point; a kept point kills every point within `radius`."""
    from scipy.spatial import cKDTree

    points = np.asarray(points)
    if shuffle_rng is not None:
        points = points.copy()
        shuffle_rng.shuffle(points, axis=0)
    tree = cKDTree(points)
    nbrs = tree.query_ball_point(points, r=radius, workers=-1)
    mask = np.ones(len(points), dtype=bool)
    for curr, idxs in enumerate(nbrs):
        if mask[curr]:
            mask[idxs] = False
            mask[curr] = True
    return points[mask]


def load_obs_mask(mask_path: str):
    """Load ObsMask{scan}_10.mat -> (BB (2,3), ObsMask bool grid, Res)."""
    from scipy.io import loadmat

    m = loadmat(mask_path)
    return m["BB"].astype(np.float64), m["ObsMask"], float(m["Res"][0][0])


def eval_scan(
    data_points: np.ndarray,
    gt_points: np.ndarray,
    obs_mask: Optional[Tuple[np.ndarray, np.ndarray, float]] = None,
    ground_plane: Optional[np.ndarray] = None,
    max_dist: float = 20.0,
    patch: float = 60.0,
) -> Dict[str, float]:
    """Chamfer scores for one scan (already densified/downsampled points).

    Protocol-exact to the reference (dtu_eval.py:119-156):
      * bounding-box crop: BB[0]-patch <= p < BB[1]+2*patch (asymmetric, the
        upper margin really is doubled and the bound strict);
      * ObsMask cell lookup via np.around (nearest cell, not floor);
      * accuracy d2s measured from the ObsMask-cropped points, completeness
        s2d measured against the merely box-cropped points (data_in, NOT the
        ObsMask-cropped set — dtu_eval.py:153);
      * distances >= max_dist are FILTERED OUT of the means, not clipped.
    """
    from scipy.spatial import cKDTree

    data = np.asarray(data_points, np.float64)
    gt = np.asarray(gt_points, np.float64)

    data_in = data
    data_in_obs = data
    if obs_mask is not None:
        BB, mask_grid, res = obs_mask
        BB = np.asarray(BB, np.float32).astype(np.float64)
        inb = np.all((data >= BB[0] - patch) & (data < BB[1] + patch * 2), axis=1)
        data_in = data[inb]
        grid_idx = np.around((data_in - BB[0]) / res).astype(np.int32)
        shape = np.array(mask_grid.shape)
        ok = np.all((grid_idx >= 0) & (grid_idx < shape), axis=1)
        g = grid_idx[ok]
        in_obs = mask_grid[g[:, 0], g[:, 1], g[:, 2]].astype(bool)
        data_in_obs = data_in[ok][in_obs]

    if len(data_in_obs) == 0 or len(data_in) == 0:
        return {"acc": float("nan"), "comp": float("nan"), "overall": float("nan")}

    gt_tree = cKDTree(gt)
    d2s = gt_tree.query(data_in_obs, k=1, workers=-1)[0]
    acc = float(d2s[d2s < max_dist].mean())

    gt_eval = gt
    if ground_plane is not None:
        # keep GT points above the ground plane (dtu_eval.py:149-152)
        p = np.asarray(ground_plane).reshape(-1)
        above = gt @ p[:3] + p[3] > 0
        gt_eval = gt[above]
    data_tree = cKDTree(data_in)
    s2d = data_tree.query(gt_eval, k=1, workers=-1)[0]
    comp = float(s2d[s2d < max_dist].mean())

    return {"acc": acc, "comp": comp, "overall": (acc + comp) / 2.0}


def eval_mesh_against_dtu(
    mesh_path: str,
    scan: int,
    dataset_dir: str,
    downsample_density: float = 0.2,
    max_dist: float = 20.0,
    patch: float = 60.0,
    shuffle_seed: Optional[int] = None,
) -> Dict[str, float]:
    """Full protocol for one scan given the DTU SampleSet layout
    (Points/stl/stl{scan:03}_total.ply + ObsMask/Plane .mat files).

    shuffle_seed seeds the pre-downsample shuffle (the reference shuffles
    unseeded, dtu_eval.py:104-106; pass a seed for reproducible scores)."""
    from ..data.io import read_ply

    verts, faces, _ = read_ply(mesh_path)
    pts = sample_mesh_surface(verts, faces if faces is not None else np.zeros((0, 3), int),
                              downsample_density)
    pts = radius_downsample(pts, downsample_density,
                            shuffle_rng=np.random.default_rng(shuffle_seed))

    gt_path = os.path.join(dataset_dir, "Points", "stl", f"stl{scan:03d}_total.ply")
    gt, _, _ = read_ply(gt_path)

    obs = None
    plane = None
    mask_path = os.path.join(dataset_dir, "ObsMask", f"ObsMask{scan}_10.mat")
    if os.path.exists(mask_path):
        obs = load_obs_mask(mask_path)
    plane_path = os.path.join(dataset_dir, "ObsMask", f"Plane{scan}.mat")
    if os.path.exists(plane_path):
        from scipy.io import loadmat

        plane = loadmat(plane_path)["P"]
    return eval_scan(pts, gt, obs_mask=obs, ground_plane=plane,
                     max_dist=max_dist, patch=patch)
