"""Encode-time merge of each view's three stage volumes into one volume.

Counterpart of the JAX package's ``ops/volume_merge.py``
(``Config.volume_merge``). Every stage volume is sampled at the same
normalised (x, y, z) coordinates (align_corners=True), so the merge is
geometric: each stage's feat||weight volume is resampled onto one common
(D_m, H, W) grid by align-corners trilinear interpolation, the stages'
features are concatenated and their weights summed. The query then samples
one volume per view instead of one per (view, stage):

    exact:  G = sum_v concat_s(f_sv) * (sum_s w_sv) / sum_v sum_s w_sv
    merged: G = sum_v trilin(concat_s rs(f_sv)) * trilin(sum_s rs(w_sv))
                / sum_v trilin(sum_s rs(w_sv))

where rs() is the common-grid resample: the identity where a stage's grid
is the common one (bit-exact), else a re-discretisation of the same
interpolant, an approximation of the exact path (the JAX package gates it
by mesh metrics, not by parity).

Layout: the port keeps its volumes unpacked and channel-first, stage
volumes (NV, F + 1, D_s, h_s, w_s) and the merged volume (NV, S F + 1,
D_m, H, W): the stages' features in stage order, then the summed weight.
The JAX package corner-packs the merged volume (8 corners per row) for the
TPU's gathers; ``F.grid_sample`` needs no packing, so the port's volume is
8x smaller than the JAX package's, and ``merge_pad`` (the JAX pack's lane
padding) changes no number here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .fused_volume_fusion import EPS
from .grid_sample import grid_sample_3d


def resize_axis_linear_ac(vol: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """Linear resample of one axis with align_corners=True: output j reads
    input position j (n_in - 1) / (n_out - 1), as the samplers and the NDC
    projection do. Two whole-slice gathers and a lerp; the identity when
    n_out == n_in, and the one input slice repeated when n_in == 1."""
    n_in = vol.shape[axis]
    if n_in == n_out:
        return vol
    if n_in == 1:
        reps = [1] * vol.ndim
        reps[axis] = n_out
        return vol.repeat(*reps)
    # jnp.linspace's float32 formula, (n_in - 1) * (j / (n_out - 1)), the
    # last position exact
    t = torch.arange(n_out - 1, device=vol.device, dtype=torch.float32) / (n_out - 1)
    pos = torch.cat([(n_in - 1) * t, t.new_full((1,), n_in - 1)])
    i0 = torch.clamp(torch.floor(pos), 0, n_in - 2).long()
    shape = [1] * vol.ndim
    shape[axis] = n_out
    f = (pos - i0.to(pos.dtype)).to(vol.dtype).reshape(shape)
    a = torch.index_select(vol, axis, i0)
    b = torch.index_select(vol, axis, i0 + 1)
    return a * (1.0 - f) + b * f


def resize_trilinear_ac(vol: torch.Tensor, out_dhw: Tuple[int, int, int]) -> torch.Tensor:
    """(NV, C, D, H, W) -> (NV, C, D', H', W') align-corners trilinear:
    depth first (a reduction or the identity here), then the two image
    axes, so the largest intermediate is the smallest."""
    d, h, w = out_dhw
    vol = resize_axis_linear_ac(vol, 2, d)
    vol = resize_axis_linear_ac(vol, 3, h)
    return resize_axis_linear_ac(vol, 4, w)


def merge_stage_volumes(fws: Dict[str, torch.Tensor], d_out: int,
                        hw_out: Tuple[int, int],
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The merged volume of per-stage feat||weight volumes.

    Args:
      fws: stage -> (NV, F + 1, D_s, h_s, w_s), the features then the
        fusion weight, in stage order (the stages are taken in insertion
        order; the JAX function sorts their names, which permutes them past
        nine stages).
      d_out, hw_out: the common grid (z-bins, (H, W)).
      dtype: the storage type; the resample runs in float32 and is cast
        afterwards, as in JAX.

    Returns (NV, S F + 1, d_out, H, W): the stages' features, then the
    summed weight."""
    feats, wsum = [], None
    for fw in fws.values():
        r = resize_trilinear_ac(fw.float(), (d_out,) + tuple(hw_out))
        feats.append(r[:, :-1])
        wsum = r[:, -1:] if wsum is None else wsum + r[:, -1:]
    return torch.cat(feats + [wsum], dim=1).to(dtype)


def query_merged_volume(vol: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Sample and fuse across views from a merged volume: one sample per
    (point, view) instead of one per (point, view, stage).

    Args:
      vol: (NV, S F + 1, D, H, W) merged volume (float32 or bf16).
      xyz: (NV, ..., 3) normalised sample coordinates, those the exact path
        feeds every stage.

    Returns (..., S F): the exact path's output contract, with the same
    ratio and 1e-8 guard."""
    fw = grid_sample_3d(vol, xyz, align_corners=True, padding_mode="zeros")
    feats, w = fw[..., :-1], fw[..., -1:]
    return torch.sum(feats * w, dim=0) / (torch.sum(w, dim=0) + EPS)
