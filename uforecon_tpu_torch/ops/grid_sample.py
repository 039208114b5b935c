"""Bilinear and trilinear sampling on channels-last tensors.

Counterpart of the JAX package's ``ops/grid_sample.py``, which writes
the gathers by hand (and corner-packs them for the TPU); here both are
``F.grid_sample``, whose ``align_corners`` and ``zeros``/``border`` modes
are the semantics the JAX functions were written to match. The packed
samplers of the JAX package are bit-equal to the unpacked ones and are not
ported.

A source may be bfloat16 (``Config.volume_dtype``,
``Config.image_gather_dtype``). The JAX package gathers such a source's
bf16 values and combines them with float32 weights into a float32 result
(bf16 times f32 promotes to f32): the samplers here sample the source's
float32 conversion, which holds the same values, so the result is that
float32 function (``F.grid_sample`` on the bf16 tensor itself would round
its output to bf16 as well). The conversion is a float32 copy of the
source: per call on the card, which keeps no second copy of its sources;
on the CPU, where a full-size stage volume's copy takes about 0.1 s, once
per source (``_float_source``).

Conventions per call site (JAX ``ray_transformer.py``):
  * image features and rgb||depth: ``align_corners=False``, zeros;
  * pair-match maps: ``align_corners=True``, border;
  * correlation volumes: ``align_corners=True``, zeros.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def in_bounds_mask(grid: torch.Tensor) -> torch.Tensor:
    """Float mask of grid points whose every coordinate lies in [-1, 1]."""
    ok = torch.all((grid >= -1.0) & (grid <= 1.0), dim=-1)
    return ok.to(torch.float32)


def _float_source(x: torch.Tensor) -> torch.Tensor:
    """A bf16 source's float32 values (exact); other sources as they are.
    On the CPU the copy is kept on the source for the calls that follow,
    while the source is unchanged and the call records its gradient as the
    copy's did."""
    if x.dtype != torch.bfloat16:
        return x
    if x.device.type != "cpu" or x.is_inference():
        return x.float()
    key = (x._version, torch.is_grad_enabled() and x.requires_grad)
    kept = getattr(x, "_float32_copy", None)
    if kept is None or kept[0] != key:
        kept = x._float32_copy = (key, x.float())
    return kept[1]


def grid_sample_2d(image: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = False,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample ``image`` (N, H, W, C) at ``grid`` (N, ..., 2)
    normalised (x, y) coordinates. Returns (N, ..., C), float32 for a bf16
    image."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(padding_mode)
    image = _float_source(image)
    n, _, _, c = image.shape
    lead = grid.shape[1:-1]
    g = grid.reshape(n, 1, -1, 2)
    out = F.grid_sample(image.permute(0, 3, 1, 2), g, mode="bilinear",
                        padding_mode=padding_mode,
                        align_corners=align_corners)       # (N, C, 1, P)
    return out[:, :, 0].permute(0, 2, 1).reshape((n,) + lead + (c,))


def grid_sample_3d(volume: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = False,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Trilinear sample ``volume`` (N, C, D, H, W), channels-first as it is
    stored, at ``grid`` (N, ..., 3) normalised (x, y, z) coordinates
    (x indexes W, y H, z D). Returns (N, ..., C), float32 for a bf16
    volume."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(padding_mode)
    volume = _float_source(volume)
    n, c = volume.shape[:2]
    lead = grid.shape[1:-1]
    g = grid.reshape(n, 1, 1, -1, 3)
    out = F.grid_sample(volume, g, mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)       # (N, C, 1, 1, P)
    return out[:, :, 0, 0].permute(0, 2, 1).reshape((n,) + lead + (c,))
