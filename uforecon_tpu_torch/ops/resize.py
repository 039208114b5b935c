"""Image resizes with ``jax.image.resize`` semantics.

The JAX package resizes depth maps, view weights and FPN features with
``jax.image.resize`` (``cascade.py:246,251,426``, ``layers.py:176``). Its
``linear`` method is a triangle filter on half-pixel centres that WIDENS
with the shrink factor whenever an axis shrinks (antialiasing), which
``F.interpolate(align_corners=False)`` does not do. On the render path the
cascade shrinks the full-resolution depth map to stage 2 (half size); the
FMT pathway and the other depth resizes enlarge. ``resize_linear`` builds
the same per-axis weight matrices as ``jax.image.resize`` so both
directions match it; for pure enlargement it equals bilinear
``F.interpolate(align_corners=False)``.
"""
from __future__ import annotations

from typing import Sequence

import torch


def linear_weight_matrix(in_size: int, out_size: int,
                         device=None) -> torch.Tensor:
    """(in_size, out_size) triangle-filter weights of one axis, computed in
    float32 as ``jax._src.image.scale.compute_weight_mat`` does (antialias
    on, no translation)."""
    f32 = torch.float32
    scale = torch.tensor(out_size / in_size, dtype=f32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(f32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


def resize_linear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, method='linear')`` for any axes whose
    size changes (shrinking axes are antialiased). A bf16 tensor is
    resized in bf16, each contraction rounded to bf16, in the order
    ``jax.image.resize``'s einsum takes for two axes: the cheaper order in
    multiply-adds first, the earlier axis on a tie."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} vs tensor rank {x.ndim}")
    axes = [(d, (n_in, n_out)) for d, (n_in, n_out) in enumerate(zip(x.shape, shape))
            if n_in != n_out]
    if x.dtype == torch.bfloat16 and len(axes) == 2:
        (_, (ia, oa)), (_, (ib, ob)) = axes
        # multiply-adds of the two orders, over the size of the other axes
        if ia * ib * oa + ib * oa * ob > ia * ib * ob + ia * ob * oa:
            axes.reverse()
    for d, (n_in, n_out) in axes:
        w = linear_weight_matrix(n_in, n_out, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(torch.movedim(x, d, -1), w, dims=1), -1, d)
    return x


def resize_nearest(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, method='nearest')``: source index
    floor((i + 0.5) * in / out) per changed axis."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} vs tensor rank {x.ndim}")
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        offs = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
        idx = torch.floor(offs).to(torch.long).to(x.device)
        x = torch.index_select(x, d, idx)
    return x
