"""Modulated deformable convolution (DCNv2) in plain PyTorch.

Counterpart of the JAX package's ``ops/deform_conv.py`` (reference
code1/encoder_utils/fmt/dcn.py:15-80; torchvision's op is not available):
each of the K*K taps bilinearly samples the input at ``p + p_k + dp_k``
with zero padding, is modulated by the mask, and is contracted against
its (C, Cout) weight slice before the next tap is sampled, which bounds
the temporaries to one tap. ``deform_conv2d_reference`` in the JAX module
is the spec.
"""
from __future__ import annotations

from typing import Optional

import torch


def _bilinear_zeros(flat: torch.Tensor, h: int, w: int,
                    py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Sample flat (N, H*W, C) at pixel coords (N, P), zero padding."""
    n, _, c = flat.shape
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy = py - y0
    wx = px - x0
    y0 = y0.to(torch.long)
    x0 = x0.to(torch.long)
    out = 0.0
    for dy, dx, wgt in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                        (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yy = y0 + dy
        xx = x0 + dx
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        v = torch.gather(flat, 1, idx[..., None].expand(n, idx.shape[1], c))
        out = out + v * (wgt * valid.to(flat.dtype))[..., None]
    return out


def deform_conv2d(
    x: torch.Tensor,          # (N, H, W, C)
    offsets: torch.Tensor,    # (N, H, W, K*K, 2) per-tap (dy, dx) in pixels
    mask: torch.Tensor,       # (N, H, W, K*K) modulation
    weight: torch.Tensor,     # (Cout, C, K, K) torch layout
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stride 1, 'same' padding, dilation 1. Returns (N, H, W, Cout)."""
    n, h, w, c = x.shape
    cout, _, kh, kw = weight.shape
    dt = x.dtype
    ys = torch.arange(h, dtype=dt, device=x.device).view(1, h, 1)
    xs = torch.arange(w, dtype=dt, device=x.device).view(1, 1, w)
    flat = x.reshape(n, h * w, c)
    w_taps = weight.permute(2, 3, 1, 0).reshape(kh * kw, c, cout)
    out = torch.zeros(n, h * w, cout, dtype=dt, device=x.device)
    for t in range(kh * kw):
        iy, ix = divmod(t, kw)
        py = (ys + (iy - (kh - 1) / 2.0) + offsets[..., t, 0]).reshape(n, -1)
        px = (xs + (ix - (kw - 1) / 2.0) + offsets[..., t, 1]).reshape(n, -1)
        tap = _bilinear_zeros(flat, h, w, py, px)
        tap = tap * mask[..., t].reshape(n, -1, 1)
        out = out + tap @ w_taps[t]
    out = out.reshape(n, h, w, cout)
    if bias is not None:
        out = out + bias
    return out
