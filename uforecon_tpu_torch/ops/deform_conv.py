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


def _jax_slope(f: torch.Tensor, value: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """``value`` (computed from ``f`` without gradient) with derivative
    ``slope`` with respect to ``f``."""
    return value + (f - f.detach()) * slope


def _clip01_slope(u: torch.Tensor) -> torch.Tensor:
    """d clip(u, 0, 1) / du as JAX differentiates it: 1 inside, 1/2 on a
    bound (JAX splits a tie of max/min evenly), 0 outside."""
    inside = ((u > 0) & (u < 1)).to(u.dtype)
    return inside + 0.5 * ((u == 0) | (u == 1)).to(u.dtype)


def _tap_weights(f: torch.Tensor):
    """The two linear weights of a corner pair at fraction ``f`` from the
    clamped base: clip(1 - |f|, 0, 1) and clip(f, 0, 1), with the JAX
    package's derivatives (``ops/deform_conv.py``; JAX's d|f|/df is 1 at
    f = 0). They differ from a plain ``1 - f, f`` only where a sample
    sits on a pixel (a kink of bilinear sampling): the DCN offsets start at
    0, so every tap does at the first step."""
    fd = f.detach()
    sign = torch.where(fd >= 0, torch.ones_like(fd), -torch.ones_like(fd))
    w0 = _jax_slope(f, torch.clamp(1.0 - fd.abs(), 0.0, 1.0),
                    -sign * _clip01_slope(1.0 - fd.abs()))
    w1 = _jax_slope(f, torch.clamp(fd, 0.0, 1.0), _clip01_slope(fd))
    return w0, w1


def _bilinear_zeros(flat: torch.Tensor, h: int, w: int,
                    py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Sample flat (N, H*W, C) at pixel coords (N, P), zero padding: the
    JAX package's clamped-base form (the 2x2 corners from the base clamped
    into the image, the fractions measured from it). The four corners are
    gathered by one index and summed by one contraction."""
    n, _, c = flat.shape
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    y0c = y0.clamp(0, h - 1)
    x0c = x0.clamp(0, w - 1)
    wy = _tap_weights(py - y0 + (y0 - y0c))
    wx = _tap_weights(px - x0 + (x0 - x0c))
    y0c = y0c.to(torch.long)
    x0c = x0c.to(torch.long)
    base = torch.arange(n, device=flat.device).view(n, 1) * (h * w)
    rows, weights = [], []
    for dy in (0, 1):
        for dx in (0, 1):
            yy = y0c + dy
            xx = x0c + dx
            rows.append(base + yy.clamp(max=h - 1) * w + xx.clamp(max=w - 1))
            weights.append(wy[dy] * wx[dx] * ((yy < h) & (xx < w)).to(flat.dtype))
    v = flat.reshape(-1, c)[torch.stack(rows, -1).reshape(-1)].reshape(n, -1, 4, c)
    return torch.einsum("npkc,npk->npc", v, torch.stack(weights, -1))


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
