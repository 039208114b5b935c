"""Positional encodings (counterpart of the JAX package's ``ops/posenc.py``).

  * sine 2D image PE of the matching transformer (numpy, static);
  * NeRF frequency encoding of the depth distance and of the view
    direction (torch);
  * sinusoidal sample-order encoding along a ray (numpy, static).
"""
from __future__ import annotations

import numpy as np
import torch


def sine_image_pe(d_model: int, height: int, width: int) -> np.ndarray:
    """2D sine positional encoding (H, W, C); positions are 1-indexed."""
    pe = np.zeros((d_model, height, width), dtype=np.float32)
    y_pos = np.arange(1, height + 1, dtype=np.float32)[:, None] * np.ones((1, width), np.float32)
    x_pos = np.ones((height, 1), np.float32) * np.arange(1, width + 1, dtype=np.float32)[None, :]
    div_term = np.exp(
        np.arange(0, d_model // 2, 2, dtype=np.float32)
        * (-np.log(10000.0) / (d_model // 2))
    )[:, None, None]
    pe[0::4] = np.sin(x_pos[None] * div_term)
    pe[1::4] = np.cos(x_pos[None] * div_term)
    pe[2::4] = np.sin(y_pos[None] * div_term)
    pe[3::4] = np.cos(y_pos[None] * div_term)
    return np.transpose(pe, (1, 2, 0))


def nerf_posenc(x: torch.Tensor, num_freqs: int,
                include_input: bool = False) -> torch.Tensor:
    """NeRF frequency encoding [sin(f0 x), cos(f0 x), sin(f1 x), ...] of the
    last axis, channel-major: (..., d) -> (..., 2 * num_freqs * d), with
    f_k = pi * 2^k and cos as sin at phase pi/2; ``include_input`` puts x
    itself first (+ d)."""
    freqs = float(np.pi) * (2.0 ** np.arange(num_freqs, dtype=np.float32))
    freqs = np.repeat(freqs, 2).astype(np.float32)
    phases = np.zeros(2 * num_freqs, dtype=np.float32)
    phases[1::2] = np.pi * 0.5
    f = torch.as_tensor(freqs, device=x.device)[:, None]
    ph = torch.as_tensor(phases, device=x.device)[:, None]
    emb = torch.sin(x[..., None, :] * f + ph)
    emb = emb.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    return torch.cat([x, emb], dim=-1) if include_input else emb


def order_posenc(d_hid: int, n_samples: int) -> np.ndarray:
    """Sinusoidal encoding of the sample index along a ray (SN, d_hid)."""
    pos = np.arange(n_samples, dtype=np.float64)[:, None]
    j = np.arange(d_hid, dtype=np.float64)[None, :]
    table = pos / np.power(10000.0, 2 * (j // 2) / d_hid)
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table.astype(np.float32)
