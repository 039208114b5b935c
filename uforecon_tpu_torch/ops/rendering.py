"""NeuS volume rendering: SRDF -> alpha compositing.

Counterpart of the JAX package's ``ops/rendering.py`` (reference
code1/encoder_utils/renderer.py:7-48), quirks included: the cosine is
fixed at -1 (so the next/previous SRDF estimates are srdf -/+ interval/2
at cos_anneal_ratio 1) and the transmittance carries the reference's
+1e-7.
"""
from __future__ import annotations

from typing import Dict

import torch


def neus_render(
    z_val: torch.Tensor,     # (RN, SN)
    radiance: torch.Tensor,  # (RN, SN, 3)
    srdf: torch.Tensor,      # (RN, SN)
    inv_s: torch.Tensor,     # scalar: exp(10 * variance)
    cos_anneal_ratio: float = 1.0,
) -> Dict[str, torch.Tensor]:
    interval = z_val[:, 1:] - z_val[:, :-1]
    interval = torch.cat([interval[:, :1], interval, interval[:, -1:]], dim=1)
    interval = (interval[:, :-1] + interval[:, 1:]) * 0.5

    inv_s = torch.clamp(inv_s, 1e-6, 1e6)
    true_cos = -1.0
    iter_cos = -(
        -true_cos * 0.5 + 0.5 * (1.0 - cos_anneal_ratio) - true_cos * cos_anneal_ratio
    )

    next_srdf = srdf + iter_cos * interval * 0.5
    prev_srdf = srdf - iter_cos * interval * 0.5
    prev_cdf = torch.sigmoid(prev_srdf * inv_s)
    next_cdf = torch.sigmoid(next_srdf * inv_s)

    p = prev_cdf - next_cdf
    c = prev_cdf
    alpha = torch.clamp((p + 1e-5) / (c + 1e-5), 0.0, 1.0)

    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], dim=1),
        dim=1,
    )[:, :-1]
    weight = alpha * trans

    return {
        "rgb": torch.sum(radiance * weight[..., None], dim=1),
        "depth": torch.sum(weight * z_val, dim=1),
        "opacity": torch.sum(weight, dim=1),
        "weight": weight,
        "variance": 1.0 / inv_s,
    }
