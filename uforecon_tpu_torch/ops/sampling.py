"""Ray point sampling: stratified coarse + inverse-CDF importance sampling.

Counterpart of the JAX package's ``ops/sampling.py`` (reference
code1/encoder_utils/sampler.py:7-108). The uniform draws ``u`` are an
argument: when it is not given they come from ``generator`` (a
``torch.Generator`` on the rays' device). torch cannot reproduce JAX's
threefry bits, so the tests pass both sides the same ``u``.

``chunk_draws`` is the draw schedule of one ray chunk: every render and
training step that draws from a generator draws through it, so that a
chunk's draws are the same on one rank as on several.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _uniform(shape, like: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=like.device,
                      dtype=like.dtype)


def chunk_draws(rn: int, samples: Tuple[int, int],
                generator: Optional[torch.Generator], device,
                coarse_only: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The uniform draws of one chunk of ``rn`` rays, in the order the
    render takes them from ``generator``: (rn, n_coarse) for
    ``sample_coarse``, then (rn, n_fine) for ``sample_importance`` (None
    with ``coarse_only``)."""
    n_coarse, n_fine = samples
    u_c = torch.rand((rn, n_coarse), generator=generator, device=device)
    u_f = None if coarse_only else torch.rand((rn, n_fine), generator=generator,
                                              device=device)
    return u_c, u_f


def sample_coarse(
    ray_o: torch.Tensor,      # (RN, 3)
    ray_d: torch.Tensor,      # (RN, 3)
    point_num: int,
    near: torch.Tensor,       # (RN,)
    far: torch.Tensor,
    u: Optional[torch.Tensor] = None,        # (RN, SN) uniform [0, 1)
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified z samples in [near, far], jittered by (u - 0.5) of one
    interval. Returns (points (RN, SN, 3), z (RN, SN))."""
    t = torch.linspace(0.0, 1.0, point_num, device=ray_o.device,
                       dtype=ray_o.dtype)
    span = (far - near)[:, None]
    z = near[:, None] + t[None, :] * span
    if u is None:
        u = _uniform(z.shape, z, generator)
    interval = 1.0 / (point_num - 1)
    z = z + (u - 0.5) * interval * span
    points = ray_o[:, None] + z[..., None] * ray_d[:, None]
    return points, z


def sample_importance(
    ray_o: torch.Tensor,      # (RN, 3)
    ray_d: torch.Tensor,      # (RN, 3)
    weight: torch.Tensor,     # (RN, SN) coarse rendering weights
    z_val: torch.Tensor,      # (RN, SN) sorted coarse z
    point_num: int,
    u: Optional[torch.Tensor] = None,        # (RN, PN) uniform [0, 1)
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse-CDF fine samples from the coarse weights: uniform draws,
    left-side bin search, linear interpolation between the bracketing z,
    sorted. Returns (points (RN, PN, 3), z (RN, PN))."""
    rn, sn = z_val.shape
    cdf = torch.cumsum(weight, dim=1) / (weight.sum(dim=1, keepdim=True) + 1e-6)
    if u is None:
        u = _uniform((rn, point_num), z_val, generator)
    u = torch.minimum(torch.maximum(u, cdf[:, 0:1]), cdf[:, -1:])

    # #{s : cdf[s] < u}: cdf is a cumulative sum of non-negative weights,
    # so the left-side search equals the JAX package's dense count
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), side="left")
    idx = idx.clamp(1, sn - 1)
    right_cdf = torch.gather(cdf, 1, idx)
    left_cdf = torch.gather(cdf, 1, idx - 1)
    z_right = torch.gather(z_val, 1, idx)
    z_left = torch.gather(z_val, 1, idx - 1)

    z = (u - left_cdf) / (right_cdf - left_cdf + 1e-6) * (z_right - z_left) + z_left
    z, _ = torch.sort(z, dim=1)
    points = ray_o[:, None] + z[..., None] * ray_d[:, None]
    return points, z
