"""Grouped pairwise cosine similarity: CUDA kernel, its plain PyTorch
version, and the wrapper that picks between them.

Replaces the Pallas TPU kernel the JAX package's ``ops/fused_similarity.py``
``grouped_cosine_fused``, the tail of the explicit-similarity query: for
each view pair (i, j), the pair's map sampled in view i and in view j, its
channels split into groups, the cosine of each group (denominator
max(|a| |b|, 1e-8), torch CosineSimilarity), averaged over pairs. The
kernel is ``csrc/grouped_cosine.cu``.

Bound on the H100: bytes (at P = 65,536 and 3 views it reads 50 MB and
writes 2 MB). Design: one thread per (point, group), points fastest. The
kernel takes any strides; ``query_similarity`` hands it the channel-first
layout ``F.grid_sample`` produces, as a view without a copy, on which a
warp's reads are contiguous.

``grouped_cosine`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises, inside an autograd Function
whose backward differentiates the plain version (the JAX ``_gc_bwd``
pattern). ``grouped_cosine.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from . import cuda_build

EPS = 1e-8  # torch nn.CosineSimilarity eps


def view_pairs(n_views: int) -> List[Tuple[int, int]]:
    """Ordered view pairs (i, j), i < j, in lexicographic order."""
    return [(a, b) for a in range(n_views - 1) for b in range(a + 1, n_views)]


def pair_slots(n_views: int) -> List[Tuple[int, int]]:
    """Slot of each pair's map in the two packed view rows: view v's row
    holds its maps in pair order, so pair p sits at the count of earlier
    pairs that involve v. The kernel uses the closed form (j - 1, i)."""
    counts = [0] * n_views
    slots = []
    for i, j in view_pairs(n_views):
        slots.append((counts[i], counts[j]))
        counts[i] += 1
        counts[j] += 1
    return slots


def grouped_cosine_reference(sampled: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Plain PyTorch forward, mirroring the JAX ``grouped_cosine_reference``:
    sampled (NV, P, (NV-1) C) -> (P, n_groups). Every pair at once: each
    pair's two (C, P) maps taken from the channel-first blocks (a view of
    the sampler's layout) into (pairs, n_groups, C / n_groups, P): a loop
    over the NV (NV - 1) / 2 pairs, a few small operations each, was bound
    by its launches (~11 ms at 11 views and 65,536 points on an H100). A
    group's sums run over its channels in order, the same on the card and
    the CPU."""
    nv, n, cc = sampled.shape
    c = cc // (nv - 1)
    g = c // n_groups
    pairs, slots = view_pairs(nv), pair_slots(nv)
    # row v * (nv - 1) + k: view v's k-th pair map, (C, P)
    maps = sampled.permute(0, 2, 1).reshape(nv * (nv - 1), c, n)

    def side(k):
        rows = torch.tensor([pr[k] * (nv - 1) + sl[k] for pr, sl in zip(pairs, slots)],
                            device=sampled.device)
        return maps.index_select(0, rows).view(len(pairs), n_groups, g, n)

    gi, gj = side(0), side(1)

    def group_sum(y):
        acc = y[:, :, 0]
        for e in range(1, g):
            acc = acc + y[:, :, e]
        return acc                                  # (pairs, n_groups, P)

    dot = group_sum(gi * gj)
    ni = torch.sqrt(group_sum(gi * gi))
    nj = torch.sqrt(group_sum(gj * gj))
    cos = dot / torch.clamp(ni * nj, min=EPS)
    return torch.mean(cos, dim=0).t().contiguous()


def _launch(sampled: torch.Tensor, n_groups: int) -> torch.Tensor:
    nv, n, cc = sampled.shape
    if nv < 2 or cc % (nv - 1) or (cc // (nv - 1)) % n_groups:
        raise ValueError(f"grouped_cosine kernel takes (NV >= 2, P, (NV-1) C) "
                         f"with C a multiple of {n_groups} groups, got "
                         f"{tuple(sampled.shape)}")
    if not sampled.is_cuda or sampled.dtype != torch.float32:
        raise ValueError("grouped_cosine kernel takes a float32 CUDA tensor, "
                         f"got {sampled.dtype} on {sampled.device}")
    ext = cuda_build.extension()
    out = torch.empty(n, n_groups, device=sampled.device, dtype=torch.float32)
    with torch.cuda.device(sampled.device):
        ext.grouped_cosine(sampled, out)
    grouped_cosine.launches += 1
    return out


# _grouped_cosine_fn(n_groups, sampled): CUDA kernel forward, backward
# through the plain version
_grouped_cosine_fn = cuda_build.kernel_function(
    lambda n_groups, x: _launch(x, n_groups),
    lambda n_groups, x: grouped_cosine_reference(x, n_groups))


def grouped_cosine(sampled: torch.Tensor, n_groups: int = 8) -> torch.Tensor:
    """Grouped pairwise cosine: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. sampled (NV, P, (NV-1) C) -> (P, n_groups)."""
    if not sampled.is_cuda:
        return grouped_cosine_reference(sampled, n_groups)
    return _grouped_cosine_fn(n_groups, sampled)


grouped_cosine.launches = 0
