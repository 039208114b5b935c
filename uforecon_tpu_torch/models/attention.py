"""Linear-attention transformer blocks (counterpart of
the JAX package's ``models/attention.py``).

  * ``FMTEncoderLayer``: the matching transformer's pre-residual layer
    (reference code1/encoder_utils/fmt/FMT.py:79-112);
  * ``LoFTREncoderLayer``: the post-concat layer of the view and ray
    transformers (reference code1/attention/transformer.py:7-58).

Tokens are (B, L, C) as in the JAX package. The per-point view
transformer's attention (a view set's few tokens per sample point) runs in
the tiny-attention CUDA kernels (``ops/tiny_attention.py``) on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.tiny_attention import (EPS, phi, tiny_linear_attention,
                                  tiny_linear_attention_reference,
                                  within_kernel_rule)
from .layers import Linear, layer_norm


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """phi(Q) (phi(K)^T V) / (phi(Q) sum phi(K)) over (B, L, H, D) tensors.

    CUDA tensors within the JAX package's shape rule for its tiny-attention
    kernel (S <= 8, L <= 8, head dim <= 16: the per-point view tokens) go
    to the CUDA kernels, which launch or raise. Otherwise two association
    orders give the same value: short sources (S <= 64) contract
    phi(Q) phi(K)^T first; long ones (the matching transformer's image
    tokens) contract phi(K)^T V first. The JAX package switches at the same
    lengths."""
    if q.is_cuda and within_kernel_rule(q, k):
        return tiny_linear_attention(q, k, v)
    if k.shape[1] <= 64:
        return tiny_linear_attention_reference(q, k, v)
    qf, kf = phi(q), phi(k)
    kv = torch.einsum("bshd,bshm->bhmd", kf, v)
    z = 1.0 / (torch.einsum("blhd,bhd->blh", qf, kf.sum(dim=1)) + EPS)
    return torch.einsum("blhd,bhmd->blhm", qf, kv) * z[..., None]


class FMTEncoderLayer(nn.Module):
    """Pre-residual encoder layer of the matching transformer."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = Linear(d_model, d_model)
        self.k_proj = Linear(d_model, d_model)
        self.v_proj = Linear(d_model, d_model)
        self.out_proj = Linear(d_model, d_model)
        self.norm1 = layer_norm(d_model)
        self.ff1 = Linear(d_model, 2 * d_model)
        self.ff2 = Linear(2 * d_model, d_model)
        self.norm2 = layer_norm(d_model)

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        s = source.shape[1]
        h = self.n_heads
        msg = linear_attention(
            self.q_proj(x).view(b, l, h, c // h),
            self.k_proj(source).view(b, s, h, c // h),
            self.v_proj(source).view(b, s, h, c // h),
        ).reshape(b, l, c)
        x = self.norm1(x + self.out_proj(msg))
        y = self.ff2(F.relu(self.ff1(x)))
        return self.norm2(x + y)


class LoFTREncoderLayer(nn.Module):
    """Post-concat encoder layer of the view / ray transformers (bias-free
    projections)."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = Linear(d_model, d_model, bias=False)
        self.k_proj = Linear(d_model, d_model, bias=False)
        self.v_proj = Linear(d_model, d_model, bias=False)
        self.merge = Linear(d_model, d_model, bias=False)
        self.norm1 = layer_norm(d_model)
        self.mlp1 = Linear(2 * d_model, 2 * d_model, bias=False)
        self.mlp2 = Linear(2 * d_model, d_model, bias=False)
        self.norm2 = layer_norm(d_model)

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        s = source.shape[1]
        h = self.n_heads
        msg = linear_attention(
            self.q_proj(x).view(b, l, h, c // h),
            self.k_proj(source).view(b, s, h, c // h),
            self.v_proj(source).view(b, s, h, c // h),
        ).reshape(b, l, c)
        msg = self.norm1(self.merge(msg))
        msg = self.mlp2(F.relu(self.mlp1(torch.cat([x, msg], dim=-1))))
        return x + self.norm2(msg)


class LocalFeatureTransformer(nn.Module):
    """Stack of LoFTR layers driven by a self/cross schedule."""

    def __init__(self, d_model: int, n_heads: int,
                 layer_names: Sequence[str] = ("self",)):
        super().__init__()
        for name in layer_names:
            if name not in ("self", "cross"):
                raise KeyError(name)
        self.layer_names = tuple(layer_names)
        for i in range(len(layer_names)):
            setattr(self, f"layer_{i}", LoFTREncoderLayer(d_model, n_heads))

    def forward(self, feat0: torch.Tensor,
                feat1: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i, name in enumerate(self.layer_names):
            layer = getattr(self, f"layer_{i}")
            feat0 = layer(feat0, feat0 if name == "self" else feat1)
        return feat0
