"""Conv / norm building blocks (counterpart of the JAX package's
``models/layers.py``).

Convolutions here are channels-first, PyTorch's own layout; the modules
that own them convert at their channels-last public boundaries. Submodule
names are the flax scope names (``Conv_0``, ``BatchNorm_0``, ``Dense_0``
...), so ``convert.load_flax_variables`` maps weights by renaming.

Padding follows the JAX package, which matches the reference torch code:
symmetric (k-1)/2 for convolutions, and ``ConvTranspose(k3, s2, p1, op1)``
for the flax ``ConvTranspose(padding=(1, 2), transpose_kernel=True)``
deconvolutions. BatchNorm runs on its running statistics (eps 1e-5, the
flax default too): the port renders, it does not train.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6   # flax LayerNorm default, used by every LayerNorm of the port


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class ConvBnRelu(nn.Module):
    """Conv2d + BatchNorm + optional ReLU on (N, C, H, W)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, kernel, stride,
                                padding=(kernel - 1) // 2, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features)
        self.relu = relu

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.relu else x


class Conv3dBnRelu(nn.Module):
    """Conv3d + BatchNorm + optional ReLU on (N, C, D, H, W)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv3d(cin, features, kernel, stride,
                                padding=(kernel - 1) // 2, bias=False)
        self.BatchNorm_0 = nn.BatchNorm3d(features)
        self.relu = relu

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.relu else x


def deconv3d(cin: int, features: int, bias: bool) -> nn.ConvTranspose3d:
    """Stride-2 3x3x3 transposed conv doubling each spatial axis."""
    return nn.ConvTranspose3d(cin, features, 3, stride=2, padding=1,
                              output_padding=1, bias=bias)


class Deconv3dBnRelu(nn.Module):
    """ConvTranspose3d(stride 2) + BatchNorm + ReLU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = deconv3d(cin, features, bias=False)
        self.BatchNorm_0 = nn.BatchNorm3d(features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.ConvTranspose_0(x)))


class MLP(nn.Module):
    """Linear stack with ReLU between layers (none after the last)."""

    def __init__(self, cin: int, features: Sequence[int]):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            setattr(self, f"Dense_{i}", nn.Linear(cin, f))
            cin = f

    def layers(self):
        return [getattr(self, f"Dense_{i}") for i in range(self.n)]

    def forward(self, x):
        for i, lin in enumerate(self.layers()):
            x = lin(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of the last two axes."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
