"""FeatureNet: 3-stage FPN image encoder with deformable-conv heads.

Counterpart of the JAX package's ``models/featurenet.py`` (reference
code1/encoder_utils/fmt/module.py:388-466, dcn.py:43-80). Input and
outputs are channels-last like the JAX module:
  stage1 (N, H/4, W/4, 4*base), stage2 (N, H/2, W/2, 2*base),
  stage3 (N, H, W, base).
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import deform_conv2d
from .layers import BatchNorm2d, Conv2d, ConvBnRelu, sigmoid, upsample_nearest_2x


class DCN(nn.Module):
    """Modulated deformable conv: a 3x3 conv predicts per-tap offsets and a
    sigmoid mask, then the deformable contraction is applied. The offset
    channels are torchvision's interleaved (dy_t, dx_t) pairs."""

    def __init__(self, cin: int, features: int, kernel: int = 3):
        super().__init__()
        kk = kernel * kernel
        self.kk = kk
        self.conv_offset_mask = Conv2d(cin, 3 * kk, kernel,
                                       padding=(kernel - 1) // 2)
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) -> (N, Cout, H, W)."""
        kk = self.kk
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)        # (N, H, W, 3KK)
        offsets = om[..., :2 * kk].reshape(*om.shape[:-1], kk, 2)
        mask = sigmoid(om[..., 2 * kk:])
        out = deform_conv2d(x.permute(0, 2, 3, 1), offsets, mask,
                            self.weight, self.bias)
        return out.permute(0, 3, 1, 2)


class DCNBlock(nn.Module):
    """[Conv+BN+ReLU] -> DCN -> BN -> ReLU -> DCN -> BN -> ReLU -> DCN."""

    def __init__(self, cin: int, mid: int, out: int, first_kernel: int = 1):
        super().__init__()
        self.ConvBnRelu_0 = ConvBnRelu(cin, mid, kernel=first_kernel)
        self.dcn0 = DCN(mid, mid)
        self.BatchNorm_0 = BatchNorm2d(mid)
        self.dcn1 = DCN(mid, mid)
        self.BatchNorm_1 = BatchNorm2d(mid)
        self.dcn2 = DCN(mid, out)

    def forward(self, x, train: bool = False):
        x = self.ConvBnRelu_0(x, train)
        x = F.relu(self.BatchNorm_0(self.dcn0(x), train))
        x = F.relu(self.BatchNorm_1(self.dcn1(x), train))
        return self.dcn2(x)


class FeatureNet(nn.Module):
    """3-scale FPN with deformable output heads."""

    def __init__(self, base_channels: int = 8):
        super().__init__()
        b = base_channels
        chans = [(3, b, 3, 1), (b, b, 3, 1),
                 (b, 2 * b, 5, 2), (2 * b, 2 * b, 3, 1), (2 * b, 2 * b, 3, 1),
                 (2 * b, 4 * b, 5, 2), (4 * b, 4 * b, 3, 1), (4 * b, 4 * b, 3, 1)]
        for i, (ci, co, k, s) in enumerate(chans):
            setattr(self, f"ConvBnRelu_{i}", ConvBnRelu(ci, co, k, s))
        self.out1 = DCNBlock(4 * b, 4 * b, 4 * b, first_kernel=1)
        self.inner1 = Conv2d(2 * b, 4 * b, 1, bias=True)
        self.out2 = DCNBlock(4 * b, 4 * b, 2 * b, first_kernel=3)
        self.inner2 = Conv2d(b, 4 * b, 1, bias=True)
        self.out3 = DCNBlock(4 * b, 4 * b, b, first_kernel=3)

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        conv = [functools.partial(getattr(self, f"ConvBnRelu_{i}"), train=train)
                for i in range(8)]
        conv0 = conv[1](conv[0](x))
        conv1 = conv[4](conv[3](conv[2](conv0)))
        conv2 = conv[7](conv[6](conv[5](conv1)))

        def cl(t):
            return t.permute(0, 2, 3, 1)

        out = {}
        intra = conv2
        out["stage1"] = cl(self.out1(intra, train))
        intra = upsample_nearest_2x(intra) + self.inner1(conv1)
        out["stage2"] = cl(self.out2(intra, train))
        intra = upsample_nearest_2x(intra) + self.inner2(conv0)
        out["stage3"] = cl(self.out3(intra, train))
        return out
