"""Correlation-frustum volume head (counterpart of
the JAX package's ``models/volumes.py`` CostRegNetWeight; reference
code1/encoder_utils/fmt/module.py:502-543). The featuregrid volume path
is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from .layers import deconv3d


class CostRegNetWeight(nn.Module):
    """3D U-Net of plain biased convs with residual adds ->
    (8-ch feature volume, 1-ch sigmoid weight volume), channels-first."""

    def __init__(self, cin: int = 1, base_channels: int = 8):
        super().__init__()
        b = base_channels

        def conv(ci, co, s):
            return nn.Conv3d(ci, co, 3, stride=s, padding=1)

        self.conv0 = conv(cin, b, 1)
        self.conv1 = conv(b, 2 * b, 2)
        self.conv2 = conv(2 * b, 2 * b, 1)
        self.conv3 = conv(2 * b, 4 * b, 2)
        self.conv4 = conv(4 * b, 4 * b, 1)
        self.conv5 = conv(4 * b, 8 * b, 2)
        self.conv6 = conv(8 * b, 8 * b, 1)
        self.conv7 = deconv3d(8 * b, 4 * b, bias=True)
        self.conv9 = deconv3d(4 * b, 2 * b, bias=True)
        self.conv11 = deconv3d(2 * b, b, bias=True)
        self.features = nn.Conv3d(b, 8, 3, padding=1, bias=False)
        self.weights = nn.Conv3d(b, 1, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        z = self.conv6(self.conv5(c4))
        z = c4 + self.conv7(z)
        z = c2 + self.conv9(z)
        z = c0 + self.conv11(z)
        return self.features(z), torch.sigmoid(self.weights(z))
