"""Feature volumes (counterpart of the JAX package's ``models/volumes.py``):

  * CostRegNetWeight: the correlation-frustum head, a 3D U-Net over each
    cascade cost volume giving an 8-channel feature volume and a sigmoid
    weight volume (reference code1/encoder_utils/fmt/module.py:502-543);
  * FeatureVolume: the ``featuregrid`` path's global volume_reso^3 grid in
    [-1, 1]^3, projected into every source view, its sampled stage-1
    features compressed by an MLP, their mask-weighted mean and variance
    over the views regularised by VolumeRegularization, a 16 -> 48 -> 16
    channel 3D U-Net (reference code1/feature_volume.py:11-97,
    encoder_utils/cnn3d.py:42-73).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.grid_sample import grid_sample_2d, in_bounds_mask
from .layers import MLP, Conv3d, Conv3dBnRelu, Deconv3dBnRelu, deconv3d, sigmoid


class CostRegNetWeight(nn.Module):
    """3D U-Net of plain biased convs with residual adds ->
    (8-ch feature volume, 1-ch sigmoid weight volume), channels-first."""

    def __init__(self, cin: int = 1, base_channels: int = 8):
        super().__init__()
        b = base_channels

        def conv(ci, co, s):
            return Conv3d(ci, co, 3, stride=s, padding=1)

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
        self.features = Conv3d(b, 8, 3, padding=1, bias=False)
        self.weights = Conv3d(b, 1, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        z = self.conv6(self.conv5(c4))
        z = c4 + self.conv7(z)
        z = c2 + self.conv9(z)
        z = c0 + self.conv11(z)
        return self.features(z), sigmoid(self.weights(z))


class VolumeRegularization(nn.Module):
    """16 -> 48 -> 16 channel 3D U-Net of the featuregrid path, on
    channels-first (N, 16, D, H, W); submodules under their flax names."""

    def __init__(self):
        super().__init__()
        chans = [(16, 16, 1), (16, 16, 2), (16, 16, 1), (16, 32, 2), (32, 32, 1),
                 (32, 48, 2), (48, 48, 1)]
        for i, (ci, co, s) in enumerate(chans):
            setattr(self, f"Conv3dBnRelu_{i}", Conv3dBnRelu(ci, co, stride=s))
        for i, (ci, co) in enumerate([(48, 32), (32, 16), (16, 16)]):
            setattr(self, f"Deconv3dBnRelu_{i}", Deconv3dBnRelu(ci, co))
        self.Conv_0 = Conv3d(16, 16, 3, padding=1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x0 = self.Conv3dBnRelu_0(x, train)
        x1 = self.Conv3dBnRelu_2(self.Conv3dBnRelu_1(x0, train), train)
        x2 = self.Conv3dBnRelu_4(self.Conv3dBnRelu_3(x1, train), train)
        x3 = self.Conv3dBnRelu_6(self.Conv3dBnRelu_5(x2, train), train)
        y2 = self.Deconv3dBnRelu_0(x3, train)
        y1 = self.Deconv3dBnRelu_1(y2 + x2, train)
        y0 = self.Deconv3dBnRelu_2(y1 + x1, train)
        return self.Conv_0(y0 + x0)


class FeatureVolume(nn.Module):
    """The featuregrid volume: (NV, h, w, C) stage-1 features and (NV, 4, 4)
    NDC projections -> a (16, Z, Y, X) channels-first grid over [-1, 1]^3,
    which ``grid_sample_3d`` samples at world (x, y, z)."""

    def __init__(self, volume_reso: int = 96, cin: int = 32):
        super().__init__()
        self.volume_reso = volume_reso
        self.MLP_0 = MLP(cin, (32, 16, 8))
        self.VolumeRegularization_0 = VolumeRegularization()

    def forward(self, feats: torch.Tensor, source_poses: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        r = self.volume_reso
        line = np.linspace(-1.0, 1.0, r, dtype=np.float32)
        grid = np.stack(np.meshgrid(line, line, line, indexing="ij"), axis=-1)
        xyz = torch.as_tensor(grid.reshape(-1, 3), device=feats.device)   # x slowest
        pts = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=-1)
        proj = torch.einsum("vij,nj->vni", source_poses, pts)
        depth = proj[..., 2]
        valid = (depth > 0).float()
        uv = proj[..., :2] / torch.where(depth == 0, torch.full_like(depth, 1e-8),
                                         depth)[..., None]
        sampled = grid_sample_2d(feats, uv[:, :, None], align_corners=False,
                                 padding_mode="zeros")[:, :, 0]     # (NV, R^3, C)
        mask = in_bounds_mask(uv) * valid                          # (NV, R^3)
        w = (mask / (mask.sum(dim=0, keepdim=True) + 1e-8))[..., None]
        compressed = self.MLP_0(sampled)                           # (NV, R^3, 8)
        mean = (compressed * w).sum(dim=0)
        var = (w * (compressed - mean[None]) ** 2).sum(dim=0)
        # (x, y, z, 16) -> channels-first (16, z, y, x): the JAX package's
        # (Z, Y, X, C) after its transpose (JAX volumes.py:128-131)
        mean_var = torch.cat([mean, var], dim=-1).reshape(r, r, r, 16)
        mean_var = mean_var.permute(3, 2, 1, 0).contiguous()
        return self.VolumeRegularization_0(mean_var[None], train)[0]
