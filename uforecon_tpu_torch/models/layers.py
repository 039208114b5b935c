"""Conv / norm building blocks (counterpart of the JAX package's
``models/layers.py``).

Convolutions here are channels-first, PyTorch's own layout; the modules
that own them convert at their channels-last public boundaries. Submodule
names are the flax scope names (``Conv_0``, ``BatchNorm_0``, ``Dense_0``
...), so ``convert.load_flax_variables`` maps weights by renaming.

Padding follows the JAX package, which matches the reference torch code:
symmetric (k-1)/2 for convolutions, and ``ConvTranspose(k3, s2, p1, op1)``
for the flax ``ConvTranspose(padding=(1, 2), transpose_kernel=True)``
deconvolutions.

BatchNorm follows flax (eps 1e-5, momentum 0.99): each BatchNorm module
takes an explicit ``train`` argument, as the flax modules do, and ignores
``module.training``. Without it, it normalises with its running
statistics; with it, with the batch's statistics (flax's fast variance
``E[x^2] - E[x]^2``, clipped at 0), and it moves its running mean and
variance by ``0.99 * running + 0.01 * batch``. Flax's running variance takes
the *biased* batch variance, where ``F.batch_norm`` takes the unbiased
one, so train mode does not go through ``F.batch_norm``.

Precision follows flax's ``dtype`` / ``param_dtype`` split: ``Conv2d``,
``Conv3d``, ``ConvTranspose3d`` and ``Linear`` compute in their
``compute_dtype`` (float32 unless ``set_compute_dtype`` says otherwise):
the input, the weight and the bias are cast to it and the output is of
it, as a flax ``Conv``/``Dense`` of ``dtype=bfloat16`` promotes all three
(the product rounded to the dtype, then the bias added in it).
The parameters stay float32, and their gradients come back through the
casts in float32. BatchNorm and LayerNorm compute in float32 whatever
their input's dtype and return float32 (flax's ``BatchNorm(dtype=
float32)`` and ``LayerNorm(dtype=float32)`` of the JAX modules), so a
bf16 module's activations after a norm are float32 again, as in JAX.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6   # flax LayerNorm default, used by every LayerNorm of the port
BN_MOMENTUM = 0.01   # torch's convention for flax's momentum=0.99


class _Cast:
    """A layer that computes in ``compute_dtype`` on float32 parameters
    (see the module docstring)."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return self._cast_forward(x.float(), self.weight, self.bias)
        # flax rounds the product to the dtype, then adds the bias in it
        y = self._cast_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self._channel(self.bias.to(dt), y)

    @staticmethod
    def _channel(b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The bias broadcast along the channel axis of a channels-first y."""
        return b.view((-1,) + (1,) * (y.ndim - 2))


class Linear(_Cast, nn.Linear):
    def _cast_forward(self, x, w, b):
        return F.linear(x, w, b)

    @staticmethod
    def _channel(b, y):
        return b


class Conv2d(_Cast, nn.Conv2d):
    def _cast_forward(self, x, w, b):
        return self._conv_forward(x, w, b)


class Conv3d(_Cast, nn.Conv3d):
    def _cast_forward(self, x, w, b):
        return self._conv_forward(x, w, b)


class ConvTranspose3d(_Cast, nn.ConvTranspose3d):
    def _cast_forward(self, x, w, b):
        return F.conv_transpose3d(x, w, b, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Every cast layer of ``module`` computes in ``dtype``."""
    for m in module.modules():
        if isinstance(m, _Cast):
            m.compute_dtype = dtype


class _FlaxBatchNorm:
    """The forward of ``BatchNorm2d`` / ``BatchNorm3d`` (see the module
    docstring)."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        axes = [0, *range(2, x.ndim)]
        mean = x.mean(axes)
        var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * var)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    def __init__(self, features: int):
        super().__init__(features, momentum=BN_MOMENTUM)


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    def __init__(self, features: int):
        super().__init__(features, momentum=BN_MOMENTUM)


class LayerNorm(nn.LayerNorm):
    """flax's ``LayerNorm(dtype=float32)``: float32 in and out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


def layer_norm(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=LN_EPS)


class ConvBnRelu(nn.Module):
    """Conv2d + BatchNorm + optional ReLU on (N, C, H, W)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True):
        super().__init__()
        self.Conv_0 = Conv2d(cin, features, kernel, stride,
                             padding=(kernel - 1) // 2, bias=False)
        self.BatchNorm_0 = BatchNorm2d(features)
        self.relu = relu

    def forward(self, x, train: bool = False):
        x = self.BatchNorm_0(self.Conv_0(x), train)
        return F.relu(x) if self.relu else x


class Conv3dBnRelu(nn.Module):
    """Conv3d + BatchNorm + optional ReLU on (N, C, D, H, W)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True):
        super().__init__()
        self.Conv_0 = Conv3d(cin, features, kernel, stride,
                             padding=(kernel - 1) // 2, bias=False)
        self.BatchNorm_0 = BatchNorm3d(features)
        self.relu = relu

    def forward(self, x, train: bool = False):
        x = self.BatchNorm_0(self.Conv_0(x), train)
        return F.relu(x) if self.relu else x


def deconv3d(cin: int, features: int, bias: bool) -> ConvTranspose3d:
    """Stride-2 3x3x3 transposed conv doubling each spatial axis."""
    return ConvTranspose3d(cin, features, 3, stride=2, padding=1,
                           output_padding=1, bias=bias)


class Deconv3dBnRelu(nn.Module):
    """ConvTranspose3d(stride 2) + BatchNorm + ReLU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = deconv3d(cin, features, bias=False)
        self.BatchNorm_0 = BatchNorm3d(features)

    def forward(self, x, train: bool = False):
        return F.relu(self.BatchNorm_0(self.ConvTranspose_0(x), train))


class MLP(nn.Module):
    """Linear stack with ReLU between layers (none after the last)."""

    def __init__(self, cin: int, features: Sequence[int]):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            setattr(self, f"Dense_{i}", Linear(cin, f))
            cin = f

    def layers(self):
        return [getattr(self, f"Dense_{i}") for i in range(self.n)]

    def forward(self, x):
        for i, lin in enumerate(self.layers()):
            x = lin(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: a float32 tensor by ``torch.sigmoid``; another
    dtype as 1 / (1 + exp(-x)), each step rounded in that dtype, as XLA
    computes a bf16 logistic."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``: a float32 tensor by ``torch.softmax``; another
    dtype op by op in that dtype (exp of the shifted input, its sum, the
    quotient, each rounded), as JAX computes a bf16 softmax."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of the last two axes."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
