"""Image quality metrics: PSNR and SSIM in PyTorch, LPIPS where available.

Counterpart of the JAX package's ``utils/metrics.py`` (reference
code1/misc/metrics.py:10-65 EvalTools, and the ``piq.psnr`` of validation,
model.py:711-712). LPIPS needs the ``lpips`` package and its pretrained
VGG weights; without them it is None, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over all pixels (piq.psnr semantics)."""
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Structural similarity of (H, W, C) or (H, W) images: Wang et al.'s
    formulation with an 11x11 gaussian window and valid filtering, as the
    JAX package (piq/skimage defaults)."""
    x, y = pred.float(), target.float()
    if x.ndim == 2:
        x, y = x[..., None], y[..., None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = _gaussian_kernel(kernel_size, sigma).to(x.device)[None, None]

    def filt(img):
        # depthwise valid convolution per channel: (H, W, C) -> (H', W', C)
        return F.conv2d(img.permute(2, 0, 1)[:, None], win)[:, 0].permute(1, 2, 0)

    mu_x, mu_y = filt(x), filt(y)
    sxx = filt(x * x) - mu_x ** 2
    syy = filt(y * y) - mu_y ** 2
    sxy = filt(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sxx + syy + c2)
    return torch.mean(num / den)


def lpips(pred: np.ndarray, target: np.ndarray) -> Optional[float]:
    """LPIPS perceptual distance; None when the ``lpips`` package (and its
    pretrained VGG) is not installed."""
    try:
        import lpips as _lpips
    except ImportError:
        return None
    loss_fn = _lpips.LPIPS(net="vgg")

    def to_t(a):
        return torch.from_numpy(np.asarray(a, np.float32).transpose(2, 0, 1)[None] * 2 - 1)

    with torch.no_grad():
        return float(loss_fn(to_t(pred), to_t(target)).item())


class EvalTools:
    """PSNR, SSIM and (where available) LPIPS of an image pair
    (reference misc/metrics.py:10-65 API)."""

    def set_inputs(self, pred: np.ndarray, target: np.ndarray):
        self.pred = np.asarray(pred, np.float32)
        self.target = np.asarray(target, np.float32)
        return self

    def get_metrics(self):
        p, t = torch.from_numpy(self.pred), torch.from_numpy(self.target)
        out = {"psnr": float(psnr(p, t)), "ssim": float(ssim(p, t))}
        lp = lpips(self.pred, self.target)
        if lp is not None:
            out["lpips"] = lp
        return out
