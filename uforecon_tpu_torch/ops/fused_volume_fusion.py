"""Cross-view fusion of the correlation-volume samples: CUDA kernel, its
plain PyTorch version, and the wrapper that picks between them.

Replaces the Pallas TPU kernel the JAX package's
``ops/fused_volume_fusion.py`` ``volume_fusion_fused``, the tail of the
correlation-volume query: with ws_v the summed stage weights of view v,
G = sum_v f_v ws_v / (sum_v ws_v + 1e-8), the stages' features side by
side. The kernel is ``csrc/volume_fusion.cu``.

Bound on the H100: bytes (at P = 65,536 and 3 views it reads 21.2 MB and
writes 6.3 MB, 0.0082 ms). Design: one thread per point, the number of
views NV a template parameter from 1 to 11 so that a view's loads do not
wait for the previous view's, a runtime count above (the same sums in
the same order), and a block's output rows stored as one coalesced run
through shared memory. The kernel takes any strides shared
by the three stages; ``query_correlation_volume`` hands it the
channel-first layout ``F.grid_sample`` produces, as views without a copy.

``volume_fusion`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises; where an input needs a gradient
it does so inside an autograd Function whose backward differentiates the
plain version (the JAX ``_vf_bwd`` pattern). ``volume_fusion.launches``
counts kernel launches.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from . import cuda_build

EPS = 1e-8  # fusion denominator
_KERNEL_STAGES = 3
_KERNEL_FEATURES = 8
# the largest view count compiled in (csrc/volume_fusion.cu kMaxViews);
# the kernel takes any count, above it with a runtime loop over views
_KERNEL_COMPILED_VIEWS = 11


def volume_fusion_reference(fws: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch forward, mirroring the JAX ``volume_fusion_reference``:
    per-stage (NV, ..., F + 1) feat||weight samples -> (..., S F)."""
    feats = torch.cat([fw[..., :-1] for fw in fws], dim=-1)
    weight_sum = 0.0
    for fw in fws:
        weight_sum = weight_sum + fw[..., -1:]
    g = torch.sum(feats * weight_sum, dim=0)
    w_all = torch.sum(weight_sum, dim=0)
    return g / (w_all + EPS)


@functools.lru_cache(maxsize=1)
def _extension():
    """The kernel extension, its layout checked once per process."""
    ext = cuda_build.extension()
    if (ext.volume_fusion_stages(), ext.volume_fusion_features(),
            ext.volume_fusion_max_views()) != (_KERNEL_STAGES, _KERNEL_FEATURES,
                                               _KERNEL_COMPILED_VIEWS):
        raise ValueError("volume_fusion layout does not match the kernel")
    return ext


def _launch(fws: Sequence[torch.Tensor]) -> torch.Tensor:
    shapes = {tuple(fw.shape) for fw in fws}
    nv, n, f1 = fws[0].shape
    if (len(fws) != _KERNEL_STAGES or len(shapes) != 1 or f1 != _KERNEL_FEATURES + 1
            or nv < 1):
        raise ValueError(f"volume_fusion kernel takes {_KERNEL_STAGES} stages "
                         f"of one shape (NV, P, {_KERNEL_FEATURES + 1}) with NV >= 1, "
                         f"got {[tuple(fw.shape) for fw in fws]}")
    dev = fws[0].device
    cuda_build.check_tensors("volume_fusion", fws)
    if len({fw.stride() for fw in fws}) != 1:
        fws = [fw.contiguous() for fw in fws]
    ext = _extension()
    # a new allocation: on a 16-byte boundary, as the kernel's stores need
    out = torch.empty(n, _KERNEL_STAGES * _KERNEL_FEATURES, device=dev,
                      dtype=torch.float32)
    with torch.cuda.device(dev):
        ext.volume_fusion(*fws, out)
    volume_fusion.launches += 1
    return out


# _volume_fusion_fn(None, *fws): CUDA kernel forward, backward through the
# plain version
_volume_fusion_fn = cuda_build.kernel_function(
    lambda _, *fws: _launch(fws), lambda _, *fws: volume_fusion_reference(fws))


def volume_fusion(*fws: torch.Tensor) -> torch.Tensor:
    """Cross-view volume fusion: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Per-stage (NV, P, F + 1) -> (P, S F)."""
    if not fws[0].is_cuda:
        return volume_fusion_reference(fws)
    if torch.is_grad_enabled() and any(fw.requires_grad for fw in fws):
        return _volume_fusion_fn(None, *fws)
    return _launch(fws)


volume_fusion.launches = 0
