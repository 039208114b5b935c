"""Fused along-ray SRDF head: CUDA kernel, its plain PyTorch version, and
the wrapper that picks between them.

Replaces the Pallas TPU kernel the JAX package's ``ops/fused_ray_head.py``
``ray_head_fused``: over each ray's (SN, 88) z-sorted tokens, one LoFTR
linear-attention layer across the samples, then the density MLP
88 -> 32 -> 16 -> 1. The kernel is ``csrc/ray_head.cu``.

Bound on the H100: FP32 arithmetic (~8.3e4 FMAs per sample against 356
bytes, exact f32). Design: one 512-thread block per ray keeps its SN x 88
tokens, the SN x 176 hidden layer and the per-ray linear-attention state
(8 heads x 11 x 11 key-value sums, taken in kv order so nothing SN x SN
exists) in shared memory, and reads the ~81k weights through the
read-only cache.

``ray_head`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises, inside an autograd Function
whose backward differentiates the plain version (the JAX ``_rh_bwd``
pattern). ``ray_head.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

EPS = 1e-6      # linear attention denominator
LN_EPS = 1e-6   # flax LayerNorm epsilon
_KERNEL_C = 88
_KERNEL_HEADS = 8


class RayHeadParams(NamedTuple):
    """Weights of the along-ray stage, f32, ``nn.Linear`` orientation."""

    wq: torch.Tensor              # (C, C)
    wk: torch.Tensor
    wv: torch.Tensor
    wmerge: torch.Tensor
    norm1_scale: torch.Tensor     # (C,)
    norm1_bias: torch.Tensor
    w1: torch.Tensor              # (2C, 2C)
    w2: torch.Tensor              # (C, 2C)
    norm2_scale: torch.Tensor
    norm2_bias: torch.Tensor
    dens_w: Tuple[torch.Tensor, ...]  # (32, C), (16, 32), (1, 16)
    dens_b: Tuple[torch.Tensor, ...]  # (32,), (16,), (1,)


def _flat_params(p: RayHeadParams):
    return [*p[:10], *p.dens_w, *p.dens_b]


def _unflat_params(ts) -> RayHeadParams:
    ts = list(ts)
    return RayHeadParams(*ts[:10], dens_w=tuple(ts[10:13]),
                         dens_b=tuple(ts[13:16]))


def ray_head_reference(y: torch.Tensor, p: RayHeadParams,
                       n_heads: int = 8) -> torch.Tensor:
    """Plain PyTorch forward, mirroring the JAX ``ray_head_reference``:
    y (RN, SN, C) -> srdf (RN, SN)."""
    rn, sn, c = y.shape
    dk = c // n_heads
    qf = (F.elu(F.linear(y, p.wq)) + 1.0).view(rn, sn, n_heads, dk)
    kf = (F.elu(F.linear(y, p.wk)) + 1.0).view(rn, sn, n_heads, dk)
    vh = F.linear(y, p.wv).view(rn, sn, n_heads, dk)
    kv = torch.einsum("bshd,bshm->bhmd", kf, vh)
    den = torch.einsum("blhd,bhd->blh", qf, kf.sum(dim=1)) + EPS
    att = torch.einsum("blhd,bhmd->blhm", qf, kv) / den[..., None]
    msg = F.layer_norm(F.linear(att.reshape(rn, sn, c), p.wmerge), (c,),
                       p.norm1_scale, p.norm1_bias, LN_EPS)
    m2 = F.linear(F.relu(F.linear(torch.cat([y, msg], -1), p.w1)), p.w2)
    out = y + F.layer_norm(m2, (c,), p.norm2_scale, p.norm2_bias, LN_EPS)
    d = F.relu(F.linear(out, p.dens_w[0], p.dens_b[0]))
    d = F.relu(F.linear(d, p.dens_w[1], p.dens_b[1]))
    return F.linear(d, p.dens_w[2], p.dens_b[2])[..., 0]


def pack_weights(p: RayHeadParams) -> torch.Tensor:
    """Flatten the weights in ``csrc/ray_head.cu``'s order, matrices in
    (in, out) orientation."""
    parts = [p.wq.t(), p.wk.t(), p.wv.t(), p.wmerge.t(), p.norm1_scale,
             p.norm1_bias, p.w1.t(), p.w2.t(), p.norm2_scale, p.norm2_bias]
    for w, b in zip(p.dens_w, p.dens_b):
        parts += [w.t(), b]
    return torch.cat([t.detach().float().reshape(-1) for t in parts])


def _launch(y: torch.Tensor, p: RayHeadParams, n_heads: int) -> torch.Tensor:
    rn, sn, c = y.shape
    if c != _KERNEL_C or n_heads != _KERNEL_HEADS or sn % 4:
        raise ValueError(f"ray_head kernel takes C={_KERNEL_C}, "
                         f"{_KERNEL_HEADS} heads and SN % 4 == 0, got C={c}, "
                         f"{n_heads} heads, SN={sn}")
    dev = y.device
    for t in [y] + _flat_params(p):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("ray_head kernel takes float32 tensors on one "
                             f"CUDA device, got {t.dtype} on {t.device}")
    ext = cuda_build.extension()
    smem = ext.ray_head_smem_bytes(sn)
    # Hopper's opt-in limit where this torch does not report it
    limit = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", 232448)
    if smem > limit:
        raise ValueError(f"ray_head kernel: SN={sn} needs {smem} bytes of "
                         f"shared memory, the card allows {limit}")
    w = pack_weights(p)
    if w.numel() != ext.ray_head_weight_count():
        raise ValueError("ray_head weight pack does not match the kernel")
    y = y.contiguous()
    srdf = torch.empty(rn, sn, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        ext.ray_head(y, w, srdf)
    ray_head.launches += 1
    return srdf


class _RayHeadFn(torch.autograd.Function):
    """CUDA kernel forward; backward through the plain version."""

    @staticmethod
    def forward(ctx, n_heads, y, *params):
        ctx.n_heads = n_heads
        ctx.save_for_backward(y, *params)
        return _launch(y, _unflat_params(params), n_heads)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(t.requires_grad) for t in saved]
            srdf = ray_head_reference(xs[0], _unflat_params(xs[1:]), ctx.n_heads)
            need = [x for x in xs if x.requires_grad]
            grads = iter(torch.autograd.grad(srdf, need, g, allow_unused=True))
        return (None, *[next(grads) if x.requires_grad else None for x in xs])


def ray_head(y: torch.Tensor, p: RayHeadParams, n_heads: int = 8) -> torch.Tensor:
    """Along-ray SRDF head: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. y (RN, SN, C) -> srdf (RN, SN)."""
    if not y.is_cuda:
        return ray_head_reference(y, p, n_heads)
    return _RayHeadFn.apply(n_heads, y, *_flat_params(p))


ray_head.launches = 0
