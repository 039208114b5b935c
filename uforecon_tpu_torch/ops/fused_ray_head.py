"""Fused along-ray SRDF head: CUDA kernel, its plain PyTorch version, and
the wrapper that picks between them.

Replaces the Pallas TPU kernel the JAX package's ``ops/fused_ray_head.py``
``ray_head_fused``: over each ray's (SN, C) z-sorted tokens, one LoFTR
linear-attention layer across the samples, then the density MLP
C -> 32 -> 16 -> 1. The kernel is ``csrc/ray_head.cu`` (in ``fast`` at
token widths 88 and 72 ``csrc/ray_head_fast.cuh``, below); like the JAX
kernel it takes any token width C (here a multiple of 8 up to 112: every
width a JAX flag set gives, 40 .. 112) and any sample count SN >= 1.

Bound on the H100: arithmetic (~8.3e4 multiply-adds per sample against
356 bytes at C = 88). Design: one 512-thread block per ray. The samples
meet only in the per-ray linear-attention state (8 heads x C/8 x C/8
key-value sums and the key sums, taken in kv order so nothing SN x SN
exists, summed over the real samples only), so the kernel takes the ray
in tiles of samples: phase 1 sums the state tile by tile, phase 2 runs
the rest of the layer and the density MLP tile by tile. A ray that fits
one tile in shared memory stays resident (its tokens read once); a longer
one streams tiles of 128 .. 16 rows (``tile_rows``). The q/k/v/merge,
mlp1 and mlp2 layers run on the tensor cores in 3xTF32
(``csrc/tc_gemm.cuh``), their weight planes streamed through a cp.async
ring; the density MLP, the LayerNorms and the attention stay FP32 on the
CUDA cores.

``precision`` is the resolved ``Config.kernel_precision``. ``highest`` and
``high`` run the kernel described above and an FP32 plain version;
``fast`` the JAX package's single bf16 pass at its ``kernel_dot`` sites
(``uforecon_tpu/ops/fused_ray_head.py:85-87,108-126``): the layer products
(q/k/v, merge, mlp1, mlp2 and the density MLP) and the linear-attention
sums kv = sum_s phi(k_s) v_s^T, num = phi(q) kv and den = phi(q) ksum,
each with both operands rounded to bf16 (round to nearest even) and the
products summed in FP32; ksum itself is an FP32 sum. In ``fast`` the
widths of ``FAST_WIDTHS`` (88, the default model; 72, without explicit
similarity) run ``csrc/ray_head_fast.cuh``, ``csrc/ray_head.cu``'s bf16
instantiation redesigned with the same outputs bit for bit: persistent
blocks of two groups of four warps, each group on its own ray; every bf16
weight resident in shared memory (``fast_image``, one TMA bulk load a
block); a warp's 16 samples kept in registers through the layers (q, k,
v, merge, mlp1, mlp2 as bf16 ``mma.m16n8k16``, each product's
accumulators the next one's operands); the state, the attention, the
LayerNorms and the density MLP with ``ray_head.cu``'s FP32 sums. Every
other width runs that instantiation itself (``takes_fast_kernel``). The
state and the attention sum as the plain version does on the CPU (sample
and feature order); the layers (on the tensor cores), ksum, the LayerNorms
and the density MLP in other orders, so now and then an intermediate's
bf16 rounding lands on the other side, the flips the card's checks allow
for (``chip_smoke.py`` FAST_SHARE). The NeuS epilogue does not depend on the
precision, as in JAX. The backward differentiates the FP32 plain version
in every precision.

The weight pack (``pack_weights``: the tensor-core matrices as TF32 hi and
lo planes, or in ``fast`` the fast kernel's ``fast_image`` at its widths
and elsewhere ``plane_pack``'s bf16 values and a zero plane with the
density MLP's weights bf16-rounded) is built once per set of weights and
precision (``cached_pack_weights``) and shared by ``ray_head`` and
``ray_head_neus``; ``ray_head.pack_builds`` counts the builds of both.

``ray_head_neus`` is the same kernel with NeuS compositing in its epilogue
(the JAX ``ray_head_neus_fused``): it also returns the weights and each
ray's rgb, depth and opacity, as ``ops/rendering.neus_render`` does.

``ray_head`` and ``ray_head_neus`` take the plain version for CPU tensors
only. For CUDA tensors they launch the kernel or raise, inside an autograd
Function whose backward differentiates the plain version (the JAX
``_rh_bwd`` / ``_rhn_bwd`` pattern). ``ray_head.launches`` and
``ray_head_neus.launches`` count the launches of the 3xTF32 kernel,
``.launches_fast`` those in ``fast`` (of ``csrc/ray_head_fast.cuh`` at
``FAST_WIDTHS``, else of ``csrc/ray_head.cu``'s bf16 instantiation).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .rendering import neus_render

EPS = 1e-6      # linear attention denominator
LN_EPS = 1e-6   # flax LayerNorm epsilon
_KERNEL_C_MAX = 112   # token widths: multiples of 8 up to this
_KERNEL_HEADS = 8
# the token widths of the fast kernel (csrc/ray_head_fast.cuh): in ``fast``
# these take it, every other width ray_head.cu's bf16 instantiation
FAST_WIDTHS = (88, 72)


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


def _phi(x: torch.Tensor) -> torch.Tensor:
    """elu(x) + 1 as the kernel computes it, x + 1 or exp(x) (the JAX
    kernel's form too): elu(x) + 1 takes exp(x) - 1 + 1, which rounds away
    the low bits of a small exp(x), and in ``fast`` a bf16 rounding of the
    result then lands on the other side now and then (1.3e-5 of values)."""
    return torch.where(x > 0, x + 1.0, torch.exp(torch.clamp(x, max=0.0)))


def ray_head_reference(y: torch.Tensor, p: RayHeadParams, n_heads: int = 8,
                       precision: str = "high", linear=None) -> torch.Tensor:
    """Plain PyTorch forward, mirroring the JAX ``ray_head_reference`` in
    FP32, or in ``fast`` the JAX kernel's ``fast`` products: y (RN, SN, C)
    -> srdf (RN, SN). ``linear(x, w)``, if given, computes the layers the
    kernel runs on the tensor cores (q/k/v/merge, mlp1, mlp2); the tests
    pass an emulation of its 3xTF32 product."""
    rn, sn, c = y.shape
    dk = c // n_heads
    dense = cuda_build.kernel_linear(precision)
    linear = linear or dense
    r = cuda_build.operand_round(precision)      # the attention sums' operands
    qf = _phi(linear(y, p.wq)).view(rn, sn, n_heads, dk)
    kf = _phi(linear(y, p.wk)).view(rn, sn, n_heads, dk)
    vh = linear(y, p.wv).view(rn, sn, n_heads, dk)
    kv = torch.einsum("bshd,bshm->bhmd", r(kf), r(vh))
    den = torch.einsum("blhd,bhd->blh", r(qf), r(kf.sum(dim=1))) + EPS
    att = torch.einsum("blhd,bhmd->blhm", r(qf), r(kv)) / den[..., None]
    msg = F.layer_norm(linear(att.reshape(rn, sn, c), p.wmerge), (c,),
                       p.norm1_scale, p.norm1_bias, LN_EPS)
    m2 = linear(F.relu(linear(torch.cat([y, msg], -1), p.w1)), p.w2)
    out = y + F.layer_norm(m2, (c,), p.norm2_scale, p.norm2_bias, LN_EPS)
    d = F.relu(dense(out, p.dens_w[0], p.dens_b[0]))
    d = F.relu(dense(d, p.dens_w[1], p.dens_b[1]))
    return dense(d, p.dens_w[2], p.dens_b[2])[..., 0]


def pack_weights(p: RayHeadParams, precision: str = "high") -> torch.Tensor:
    """The weights as the kernel at ``precision`` and this width reads
    them: in ``fast`` at a width of ``FAST_WIDTHS`` the fast kernel's
    ``fast_image``; otherwise flattened in ``csrc/ray_head.cu``'s order,
    matrices in (in, out) orientation, the tensor-core matrices (q, k, v,
    merge, mlp1, mlp2) as their TF32 hi plane, then lo plane, or in
    ``fast`` as their bf16 values and a zero plane, and the density MLP's
    weights bf16-rounded."""
    if cuda_build.is_fast(precision) and p.wq.shape[0] in FAST_WIDTHS:
        return fast_image(p)
    return plane_pack(p, precision)


def plane_pack(p: RayHeadParams, precision: str = "high") -> torch.Tensor:
    """``csrc/ray_head.cu``'s pack at ``precision`` (``pack_weights`` at
    every width but ``FAST_WIDTHS`` in ``fast``)."""
    tc = cuda_build.bf16_planes if cuda_build.is_fast(precision) else cuda_build.tf32_planes
    small = cuda_build.operand_round(precision)
    parts = [tc(p.wq.t()), tc(p.wk.t()), tc(p.wv.t()), tc(p.wmerge.t()),
             p.norm1_scale, p.norm1_bias, tc(p.w1.t()), tc(p.w2.t()),
             p.norm2_scale, p.norm2_bias]
    for w, b in zip(p.dens_w, p.dens_b):
        parts += [small(w.t().detach().float()), b]
    return torch.cat([t.detach().float().reshape(-1) for t in parts])


def fast_image(p: RayHeadParams) -> torch.Tensor:
    """The fast kernel's weight pack (``csrc/ray_head_fast.cuh`` ``Img``)
    as float32 words, the image a block copies into shared memory: wq, wk,
    wv, wmerge, w1, w2 and the density MLP's first two weights rounded to
    bf16, each as its torch (out, in) rows ``cuda_build.image_stride(in)``
    elements apart; then in float32 the LayerNorms' scales and biases, the
    density MLP's first two biases, its last layer's 16 weights rounded to
    bf16 and its bias, padded to 4 floats."""
    rows = []
    for w in (p.wq, p.wk, p.wv, p.wmerge, p.w1, p.w2, *p.dens_w[:2]):
        w = cuda_build.bf16_round(w.detach().float())
        rows.append(F.pad(w, (0, cuda_build.image_stride(w.shape[1]) - w.shape[1])).reshape(-1))
    bf16 = torch.cat(rows).to(torch.bfloat16)
    f32 = [p.norm1_scale, p.norm1_bias, p.norm2_scale, p.norm2_bias, p.dens_b[0],
           p.dens_b[1], cuda_build.bf16_round(p.dens_w[2].detach().float()), p.dens_b[2]]
    f32 = torch.cat([t.detach().float().reshape(-1) for t in f32])
    return torch.cat([bf16.view(torch.float32), f32, f32.new_zeros(-f32.numel() % 4)])


_packs = cuda_build.PackCache()


def cached_pack_weights(p: RayHeadParams, precision: str = "high") -> torch.Tensor:
    """``pack_weights(p, precision)``, built once per set of weights and
    precision (``cuda_build.PackCache``); ``ray_head.pack_builds`` counts
    builds."""
    pack, built = _packs.get(_flat_params(p), lambda: pack_weights(p, precision),
                             precision)
    ray_head.pack_builds += built
    return pack


@functools.lru_cache(maxsize=None)
def _smem_limit(dev: torch.device) -> int:
    """Shared memory a block may opt into on ``dev`` (Hopper's 232,448
    where this torch does not report it)."""
    return getattr(torch.cuda.get_device_properties(dev),
                   "shared_memory_per_block_optin", 232448)


def _prepare(y: torch.Tensor, p: RayHeadParams, n_heads: int, precision: str,
             *extra: torch.Tensor, neus: bool = False):
    """Checks what the kernel takes; returns the extension and the weight
    pack."""
    rn, sn, c = y.shape
    if c % 8 or not 0 < c <= _KERNEL_C_MAX or n_heads != _KERNEL_HEADS or sn < 1:
        raise ValueError(f"ray_head kernel takes C in 8..{_KERNEL_C_MAX} with C % 8 "
                         f"== 0, {_KERNEL_HEADS} heads and SN >= 1, got C={c}, "
                         f"{n_heads} heads, SN={sn}")
    dev = y.device
    for t in [y, *extra] + _flat_params(p):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("ray_head kernel takes float32 tensors on one "
                             f"CUDA device, got {t.dtype} on {t.device}")
    ext = cuda_build.extension()
    w = cached_pack_weights(p, precision)
    if takes_fast_kernel(c, precision):
        n_w = ext.ray_head_fast_pack_bytes(c) // 4
    else:
        limit = _smem_limit(dev)
        if ext.ray_head_smem_bytes(sn, c, neus, limit) < 0:
            raise ValueError(f"ray_head kernel: no tile fits the card's {limit} bytes "
                             f"of shared memory at C={c}, SN={sn}")
        n_w = ext.ray_head_weight_count(c)
    if w.numel() != n_w:
        raise ValueError("ray_head weight pack does not match the kernel")
    return ext, w


def takes_fast_kernel(c: int, precision: str) -> bool:
    """Does a ray head of width ``c`` at ``precision`` run the fast kernel
    (``csrc/ray_head_fast.cuh``)? Else ``csrc/ray_head.cu``."""
    return cuda_build.is_fast(precision) and c in FAST_WIDTHS


def tile_rows(sn: int, c: int, neus: bool = False, device=None) -> int:
    """Rows of the kernel's sample tiles for a ray of ``sn`` samples at
    width ``c`` on ``device``'s card: the whole ray rounded up to 16
    (resident) where it fits, else 128, 64, 32 or 16 (streamed)."""
    dev = torch.device(device or "cuda")
    return cuda_build.extension().ray_head_tile_rows(sn, c, neus, _smem_limit(dev))


def _launch(y: torch.Tensor, p: RayHeadParams, n_heads: int = 8,
            precision: str = "high") -> torch.Tensor:
    ext, w = _prepare(y, p, n_heads, precision)
    rn, sn, c = y.shape
    y = cuda_build.aligned(y)
    srdf = torch.empty(rn, sn, device=y.device, dtype=torch.float32)
    fast = cuda_build.is_fast(precision)
    with torch.cuda.device(y.device):
        if takes_fast_kernel(c, precision):
            ext.ray_head_fast(y, w, srdf)
        else:
            ext.ray_head(y, w, srdf, fast)
    cuda_build.count_launch(ray_head, fast)
    return srdf


# _ray_head_fn((n_heads, precision), y, *params): CUDA kernel forward,
# backward through the FP32 plain version
_ray_head_fn = cuda_build.kernel_function(
    lambda st, y, *ps: _launch(y, _unflat_params(ps), *st),
    lambda st, y, *ps: ray_head_reference(y, _unflat_params(ps), st[0]))


def ray_head(y: torch.Tensor, p: RayHeadParams, n_heads: int = 8,
             precision: str = "high") -> torch.Tensor:
    """Along-ray SRDF head at a resolved kernel precision: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. y (RN, SN, C) ->
    srdf (RN, SN)."""
    if not y.is_cuda:
        return ray_head_reference(y, p, n_heads, precision)
    return _ray_head_fn((n_heads, precision), y, *_flat_params(p))


ray_head.launches = 0
ray_head.launches_fast = 0
ray_head.pack_builds = 0


# ---------------------------------------------------------------------------
# The ray head with NeuS compositing in its epilogue (the JAX
# ``ray_head_neus_fused``): the same kernel, templated, composites each ray
# from its srdf in shared memory, in place of the elementwise and scan
# launches of ``neus_render``.


def ray_head_neus_reference(y: torch.Tensor, z: torch.Tensor, rad: torch.Tensor,
                            inv_s: torch.Tensor, p: RayHeadParams,
                            n_heads: int = 8, precision: str = "high"):
    """Plain PyTorch forward, mirroring the JAX ``ray_head_neus_reference``:
    ``ray_head_reference`` followed by ``ops/rendering.neus_render``.
    y (RN, SN, C), z (RN, SN), rad (RN, SN, 3), inv_s () -> srdf (RN, SN),
    weight (RN, SN), rgb (RN, 3), depth (RN,), opacity (RN,)."""
    srdf = ray_head_reference(y, p, n_heads, precision)
    out = neus_render(z, rad, srdf, inv_s)
    return srdf, out["weight"], out["rgb"], out["depth"], out["opacity"]


def _launch_neus(y, z, rad, inv_s, p: RayHeadParams, n_heads: int = 8,
                 precision: str = "high"):
    rn, sn, _ = y.shape
    if tuple(z.shape) != (rn, sn) or tuple(rad.shape) != (rn, sn, 3) \
            or inv_s.numel() != 1:
        raise ValueError(f"ray_head_neus kernel takes z (RN, SN), rad (RN, SN, 3) "
                         f"and a scalar inv_s for y (RN, SN, C) = "
                         f"{tuple(y.shape)}, got {tuple(z.shape)}, "
                         f"{tuple(rad.shape)}, {tuple(inv_s.shape)}")
    ext, w = _prepare(y, p, n_heads, precision, z, rad, inv_s, neus=True)
    dev = y.device
    outs = [torch.empty(shape, device=dev, dtype=torch.float32)
            for shape in ((rn, sn), (rn, sn), (rn, 3), (rn,), (rn,))]
    fast = cuda_build.is_fast(precision)
    args = (cuda_build.aligned(y), w, z.contiguous(), rad.contiguous(), inv_s.contiguous(),
            *outs)
    with torch.cuda.device(dev):
        if takes_fast_kernel(y.shape[2], precision):
            ext.ray_head_neus_fast(*args)
        else:
            ext.ray_head_neus(*args, fast)
    cuda_build.count_launch(ray_head_neus, fast)
    if sn == 1:   # neus_render's weights have no interval to live on
        outs[1] = outs[1][:, :0]
    return tuple(outs)


# _ray_head_neus_fn((n_heads, precision), y, z, rad, inv_s, *params): CUDA
# kernel forward, backward through the FP32 plain version
_ray_head_neus_fn = cuda_build.kernel_function(
    lambda st, y, z, rad, inv_s, *ps: _launch_neus(
        y, z, rad, inv_s, _unflat_params(ps), *st),
    lambda st, y, z, rad, inv_s, *ps: ray_head_neus_reference(
        y, z, rad, inv_s, _unflat_params(ps), st[0]))


def ray_head_neus(y: torch.Tensor, z: torch.Tensor, rad: torch.Tensor,
                  inv_s: torch.Tensor, p: RayHeadParams, n_heads: int = 8,
                  precision: str = "high"):
    """Along-ray SRDF head + NeuS compositing at a resolved kernel
    precision: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Returns (srdf, weight, rgb, depth, opacity)."""
    if not y.is_cuda:
        return ray_head_neus_reference(y, z, rad, inv_s, p, n_heads, precision)
    return _ray_head_neus_fn((n_heads, precision), y, z, rad, inv_s, *_flat_params(p))


ray_head_neus.launches = 0
ray_head_neus.launches_fast = 0
