"""Fused per-point view head: CUDA kernel, its plain PyTorch version, and
the wrapper that picks between them.

Replaces the Pallas TPU kernel the JAX package's ``ops/fused_point_head.py``
``point_head_fused``. Per sample point it runs the pre-similarity MLP, the
in-kernel NeRF PE of the depth distance, one LoFTR linear-attention layer
over the view token and the NV view tokens, and the masked radiance
softmax. The kernel is ``csrc/point_head.cu``.

Bound on the H100: arithmetic. A point costs ~2.6e5 multiply-adds
against ~1 KB in and out (~500 FLOP per byte). Design: the q/k/v/merge,
mlp1 and mlp2 layers run on the tensor cores in 3xTF32
(``csrc/tc_gemm.cuh``: each operand split into a TF32 hi and lo part,
three products summed in FP32), accurate to a few FP32 roundings; a
320-thread block keeps the activations of 16 points (16 x (NV + 1) token
rows; from 9 views on, 144 / (NV + 1) points, the most shared memory
holds) in shared memory through the whole layer chain and streams the
weight planes through a cp.async ring. The small MLPs, the LayerNorms,
the attention and the softmax stay FP32 on the CUDA cores. It is built
for 2..11 views (``KERNEL_COMPILED_VIEWS``; DTU's evaluation set 1 has
11). Any count past them, as the JAX kernel takes, goes to
``csrc/point_head_stream.cu`` in both precisions: the token rows streamed
through shared memory in two passes, keys and values in a global scratch
the wrapper allocates (``point_head_scratch_floats``).

``precision`` is the resolved ``Config.kernel_precision``. ``highest`` and
``high`` run the kernel described above and an FP32 plain version.
``fast`` runs the JAX package's single bf16 pass at its ``kernel_dot``
sites (``uforecon_tpu/ops/fused_point_head.py:138-143``: the pre-
similarity MLP, q/k/v, merge, mlp1, mlp2 and the radiance MLP): both
operands of each product rounded to bf16 (round to nearest even), the
products summed in FP32. Its kernel keeps every bf16 weight resident in
shared memory (``fast_image``), loaded once per persistent block: up to 5
views (``csrc/point_head_fast.cuh``) tiles of 32 token rows, two a block
on eight warps each, the layers and both small MLPs as bf16
``mma.m16n8k16``; from 6 views on (``csrc/point_head_fast_views.cu``) one
tile of 64 rows on sixteen warps, the same bf16 operands summed by FP32
FMAs, k in order (the sums of the plain version on the CPU, bit for
bit), in register-blocked products; the plain version rounds at
the same sites
(``cuda_build.kernel_linear``). The attention and the softmax stay FP32
in every precision, as in JAX, and elu + 1 is x + 1 or exp(x) in both,
as in the JAX kernel and reference. The backward differentiates the
FP32 plain version in every precision, as JAX's reference VJP does.

The weight pack (``pack_weights``: the tensor-core matrices as TF32 hi and
lo planes; in ``fast`` the fast kernel's ``fast_image``, or past the
compiled-in counts, for the streamed kernel, the planes' layout with bf16
values and a zero lo plane and the small MLPs' weights bf16-rounded) is
built once per set of weights, precision and layout and reused
(``cached_pack_weights``; ``point_head.pack_builds`` counts the builds).

The kernel is built for the correlation volume's 24 features (tokens of
80, heads of 10) and the feature grid's 16 (tokens of 72, heads of 9):
the JAX gate sends both to it (``KERNEL_VOL_WIDTHS``).

Layouts are point-major, what ``F.grid_sample`` gives once permuted:
inputs (NV, P, C) / (P, C), outputs token (P, C) and radiance (P, 3). The
JAX module is feature-major; the tests transpose.

``point_head`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises, inside an autograd Function
whose backward differentiates the plain version (the JAX ``_ph_bwd``
pattern). ``point_head.launches`` counts the launches of the 3xTF32
kernel, ``point_head.launches_fast`` those of the ``fast`` kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .fused_ray_head import _phi
from .posenc import nerf_posenc

EPS = 1e-6      # linear attention denominator
LN_EPS = 1e-6   # flax LayerNorm epsilon
# the kernels' volume widths: the correlation volume's 24 features, the
# feature grid's 16 (tokens of 80 and 72)
KERNEL_VOL_WIDTHS = (24, 16)
# the largest view count the point-head kernels are compiled for
# (csrc/point_head*.cuh kMaxViews); any larger count runs their streamed
# kernels (csrc/point_head*_stream.cu)
KERNEL_COMPILED_VIEWS = 11


def kernel_dims(c_vol: int) -> dict:
    """The widths the point-head kernels take at volume width ``c_vol``:
    tokens of img 32 | vol | sim16 16 | depth PE 8, 8 heads."""
    return dict(c=32 + c_vol + 16 + 8, c_img=32, c_vol=c_vol, c_sim=8, n_heads=8)


class PointHeadParams(NamedTuple):
    """Weights of the per-point stage, f32, torch ``nn.Linear`` orientation
    (out, in)."""

    view_token: torch.Tensor     # (C,)
    wq: torch.Tensor             # (C, C)
    wk: torch.Tensor
    wv: torch.Tensor
    wmerge: torch.Tensor
    norm1_scale: torch.Tensor    # (C,)
    norm1_bias: torch.Tensor
    w1: torch.Tensor             # (2C, 2C)
    w2: torch.Tensor             # (C, 2C)
    norm2_scale: torch.Tensor
    norm2_bias: torch.Tensor
    sim_w: Tuple[torch.Tensor, ...]   # (32, 8), (32, 32), (16, 32)
    sim_b: Tuple[torch.Tensor, ...]   # (32,), (32,), (16,)
    rad_w: Tuple[torch.Tensor, ...]   # (16, C+3), (8, 16), (1, 8)
    rad_b: Tuple[torch.Tensor, ...]


class PointHeadInputs(NamedTuple):
    """Per-chunk point tensors, point-major."""

    img_feat: torch.Tensor    # (NV, P, C_img)
    vol_feat: torch.Tensor    # (P, C_vol)
    sim_feat: torch.Tensor    # (P, 8) raw cosine groups
    depth_dist: torch.Tensor  # (NV, P) sampled MVS depth minus point cam-z
    dir_rel: torch.Tensor     # (NV, P, 3)
    rgb: torch.Tensor         # (NV, P, 3)
    mask: torch.Tensor        # (NV, P)


def _flat_params(p: PointHeadParams):
    return [p.view_token, p.wq, p.wk, p.wv, p.wmerge, p.norm1_scale,
            p.norm1_bias, p.w1, p.w2, p.norm2_scale, p.norm2_bias,
            *p.sim_w, *p.sim_b, *p.rad_w, *p.rad_b]


def _unflat_params(ts) -> PointHeadParams:
    ts = list(ts)
    return PointHeadParams(*ts[:11], sim_w=tuple(ts[11:14]),
                           sim_b=tuple(ts[14:17]), rad_w=tuple(ts[17:20]),
                           rad_b=tuple(ts[20:23]))


def point_head_reference(inp: PointHeadInputs, p: PointHeadParams,
                         n_heads: int = 8, precision: str = "high", linear=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward, mirroring the JAX ``point_head_reference`` in
    FP32, or in ``fast`` the JAX kernel's ``fast`` products. ``linear(x,
    w)``, if given, computes the layers the kernel runs on the tensor cores
    (q/k/v/merge, mlp1, mlp2); the tests pass an emulation of its 3xTF32
    product. Returns (token (P, C), radiance (P, 3))."""
    nv, n, _ = inp.img_feat.shape
    c = p.view_token.numel()
    dk = c // n_heads
    dense = cuda_build.kernel_linear(precision)
    linear = linear or dense

    s = F.relu(dense(inp.sim_feat, p.sim_w[0], p.sim_b[0]))
    s = F.relu(dense(s, p.sim_w[1], p.sim_b[1]))
    sim16 = dense(s, p.sim_w[2], p.sim_b[2])                      # (P, 16)

    pe = nerf_posenc(inp.depth_dist[..., None], num_freqs=4)       # (NV, P, 8)

    views = torch.cat([inp.img_feat,
                       inp.vol_feat.expand(nv, n, -1),
                       sim16.expand(nv, n, -1), pe], dim=-1)
    x = torch.cat([p.view_token.reshape(1, 1, c).expand(1, n, c), views], 0)
    l_ = nv + 1

    q = _phi(linear(x, p.wq)).view(l_, n, n_heads, dk)
    k = _phi(linear(x, p.wk)).view(l_, n, n_heads, dk)
    v = linear(x, p.wv).view(l_, n, n_heads, dk)
    sc = torch.einsum("lphd,sphd->lsph", q, k)
    den = sc.sum(dim=1) + EPS                                      # (L, P, H)
    att = torch.einsum("lsph,sphd->lphd", sc, v) / den[..., None]
    msg = F.layer_norm(linear(att.reshape(l_, n, c), p.wmerge), (c,),
                       p.norm1_scale, p.norm1_bias, LN_EPS)
    y = linear(F.relu(linear(torch.cat([x, msg], -1), p.w1)), p.w2)
    out = x + F.layer_norm(y, (c,), p.norm2_scale, p.norm2_bias, LN_EPS)

    z = torch.cat([out[1:], inp.dir_rel], dim=-1)                  # (NV, P, C+3)
    z = F.relu(dense(z, p.rad_w[0], p.rad_b[0]))
    z = F.relu(dense(z, p.rad_w[1], p.rad_b[1]))
    z = dense(z, p.rad_w[2], p.rad_b[2])[..., 0]                   # (NV, P)
    z = torch.where(inp.mask == 0, torch.full_like(z, -1e9), z)
    w = torch.softmax(z, dim=0)
    rad = torch.einsum("vpc,vp->pc", inp.rgb, w)
    return out[0], rad


def pack_weights(p: PointHeadParams, precision: str = "high",
                 streamed: bool = False) -> torch.Tensor:
    """The weights as the kernel at ``precision`` reads them: in ``fast``
    the fast kernel's ``fast_image``; otherwise, and in ``fast`` with
    ``streamed`` (the streamed kernel past ``KERNEL_COMPILED_VIEWS``),
    flattened in ``csrc/point_head.cu``'s order, matrices in (in, out)
    orientation, the tensor-core matrices (q, k, v, merge, mlp1, mlp2) as
    their TF32 hi plane, then lo plane, or in ``fast`` as their bf16 values
    and a zero plane (``cuda_build.bf16_planes``), and the small MLPs'
    weights bf16-rounded."""
    fast = cuda_build.is_fast(precision)
    if fast and not streamed:
        return fast_image(p)
    tc = cuda_build.bf16_planes if fast else cuda_build.tf32_planes
    small = cuda_build.operand_round(precision)
    parts = [p.view_token, tc(p.wq.t()), tc(p.wk.t()), tc(p.wv.t()),
             tc(p.wmerge.t()), p.norm1_scale, p.norm1_bias, tc(p.w1.t()),
             tc(p.w2.t()), p.norm2_scale, p.norm2_bias]
    for w, b in zip(p.sim_w, p.sim_b):
        parts += [small(w.t().detach().float()), b]
    for w, b in zip(p.rad_w, p.rad_b):
        parts += [small(w.t().detach().float()), b]
    return torch.cat([t.detach().float().reshape(-1) for t in parts])


def fast_image(p: PointHeadParams) -> torch.Tensor:
    """The fast kernel's weight pack (``csrc/point_head_fast.cuh`` ``Img``)
    as float32 words: the image a block copies into shared memory, wq, wk,
    wv, wmerge, w1, w2 and the small MLPs' weights rounded to bf16, each as
    its torch (out, in) rows ``cuda_build.image_stride(in)`` elements apart
    (the last radiance layer's one row padded to 8 with zero rows), then in
    float32 the LayerNorms' scales and biases and the small MLPs' biases
    (the last padded to 4); after the image the view token in float32, which
    the kernel reads from global memory."""
    rows = []
    for w in (p.wq, p.wk, p.wv, p.wmerge, p.w1, p.w2, *p.sim_w, *p.rad_w):
        w = cuda_build.bf16_round(w.detach().float())
        pad_rows = max(8 - w.shape[0], 0)
        rows.append(F.pad(w, (0, cuda_build.image_stride(w.shape[1]) - w.shape[1], 0, pad_rows))
                    .reshape(-1))
    bf16 = torch.cat(rows).to(torch.bfloat16)
    f32 = [p.norm1_scale, p.norm1_bias, p.norm2_scale, p.norm2_bias, *p.sim_b, *p.rad_b]
    f32 = torch.cat([t.detach().float().reshape(-1) for t in f32])
    return torch.cat([bf16.view(torch.float32), f32, f32.new_zeros(-f32.numel() % 4),
                      p.view_token.detach().float().reshape(-1)])


_packs = cuda_build.PackCache()
_stream_packs = cuda_build.PackCache()


def cached_pack_weights(p: PointHeadParams, precision: str = "high",
                        streamed: bool = False) -> torch.Tensor:
    """``pack_weights(p, precision, streamed)``, built once per set of
    weights, precision and layout (``cuda_build.PackCache``);
    ``point_head.pack_builds`` counts builds."""
    cache = _stream_packs if streamed else _packs
    pack, built = cache.get(_flat_params(p), lambda: pack_weights(p, precision, streamed),
                            precision)
    point_head.pack_builds += built
    return pack


def _launch(inp: PointHeadInputs, p: PointHeadParams, n_heads: int = 8,
            precision: str = "high") -> Tuple[torch.Tensor, torch.Tensor]:
    nv, n, c_img = inp.img_feat.shape
    c = p.view_token.numel()
    c_vol = inp.vol_feat.shape[-1]
    dims = dict(c=c, c_img=c_img, c_vol=c_vol, c_sim=inp.sim_feat.shape[-1],
                n_heads=n_heads)
    if nv < 2:
        raise ValueError(f"point_head kernel takes 2 views or more, got {nv} views")
    if c_vol not in KERNEL_VOL_WIDTHS or dims != kernel_dims(c_vol):
        raise ValueError(f"point_head kernel takes {kernel_dims(24)} or "
                         f"{kernel_dims(16)}, got {dims}")
    dev = inp.img_feat.device
    cuda_build.check_tensors("point_head", list(inp) + _flat_params(p))
    ext = cuda_build.extension()
    ins = [cuda_build.aligned(t) for t in inp]
    streamed = nv > KERNEL_COMPILED_VIEWS
    w = cached_pack_weights(p, precision, streamed)
    fast = cuda_build.is_fast(precision)
    n_w = (ext.point_head_fast_pack_bytes(c_vol) // 4 if fast and not streamed
           else ext.point_head_weight_count(c_vol))
    if w.numel() != n_w:
        raise ValueError("point_head weight pack does not match the kernel")
    token = torch.empty(n, c, device=dev, dtype=torch.float32)
    rad = torch.empty(n, 3, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        scratch = (torch.empty(ext.point_head_scratch_floats(c_vol, nv, n), device=dev,
                               dtype=torch.float32) if streamed else cuda_build.no_scratch(dev))
        ext.point_head(*ins, w, token, rad, scratch, fast)
    cuda_build.count_launch(point_head, fast)
    return token, rad


def _split(tensors):
    return PointHeadInputs(*tensors[:7]), _unflat_params(tensors[7:])


# _point_head_fn((n_heads, precision), *inputs, *params): CUDA kernel
# forward, backward through the FP32 plain version
_point_head_fn = cuda_build.kernel_function(
    lambda st, *ts: _launch(*_split(ts), *st),
    lambda st, *ts: point_head_reference(*_split(ts), st[0]))


def point_head(inp: PointHeadInputs, p: PointHeadParams, n_heads: int = 8,
               precision: str = "high") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point view head at a resolved kernel precision: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. Returns (token
    (P, C), radiance (P, 3))."""
    if not inp.img_feat.is_cuda:
        return point_head_reference(inp, p, n_heads, precision)
    return _point_head_fn((n_heads, precision), *inp, *_flat_params(p))


point_head.launches = 0
point_head.launches_fast = 0
point_head.pack_builds = 0
