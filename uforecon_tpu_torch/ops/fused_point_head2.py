"""Split-weight per-point view head (``point_head='v2'``): CUDA kernel, its
plain PyTorch version, the host-side weight split, and the wrapper that
picks between them.

Replaces the Pallas TPU kernel of the JAX package's
``ops/fused_point_head2.py`` ``point_head2_fused``. It computes what the
point head (``ops/fused_point_head.py``) computes, on the same point-major
inputs and the same weights, by another algebra: the per-view 80-channel
token [img 32 | vol 24 | sim16 16 | pe 8] is never built. Every consumer
of a view token (q/k/v, the LoFTR mlp1 and the radiance layer 0) is split
by feature group against the raw inputs. The view-shared groups (vol and
sim16) are projected once per point rather than once per view, and the
view token's own q/k/v and mlp1 rows are constants computed here, on the
host. At the defaults (3 views) that is ~203.3k FMAs per point against the
point head's ~264.7k. The kernel is ``csrc/point_head2.cu``: its layer
GEMMs run on the tensor cores in 3xTF32 (``csrc/tc_gemm.cuh``), as the
point head's do. It is built for 2..11 views
(``KERNEL_COMPILED_VIEWS``); any count past them goes to
``csrc/point_head2_stream.cu``, which streams the view rows through shared
memory in two passes, keys and values in a global scratch the wrapper
allocates (``point_head2_scratch_floats``).

``split_weights2`` builds the split: the row slices at the feature-group
offsets 0 / 32 / 56 / 72 / 80 of wq, wk, wv, w1[:C] and rad_w[0] in (in,
out) orientation, grouped as the kernel reads them (``layout2``), plus the
constants ``tok_qkv`` and ``w1a_tok``. ``pack_weights2`` flattens it; the
matrices the kernel multiplies on the tensor cores in 3xTF32
(``TC_MATRICES``: the shared projection, the per-view q/k/v, merge, mlp1
and mlp2) go in as a TF32 hi plane, then a lo plane
(``cuda_build.tf32_planes``).

``precision`` is the resolved ``Config.kernel_precision``. In
``highest`` and ``high`` the kernel runs 3xTF32 and the plain version is
the point head's FP32 one (the same function). In ``fast`` the function
is the JAX split-weight kernel's: every ``kernel_dot`` of
``uforecon_tpu/ops/fused_point_head2.py:73-76`` with both operands rounded
to bf16 and the products summed in FP32, which is not the point head's
``fast`` function. It rounds each feature group's input (so a view token
is rounded in its parts, and the radiance layer takes the rounded token
and the rounded m2 apart, not their rounded sum), and the attention's
head sums and broadcasts are products with 0/1 matrices, so each
(token, source) score is a sum of bf16-rounded q k products that enters
the weighted sum bf16-rounded, and the denominator is bf16-rounded too
(``point_head2_fast_reference``). The view token's own q/k/v and mlp1
rows stay FP32 (the JAX wrapper's HIGHEST dots). The kernel's ``fast``
instantiation runs its tensor-core layers as one bf16 ``mma.m16n8k16``
pass on a pack of bf16 planes (the radiance bias row split into three
bf16 rows, so that it adds in FP32 as JAX's bias does), and rounds its
attention and small MLPs at the same sites.

``point_head2`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises, inside an autograd Function whose
backward differentiates the FP32 plain version (the JAX ``_ph2_bwd``
delegates to the point head's backward the same way).
``point_head2.launches`` counts the launches of the 3xTF32 kernel,
``point_head2.launches_fast`` those of the ``fast`` kernel. The split pack
is built once per set of weights and precision (``cuda_build.PackCache``);
``point_head2.pack_builds`` counts the builds.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .fused_point_head import (KERNEL_COMPILED_VIEWS, KERNEL_VOL_WIDTHS, EPS, LN_EPS,
                               PointHeadInputs, PointHeadParams, _flat_params, _split,
                               kernel_dims, point_head_reference)
from .fused_ray_head import _phi
from .posenc import nerf_posenc

PE_DIM = 8      # NeRF PE of the depth distance, 4 frequencies
# the matrices the kernel runs on the tensor cores: two planes each in the pack
TC_MATRICES = ("sh", "v_qkv", "wm", "v_w1", "w2", "v_rad")

# the inputs are point-major in the port already: the JAX module's
# PointHeadInputs2 is the point head's PointHeadInputs
PointHeadInputs2 = PointHeadInputs


def point_head2_reference(inp: PointHeadInputs, p: PointHeadParams,
                          n_heads: int = 8, precision: str = "high"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward: in FP32 the point head's reference (the JAX
    module's backward reference, point-major here already), in ``fast``
    ``point_head2_fast_reference``. Returns (token (P, C), radiance
    (P, 3))."""
    if cuda_build.is_fast(precision):
        return point_head2_fast_reference(inp, p, n_heads)
    return point_head_reference(inp, p, n_heads)


def _tok_dot(tok: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The view token times an (out, in) weight, as the JAX wrapper's
    HIGHEST-precision dots: in float64, whatever the card's TF32 setting."""
    return (w.double() @ tok.double()).float()


def point_head2_fast_reference(inp: PointHeadInputs, p: PointHeadParams,
                               n_heads: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX split-weight kernel in ``fast`` (``uforecon_tpu/ops/
    fused_point_head2.py`` ``_kernel``): each of its ``kernel_dot``
    products with both operands rounded to bf16 and summed in FP32, in
    the point head's weights. Returns (token (P, C), radiance (P, 3))."""
    r, lin = cuda_build.bf16_round, cuda_build.fast_linear
    nv, n, _ = inp.img_feat.shape
    c = p.view_token.numel()
    dk = c // n_heads
    tok = p.view_token.reshape(-1)

    s = F.relu(lin(inp.sim_feat, p.sim_w[0], p.sim_b[0]))
    s = F.relu(lin(s, p.sim_w[1], p.sim_b[1]))
    sim16 = lin(s, p.sim_w[2], p.sim_b[2])                         # (P, 16)
    pe = nerf_posenc(inp.depth_dist[..., None], num_freqs=4)       # (NV, P, 8)
    # the view rows' inputs: the products of their groups sum to one product
    views = torch.cat([inp.img_feat, inp.vol_feat.expand(nv, n, -1),
                       sim16.expand(nv, n, -1), pe], dim=-1)        # (NV, P, C)

    def tok_rows(w):                                                # (1, P, C)
        return _tok_dot(tok, w).expand(1, n, -1)

    qf = _phi(torch.cat([tok_rows(p.wq), lin(views, p.wq)]))   # (L, P, C)
    kf = _phi(torch.cat([tok_rows(p.wk), lin(views, p.wk)]))
    vv = torch.cat([tok_rows(p.wv), lin(views, p.wv)])
    l_ = nv + 1
    # score (l, s) per head: the head sum of bf16-rounded q k products
    sc = r(qf[:, None] * kf[None]).view(l_, l_, n, n_heads, dk).sum(-1)  # (L, S, P, H)
    acc = torch.einsum("lsph,sphd->lphd", r(sc), vv.view(l_, n, n_heads, dk))
    att = (acc / (r(sc.sum(dim=1))[..., None] + EPS)).reshape(l_, n, c)

    msg = F.layer_norm(lin(att, p.wmerge), (c,), p.norm1_scale, p.norm1_bias, LN_EPS)
    w1a, w1b = p.w1[:, :c], p.w1[:, c:]
    x_w1 = torch.cat([_tok_dot(tok, w1a).expand(1, n, -1), lin(views, w1a)])
    y = F.relu(x_w1 + lin(msg, w1b))
    m2 = F.layer_norm(lin(y, p.w2), (c,), p.norm2_scale, p.norm2_bias, LN_EPS)
    token = tok + m2[0]

    # radiance layer 0: the token and m2 enter apart (out_v = x_v + m2_v)
    r0 = p.rad_w[0]
    z = (lin(views, r0[:, :c]) + lin(m2[1:], r0[:, :c]) + lin(inp.dir_rel, r0[:, c:])
         + p.rad_b[0])
    z = F.relu(lin(F.relu(z), p.rad_w[1], p.rad_b[1]))
    z = lin(z, p.rad_w[2], p.rad_b[2])[..., 0]                      # (NV, P)
    z = torch.where(inp.mask == 0, torch.full_like(z, -1e9), z)
    w = torch.softmax(z, dim=0)
    return token, torch.einsum("vpc,vp->pc", inp.rgb, w)


def rad_rows(g_view: int) -> int:
    """Rows of the radiance layer 0's first operand in the kernel: [img |
    pe] (g_view), dir (3), three 1s that take the bias rows, zeros up to a
    multiple of 8 (the tensor-core k step)."""
    return (g_view + 3 + BIAS_ROWS + 7) // 8 * 8


# rows of the radiance bias in v_rad: the bias and two zero rows in 3xTF32
# (whose planes carry it to 2^-22), its three-way bf16 split in fast (a
# float32 bias, as JAX adds it)
BIAS_ROWS = 3


def layout2(c: int, c_img: int, c_vol: int, c_sim: int, s_hid: int = 32
            ) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    """name -> (offset, shape) of each part of ``pack_weights2``'s buffer,
    in ``csrc/point_head2.cu``'s order, for token width c = c_img + c_vol +
    c_sim + 8 and a pre-similarity MLP 8 -> s_hid -> s_hid -> c_sim. ``sh``
    holds the rows of the view-shared groups [vol | sim16], ``v_*`` those of
    the per-view groups [img | pe] (``v_rad`` adds dir_rel and then all C
    token rows, which take the LoFTR output m2; between them the bias row
    and zero rows up to ``rad_rows``). A matrix of ``TC_MATRICES`` has the
    shape (2, in, out): its hi plane, then its lo plane."""
    c2, r1 = 2 * c, 16
    g_shared = c_vol + c_sim
    g_view = c - g_shared                   # img + pe
    shapes = [
        ("tok", (c,)),
        ("tok_qkv", (3, c)),                # view_token @ wq, wk, wv
        ("w1a_tok", (c2,)),                 # view_token @ w1[:C]
        ("sh", (2, g_shared, 3 * c + c2 + r1)),  # columns wq | wk | wv | w1a | r0
        ("v_qkv", (2, g_view, 3 * c)),      # columns wq | wk | wv
        ("wm", (2, c, c)),
        ("n1s", (c,)), ("n1b", (c,)),
        ("v_w1", (2, g_view + c, c2)),      # w1a's view rows, then w1[C:]
        ("w2", (2, c2, c)),
        ("n2s", (c,)), ("n2b", (c,)),
        ("sw0", (8, s_hid)), ("sb0", (s_hid,)),
        ("sw1", (s_hid, s_hid)), ("sb1", (s_hid,)),
        ("sw2", (s_hid, c_sim)), ("sb2", (c_sim,)),
        ("v_rad", (2, rad_rows(g_view) + c, r1)),  # r0's view, dir, bias, 0 rows, r0[:C]
        ("rw1", (r1, 8)), ("rb1", (8,)),
        ("rw2", (8, 1)), ("rb2", (1,)),
    ]
    out, off = {}, 0
    for name, shape in shapes:
        out[name] = (off, shape)
        n = 1
        for s in shape:
            n *= s
        off += n
    out["total"] = (off, ())
    return out


def split_weights2(p: PointHeadParams, c_img: int = 32,
                   precision: str = "high") -> Dict[str, torch.Tensor]:
    """The weights split by feature group: ``layout2``'s parts by name,
    every matrix in (in, out) orientation and float32, as one plane. The
    port's weights are ``nn.Linear`` (out, in); the JAX slices are rows of
    (in, out). The token is [img c_img | vol | sim16 | pe 8]; the widths of
    sim16 and vol follow from the weights. ``precision`` picks the
    radiance bias rows (``BIAS_ROWS``)."""
    c = p.view_token.numel()
    c_sim = p.sim_w[2].shape[0]
    c_vol = c - c_img - c_sim - PE_DIM
    o1, o3 = c_img, c_img + c_vol + c_sim   # offsets of vol and pe
    g_view = c - c_vol - c_sim              # img + pe
    f = lambda t: t.detach().float()
    tok = f(p.view_token).reshape(-1)
    wq, wk, wv = (f(w).t() for w in (p.wq, p.wk, p.wv))       # (in, out)
    w1 = f(p.w1).t()
    w1a, w1b = w1[:c], w1[c:]
    r0 = f(p.rad_w[0]).t()                                     # (C + 3, 16)

    def shared(w):            # rows of vol, then sim16
        return w[o1:o3]

    def view(w):              # rows of img, then pe
        return torch.cat([w[:o1], w[o3:c]])

    def tok_dot(w):             # (in, out) here
        return _tok_dot(tok, w.t())

    b0 = f(p.rad_b[0])
    if cuda_build.is_fast(precision):
        hi = cuda_build.bf16_round(b0)
        mid = cuda_build.bf16_round(b0 - hi)
        bias = torch.stack([hi, mid, cuda_build.bf16_round(b0 - hi - mid)])
    else:
        bias = torch.cat([b0[None], b0.new_zeros(BIAS_ROWS - 1, b0.numel())])

    parts = {
        "tok": tok,
        "tok_qkv": torch.stack([tok_dot(w) for w in (wq, wk, wv)]),
        "w1a_tok": tok_dot(w1a),
        "sh": torch.cat([shared(w) for w in (wq, wk, wv, w1a, r0)], dim=1),
        "v_qkv": torch.cat([view(w) for w in (wq, wk, wv)], dim=1),
        "wm": f(p.wmerge).t(), "n1s": f(p.norm1_scale), "n1b": f(p.norm1_bias),
        "v_w1": torch.cat([view(w1a), w1b]),
        "w2": f(p.w2).t(), "n2s": f(p.norm2_scale), "n2b": f(p.norm2_bias),
        # radiance layer 0: [img | pe] rows, dir rows, the bias rows (the
        # kernel's 1 columns), zero rows, then the C rows that take m2
        "v_rad": torch.cat([view(r0), r0[c:c + 3], bias,
                            r0.new_zeros(rad_rows(g_view) - g_view - 3 - BIAS_ROWS,
                                         r0.shape[1]),
                            r0[:c]]),
        "rw1": f(p.rad_w[1]).t(), "rb1": f(p.rad_b[1]),
        "rw2": f(p.rad_w[2]).t(), "rb2": f(p.rad_b[2]),
    }
    for i, (w, b) in enumerate(zip(p.sim_w, p.sim_b)):
        parts[f"sw{i}"], parts[f"sb{i}"] = f(w).t(), f(b)
    lay = layout2(c, c_img, c_vol, c_sim, p.sim_w[0].shape[0])
    for name, (_, shape) in lay.items():
        want = shape[1:] if name in TC_MATRICES else shape
        if name != "total" and tuple(parts[name].shape) != want:
            raise ValueError(f"split_weights2: {name} is {tuple(parts[name].shape)}, "
                             f"the layout wants {want}")
    return {name: parts[name] for name in lay if name != "total"}


# the small MLPs' weights, which the kernel multiplies on the CUDA cores
SMALL_MATRICES = ("sw0", "sw1", "sw2", "rw1", "rw2")


def pack_weights2(p: PointHeadParams, c_img: int = 32,
                  precision: str = "high") -> torch.Tensor:
    """``split_weights2(p, c_img, precision)`` flattened in ``layout2``'s
    order, the matrices of ``TC_MATRICES`` as their TF32 hi plane, then lo
    plane, or in ``fast`` as their bf16 values and a zero plane, with the
    ``SMALL_MATRICES`` bf16-rounded."""
    tc = cuda_build.bf16_planes if cuda_build.is_fast(precision) else cuda_build.tf32_planes
    small = cuda_build.operand_round(precision)
    parts = split_weights2(p, c_img, precision)
    return torch.cat([tc(t) if name in TC_MATRICES
                      else (small(t) if name in SMALL_MATRICES else t).reshape(-1)
                      for name, t in parts.items()])


def _launch(inp: PointHeadInputs, p: PointHeadParams, n_heads: int = 8,
            precision: str = "high") -> Tuple[torch.Tensor, torch.Tensor]:
    nv, n, c_img = inp.img_feat.shape
    c = p.view_token.numel()
    c_vol = inp.vol_feat.shape[-1]
    dims = dict(c=c, c_img=c_img, c_vol=c_vol, c_sim=inp.sim_feat.shape[-1],
                n_heads=n_heads)
    d = kernel_dims(c_vol)
    if nv < 2:
        raise ValueError(f"point_head2 kernel takes 2 views or more, got {nv} views")
    if c_vol not in KERNEL_VOL_WIDTHS or dims != d:
        raise ValueError(f"point_head2 kernel takes {kernel_dims(24)} or "
                         f"{kernel_dims(16)}, got {dims}")
    dev = inp.img_feat.device
    cuda_build.check_tensors("point_head2", list(inp) + _flat_params(p))
    expect = {"img_feat": (nv, n, c_img), "vol_feat": (n, d["c_vol"]),
              "sim_feat": (n, d["c_sim"]), "depth_dist": (nv, n),
              "dir_rel": (nv, n, 3), "rgb": (nv, n, 3), "mask": (nv, n)}
    for name, shape in expect.items():
        if tuple(getattr(inp, name).shape) != shape:
            raise ValueError(f"point_head2 kernel takes {name} of shape {shape}, "
                             f"got {tuple(getattr(inp, name).shape)}")
    ext = cuda_build.extension()
    ins = [cuda_build.aligned(t) for t in inp]
    w, built = _packs.get(_flat_params(p), lambda: pack_weights2(p, precision=precision),
                          precision)
    point_head2.pack_builds += built
    if w.numel() != ext.point_head2_weight_count(c_vol):
        raise ValueError("point_head2 weight pack does not match the kernel")
    token = torch.empty(n, c, device=dev, dtype=torch.float32)
    rad = torch.empty(n, 3, device=dev, dtype=torch.float32)
    fast = cuda_build.is_fast(precision)
    with torch.cuda.device(dev):
        scratch = (torch.empty(ext.point_head2_scratch_floats(c_vol, nv, n), device=dev,
                               dtype=torch.float32) if nv > KERNEL_COMPILED_VIEWS
                   else cuda_build.no_scratch(dev))
        ext.point_head2(*ins, w, token, rad, scratch, fast)
    cuda_build.count_launch(point_head2, fast)
    return token, rad


_packs = cuda_build.PackCache()


# _point_head2_fn((n_heads, precision), *inputs, *params): CUDA kernel
# forward, backward through the FP32 plain version
_point_head2_fn = cuda_build.kernel_function(
    lambda st, *ts: _launch(*_split(ts), *st),
    lambda st, *ts: point_head2_reference(*_split(ts), st[0]))


def point_head2(inp: PointHeadInputs, p: PointHeadParams, n_heads: int = 8,
                precision: str = "high") -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-weight per-point view head at a resolved kernel precision: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Returns (token (P, C), radiance (P, 3))."""
    if not inp.img_feat.is_cuda:
        return point_head2_reference(inp, p, n_heads, precision)
    return _point_head2_fn((n_heads, precision), *inp, *_flat_params(p))


point_head2.launches = 0
point_head2.launches_fast = 0
point_head2.pack_builds = 0
