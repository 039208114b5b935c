"""Tiny-sequence linear attention: CUDA kernels (forward and backward),
their plain PyTorch versions, and the wrappers that pick between them.

Replaces the Pallas TPU kernels of the JAX package's
``ops/pallas_attention.py``: ``tiny_linear_attention`` (``_fwd_tb``, body
``_fwd_kernel``) and its hand-written backward (``_bwd_tb``, body
``_bwd_kernel``). The per-point view transformer runs elu+1 linear
attention over a view set's few tokens (L, S <= 8, head dim <= 16) for
every sample point of a render chunk. The kernels are
``csrc/tiny_attention.cu``.

Bound on the H100: bytes. At the view transformer's shape (65,536 points,
L = S = 4, 8 heads of 10) the forward reads three and writes one
(B, 4, 8, 10) f32 tensor, ~0.34 GFLOP for 335.5 MB; the backward reads
four and writes three. q, k and v are read in the (B, L, H, D) layout
``nn.Linear`` gives them, with no transpose or padding. Forward design:
persistent blocks stream tiles of points through a ring of shared-memory
stages by TMA bulk copies (one per input and tile), one thread computes one
(point, query token, head) item, and the output tile leaves by a bulk
store; the bulk copies need 16-byte-aligned tensors (``cuda_build.aligned``).
Backward design: the same stream with g as a fourth input and dq, dk and
dv leaving by bulk stores; one thread per (point, query token, head) item
recomputes the attention and writes dq, then one thread per (point, source
token, head) item sums over the query tokens into dk and dv, so no sum
goes through a shared-memory read-modify-write. It is built for bounds on
L, S, D and M known when compiled, so that its arithmetic hides behind its
copies; bytes bound it (7 x 83.9 MB at route A's shape, 0.175 ms).

``tiny_linear_attention`` takes the plain version for CPU tensors only.
For CUDA tensors it launches the forward kernel or raises, inside an
autograd Function whose backward is ``tiny_linear_attention_backward``:
the backward kernel for CUDA tensors, the plain backward (the JAX
``_bwd_kernel``'s formulas) for CPU tensors. ``.launches`` on each counts
kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

EPS = 1e-6          # linear attention denominator
MAX_TOKENS = 8      # L and S the kernels take (the JAX dispatch rule)
MAX_HEAD_DIM = 16   # D, and M, the kernels take


def phi(x: torch.Tensor) -> torch.Tensor:
    """elu(x) + 1, the linear-attention feature map."""
    return F.elu(x) + 1.0


def within_kernel_rule(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX package's rule for its tiny-attention kernel
    (``models/attention.py`` ``linear_attention``): S <= 8, L <= 8 and a
    head dim <= 16."""
    return (k.shape[1] <= MAX_TOKENS and q.shape[1] <= MAX_TOKENS
            and q.shape[-1] <= MAX_HEAD_DIM)


def tiny_linear_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch forward, the qk-order einsums of the JAX
    ``models/attention.py`` ``linear_attention``: phi(Q) phi(K)^T first,
    then the sum over the S source tokens. q (B, L, H, D), k (B, S, H, D),
    v (B, S, H, M) -> (B, L, H, M)."""
    qf, kf = phi(q), phi(k)
    scores = torch.einsum("blhd,bshd->bhls", qf, kf)
    denom = scores.sum(dim=-1) + EPS                         # (B, H, L)
    out = torch.einsum("bhls,bshm->bhlm", scores, v) / denom[..., None]
    return out.permute(0, 2, 1, 3)


def tiny_linear_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward, the formulas of the JAX ``_bwd_kernel``: the
    scores and the denominator recomputed, then dq, dk and dv for the
    output gradient g (B, L, H, M), with dphi(x) = 1 for x > 0, else
    exp(x)."""
    qf, kf = phi(q), phi(k)
    sc = torch.einsum("blhd,bshd->blsh", qf, kf)             # (B, L, S, H)
    den = sc.sum(dim=2) + EPS                                # (B, L, H)
    out = torch.einsum("blsh,bshm->blhm", sc, v) / den[..., None]
    dv = torch.einsum("blsh,blhm->bshm", sc / den[:, :, None], g)
    # ds[l, s, h] = sum_m g[l, h, m] (v[s, h, m] - out[l, h, m]) / den[l, h]
    ds = (torch.einsum("blhm,bshm->blsh", g, v)
          - (g * out).sum(dim=-1)[:, :, None]) / den[:, :, None]
    dqf = torch.einsum("blsh,bshd->blhd", ds, kf)
    dkf = torch.einsum("blsh,blhd->bshd", ds, qf)

    def dphi(x):
        return torch.where(x > 0, torch.ones_like(x), torch.exp(x))

    return dqf * dphi(q), dkf * dphi(k), dv


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *more: torch.Tensor) -> None:
    """Raises unless the kernel takes these tensors."""
    b, l_, h, d = q.shape
    s, m = k.shape[1], v.shape[-1]
    if (tuple(k.shape) != (b, s, h, d) or tuple(v.shape) != (b, s, h, m)
            or not within_kernel_rule(q, k) or m > MAX_HEAD_DIM):
        raise ValueError(f"{what} kernel takes q (B, L, H, D), k (B, S, H, D), "
                         f"v (B, S, H, M) with L, S <= {MAX_TOKENS} and D, M <= "
                         f"{MAX_HEAD_DIM}, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for t in (q, k, v, *more):
        if not t.is_cuda or t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{what} kernel takes float32 tensors on one CUDA "
                             f"device, got {t.dtype} on {t.device}")


def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    _check("tiny_attention", q, k, v)
    ext = cuda_build.extension()
    b, l_, h, _ = q.shape
    out = torch.empty(b, l_, h, v.shape[-1], device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        ext.tiny_attention_fwd(*(cuda_build.aligned(t) for t in (q, k, v)), out)
    tiny_linear_attention.launches += 1
    return out


def _launch_bwd(q, k, v, g):
    _check("tiny_attention backward", q, k, v, g)
    if tuple(g.shape) != (*q.shape[:3], v.shape[-1]):
        raise ValueError(f"tiny_attention backward kernel takes g (B, L, H, M), "
                         f"got {tuple(g.shape)}")
    ext = cuda_build.extension()
    q, k, v, g = (cuda_build.aligned(t) for t in (q, k, v, g))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        ext.tiny_attention_bwd(q, k, v, g, dq, dk, dv)
    tiny_linear_attention_backward.launches += 1
    return dq, dk, dv


def tiny_linear_attention_backward(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, g: torch.Tensor):
    """Gradients (dq, dk, dv) of ``tiny_linear_attention`` for the output
    gradient g: the backward kernel for CUDA tensors, the plain backward
    for CPU tensors."""
    if not q.is_cuda:
        return tiny_linear_attention_backward_reference(q, k, v, g)
    return _launch_bwd(q, k, v, g)


tiny_linear_attention_backward.launches = 0


class _TinyAttention(torch.autograd.Function):
    """Forward kernel; backward through ``tiny_linear_attention_backward``
    (the JAX ``custom_vjp`` of ``_attn_tb``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch_fwd(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return tiny_linear_attention_backward(*ctx.saved_tensors, g)


def tiny_linear_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """elu+1 linear attention over tiny token sets: the CUDA kernels for
    CUDA tensors, the plain version for CPU tensors. q (B, L, H, D),
    k (B, S, H, D), v (B, S, H, M) -> (B, L, H, M). Other dtypes than
    float32 (a bf16 view transformer) compute in float32 and return the
    input's dtype, as the JAX wrapper casts (``ops/pallas_attention.py:
    204-209``); the gradients come back through the casts."""
    if q.dtype != torch.float32:
        return tiny_linear_attention(q.float(), k.float(), v.float()).to(q.dtype)
    if not q.is_cuda:
        return tiny_linear_attention_reference(q, k, v)
    return _TinyAttention.apply(q, k, v)


tiny_linear_attention.launches = 0
