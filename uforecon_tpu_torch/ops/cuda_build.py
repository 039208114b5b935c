"""Build and load the port's CUDA kernels (``uforecon_tpu_torch/csrc``).

One ``torch.utils.cpp_extension.load`` call compiles every source: the
kernels (``*.cu``, for ``sm_90a``, no PyTorch header) and the small
binding file ``bindings.cpp`` (the only one that includes
``torch/extension.h``). The extension goes into
``uforecon_tpu_torch/_build/`` (git-ignored); ``load`` keys it by the
sources and flags, so unchanged sources reuse the built library. The build
happens at the first kernel launch, never at import, and a failed build
raises.

``kernel_function`` wraps a kernel launcher for autograd: forward runs
the kernel, backward differentiates the kernel's plain version. Every
kernel wrapper of the port goes through it.

The head kernels read their weights from one packed buffer each, built
for one kernel precision (``Config.kernel_precision``, resolved). In
``highest`` and ``high`` ``tf32_planes`` splits a matrix into the two
TF32 planes their tensor-core layers take (3xTF32, ``csrc/tc_gemm.cuh``);
in ``fast`` ``bf16_planes`` gives its bf16 values and a zero plane in the
same place, so one layout serves both and a k16 step past a matrix's last
row reads zeros. ``PackCache`` builds a pack once per set of weights and
precision. ``kernel_linear`` is the plain versions' product at a
precision: float32, or the JAX package's ``fast`` (both operands rounded
to bf16, ``bf16_round``, products summed in float32).
"""
from __future__ import annotations

import collections
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]
# the sources that take longest to compile (30-90 s each on an 8-core
# host), about in that order: ninja starts its jobs in the sources' order,
# so these start first and the build does not end on one started late
SLOW_SOURCES = ("bindings.cpp", "point_head2_views.cu", "point_head2_stream.cu",
                "ray_head.cu", "point_head2_fast_views.cu", "point_head_stream.cu",
                "point_head_fast_views.cu", "tiny_attention_bwd2.cu", "tiny_attention_bwd1.cu",
                "tiny_attention.cu")


def sources():
    """``bindings.cpp`` and every ``csrc/*.cu``, SLOW_SOURCES first."""
    files = [CSRC / "bindings.cpp", *CSRC.glob("*.cu")]
    slow = {name: i for i, name in enumerate(SLOW_SOURCES)}
    return sorted(files, key=lambda f: (slow.get(f.name, len(slow)), f.name))


@functools.lru_cache(maxsize=1)
def extension():
    """The loaded kernel extension, built on first call."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(name="uforecon_tpu_torch_kernels",
                sources=[str(s) for s in sources()],
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O2"], extra_cuda_cflags=CUDA_FLAGS,
                extra_include_paths=[str(CSRC)], verbose=False)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (a contiguous
    view at another offset is copied): the head kernels load their inputs
    by cp.async in 16-byte pieces, the tiny-attention forward by TMA bulk
    copies."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kernel_function(launch, reference):
    """An autograd function called as ``fn(static, *tensors)``, ``static``
    holding the arguments that are not tensors: forward returns
    ``launch(static, *tensors)`` (the CUDA kernel), backward differentiates
    ``reference(static, *tensors)`` (its plain version) at the saved
    inputs."""

    class KernelFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, static, *tensors):
            ctx.static = static
            ctx.save_for_backward(*tensors)
            return launch(static, *tensors)

        @staticmethod
        def backward(ctx, *grads):
            with torch.enable_grad():
                xs = [t.detach().requires_grad_(t.requires_grad)
                      for t in ctx.saved_tensors]
                outs = reference(ctx.static, *xs)
                need = [x for x in xs if x.requires_grad]
                got = iter(torch.autograd.grad(outs, need, grads, allow_unused=True))
            return (None, *[next(got) if x.requires_grad else None for x in xs])

    return KernelFn.apply


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 stored mantissa bits), to nearest
    with ties away from zero: ``cvt.rna.tf32.f32``, and the kernels'
    ``tc::rna_tf32``, on finite values."""
    bits = x.detach().float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_planes(w: torch.Tensor) -> torch.Tensor:
    """``w`` flattened as its TF32 hi plane, then its lo plane:
    hi = RNA(w), lo = RNA(w - hi), so w = hi + lo up to 2^-22 |w|."""
    hi = tf32_round(w)
    lo = tf32_round(w.detach().float() - hi)
    return torch.cat([hi.reshape(-1), lo.reshape(-1)])


# resolved kernel precisions (config.resolve_kernel_precision)
PRECISIONS = ("highest", "high", "fast")


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest, ties to even: JAX's
    ``astype(bfloat16)`` and the kernels' ``cvt.rn.bf16x2.f32``), as
    float32."""
    return x.to(torch.bfloat16).to(x.dtype)


def bf16_planes(w: torch.Tensor) -> torch.Tensor:
    """``w`` flattened as its bf16 values (``bf16_round``), then a zero
    plane where ``tf32_planes`` puts the lo plane."""
    hi = bf16_round(w.detach().float()).reshape(-1)
    return torch.cat([hi, torch.zeros_like(hi)])


def image_stride(k: int) -> int:
    """The bf16 row stride of a matrix of ``k`` inputs in the fast heads'
    weight images (``fused_point_head.fast_image``,
    ``fused_ray_head.fast_image``): ``k`` rounded up to 8, or 8 more,
    whichever is an odd multiple of 4 words (``kpad`` of
    ``csrc/point_head_fast.cuh`` and ``csrc/ray_head_fast.cuh``:
    conflict-free B fragments)."""
    k8 = -(-k // 8) * 8
    return k8 if (k8 // 2) % 8 == 4 else k8 + 8


def fast_linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """``F.linear`` of bf16-rounded ``x`` and ``w``, the bias added in
    float32: the JAX package's ``kernel_dot`` in ``fast`` (products of two
    bf16 values are exact in float32; only the order of the sums
    differs)."""
    return F.linear(bf16_round(x), bf16_round(w), b)


def is_fast(precision: str) -> bool:
    """Is the resolved kernel precision ``fast``? Raises on a value that
    is not one."""
    if precision not in PRECISIONS:
        raise ValueError(f"kernel precision {precision!r} not in {PRECISIONS}")
    return precision == "fast"


def kernel_linear(precision: str):
    """The plain versions' layer product at a resolved kernel precision:
    ``fast_linear`` for ``fast``, ``F.linear`` (float32) otherwise."""
    return fast_linear if is_fast(precision) else F.linear


def operand_round(precision: str):
    """What a ``kernel_dot`` operand goes through at a resolved kernel
    precision: ``bf16_round`` for ``fast``, nothing otherwise."""
    return bf16_round if is_fast(precision) else (lambda t: t)


def check_tensors(name: str, tensors) -> None:
    """Raises unless every tensor is float32 on one CUDA device, what the
    head and fusion kernels take."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{name} kernel takes float32 tensors on one CUDA device, "
                             f"got {t.dtype} on {t.device}")


_NO_SCRATCH = {}


def no_scratch(device) -> torch.Tensor:
    """An empty float32 tensor on ``device``, made once: the scratch a head
    kernel is handed at a view count it is compiled for, where it takes
    none."""
    t = _NO_SCRATCH.get(device)
    if t is None:
        t = _NO_SCRATCH[device] = torch.empty(0, device=device, dtype=torch.float32)
    return t


def count_launch(wrapper, fast: bool) -> None:
    """One launch on a head wrapper's count: ``launches`` (3xTF32) or
    ``launches_fast``."""
    if fast:
        wrapper.launches_fast += 1
    else:
        wrapper.launches += 1

_PACK_CACHES = []


class PackCache:
    """Weight packs built once per set of weights and kernel precision.

    ``get(tensors, build, precision)`` returns ``(pack, built)``: the pack
    ``build()`` made for these ``tensors`` (on one device) at this
    precision before, or a new one. The key is the precision, the device
    and each tensor's ``(data_ptr, _version)``, so two models sharing
    weights at two precisions get two packs, and an
    in-place update (an optimiser step, ``load_state_dict``) or a move
    (``.to()``) builds anew and anything else reuses the pack. (Writes through ``.data`` do not
    bump ``_version`` and are not seen.) An entry holds its tensors'
    storages, so no other tensor takes their addresses while it lives; the
    cache keeps the ``size`` latest entries."""

    def __init__(self, size: int = 8):
        self.size = size
        self._entries = collections.OrderedDict()
        _PACK_CACHES.append(self)

    def get(self, tensors, build, precision: str = "high"):
        is_fast(precision)
        key = (precision, tensors[0].device,
               *[(t.data_ptr(), t._version) for t in tensors])
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            return hit[1], False
        pack = build()
        self._entries[key] = ([t.untyped_storage() for t in tensors], pack)
        while len(self._entries) > self.size:
            self._entries.popitem(last=False)
        return pack, True

    def clear(self):
        self._entries.clear()


def clear_pack_caches():
    """Drop every cached weight pack (the next launch of each head builds
    its pack again)."""
    for cache in _PACK_CACHES:
        cache.clear()
