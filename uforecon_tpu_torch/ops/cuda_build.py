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
"""
from __future__ import annotations

import functools
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]


@functools.lru_cache(maxsize=1)
def extension():
    """The loaded kernel extension, built on first call."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(name="uforecon_tpu_torch_kernels",
                sources=[str(s) for s in [CSRC / "bindings.cpp",
                                          *sorted(CSRC.glob("*.cu"))]],
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O2"], extra_cuda_cflags=CUDA_FLAGS,
                extra_include_paths=[str(CSRC)], verbose=False)


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
