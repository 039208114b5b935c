"""Build and load the port's CUDA kernels (``uforecon_tpu_torch/csrc``).

One ``torch.utils.cpp_extension.load`` call compiles every source: the
kernels (``*.cu``, for ``sm_90a``, no PyTorch header) and the small
binding file ``bindings.cpp`` (the only one that includes
``torch/extension.h``). The extension goes into
``uforecon_tpu_torch/_build/`` (git-ignored); ``load`` keys it by the
sources and flags, so unchanged sources reuse the built library. The build
happens at the first kernel launch, never at import, and a failed build
raises.
"""
from __future__ import annotations

import functools
from pathlib import Path

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
