"""UFORecon in PyTorch and CUDA: the depth-map render path on one NVIDIA GPU.

A port of the repository's JAX package (the directory beside this one,
which stays the reference it is tested against). Module paths mirror the
JAX package's so each counterpart is easy to find; public functions keep
the JAX layouts (channels-last images, ``(RN, SN, C)`` tokens).

Entry point of this slice: :func:`uforecon_tpu_torch.pipeline.extract.
extract_geometry_for_dataset`, which encodes each view set once and
renders its depth map chunk by chunk through the two hand-written Hopper
kernels (``ops/fused_point_head.py``, ``ops/fused_ray_head.py``).

Importing the package imports neither ``jax`` nor the JAX package and
builds no kernel: kernels are compiled at their first launch on a CUDA
tensor.
"""
from .config import Config

__all__ = ["Config"]
