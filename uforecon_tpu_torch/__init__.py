"""UFORecon in PyTorch and CUDA: the depth-map render path and training on
one NVIDIA GPU.

A port of the repository's JAX package (the directory beside this one,
which stays the reference it is tested against). Module paths mirror the
JAX package's so each counterpart is easy to find; public functions keep
the JAX layouts (channels-last images, ``(RN, SN, C)`` tokens).

Entry point: :func:`uforecon_tpu_torch.pipeline.extract.
extract_geometry_for_dataset`, which encodes each view set once and
renders its depth map chunk by chunk through hand-written Hopper kernels:
the point and ray heads (``ops/fused_point_head.py``,
``ops/fused_ray_head.py``); with the render-glue knobs of ``Config`` on,
the grouped cosine, the volume fusion and the ray head's NeuS epilogue
(``ops/fused_similarity.py``, ``ops/fused_volume_fusion.py``); and on the
view-transformer route (``fused_point_head='never'``, or without explicit
similarity) the tiny linear attention and its backward
(``ops/tiny_attention.py``).
Training: :func:`uforecon_tpu_torch.pipeline.fit.fit` (render training,
matcher frozen) and :func:`~uforecon_tpu_torch.pipeline.fit.pretrain_mvs`
(the matcher on ground-truth depth), with the steps of
``pipeline/trainer.py``; ``cli/run.py`` runs both entry points.
They run on the CUDA card unless the caller passes ``device="cpu"``.

Importing the package imports neither ``jax`` nor the JAX package and
builds no kernel: kernels are compiled at their first launch on a CUDA
tensor.
"""
from .config import Config

__all__ = ["Config"]
