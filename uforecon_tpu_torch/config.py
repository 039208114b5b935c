"""Configuration of the depth-map render path.

A copy of the JAX package's ``config.Config`` fields that encode and
render read, with the same names and defaults (the repo's default DTU
configuration). The port always runs the JAX package's exact path with
correlation volumes (``volume_reso`` 96) and the MVS depth guide with its
positional encoding. Explicit pairwise similarity is on by default;
``explicit_similarity=False`` is the paper's ablation without it (no
similarity query, no ``pre_sim_mlp``: d_view 64 and a ray-head width of
72). The JAX evaluation approximations (merged stage volumes, bf16 gather
sources, low-precision kernel math, brick gathers and the other TPU
layout knobs) and the other ablations (``use_dir_srdf``, no depth guide,
bf16 compute) do not exist here.

``coarse_sample`` / ``fine_sample`` are the samples per ray of the
render; the JAX package reads ``test_sample_*`` in their place when it
extracts geometry, a choice its CLI makes.

The three render-glue knobs keep the JAX names, values and defaults
(``never``). In the JAX package ``auto`` means "on a TPU"; in the port
``auto`` and ``always`` both route to the kernel wrapper, which launches
the CUDA kernel for CUDA tensors and runs its plain version only for CPU
tensors:
  * ``fused_similarity``: the grouped cosine of the explicit-similarity
    query (``ops/fused_similarity.py``);
  * ``fused_volume_fusion``: the cross-view fusion of the correlation-
    volume samples (``ops/fused_volume_fusion.py``);
  * ``fused_neus_epilogue`` (``auto | never``): the ray head with the NeuS
    compositing in its epilogue (``ops/fused_ray_head.py ray_head_neus``).
``FUSED_GLUE`` sets all three on; ``UFORecon.with_knobs(**FUSED_GLUE)``
gives that route on the same weights.

``fused_point_head`` (``auto | always | never``, default ``auto``, the JAX
name and values) picks the per-point stage's route. ``auto`` takes the
point-head kernel (``ops/fused_point_head.py``) where the full feature set
is there (the JAX package adds "on a TPU"), else the view-transformer
route: ``nn.Linear`` projections and MLPs around the tiny-attention
kernels (``ops/tiny_attention.py``). ``never`` always takes the view
transformer (``UFORecon.with_knobs(fused_point_head="never")`` on the same
weights); ``always`` raises without the full feature set, as JAX does.

``point_head`` (``v1 | v2``, default ``v1``, the JAX name and values)
picks the kernel of that point-head route: ``v1`` the point-head kernel,
``v2`` the split-weight point head (``ops/fused_point_head2.py``), which
computes the same function on the same weights without building each
view's 80-channel token. It takes effect only where the point head runs
(``fused_point_head`` ``auto``/``always`` with explicit similarity); with
``never``, or in the ablation, ``v2`` changes nothing, as in JAX.
``UFORecon.with_knobs(point_head="v2")`` is that route on the same weights.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

FUSED_GLUE = dict(fused_similarity="auto", fused_volume_fusion="auto",
                  fused_neus_epilogue="auto")


@dataclasses.dataclass(frozen=True)
class Config:
    out_dir: str = "./outputs"

    # ---- ray sampling ------------------------------------------------------
    coarse_sample: int = 64
    fine_sample: int = 64
    test_ray_num: int = 800              # sets the ray-chunk size (renderer)

    # ---- correlation / cascade MVS ----------------------------------------
    ndepths: Tuple[int, ...] = (48, 32, 8)
    depth_inter_r: Tuple[float, ...] = (4.0, 2.0, 1.0)
    cr_base_chs: Tuple[int, ...] = (8, 8, 8)

    # ---- model -------------------------------------------------------------
    # reference-shipped similarity semantics (see ray_transformer
    # query_similarity): both sides of each pair sample the view-i map
    sim_pair_quirk: bool = True
    fmt_layer_names: Tuple[str, ...] = ("self", "cross") * 4
    img_feat_dim: int = 32
    fea_volume_dim: int = 24             # 8ch x 3 cascade stages
    cos_n_group: int = 8
    explicit_similarity: bool = True

    # ---- render-glue kernels (see the module docstring) ----------------
    fused_similarity: str = "never"      # auto | always | never
    fused_volume_fusion: str = "never"   # auto | always | never
    fused_neus_epilogue: str = "never"   # auto | never
    # per-point stage (see the module docstring)
    fused_point_head: str = "auto"       # auto | always | never
    point_head: str = "v1"               # v1 | v2

    def __post_init__(self):
        allowed = {
            "fused_similarity": ("auto", "always", "never"),
            "fused_volume_fusion": ("auto", "always", "never"),
            "fused_neus_epilogue": ("auto", "never"),
            "fused_point_head": ("auto", "always", "never"),
            "point_head": ("v1", "v2"),
        }
        for field, values in allowed.items():
            v = getattr(self, field)
            if v not in values:
                raise ValueError(f"Config.{field}={v!r} not in {values}")
        if self.fused_point_head == "always" and not self.explicit_similarity:
            raise ValueError("fused_point_head='always' needs the point-head "
                             "kernel's full feature set, which includes explicit "
                             "similarity; use 'auto' to allow the view-transformer "
                             "route")
        if len(self.ndepths) != 3:
            raise ValueError(f"the cascade has 3 stages, got ndepths={self.ndepths}")
        if len(self.depth_inter_r) != len(self.ndepths) or \
                len(self.cr_base_chs) != len(self.ndepths):
            raise ValueError("depth_inter_r and cr_base_chs need one entry per stage")

    # dims that the ray transformer sees (JAX config.py:274-304)
    @property
    def sim_feat_fix(self) -> int:
        return 16 if self.explicit_similarity else 0   # pre-similarity MLP output

    @property
    def depth_dim(self) -> int:
        return 8      # NeRF PE of the depth distance, num_freqs=4

    @property
    def view_trans_dim(self) -> int:
        return self.img_feat_dim + self.fea_volume_dim + self.sim_feat_fix + self.depth_dim

    @property
    def ray_trans_dim(self) -> int:
        return self.view_trans_dim + 8  # + order PE width
