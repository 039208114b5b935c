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
render; under ``extract_geometry`` it reads ``test_sample_coarse`` /
``test_sample_fine`` in their place, as the JAX package does
(``models/uforecon.py:389-390``). ``test_coarse_only`` returns the coarse
pass as both outputs. The scan, view and checkpoint fields are those of the
JAX package's extract command, the training fields (``logdir`` ...
``pair_file``, ``numdepth``) those of its training command, with the same
names and defaults; ``config_from_args`` parses the flags of both.

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
    root_dir: str = "./DTU"
    out_dir: str = "./outputs"
    seed: int = 0
    load_ckpt: str = ""
    logdir: str = "./logdir"
    exp_name: str = "uforecon_tpu"
    debug: bool = False                  # training: 3 steps, one validation

    # ---- training ----------------------------------------------------------
    batch_size: int = 1                  # scenes averaged per optimizer step
    max_epochs: int = 16
    uforecon_lr: float = 1e-4
    weight_rgb: float = 1.0
    weight_depth: float = 1.0
    train_n_view: int = 5                # ref + 4 source views
    view_selection_type: str = "best"    # best | random
    val_only: bool = False               # one validation pass (main.py:222)
    train_ray_num: int = 1024            # rays per step and validation chunk
    train_list: str = ""                 # DTU split lists and pair file
    val_list: str = ""                   # ("" = the packaged ones)
    pair_file: str = ""

    # ---- ray sampling ------------------------------------------------------
    coarse_sample: int = 64
    fine_sample: int = 64
    test_sample_coarse: int = 64
    test_sample_fine: int = 64
    test_ray_num: int = 800              # sets the ray-chunk size (renderer)

    # ---- testing (the extract command) -----------------------------------
    extract_geometry: bool = False
    test_n_view: int = 3
    test_ref_view: Tuple[int, ...] = (23, 24, 33)
    test_scan: str = "scan1"
    set: int = 0
    test_coarse_only: bool = False
    img_wh: Tuple[int, ...] = ()         # render size W H; () = the dataset's

    # ---- correlation / cascade MVS ----------------------------------------
    ndepths: Tuple[int, ...] = (48, 32, 8)
    numdepth: int = 192                  # the datasets' hypotheses in mm
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

    @property
    def samples(self) -> Tuple[int, int]:
        """(coarse, fine) samples per ray of a render chunk."""
        if self.extract_geometry:
            return self.test_sample_coarse, self.test_sample_fine
        return self.coarse_sample, self.fine_sample

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


def _ints(s) -> Tuple[int, ...]:
    return tuple(int(x) for x in str(s).split(",") if x)


def _floats(s) -> Tuple[float, ...]:
    return tuple(float(x) for x in str(s).split(",") if x)


# flag sets of the JAX package's CLI that select a model or a path the port
# does not have: (test on the parsed flags, message naming the flag)
_UNSUPPORTED = (
    (lambda a: not a.depth_pos_encoding,
     "--depth_pos_encoding is required: without it the JAX package builds a "
     "model with no depth PE, which the port does not have"),
    (lambda a: a.mvs_depth_guide <= 0,
     "--mvs_depth_guide {a.mvs_depth_guide}: a model with no depth PE is not ported"),
    (lambda a: a.use_dir_srdf,
     "--use_dir_srdf: the view-direction encoding of the ray head is not ported"),
    (lambda a: a.volume_type != "correlation",
     "--volume_type {a.volume_type}: only correlation volumes are ported"),
    (lambda a: a.volume_reso <= 0,
     "--volume_reso {a.volume_reso}: a model without volume features is not ported"),
    (lambda a: a.share_cr,
     "--share_cr: one shared cost-regularisation net is not ported"),
    (lambda a: a.compute_dtype != "float32",
     "--compute_dtype {a.compute_dtype}: the port computes in float32"),
    (lambda a: a.encoder_dtype not in ("", "float32"),
     "--encoder_dtype {a.encoder_dtype}: the port computes in float32"),
    (lambda a: a.test_general,
     "--test_general: the GeneralFit dataset is not ported"),
    (lambda a: a.extract_similarity,
     "--extract_similarity: the similarity field is not ported"),
    (lambda a: _ints(a.mesh_shape) != (1,),
     "--mesh_shape {a.mesh_shape}: the port renders on one card"),
)


def config_from_args(argv=None) -> Tuple["Config", str]:
    """Parse the JAX package's flags (``uforecon_tpu/config.py:352``
    ``config_from_args``: the same names and defaults), those of extraction
    (``--extract_geometry``) and of training (without it), plus
    ``--device``.

    Returns the Config and the device. Raises ``ValueError``, naming the
    flag, on a flag set that selects a model or a path the port does not
    have, rather than rendering its default model. The port renders the
    exact path: the JAX package's evaluation approximations
    (``volume_merge``, ``kernel_precision``, ``image_gather_dtype``) do not
    exist here."""
    import argparse

    p = argparse.ArgumentParser(
        "uforecon_tpu_torch.cli.run",
        description="Train on DTU, or with --extract_geometry render the depth "
                    "maps of DTU scans, on a CUDA card. The port runs the "
                    "exact path: it has none of the JAX evaluation "
                    "approximations (volume_merge, kernel_precision, "
                    "image_gather_dtype).")
    d = Config()
    p.add_argument("--root_dir", type=str, default=d.root_dir)
    p.add_argument("--out_dir", type=str, default=d.out_dir)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--load_ckpt", type=str, default=d.load_ckpt,
                   help="a state-dict file, a checkpoint of the port's training or "
                        "the reference's Lightning .ckpt (convert.load_weights); "
                        "without it: seeded random weights")
    p.add_argument("--logdir", type=str, default=d.logdir)
    p.add_argument("--exp_name", type=str, default=d.exp_name)
    p.add_argument("--debug", action="store_true",
                   help="training: 3 steps, then one validation and a checkpoint")
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--max_epochs", type=int, default=d.max_epochs)
    p.add_argument("--uforecon_lr", type=float, default=d.uforecon_lr)
    p.add_argument("--weight_rgb", type=float, default=d.weight_rgb)
    p.add_argument("--weight_depth", type=float, default=d.weight_depth)
    p.add_argument("--train_n_view", type=int, default=d.train_n_view)
    p.add_argument("--view_selection_type", type=str, default=d.view_selection_type)
    p.add_argument("--val_only", action="store_true")
    p.add_argument("--train_ray_num", type=int, default=d.train_ray_num)
    p.add_argument("--coarse_sample", type=int, default=d.coarse_sample)
    p.add_argument("--fine_sample", type=int, default=d.fine_sample)
    p.add_argument("--train_list", type=str, default=d.train_list)
    p.add_argument("--val_list", type=str, default=d.val_list)
    p.add_argument("--pair_file", type=str, default=d.pair_file)
    p.add_argument("--numdepth", type=int, default=d.numdepth)
    p.add_argument("--test_sample_coarse", type=int, default=d.test_sample_coarse)
    p.add_argument("--test_sample_fine", type=int, default=d.test_sample_fine)
    p.add_argument("--extract_geometry", action="store_true")
    p.add_argument("--test_general", action="store_true")
    p.add_argument("--test_n_view", type=int, default=d.test_n_view)
    p.add_argument("--test_ray_num", type=int, default=d.test_ray_num)
    p.add_argument("--test_ref_view", type=int, nargs="+", default=list(d.test_ref_view))
    p.add_argument("--test_scan", type=str, default=d.test_scan)
    p.add_argument("--img_wh", type=int, nargs=2, default=[],
                   help="render resolution W H (default: the dataset's 800 640)")
    p.add_argument("--set", type=int, default=d.set)
    p.add_argument("--test_coarse_only", action="store_true")
    p.add_argument("--extract_similarity", action="store_true")
    p.add_argument("--ndepths", type=str, default="48,32,8")
    p.add_argument("--depth_inter_r", type=str, default="4,2,1")
    p.add_argument("--cr_base_chs", type=str, default="8,8,8")
    p.add_argument("--share_cr", action="store_true")
    p.add_argument("--volume_type", type=str, default="correlation")
    p.add_argument("--volume_reso", type=int, default=96)
    p.add_argument("--mvs_depth_guide", type=int, default=1)
    p.add_argument("--depth_pos_encoding", action="store_true")
    p.add_argument("--explicit_similarity", action="store_true",
                   help="without it: the paper's ablation without explicit "
                        "similarity, as in the JAX package")
    p.add_argument("--use_dir_srdf", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="float32")
    p.add_argument("--encoder_dtype", type=str, default="")
    p.add_argument("--mesh_shape", type=str, default="1")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu runs the kernels' plain PyTorch versions")
    a = p.parse_args(argv)
    for unsupported, message in _UNSUPPORTED:
        if unsupported(a):
            raise ValueError(message.format(a=a))
    cfg = Config(
        root_dir=a.root_dir, out_dir=a.out_dir, seed=a.seed, load_ckpt=a.load_ckpt,
        logdir=a.logdir, exp_name=a.exp_name, debug=a.debug,
        batch_size=a.batch_size, max_epochs=a.max_epochs, uforecon_lr=a.uforecon_lr,
        weight_rgb=a.weight_rgb, weight_depth=a.weight_depth,
        train_n_view=a.train_n_view, view_selection_type=a.view_selection_type,
        val_only=a.val_only, train_ray_num=a.train_ray_num,
        coarse_sample=a.coarse_sample, fine_sample=a.fine_sample,
        train_list=a.train_list, val_list=a.val_list, pair_file=a.pair_file,
        numdepth=a.numdepth,
        test_sample_coarse=a.test_sample_coarse, test_sample_fine=a.test_sample_fine,
        test_ray_num=a.test_ray_num, extract_geometry=a.extract_geometry,
        test_n_view=a.test_n_view, test_ref_view=tuple(a.test_ref_view),
        test_scan=a.test_scan, set=a.set, test_coarse_only=a.test_coarse_only,
        img_wh=tuple(a.img_wh), ndepths=_ints(a.ndepths),
        depth_inter_r=_floats(a.depth_inter_r), cr_base_chs=_ints(a.cr_base_chs),
        explicit_similarity=a.explicit_similarity)
    return cfg, a.device
