"""Configuration of the depth-map render path.

A copy of the JAX package's ``config.Config`` fields that encode and
render read, with the same names and defaults (the repo's default DTU
configuration: correlation volumes, ``volume_reso`` 96, the MVS depth
guide with its positional encoding, explicit similarity). The model
configurations of the JAX package are here too, with its flags:
  * ``volume_type`` ``correlation`` (per-stage frustum volumes, 24
    features) or ``featuregrid`` (one ``volume_reso``^3 grid regularised
    by a 3D U-Net, 16 features); ``volume_reso`` 0 builds no volume;
  * ``mvs_depth_guide`` <= 0 or no ``depth_pos_encoding``: no depth PE;
  * ``use_dir_srdf``: the view-direction PE (24 features);
  * ``explicit_similarity=False``: the paper's ablation (no similarity
    query, no ``pre_sim_mlp``).
The view-token width is their sum (``view_trans_dim``: 32 + 0/16/24 +
0/16 + 0/8 + 0/24) and the ray head's 8 more, 40 .. 112. JAX's gate
sends a configuration with a volume of either kind, the similarity and
the depth guide (and no direction PE) to the point head (the feature
grid's at tokens of 72), every other one to the view transformer. Each
of them trains. So do the JAX package's cascade flags: ``share_cr`` (one
cost-regularisation U-Net at base 8 for every stage) and ``grad_method``
(``detach``, or ``undetached``: the next stage's hypotheses keep the
gradient of the previous stage's depth, which only MVS pretraining
sees). The JAX package's TPU layout knobs (brick gathers, corner packing,
``image_row_merge``) do not exist here.

The JAX precision policies are here with its names and resolution
(``uforecon_tpu/models/uforecon.py:91-95``): ``compute_dtype``
(``float32 | bfloat16``) is the dtype of the volume head
(``CostRegNetWeight`` or ``FeatureVolume``) and of the ray transformer;
the cascade matcher takes ``encoder_dtype or compute_dtype`` (``""``
follows ``compute_dtype``; ``--encoder_dtype bfloat16`` alone is JAX's
mixed policy: a bf16 matcher and a float32 trained half). In a module of
either dtype, as in flax, convolutions and dense layers compute in it,
BatchNorm and LayerNorm in float32, and the parameters, their gradients
and the optimizer state stay float32 (``models/layers.py``). JAX's gates
send a bfloat16 ray transformer past the point-head and ray-head kernels
(the view transformer and its tiny-attention kernels take it; the ray
stage runs the modules), as they do.

The JAX package's evaluation approximations are here, with its names,
values, defaults and validation (``uforecon_tpu/config.py:116-265``):
  * ``volume_merge`` (``auto | always | never``, default ``auto``), with
    ``merge_depth`` (0 = the last stage's depth), ``merge_pad`` and
    ``merge_max_bytes`` (6 GiB): resample each view's three stage volumes
    onto one grid at encode time (``ops/volume_merge.py``) and query one
    volume per view. ``use_volume_merge`` decides: ``always``, or ``auto``
    under ``extract_geometry`` unless the JAX guard's byte count
    (``merge_guard_bytes``, the JAX package's corner-packed layout, which
    ``merge_pad`` widens) exceeds ``merge_max_bytes``. The port's own
    unpacked volume is 8x smaller; the guard stays so that one config picks
    the same path in both packages.
  * ``volume_dtype`` (``float32 | bfloat16``, default ``bfloat16``): the
    storage type of the stage volumes (and of the merged volume), in
    training too.
  * ``image_gather_dtype`` (``float32 | bfloat16``, default ``bfloat16``):
    the pair maps, the image features and rgb||depth are sampled from
    sources of this type, under ``extract_geometry`` only (training keeps
    float32). Sampling combines bf16 values with float32 weights into a
    float32 result, as the JAX package does (``ops/grid_sample.py``).
  * ``kernel_precision`` (``auto | highest | high | fast``, default
    ``auto``): the products of the four head kernels (point head, ray head
    and its NeuS variant, split-weight point head). ``resolve_kernel_
    precision`` gives ``fast`` under ``extract_geometry`` and ``high``
    otherwise. ``fast`` is the JAX package's single bf16 pass: both
    operands rounded to bf16 (round to nearest even), products summed in
    float32. ``highest`` and ``high`` both run the kernels' 3xTF32 products
    (~1e-6 relative, within the tolerances that hold those JAX modes) and
    the plain versions' float32 products. The resolution is per model
    (``UFORecon.kernel_precision``), with no process-wide mode: the JAX
    package pins one mode per process (``ops/kernel_precision.set_mode``)
    because its jit caches would not see a change; the port has no such
    cache, so two models of one process may run two modes. That differs
    from JAX only in a process whose JAX kernels would trace under two
    modes: JAX refuses an explicit second mode, and its ``auto`` keeps the
    first. A process that trains and then extracts, as ``learn_sanity``'s
    mesh evaluation, therefore extracts at ``high`` in JAX; the port's
    ``learn_sanity`` passes its trainer's resolved mode to the evaluation's
    config, so it extracts at ``high`` too. The trainer refuses ``fast``,
    as JAX does.
``EXACT`` sets all four to the exact path (``never`` / ``float32`` /
``highest``), the configuration the JAX goldens pin.

``coarse_sample`` / ``fine_sample`` are the samples per ray of the
render; under ``extract_geometry`` it reads ``test_sample_coarse`` /
``test_sample_fine`` in their place, as the JAX package does
(``models/uforecon.py:389-390``). ``test_coarse_only`` returns the coarse
pass as both outputs. The scan, view and checkpoint fields are those of the
JAX package's extract command (with ``test_general``, ``dataset`` and
``use_mask`` for GeneralFit, and ``extract_similarity``, ``sim_reso`` and
``sim_threshold`` for the similarity field), the training fields
(``logdir`` ... ``pair_file``, ``numdepth``) those of its training command,
with the same names and defaults; ``config_from_args`` parses every flag of
the JAX parser. Six of them are inert in the JAX package too and are
accepted and dropped: ``--test_dir``, ``--depth_dir``, ``--patch_size``,
``--sW``, ``--sH`` and ``--only_reference_frustum``
(``uforecon_tpu/config.py:7-15``).

The three render-glue knobs keep the JAX names, values and defaults
(``never``). In the JAX package ``auto`` means "on a TPU"; in the port
``auto`` and ``always`` both route to the kernel wrapper, which launches
the CUDA kernel for CUDA tensors and runs its plain version only for CPU
tensors:
  * ``fused_similarity``: the grouped cosine of the explicit-similarity
    query (``ops/fused_similarity.py``);
  * ``fused_volume_fusion``: the cross-view fusion of the correlation-
    volume samples (``ops/fused_volume_fusion.py``; the merged volume's
    query does not take it, as in JAX);
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
# the JAX package's exact path, which its goldens pin
EXACT = dict(volume_merge="never", volume_dtype="float32",
             image_gather_dtype="float32", kernel_precision="highest")


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
    test_general: bool = False           # GeneralFit in place of the DTU scans
    dataset: str = "dtu"                 # GeneralFit: blendedmvs | mvimage | ...
    use_mask: bool = False               # GeneralFit: apply masks/{vid}_mask.jpg
    extract_similarity: bool = False     # + the mean-similarity field's mesh
    sim_reso: int = 128
    sim_threshold: float = 0.99
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
    share_cr: bool = False               # one cost-regularisation net, base 8
    grad_method: str = "detach"          # detach | undetached

    # ---- model -------------------------------------------------------------
    # reference-shipped similarity semantics (see ray_transformer
    # query_similarity): both sides of each pair sample the view-i map
    sim_pair_quirk: bool = True
    fmt_layer_names: Tuple[str, ...] = ("self", "cross") * 4
    img_feat_dim: int = 32
    fea_volume_dim: int = 24             # 8ch x 3 cascade stages
    cos_n_group: int = 8
    explicit_similarity: bool = True
    volume_type: str = "correlation"     # correlation | featuregrid
    volume_reso: int = 96                # featuregrid side; 0: no volume
    mvs_depth_guide: int = 1             # <= 0: no depth guide, no depth PE
    depth_pos_encoding: bool = True
    use_dir_srdf: bool = False           # + view-direction PE (24)
    # precision policies (see the module docstring)
    compute_dtype: str = "float32"       # float32 | bfloat16
    encoder_dtype: str = ""              # "" (= compute_dtype) | float32 | bfloat16

    # ---- render-glue kernels (see the module docstring) ----------------
    fused_similarity: str = "never"      # auto | always | never
    fused_volume_fusion: str = "never"   # auto | always | never
    fused_neus_epilogue: str = "never"   # auto | never
    # per-point stage (see the module docstring)
    fused_point_head: str = "auto"       # auto | always | never
    point_head: str = "v1"               # v1 | v2

    # ---- evaluation approximations (see the module docstring) ------------
    volume_dtype: str = "bfloat16"       # float32 | bfloat16
    kernel_precision: str = "auto"       # auto | highest | high | fast
    volume_merge: str = "auto"           # auto | always | never
    merge_max_bytes: int = 6 << 30       # 'auto' falls back above; 0: no guard
    image_gather_dtype: str = "bfloat16"  # float32 | bfloat16
    merge_depth: int = 0                 # common-grid z-bins; 0 = ndepths[-1]
    merge_pad: bool = False              # the JAX pack's 256-lane rows (guard only)
    # ranks along the ray axis (parallel/sharding.py): extraction takes
    # min(mesh_shape[0], cards), training prod(mesh_shape) (cli/run.py)
    mesh_shape: Tuple[int, ...] = (1,)

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
            "volume_merge": ("auto", "always", "never"),
            "volume_dtype": ("float32", "bfloat16"),
            "image_gather_dtype": ("float32", "bfloat16"),
            "kernel_precision": ("auto", "highest", "high", "fast"),
            "volume_type": ("correlation", "featuregrid"),
            "grad_method": ("detach", "undetached"),
            "compute_dtype": ("float32", "bfloat16"),
            "encoder_dtype": ("", "float32", "bfloat16"),
        }
        for field, values in allowed.items():
            v = getattr(self, field)
            if v not in values:
                raise ValueError(f"Config.{field}={v!r} not in {values}")
        if self.fused_point_head == "always" and not self.full_point_features:
            raise ValueError("fused_point_head='always' needs the point-head "
                             "kernel's full feature set (a volume, explicit "
                             "similarity, depth PE, no use_dir_srdf); use 'auto' to "
                             "allow the view-transformer route")
        if len(self.ndepths) != 3:
            raise ValueError(f"the cascade has 3 stages, got ndepths={self.ndepths}")
        if len(self.depth_inter_r) != len(self.ndepths) or \
                len(self.cr_base_chs) != len(self.ndepths):
            raise ValueError("depth_inter_r and cr_base_chs need one entry per stage")

    @property
    def dtype(self):
        """The torch dtype of the volume head and the ray transformer."""
        import torch
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def encoder_torch_dtype(self):
        """The torch dtype of the cascade matcher: ``encoder_dtype``, or
        ``compute_dtype`` where it is empty."""
        import torch
        dt = self.encoder_dtype or self.compute_dtype
        return torch.bfloat16 if dt == "bfloat16" else torch.float32

    # dims that the ray transformer sees (JAX config.py:274-304)
    @property
    def correlation_volume(self) -> bool:
        """Does encode build the per-stage correlation volumes?"""
        return self.volume_type == "correlation" and self.volume_reso > 0

    @property
    def feature_grid(self) -> bool:
        """Does encode build the featuregrid volume?"""
        return self.volume_type == "featuregrid" and self.volume_reso > 0

    @property
    def effective_fea_volume_dim(self) -> int:
        """Volume features per point: 0 without a volume, 16 from the
        feature grid's U-Net, ``fea_volume_dim`` (8 x stages) from the
        correlation volumes."""
        if self.volume_reso <= 0:
            return 0
        return 16 if self.feature_grid else self.fea_volume_dim

    @property
    def sim_feat_fix(self) -> int:
        return 16 if self.explicit_similarity else 0   # pre-similarity MLP output

    @property
    def depth_guide(self) -> bool:
        """Do the points carry the NeRF PE of their MVS depth distance?"""
        return self.mvs_depth_guide > 0 and self.depth_pos_encoding

    @property
    def depth_dim(self) -> int:
        return 8 if self.depth_guide else 0   # NeRF PE, num_freqs=4

    @property
    def dir_dim(self) -> int:
        """The view-direction PE: 4 frequencies x sin, cos x 3, without the
        raw direction. The JAX config says 27 (with it); the JAX model
        builds 24 (``models/ray_transformer.py:346-357``: 27 would give a
        prime width no head count divides), and this follows the model."""
        return 24 if self.use_dir_srdf else 0

    @property
    def full_point_features(self) -> bool:
        """Has every point the point-head kernel's full feature set (the JAX
        gate, ``models/ray_transformer.py:505-521``)?"""
        return (self.volume_reso > 0 and self.explicit_similarity
                and self.depth_guide and not self.use_dir_srdf)

    @property
    def view_trans_dim(self) -> int:
        return (self.img_feat_dim + self.effective_fea_volume_dim + self.sim_feat_fix
                + self.depth_dim + self.dir_dim)

    @property
    def ray_trans_dim(self) -> int:
        return self.view_trans_dim + 8  # + order PE width


def resolve_kernel_precision(cfg: Config) -> str:
    """The head kernels' precision for a model of ``cfg``: ``auto`` gives
    ``fast`` under ``extract_geometry`` and ``high`` otherwise, as the JAX
    package's ``UFORecon.setup`` does (``models/uforecon.py:79-90``), per
    model rather than per process."""
    if cfg.kernel_precision != "auto":
        return cfg.kernel_precision
    return "fast" if cfg.extract_geometry else "high"


def merge_guard_bytes(cfg: Config, nv: int, h: int, w: int) -> int:
    """The JAX package's byte count of a merged volume, corner-packed as it
    stores it (``models/uforecon.py:158-168``): nv x d_m x h x w x 8 corners
    x (32 lanes with ``merge_pad``, else 8 features per stage + the weight)
    x the bytes of ``volume_dtype``."""
    d_m = cfg.merge_depth or cfg.ndepths[-1]
    c_pack = 8 * (32 if cfg.merge_pad else 8 * len(cfg.ndepths) + 1)
    return nv * d_m * h * w * c_pack * (4 if cfg.volume_dtype == "float32" else 2)


def use_volume_merge(cfg: Config, nv: int, h: int, w: int) -> bool:
    """Does ``encode`` merge the stage volumes of nv views at h x w? The JAX
    decision (``models/uforecon.py:156-170``): only correlation volumes
    merge; ``always``, or ``auto`` under ``extract_geometry``, unless
    ``merge_guard_bytes`` exceeds ``merge_max_bytes`` (0 turns the guard
    off)."""
    if not cfg.correlation_volume:
        return False
    use = cfg.volume_merge == "always" or (cfg.volume_merge == "auto"
                                           and cfg.extract_geometry)
    if use and cfg.volume_merge == "auto" and cfg.merge_max_bytes:
        return merge_guard_bytes(cfg, nv, h, w) <= cfg.merge_max_bytes
    return use


def _ints(s) -> Tuple[int, ...]:
    return tuple(int(x) for x in str(s).split(",") if x)


def _floats(s) -> Tuple[float, ...]:
    return tuple(float(x) for x in str(s).split(",") if x)


# flag sets of the JAX package's CLI that select a model or a path the port
# does not have: (test on the parsed flags, message naming the flag)
_UNSUPPORTED = (
    (lambda a: a.volume_type not in ("correlation", "featuregrid"),
     "--volume_type {a.volume_type}: the JAX package builds correlation or "
     "featuregrid volumes"),
)


def config_from_args(argv=None) -> Tuple["Config", str]:
    """Parse the JAX package's flags (``uforecon_tpu/config.py:352``
    ``config_from_args``: the same names and defaults), those of extraction
    (``--extract_geometry``) and of training (without it), plus
    ``--device`` and the evaluation approximations' fields
    (``--volume_merge`` ... ``--kernel_precision``, default as in
    ``Config``), which stand in for the JAX package's ``UFO_*``
    environment overrides; ``--volume_merge never --volume_dtype float32
    --image_gather_dtype float32 --kernel_precision highest`` is the exact
    path.

    Returns the Config and the device. Raises ``ValueError``, naming the
    flag, on a flag set that selects a path the port does not have (an
    unknown ``--volume_type``), rather than running its default model; ``Config`` raises on an unknown
    ``--grad_method``, ``--compute_dtype`` or ``--encoder_dtype``. Every
    model configuration and precision policy trains and extracts."""
    import argparse

    p = argparse.ArgumentParser(
        "uforecon_tpu_torch.cli.run",
        description="Train on DTU, or with --extract_geometry render the depth "
                    "maps of DTU scans or (--test_general) of a custom capture, "
                    "on a CUDA card.")
    d = Config()
    p.add_argument("--dataset", type=str, default=d.dataset,
                   help="GeneralFit's layout: blendedmvs; any other value reads "
                        "images/{vid:08d}.jpg at 960x544 (mvimage also fixes "
                        "near/far to 400/900)")
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
    p.add_argument("--use_mask", action="store_true")
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--max_epochs", type=int, default=d.max_epochs)
    p.add_argument("--uforecon_lr", type=float, default=d.uforecon_lr)
    p.add_argument("--weight_rgb", type=float, default=d.weight_rgb)
    p.add_argument("--weight_depth", type=float, default=d.weight_depth)
    p.add_argument("--train_n_view", type=int, default=d.train_n_view)
    p.add_argument("--view_selection_type", type=str, default=d.view_selection_type)
    p.add_argument("--val_only", action="store_true")
    p.add_argument("--depth_dir", type=str, default=None, help="accepted and unused")
    p.add_argument("--train_ray_num", type=int, default=d.train_ray_num)
    p.add_argument("--coarse_sample", type=int, default=d.coarse_sample)
    p.add_argument("--fine_sample", type=int, default=d.fine_sample)
    p.add_argument("--train_list", type=str, default=d.train_list)
    p.add_argument("--val_list", type=str, default=d.val_list)
    p.add_argument("--pair_file", type=str, default=d.pair_file)
    p.add_argument("--numdepth", type=int, default=d.numdepth)
    p.add_argument("--test_sample_coarse", type=int, default=d.test_sample_coarse)
    p.add_argument("--test_sample_fine", type=int, default=d.test_sample_fine)
    p.add_argument("--patch_size", type=int, default=1, help="accepted and unused")
    p.add_argument("--sW", type=int, default=1, help="accepted and unused")
    p.add_argument("--sH", type=int, default=1, help="accepted and unused")
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
    p.add_argument("--sim_reso", type=int, default=d.sim_reso)
    p.add_argument("--sim_threshold", type=float, default=d.sim_threshold)
    p.add_argument("--test_dir", type=str, default="", help="accepted and unused")
    p.add_argument("--ndepths", type=str, default="48,32,8")
    p.add_argument("--depth_inter_r", type=str, default="4,2,1")
    p.add_argument("--cr_base_chs", type=str, default="8,8,8")
    p.add_argument("--share_cr", action="store_true")
    p.add_argument("--grad_method", type=str, default="detach")
    p.add_argument("--volume_type", type=str, default="correlation")
    p.add_argument("--volume_reso", type=int, default=96)
    p.add_argument("--mvs_depth_guide", type=int, default=1)
    p.add_argument("--depth_pos_encoding", action="store_true")
    p.add_argument("--explicit_similarity", action="store_true",
                   help="without it: the paper's ablation without explicit "
                        "similarity, as in the JAX package")
    p.add_argument("--use_dir_srdf", action="store_true")
    p.add_argument("--only_reference_frustum", action="store_true",
                   help="accepted and unused")
    p.add_argument("--compute_dtype", type=str, default="float32")
    p.add_argument("--encoder_dtype", type=str, default="")
    p.add_argument("--mesh_shape", type=str, default="1")
    p.add_argument("--volume_merge", choices=("auto", "always", "never"),
                   default=d.volume_merge)
    p.add_argument("--merge_depth", type=int, default=d.merge_depth)
    p.add_argument("--merge_pad", action="store_true",
                   help="count the JAX package's 256-lane rows in the merge guard")
    p.add_argument("--merge_max_bytes", type=int, default=d.merge_max_bytes)
    p.add_argument("--volume_dtype", choices=("float32", "bfloat16"),
                   default=d.volume_dtype)
    p.add_argument("--image_gather_dtype", choices=("float32", "bfloat16"),
                   default=d.image_gather_dtype)
    p.add_argument("--kernel_precision", choices=("auto", "highest", "high", "fast"),
                   default=d.kernel_precision)
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
        test_general=a.test_general, dataset=a.dataset, use_mask=a.use_mask,
        extract_similarity=a.extract_similarity, sim_reso=a.sim_reso,
        sim_threshold=a.sim_threshold,
        test_n_view=a.test_n_view, test_ref_view=tuple(a.test_ref_view),
        test_scan=a.test_scan, set=a.set, test_coarse_only=a.test_coarse_only,
        img_wh=tuple(a.img_wh), ndepths=_ints(a.ndepths),
        depth_inter_r=_floats(a.depth_inter_r), cr_base_chs=_ints(a.cr_base_chs),
        share_cr=a.share_cr, grad_method=a.grad_method,
        compute_dtype=a.compute_dtype, encoder_dtype=a.encoder_dtype,
        explicit_similarity=a.explicit_similarity, volume_type=a.volume_type,
        volume_reso=a.volume_reso, mvs_depth_guide=a.mvs_depth_guide,
        depth_pos_encoding=a.depth_pos_encoding, use_dir_srdf=a.use_dir_srdf,
        volume_merge=a.volume_merge, merge_depth=a.merge_depth, merge_pad=a.merge_pad,
        merge_max_bytes=a.merge_max_bytes, volume_dtype=a.volume_dtype,
        image_gather_dtype=a.image_gather_dtype, kernel_precision=a.kernel_precision,
        mesh_shape=_ints(a.mesh_shape))
    return cfg, a.device
