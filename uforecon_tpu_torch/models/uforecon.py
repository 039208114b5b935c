"""UFORecon top model: ``encode`` once per view set, ``render_chunk`` per
ray chunk.

Counterpart of the JAX package's ``models/uforecon.py`` (reference
code1/model.py:28-911), with its evaluation approximations
(``config.py``): the correlation volumes kept unpacked, per stage as
(NV, 9, D, h, w) (8 feature channels + the sigmoid weight) or merged into
one (NV, 25, D_m, H, W) volume per view (``ops/volume_merge.py``), stored
at ``volume_dtype``; gather sources at ``image_gather_dtype`` under
``extract_geometry``; the head kernels at ``kernel_precision``, resolved
per model (``UFORecon.kernel_precision``). Its model configurations too:
the ``featuregrid`` volume (``models/volumes.FeatureVolume``, one (16, Z,
Y, X) grid per view set, sampled at the world points with
``align_corners=False`` and zeros), no volume at ``volume_reso`` 0, no
depth guide without ``mvs_depth_guide`` / ``depth_pos_encoding``, and the
direction PE with ``use_dir_srdf``; and its precision policies: the
matcher in ``Config.encoder_torch_dtype``, the volume head and the ray
transformer in ``Config.dtype`` (``models/layers.set_compute_dtype``, the
JAX ``UFORecon.setup``'s ``enc_dtype`` / ``dtype``). Encode returns what
those modules give: under a bf16 matcher its stage-1 features and pair
maps come out of LayerNorms in float32 and its cost volumes in bf16, which
a float32 volume head takes as float32, as flax promotes them.

Gradients follow the caller's grad mode, as in training (``pipeline/
trainer.py``), with one cut: ``encode`` runs the cascade matcher without
gradients (the JAX package's ``stop_gradient``; the matcher is frozen in
render training), while the volume head (``mvs_volume``) and the NeuS
``variance`` stay trainable. Inference callers (``pipeline/extract.py``,
``pipeline/renderer.py``) run under ``torch.no_grad``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import warnings
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from ..config import Config, resolve_kernel_precision, use_volume_merge
from ..ops.camera import project_points_ndc
from ..ops.grid_sample import grid_sample_3d
from ..ops.rendering import neus_render
from ..ops.sampling import chunk_draws, sample_coarse, sample_importance
from ..ops.volume_merge import merge_stage_volumes
from .cascade import CascadeMatcher
from .layers import set_compute_dtype
from .ray_transformer import RayTransformer, query_correlation_volume, query_similarity
from .volumes import CostRegNetWeight, FeatureVolume


class SceneInputs(NamedTuple):
    """Per-scene tensors consumed by encode and render (one device)."""

    source_imgs: torch.Tensor      # (NV, H, W, 3)
    source_poses: torch.Tensor     # (NV, 4, 4) NDC projections
    src_cam_pos: torch.Tensor      # (NV, 3) camera centres
    ref_cam_pos: torch.Tensor      # (3,)
    src_w2cs: torch.Tensor         # (NV, 4, 4) scaled-scene w2c
    near: torch.Tensor             # () scene near
    far: torch.Tensor              # () scene far
    ray_o: torch.Tensor            # (3,) reference camera origin
    proj_matrices: Dict[str, torch.Tensor]  # stage -> (NV, 2, 4, 4), mm scale
    depth_values: torch.Tensor     # (D0,) hypotheses in mm
    scale_factor: torch.Tensor     # () 1 / scene radius


class EncoderOutputs(NamedTuple):
    source_feats: torch.Tensor               # (NV, h1, w1, 32)
    # stage -> (NV, 9, D, h, w), or {"merged": (NV, 25, D_m, H, W)}; {}
    # without correlation volumes
    volumes: Dict[str, torch.Tensor]
    aug0: torch.Tensor                       # (P, h1, w1, 32)
    aug1: torch.Tensor
    mvs_depths: torch.Tensor                 # (NV, H, W) scaled to the scene
    fea_grid: Optional[torch.Tensor] = None  # (16, Z, Y, X): featuregrid only


@contextlib.contextmanager
def _deterministic_cudnn():
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


class UFORecon(nn.Module):
    """Generalisable sparse-view SRDF reconstruction model."""

    def __init__(self, cfg: Config):
        super().__init__()
        # full-f32 matmuls and convolutions on the card: cuDNN's TF32 is on
        # by default and would make the convolutions inexact
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = c = cfg
        self.matcher = CascadeMatcher(
            ndepths=c.ndepths, depth_intervals_ratio=c.depth_inter_r,
            cr_base_chs=c.cr_base_chs, fmt_layer_names=c.fmt_layer_names,
            grad_method=c.grad_method, share_cr=c.share_cr)
        set_compute_dtype(self.matcher, c.encoder_torch_dtype)
        if c.correlation_volume:
            self.mvs_volume = CostRegNetWeight(1, base_channels=8)
            set_compute_dtype(self.mvs_volume, c.dtype)
        elif c.feature_grid:
            self.feature_volume = FeatureVolume(c.volume_reso, cin=c.img_feat_dim)
            set_compute_dtype(self.feature_volume, c.dtype)
        self.ray_transformer = RayTransformer(
            img_feat_dim=c.img_feat_dim, fea_volume_dim=c.effective_fea_volume_dim,
            sim_feat_fix=c.sim_feat_fix, depth_dim=c.depth_dim,
            use_dir_srdf=c.use_dir_srdf, dtype=c.dtype)
        set_compute_dtype(self.ray_transformer, c.dtype)
        # NeuS deviation scalar (reference single_variance_network.py:5-11)
        self.variance = nn.Parameter(torch.tensor(0.3))
        self.eval()

    def with_knobs(self, **knobs) -> "UFORecon":
        """A shallow copy sharing this model's modules and weights, with
        those ``cfg`` fields replaced (e.g. ``**config.FUSED_GLUE``,
        ``**config.EXACT``)."""
        other = copy.copy(self)
        other.cfg = dataclasses.replace(self.cfg, **knobs)
        return other

    @property
    def kernel_precision(self) -> str:
        """The head kernels' precision, resolved from ``cfg``
        (``config.resolve_kernel_precision``)."""
        return resolve_kernel_precision(self.cfg)

    # ------------------------------------------------------------------
    def encode(self, scene: SceneInputs, train: bool = False) -> EncoderOutputs:
        """The view set's encoding; ``train`` runs the matcher's BatchNorms
        on batch statistics (render training keeps them on their running
        statistics, as JAX does). The correlation volume head runs per
        stage and view rotation; with ``config.use_volume_merge`` the stage
        volumes are merged, else each is stored at ``volume_dtype``.
        ``auto`` leaves the merge only by the JAX byte guard, with a
        warning. The featuregrid path builds its grid instead; at
        ``volume_reso`` 0 there is no volume. cuDNN takes deterministic
        algorithms here (its backward, in training, the ones it picks):
        otherwise a transposed 3D convolution of the volume head may add
        with atomics, and two encodings of one view differ in their last
        bits (seen on an H100), which the fine pass can turn into
        millimetres of depth."""
        with _deterministic_cudnn():
            return self._encode(scene, train)

    def _encode(self, scene: SceneInputs, train: bool) -> EncoderOutputs:
        c = self.cfg
        nv, h, w = scene.source_imgs.shape[:3]
        if h % 32 or w % 32:
            raise ValueError(f"image dims must be multiples of 32, got {h}x{w}")
        with torch.no_grad():
            enc = self.matcher(scene.source_imgs, scene.proj_matrices,
                               scene.depth_values, train)
        outs = dict(source_feats=enc["feat_stage1"], volumes={}, aug0=enc["aug0"],
                    aug1=enc["aug1"], mvs_depths=enc["mvs_depth"] * scene.scale_factor)
        if not c.correlation_volume:
            if c.feature_grid:
                outs["fea_grid"] = self.feature_volume(enc["feat_stage1"],
                                                       scene.source_poses, train)
            return EncoderOutputs(**outs)
        fws = {}
        for stage, cv in enc["cost_volumes"].items():   # (NV, D, h, w)
            fw = []
            for r in range(cv.shape[0]):
                f, wgt = self.mvs_volume(cv[r][None, None])
                fw.append(torch.cat([f, wgt], dim=1)[0])
            fws[stage] = torch.stack(fw)
        dtype = torch.float32 if c.volume_dtype == "float32" else torch.bfloat16
        merge = use_volume_merge(c, nv, h, w)
        if c.volume_merge == "auto" and c.extract_geometry and not merge:
            warnings.warn(f"volume_merge='auto': the merged volume of {nv} views at "
                          f"{w}x{h} exceeds merge_max_bytes={c.merge_max_bytes}; "
                          "querying the per-stage volumes", stacklevel=3)
        if merge:
            volumes = {"merged": merge_stage_volumes(
                fws, c.merge_depth or c.ndepths[-1], (h, w), dtype)}
        else:
            volumes = {stage: fw.to(dtype) for stage, fw in fws.items()}
        return EncoderOutputs(**{**outs, "volumes": volumes})

    # ------------------------------------------------------------------
    def _point_features(self, scene: SceneInputs, enc: EncoderOutputs,
                        points: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-point half of sample2rgb (model.py:308-332)."""
        c = self.cfg
        nv = scene.source_imgs.shape[0]
        # bf16 image-gather sources on the extract path only (JAX
        # models/uforecon.py:121,297-301)
        gather_dtype = (torch.bfloat16 if c.image_gather_dtype == "bfloat16"
                        and c.extract_geometry else torch.float32)
        if c.explicit_similarity:
            sim_feat, xy, valid = query_similarity(
                points, scene.source_poses, enc.aug0, enc.aug1, nv,
                n_groups=c.cos_n_group, pair_quirk=c.sim_pair_quirk,
                fused=c.fused_similarity, source_dtype=gather_dtype)
        else:
            sim_feat = None
            xy, _, valid = project_points_ndc(scene.source_poses, points)
        fea_volume_feat = None
        if c.correlation_volume:
            fea_volume_feat = query_correlation_volume(
                points, scene.source_poses, enc.volumes, (scene.near, scene.far),
                fused=c.fused_volume_fusion)
        elif enc.fea_grid is not None:
            fea_volume_feat = grid_sample_3d(enc.fea_grid[None], points[None],
                                             align_corners=False, padding_mode="zeros")[0]
        return self.ray_transformer.per_point(
            points=points, source_imgs=scene.source_imgs,
            source_feats=enc.source_feats, ref_cam_pos=scene.ref_cam_pos,
            src_cam_pos=scene.src_cam_pos, src_w2cs=scene.src_w2cs,
            points_xy=xy, valid_depth=valid, fea_volume_feat=fea_volume_feat,
            sim_feat=sim_feat, mvs_depths=enc.mvs_depths if c.depth_guide else None,
            fused=c.fused_point_head, point_head=c.point_head,
            precision=self.kernel_precision, source_dtype=gather_dtype)

    def _render_sequence(self, z_val: torch.Tensor,
                         pp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Ray transformer -> SRDF -> NeuS compositing (model.py:332-348),
        in one kernel when ``fused_neus_epilogue`` is 'auto'."""
        inv_s = torch.exp(self.variance * 10.0)
        if (self.cfg.fused_neus_epilogue == "auto"
                and self.ray_transformer.fused_ray_ok):
            return self.ray_transformer.along_ray_neus(
                pp["token"], z_val, pp["radiance"], inv_s, self.kernel_precision)
        srdf = self.ray_transformer.along_ray(pp["token"], self.kernel_precision)
        out = neus_render(z_val, pp["radiance"], srdf, inv_s)
        out["srdf"] = srdf
        return out

    # ------------------------------------------------------------------
    def render_chunk(
        self,
        scene: SceneInputs,
        enc: EncoderOutputs,
        ray_d: torch.Tensor,                        # (RN, 3) NDC-space directions
        generator: Optional[torch.Generator] = None,
        near_per_ray: Optional[torch.Tensor] = None,  # (RN,), else scene near
        far_per_ray: Optional[torch.Tensor] = None,
        u_coarse: Optional[torch.Tensor] = None,    # (RN, n_coarse) uniform
        u_fine: Optional[torch.Tensor] = None,      # (RN, n_fine) draws
        coarse_only: bool = False,
    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Coarse + importance-sampled fine rendering of one ray chunk
        (reference model.py:393-482), ``cfg.samples`` points per ray. Draws
        not given come from ``generator`` (``chunk_draws``). ``coarse_only``
        returns the coarse pass as both outputs."""
        n_coarse, n_fine = self.cfg.samples
        rn = ray_d.shape[0]
        if u_coarse is None and u_fine is None:
            u_coarse, u_fine = chunk_draws(rn, self.cfg.samples, generator, ray_d.device,
                                           coarse_only)
        ray_o = scene.ray_o.expand(rn, 3)
        near = near_per_ray if near_per_ray is not None else scene.near.expand(rn)
        far = far_per_ray if far_per_ray is not None else scene.far.expand(rn)

        points, z_val = sample_coarse(ray_o, ray_d, n_coarse, near, far,
                                      u=u_coarse, generator=generator)
        pp_c = self._point_features(scene, enc, points)
        out_c = self._render_sequence(z_val, pp_c)
        if coarse_only:
            return {"coarse": out_c, "fine": out_c}

        points_f, z2 = sample_importance(ray_o, ray_d, out_c["weight"].detach(),
                                         z_val.detach(), n_fine, u=u_fine,
                                         generator=generator)
        # the per-point stage is sample-independent: only the new fine
        # points are evaluated, and the merge by z is a permutation of the
        # coarse and fine outputs
        pp_f = self._point_features(scene, enc, points_f)
        z_cat = torch.cat([z_val, z2], dim=1)
        z_all, order = torch.sort(z_cat, dim=1, stable=True)
        cat = torch.cat([
            torch.cat([pp_c["token"], pp_c["radiance"]], dim=-1),
            torch.cat([pp_f["token"], pp_f["radiance"]], dim=-1)], dim=1)
        cat = torch.gather(cat, 1, order[..., None].expand(-1, -1, cat.shape[-1]))
        d_tok = pp_c["token"].shape[-1]
        pp_all = {"token": cat[..., :d_tok], "radiance": cat[..., d_tok:]}
        return {"coarse": out_c, "fine": self._render_sequence(z_all, pp_all)}
