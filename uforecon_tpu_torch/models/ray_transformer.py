"""RayTransformer: per-point view aggregation + along-ray SRDF head.

Counterpart of the JAX package's ``models/ray_transformer.py`` (reference
code1/ray_transformer.py:86-331). Per sample point it fuses sampled image
features (32), volume features (24 from the correlation volumes, 16 from
the feature grid, none at ``volume_reso`` 0), pairwise similarity
(8 cosine groups -> 16 through pre_sim_mlp; absent without explicit
similarity), the NeRF PE of the MVS depth distance (8; absent without the
depth guide or its PE) and, with ``use_dir_srdf``, the NeRF PE of each
view's relative direction (24: 4 frequencies, without the raw direction,
as the JAX model builds it); a view token runs through a linear-attention
view transformer, a ray transformer runs along the sample axis, an SRDF
MLP follows, and the radiance is a masked softmax blend over views.

``per_point`` takes one of two routes, by the JAX package's gate
(``_fused_ok``) and the ``fused_point_head`` knob: the point head, which
needs the full feature set (a volume of either kind, similarity, depth PE,
no direction PE), or the view-transformer modules, whose attention goes to
the tiny-attention kernels (``ops/tiny_attention.py``).
The point head is the point-head kernel wrapper
(``ops/fused_point_head.py``) or, with ``point_head='v2'``, the
split-weight point head (``ops/fused_point_head2.py``) on the same inputs
and weights. ``along_ray`` always
goes through the ray-head wrapper (``ops/fused_ray_head.py``). Each wrapper
runs its CUDA kernel on CUDA tensors and its plain version on CPU tensors.
The submodules hold the weights under their flax names.

``fused`` of ``query_similarity`` / ``query_correlation_volume`` takes the
Config knob's values: ``auto`` and ``always`` route the query's tail to the
kernel wrapper (``ops/fused_similarity.py``, ``ops/fused_volume_fusion.py``),
``never`` to its plain version. A merged volume
(``Config.volume_merge``) is queried by ``ops/volume_merge.
query_merged_volume``, which needs no fusion kernel, as in JAX.

The ray transformer computes in ``dtype`` (``Config.compute_dtype``;
its cast layers are set by ``UFORecon``). JAX's gates run the point-head
and ray-head kernels in float32 only (``_fused_ok``, ``_fused_ray_ok``):
a bf16 ray transformer takes the view transformer (its tiny attention in
float32 on the kernels, cast back) and runs the ray stage through its
modules, with no kernel, as JAX does.

``precision`` (the resolved ``Config.kernel_precision``) goes to the head
wrappers; ``source_dtype`` (``Config.image_gather_dtype`` on the extract
path) is the type the pair maps, image features and rgb||depth are
sampled from.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.camera import project_points_ndc
from ..ops.fused_point_head import PointHeadInputs, PointHeadParams
from ..ops.fused_point_head import point_head as point_head_v1
from ..ops.fused_point_head2 import point_head2
from ..ops.fused_ray_head import RayHeadParams, ray_head, ray_head_neus
from ..ops.fused_similarity import grouped_cosine, grouped_cosine_reference, view_pairs
from ..ops.fused_volume_fusion import volume_fusion, volume_fusion_reference
from ..ops.grid_sample import grid_sample_2d, grid_sample_3d, in_bounds_mask
from ..ops.posenc import nerf_posenc, order_posenc
from ..ops.volume_merge import query_merged_volume
from .attention import LocalFeatureTransformer
from .layers import MLP, softmax


def query_correlation_volume(
    points: torch.Tensor,                 # (RN, SN, 3) world points
    source_poses: torch.Tensor,           # (NV, 4, 4) NDC projections
    volumes: Dict[str, torch.Tensor],     # stage -> (NV, 9, D, h, w) feat||weight
    near_far: Tuple[torch.Tensor, torch.Tensor],
    fused: str = "never",
) -> torch.Tensor:
    """Weighted cross-view fusion of the per-stage frustum features
    (reference model.py:350-390): G = sum_n f_n w_n / sum_n w_n, with the
    8 channels of every stage concatenated. ``volumes`` may instead hold
    one ``"merged"`` volume (JAX ``:83-91``). Returns (RN, SN, 8 * stages)."""
    _, xyz, _ = project_points_ndc(source_poses, points, near_far=near_far)
    if "merged" in volumes:
        return query_merged_volume(volumes["merged"], xyz)
    fws = [grid_sample_3d(vol, xyz, align_corners=True, padding_mode="zeros")
           for vol in volumes.values()]                       # (NV, RN, SN, 9)
    if fused == "never":
        return volume_fusion_reference(fws)
    nv, lead = fws[0].shape[0], fws[0].shape[1:-1]
    # views of the sampler's channel-first output: the kernel reads them
    # without a copy
    flat = [fw.reshape(nv, -1, fw.shape[-1]) for fw in fws]
    return volume_fusion(*flat).reshape(*lead, -1)


def build_pair_maps(aug0: torch.Tensor, aug1: torch.Tensor, n_views: int,
                    pair_quirk: bool = True) -> torch.Tensor:
    """Per-view channel concat of every pair map the view takes part in, in
    pair order (the slots of ``ops/fused_similarity.pair_slots``). Returns
    (NV, h, w, (NV-1)C)."""
    maps = [[] for _ in range(n_views)]
    for p, (i, j) in enumerate(view_pairs(n_views)):
        maps[i].append(aug0[p])
        maps[j].append(aug0[p] if pair_quirk else aug1[p])
    return torch.stack([torch.cat(m, dim=-1) for m in maps])


def query_similarity(
    points: torch.Tensor,        # (RN, SN, 3)
    source_poses: torch.Tensor,  # (NV, 4, 4)
    aug0: torch.Tensor,          # (P, h, w, C) pair-match features, view i
    aug1: torch.Tensor,          # (P, h, w, C) pair-match features, view j
    n_views: int,
    n_groups: int = 8,
    pair_quirk: bool = True,
    fused: str = "never",
    source_dtype: torch.dtype = torch.float32,
):
    """Explicit pairwise feature similarity (reference model.py:218-305).

    For each pair (i, j) the view-i map is sampled at the projection into
    view i and the view-j map at the projection into view j
    (align_corners=True, border), channels split into ``n_groups``, cosine
    per group, mean over pairs. ``pair_quirk`` reproduces the reference's
    FMT cross mode, which hands view j the pair's view-i map. The maps are
    sampled from ``source_dtype`` values (JAX ``:205-212``).

    Returns (feat_info (..., n_groups), xy (NV, ..., 2), valid (NV, ...)).
    """
    if n_views < 2:
        raise ValueError(f"explicit similarity needs >= 2 views, got {n_views}")
    xy, _, valid = project_points_ndc(source_poses, points)
    merged = build_pair_maps(aug0, aug1, n_views, pair_quirk).to(source_dtype)
    sampled = grid_sample_2d(merged, xy, align_corners=True, padding_mode="border")
    # a view of the sampler's channel-first output: the kernel reads it
    # without a copy
    flat = sampled.reshape(n_views, -1, sampled.shape[-1])
    cosine = grouped_cosine_reference if fused == "never" else grouped_cosine
    feat = cosine(flat, n_groups).reshape(*sampled.shape[1:-1], n_groups)
    return feat, xy, valid


@functools.lru_cache(maxsize=16)
def _order_pe(d: int, sn: int, device: torch.device) -> torch.Tensor:
    """``order_posenc(d, sn)`` on ``device``, built once per (d, SN,
    device): the ray head's input takes it on every call."""
    return torch.as_tensor(order_posenc(d, sn), device=device)


class RayTransformer(nn.Module):
    """View + ray linear-attention SRDF head, split into ``per_point``
    (independent across samples, so the fine pass runs it on the new
    samples only) and ``along_ray`` (over a z-sorted sequence)."""

    def __init__(self, img_feat_dim: int = 32, fea_volume_dim: int = 24,
                 sim_feat_fix: int = 16, depth_dim: int = 8, use_dir_srdf: bool = False,
                 pe_d_hid: int = 8, n_heads: int = 8, sim_feat_dim: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.img_feat_dim = img_feat_dim
        self.fea_volume_dim = fea_volume_dim
        self.sim_feat_fix = sim_feat_fix
        self.depth_dim = depth_dim
        self.use_dir_srdf = use_dir_srdf
        self.pe_d_hid = pe_d_hid
        self.n_heads = n_heads
        d = self.d_view
        # as in flax, no pre-similarity weights without explicit similarity
        if sim_feat_fix > 0:
            self.pre_sim_mlp = MLP(sim_feat_dim, (32, 32, sim_feat_fix))
        self.density_view_transformer = LocalFeatureTransformer(d, n_heads)
        self.density_ray_transformer = LocalFeatureTransformer(d + pe_d_hid, n_heads)
        self.density_mlp = MLP(d + pe_d_hid, (32, 16, 1))
        self.linear_radianceweight_1_softmax = MLP(d + 3, (16, 8, 1))
        self.view_token = nn.Parameter(torch.zeros(1, d))

    @property
    def d_view(self) -> int:
        d = self.img_feat_dim + self.fea_volume_dim + self.sim_feat_fix + self.depth_dim
        return d + 24 if self.use_dir_srdf else d   # the direction PE

    def per_point(
        self,
        points: torch.Tensor,              # (RN, SN, 3)
        source_imgs: torch.Tensor,         # (NV, H, W, 3)
        source_feats: torch.Tensor,        # (NV, h1, w1, C)
        ref_cam_pos: torch.Tensor,         # (3,)
        src_cam_pos: torch.Tensor,         # (NV, 3)
        src_w2cs: torch.Tensor,            # (NV, 4, 4)
        points_xy: torch.Tensor,           # (NV, RN, SN, 2)
        valid_depth: torch.Tensor,         # (NV, RN, SN)
        fea_volume_feat: Optional[torch.Tensor],  # (RN, SN, Dv); None: no volume
        sim_feat: Optional[torch.Tensor],  # (RN, SN, 8); None without similarity
        mvs_depths: Optional[torch.Tensor],  # (NV, H, W); None: no depth PE
        fused: str = "auto",               # Config.fused_point_head
        point_head: str = "v1",            # Config.point_head
        precision: str = "high",           # resolved Config.kernel_precision
        source_dtype: torch.dtype = torch.float32,  # image-gather sources
    ) -> Dict[str, torch.Tensor]:
        """Gathers the per-point features (image features and rgb||depth
        from ``source_dtype`` sources, JAX ``:414-440``) and runs the point
        head (v1, or v2 by ``point_head``, at ``precision``) or the view
        transformer (``_fused_ok``). Returns ``token`` (RN, SN, C) and
        ``radiance`` (RN, SN, 3)."""
        rn, sn, _ = points.shape
        nv = source_imgs.shape[0]
        n = rn * sn

        v1 = points[None] - ref_cam_pos.reshape(1, 1, 1, 3)
        v2 = points[None] - src_cam_pos.reshape(nv, 1, 1, 3)
        v1 = v1 / torch.linalg.norm(v1, dim=-1, keepdim=True)
        v2 = v2 / torch.linalg.norm(v2, dim=-1, keepdim=True)
        dir_relative = v1 - v2                                  # (NV, RN, SN, 3)

        img_feat = grid_sample_2d(source_feats.to(source_dtype),
                                  points_xy)                    # (NV, RN, SN, C)
        # rgb and the depth guide share the resolution and the grid
        rgb_src = source_imgs
        if mvs_depths is not None:
            rgb_src = torch.cat([source_imgs, mvs_depths[..., None]], dim=-1)
        rgbd = grid_sample_2d(rgb_src.to(source_dtype), points_xy)
        mask = in_bounds_mask(points_xy) * valid_depth          # (NV, RN, SN)
        depth_dist = None
        if mvs_depths is not None:
            cam = (torch.einsum("vij,rsj->vrsi", src_w2cs[:, :3, :3], points)
                   + src_w2cs[:, None, None, :3, 3])
            depth_dist = rgbd[..., 3] - cam[..., 2]             # (NV, RN, SN)

        if not self._fused_ok(fea_volume_feat, sim_feat, depth_dist, fused):
            return self._per_point_view_transformer(
                img_feat, fea_volume_feat, sim_feat, depth_dist, dir_relative,
                rgbd[..., :3], mask)
        head = point_head2 if point_head == "v2" else point_head_v1
        token, rad = head(
            PointHeadInputs(
                img_feat=img_feat.reshape(nv, n, -1),
                vol_feat=fea_volume_feat.reshape(n, -1),
                sim_feat=sim_feat.reshape(n, -1),
                depth_dist=depth_dist.reshape(nv, n),
                dir_rel=dir_relative.reshape(nv, n, 3),
                rgb=rgbd[..., :3].reshape(nv, n, 3),
                mask=mask.reshape(nv, n)),
            self.point_head_params(), self.n_heads, precision)
        return {"token": token.reshape(rn, sn, -1),
                "radiance": rad.reshape(rn, sn, 3)}

    def _fused_ok(self, fea_volume_feat, sim_feat, depth_dist, fused: str) -> bool:
        """Route the per-point stage to the point-head kernel? The JAX gate
        (``RayTransformer._fused_ok``): the kernel needs the full feature
        set (volume features, similarity, depth distance, no direction PE);
        ``auto`` takes it where it is there, ``always`` raises where it is
        not. The volume is either kind: the point-head kernels take the
        correlation volume's 24 features and the feature grid's 16."""
        if fused == "never":
            return False
        full = (fea_volume_feat is not None and sim_feat is not None
                and depth_dist is not None and not self.use_dir_srdf
                and self.dtype == torch.float32)
        if fused == "always" and not full:
            raise ValueError(
                "fused_point_head='always' but the point-head kernel's "
                "prerequisites are not met (needs volume + explicit similarity + "
                "depth PE features, use_dir_srdf off, float32 compute); use 'auto' to "
                "allow the view transformer")
        return full

    def _per_point_view_transformer(self, img_feat, fea_volume_feat, sim_feat,
                                    depth_dist, dir_relative, img_rgb, mask):
        """The per-point stage through the view-transformer modules (JAX
        ``per_point`` past its fused branch): (RN*SN, NV, C) view tokens
        (image features | volume | similarity | depth PE | direction PE,
        each where the configuration has it) after the view token, one
        LoFTR layer, then the masked radiance softmax."""
        nv, rn, sn, _ = img_feat.shape
        n = rn * sn

        def per_view(a):          # (NV, RN, SN, C) -> (RN*SN, NV, C)
            return a.permute(1, 2, 0, 3).reshape(n, nv, -1)

        def shared(a):            # (RN, SN, C) -> (RN*SN, NV, C)
            return a.reshape(n, 1, -1).expand(n, nv, -1)

        parts = [per_view(img_feat)]
        if fea_volume_feat is not None:
            parts.append(shared(fea_volume_feat))
        if sim_feat is not None:
            parts.append(shared(self.pre_sim_mlp(sim_feat)))
        if depth_dist is not None:
            parts.append(per_view(nerf_posenc(depth_dist[..., None], num_freqs=4)))
        if self.use_dir_srdf:
            parts.append(per_view(nerf_posenc(dir_relative, num_freqs=4,
                                              include_input=False)))
        x = torch.cat(parts, dim=-1)
        token = self.view_token.reshape(1, 1, -1).expand(n, 1, -1)
        x = self.density_view_transformer(torch.cat([token.to(x.dtype), x], dim=1))

        # radiance: masked softmax blend over views
        vf = x[:, 1:].reshape(rn, sn, nv, -1)
        xw = self.linear_radianceweight_1_softmax(
            torch.cat([vf, dir_relative.permute(1, 2, 0, 3)], dim=-1))
        m = mask.permute(1, 2, 0)[..., None]                     # (RN, SN, NV, 1)
        xw = torch.where(m == 0, torch.full_like(xw, -1e9), xw)
        w = softmax(xw, dim=-2)
        radiance = (img_rgb.permute(1, 2, 0, 3) * w).sum(dim=2)  # (RN, SN, 3)
        return {"token": x[:, 0].reshape(rn, sn, -1), "radiance": radiance}

    def point_head_params(self) -> PointHeadParams:
        lv = self.density_view_transformer.layer_0
        sp = self.pre_sim_mlp.layers()
        rp = self.linear_radianceweight_1_softmax.layers()
        return PointHeadParams(
            view_token=self.view_token.reshape(-1),
            wq=lv.q_proj.weight, wk=lv.k_proj.weight, wv=lv.v_proj.weight,
            wmerge=lv.merge.weight,
            norm1_scale=lv.norm1.weight, norm1_bias=lv.norm1.bias,
            w1=lv.mlp1.weight, w2=lv.mlp2.weight,
            norm2_scale=lv.norm2.weight, norm2_bias=lv.norm2.bias,
            sim_w=tuple(d.weight for d in sp), sim_b=tuple(d.bias for d in sp),
            rad_w=tuple(d.weight for d in rp), rad_b=tuple(d.bias for d in rp))

    def ray_head_params(self) -> RayHeadParams:
        lv = self.density_ray_transformer.layer_0
        dp = self.density_mlp.layers()
        return RayHeadParams(
            wq=lv.q_proj.weight, wk=lv.k_proj.weight, wv=lv.v_proj.weight,
            wmerge=lv.merge.weight,
            norm1_scale=lv.norm1.weight, norm1_bias=lv.norm1.bias,
            w1=lv.mlp1.weight, w2=lv.mlp2.weight,
            norm2_scale=lv.norm2.weight, norm2_bias=lv.norm2.bias,
            dens_w=tuple(d.weight for d in dp), dens_b=tuple(d.bias for d in dp))

    def _ray_input(self, token: torch.Tensor) -> torch.Tensor:
        """(RN, SN, C) tokens || the order PE, which indexes position in the
        sorted sequence."""
        rn, sn, _ = token.shape
        pe = _order_pe(self.pe_d_hid, sn, token.device)
        return torch.cat([token, pe.to(token.dtype)[None].expand(rn, sn, -1)], dim=-1)

    @property
    def fused_ray_ok(self) -> bool:
        """Does the ray stage take the ray-head kernels? JAX's
        ``_fused_ray_ok``: only in float32."""
        return self.dtype == torch.float32

    def along_ray(self, token: torch.Tensor, precision: str = "high") -> torch.Tensor:
        """Ray transformer over a z-sorted (RN, SN, C) sequence -> SRDF
        (RN, SN): the ray head at ``precision``, or, in bf16, the ray
        transformer's modules (SRDF in bf16, as JAX's flax path gives it)."""
        y = self._ray_input(token)
        if not self.fused_ray_ok:
            return self.density_mlp(self.density_ray_transformer(y))[..., 0]
        return ray_head(y, self.ray_head_params(), self.n_heads, precision)

    def along_ray_neus(self, token: torch.Tensor, z_val: torch.Tensor,
                       radiance: torch.Tensor, inv_s: torch.Tensor,
                       precision: str = "high") -> Dict[str, torch.Tensor]:
        """``along_ray`` + NeuS compositing through the epilogue kernel
        (``ray_head_neus``). Returns the ``neus_render`` dict plus ``srdf``."""
        srdf, weight, rgb, depth, opacity = ray_head_neus(
            self._ray_input(token), z_val, radiance, inv_s,
            self.ray_head_params(), self.n_heads, precision)
        return {"rgb": rgb, "depth": depth, "opacity": opacity, "weight": weight,
                "variance": 1.0 / inv_s, "srdf": srdf}
