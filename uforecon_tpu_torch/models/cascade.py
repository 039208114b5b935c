"""Cascade MVS depth estimation (TransMVSNet-style).

Counterpart of the JAX package's ``models/cascade.py`` (reference
code1/encoder_utils/fmt/TransMVSNet.py:23-242, module.py:329-707). Per
stage: depth hypotheses around the previous stage's winner-take-all depth,
homography warp of every source view over the hypotheses, correlation with
the reference view, per-view weights from PixelwiseNet, 3D U-Net
regularisation, softmax and winner-take-all. The whole encoder repeats
once per rotation of the view order, so that every view leads once.

``train`` is an explicit argument, as in the JAX module (not
``module.training``): with it the BatchNorms normalise with batch statistics
and move their running statistics once per call, as flax's mutable
``batch_stats`` do. With ``grad_method='detach'`` (the default) gradients
stop at each stage's depth before the next stage's hypotheses; with
``undetached`` they flow on, as in the JAX module. ``share_cr`` builds one
cost-regularisation U-Net at base 8 (``cost_reg_shared``) that every stage
calls, the JAX ``share_cr``; otherwise each stage has its own
(``cost_reg_{i}`` at ``cr_base_chs[i]``). Under a bf16 ``set_compute_dtype``
the warp grid and the hypotheses stay float32 (JAX computes the geometry in
float32 whatever the features' dtype: a bf16 pixel coordinate is ~2 px off
at W = 640); the correlation is float32 because the sampler returns
float32 from a bf16 source, as JAX's bf16 rows times float32 weights do.
Rotation 0's per-stage probability volumes and hypotheses are returned as
``rot0``: MVS pretraining supervises them.

Feature maps are channels-last (V, H, W, C) like the JAX module; cost
volumes and depth maps carry no channel axis.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.grid_sample import grid_sample_2d
from ..ops.resize import resize_linear, resize_nearest
from .layers import Conv3d, Conv3dBnRelu, Deconv3dBnRelu, sigmoid, softmax


# --------------------------------------------------------------------------
# Geometry: homography warping over depth hypotheses
# --------------------------------------------------------------------------


def combine_projection(proj: torch.Tensor) -> torch.Tensor:
    """(V, 2, 4, 4) [extrinsic, intrinsic] stacks -> (V, 4, 4) K @ E."""
    out = proj[:, 0].clone()
    out[:, :3, :4] = proj[:, 1, :3, :3] @ proj[:, 0, :3, :4]
    return out


def homo_warp_grid(src_proj: torch.Tensor, ref_proj: torch.Tensor,
                   depth_values: torch.Tensor) -> torch.Tensor:
    """Normalised (x, y) grid (D, H, W, 2) warping one source view onto the
    reference hypothesis planes; points behind the camera go to -99."""
    d, h, w = depth_values.shape
    dev = depth_values.device
    proj = src_proj @ torch.linalg.inv(ref_proj)
    rot, trans = proj[:3, :3], proj[:3, 3]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    xyz = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)          # (H, W, 3)
    rot_xyz = xyz @ rot.T
    proj_xyz = rot_xyz[None] * depth_values[..., None] + trans        # (D, H, W, 3)
    z = proj_xyz[..., 2]
    invalid = z < 1e-6
    xy = proj_xyz[..., :2] / torch.where(invalid, torch.ones_like(z), z)[..., None]
    gx = xy[..., 0] / ((w - 1) / 2.0) - 1.0
    gy = xy[..., 1] / ((h - 1) / 2.0) - 1.0
    gx = torch.where(invalid, torch.full_like(gx, -99.0), gx)
    gy = torch.where(invalid, torch.full_like(gy, -99.0), gy)
    return torch.stack([gx, gy], dim=-1)


def _correlate_chunked(src_feats: torch.Tensor,     # (V, H, W, C)
                       src_projs: torch.Tensor,     # (V, 4, 4)
                       ref_proj: torch.Tensor,      # (4, 4)
                       ref_feat: torch.Tensor,      # (H, W, C)
                       depth_values: torch.Tensor,  # (D, H, W)
                       target_elems: int = 1 << 26) -> torch.Tensor:
    """Warp + correlate: the channel mean of warped * ref, (V, D, H, W).
    The hypothesis axis is chunked so the warped features of one chunk
    hold at most ``target_elems`` values."""
    v, h, w, c = src_feats.shape
    d = depth_values.shape[0]
    dc = max(1, min(d, target_elems // max(v * h * w * c, 1)))
    out = []
    for d0 in range(0, d, dc):
        dv = depth_values[d0:d0 + dc]
        grids = torch.stack([homo_warp_grid(p, ref_proj, dv) for p in src_projs])
        n = dv.shape[0]
        warped = grid_sample_2d(src_feats, grids.reshape(v, n * h * w, 2),
                                align_corners=True, padding_mode="zeros")
        warped = warped.reshape(v, n, h, w, c)
        out.append(torch.mean(warped * ref_feat, dim=-1))
    return torch.cat(out, dim=1)


def depth_hypotheses_full(depth_min: torch.Tensor, depth_max: torch.Tensor,
                          ndepth: int) -> torch.Tensor:
    """Uniform (D,) hypotheses between the scene depth bounds (stage 1)."""
    i = torch.arange(ndepth, dtype=torch.float32, device=depth_min.device)
    return depth_min + i * ((depth_max - depth_min) / (ndepth - 1))


def depth_hypotheses_around(cur_depth: torch.Tensor, ndepth: int,
                            interval) -> torch.Tensor:
    """(D, H, W) hypotheses centred on the previous stage's depth map."""
    lo = cur_depth - ndepth / 2.0 * interval
    hi = cur_depth + ndepth / 2.0 * interval
    step = (hi - lo) / (ndepth - 1)
    i = torch.arange(ndepth, dtype=cur_depth.dtype, device=cur_depth.device)
    return lo[None] + i.view(-1, 1, 1) * step[None]


def resize_hypotheses(vol: torch.Tensor, out_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Trilinear resize of a (D, H, W) hypothesis volume; a shrinking depth
    axis is antialiased as ``jax.image.resize`` does."""
    return resize_linear(vol, out_shape)


def upsample_depth(depth: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Linear depth-map resize (``jax.image.resize`` semantics)."""
    return resize_linear(depth, out_hw)


def depth_wta(prob_volume: torch.Tensor, depth_values: torch.Tensor) -> torch.Tensor:
    """Winner-take-all depth: the hypothesis at the first argmax."""
    idx = torch.argmax(prob_volume, dim=0)
    return torch.gather(depth_values, 0, idx[None])[0]


# --------------------------------------------------------------------------
# Networks (channels-first)
# --------------------------------------------------------------------------


class PixelwiseNet(nn.Module):
    """Per-view weight head: 1x1x1 convs + sigmoid + max over depth."""

    def __init__(self):
        super().__init__()
        self.Conv3dBnRelu_0 = Conv3dBnRelu(1, 16, kernel=1)
        self.Conv3dBnRelu_1 = Conv3dBnRelu(16, 8, kernel=1)
        self.Conv_0 = Conv3d(8, 1, 1)

    def forward(self, sim: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(N, D, H, W) correlations -> (N, H, W) weights."""
        x = self.Conv3dBnRelu_1(self.Conv3dBnRelu_0(sim[:, None], train), train)
        x = sigmoid(self.Conv_0(x))
        return torch.amax(x, dim=2)[:, 0]


class CostRegNet(nn.Module):
    """3D U-Net cost regularisation: (N, Cin, D, H, W) -> (N, 1, D, H, W)."""

    def __init__(self, cin: int = 1, base_channels: int = 8):
        super().__init__()
        b = base_channels
        chans = [(cin, b, 1), (b, 2 * b, 2), (2 * b, 2 * b, 1), (2 * b, 4 * b, 2),
                 (4 * b, 4 * b, 1), (4 * b, 8 * b, 2), (8 * b, 8 * b, 1)]
        for i, (ci, co, s) in enumerate(chans):
            setattr(self, f"Conv3dBnRelu_{i}", Conv3dBnRelu(ci, co, stride=s))
        self.Deconv3dBnRelu_0 = Deconv3dBnRelu(8 * b, 4 * b)
        self.Deconv3dBnRelu_1 = Deconv3dBnRelu(4 * b, 2 * b)
        self.Deconv3dBnRelu_2 = Deconv3dBnRelu(2 * b, b)
        self.Conv_0 = Conv3d(b, 1, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = [functools.partial(getattr(self, f"Conv3dBnRelu_{i}"), train=train)
             for i in range(7)]
        c0 = c[0](x)
        c2 = c[2](c[1](c0))
        c4 = c[4](c[3](c2))
        x = c[6](c[5](c4))
        x = c4 + self.Deconv3dBnRelu_0(x, train)
        x = c2 + self.Deconv3dBnRelu_1(x, train)
        x = c0 + self.Deconv3dBnRelu_2(x, train)
        return self.Conv_0(x)


class CascadeMatcher(nn.Module):
    """FeatureNet + FMT + 3-stage cascade over all view rotations.

    The backbone runs once per view; the FMT pathway and the cascade
    repeat for each rotation of the view order (a Python loop)."""

    def __init__(self, ndepths: Sequence[int] = (48, 32, 8),
                 depth_intervals_ratio: Sequence[float] = (4.0, 2.0, 1.0),
                 cr_base_chs: Sequence[int] = (8, 8, 8),
                 base_channels: int = 8,
                 fmt_layer_names: Sequence[str] = ("self", "cross") * 4,
                 grad_method: str = "detach", share_cr: bool = False):
        super().__init__()
        from .featurenet import FeatureNet
        from .fmt import FMTWithPathway

        self.grad_method = grad_method
        self.share_cr = share_cr
        self.ndepths = tuple(ndepths)
        self.depth_intervals_ratio = tuple(depth_intervals_ratio)
        self.feature = FeatureNet(base_channels)
        self.fmt_with_pathway = FMTWithPathway(
            base_channels=base_channels, d_model=base_channels * 4,
            layer_names=fmt_layer_names)
        self.pixel_wise_net = PixelwiseNet()
        if share_cr:
            # one net for all stages, base 8 (JAX cascade.py:344-350)
            self.cost_reg_shared = CostRegNet(1, 8)
        else:
            for i in range(len(self.ndepths)):
                setattr(self, f"cost_reg_{i}", CostRegNet(1, cr_base_chs[i]))

    def cost_reg(self, stage_idx: int) -> CostRegNet:
        """The cost-regularisation net of a stage."""
        if self.share_cr:
            return self.cost_reg_shared
        return getattr(self, f"cost_reg_{stage_idx}")

    def _run_stage(self, stage_idx, features, proj_matrices, depth_values,
                   view_weights: Optional[torch.Tensor], train: bool):
        projs = combine_projection(proj_matrices)
        sim = _correlate_chunked(features[1:], projs[1:], projs[0],
                                 features[0], depth_values)   # (V-1, D, H, W)
        if view_weights is None:   # stage 1 only
            view_weights = self.pixel_wise_net(sim, train)     # (V-1, H, W)
        w = view_weights[:, None]
        agg = torch.sum(sim * w, dim=0) / (torch.sum(w, dim=0) + 1e-5)
        cost_reg = self.cost_reg(stage_idx)(agg[None, None], train)[0, 0]
        prob_volume = softmax(cost_reg, dim=0)
        return {
            "depth": depth_wta(prob_volume, depth_values),
            "cost_volume": cost_reg,
            "prob_volume": prob_volume,
            "depth_values": depth_values,
        }, view_weights

    def _rotation(self, feats, projs, depth_values, img_hw, train):
        """One view-rotation pass: FMT pathway + 3-stage cascade."""
        h, w = img_hw
        feats_fmt = self.fmt_with_pathway(feats)
        depth_min = depth_values[0]
        depth_max = depth_values[-1]
        depth_interval = (depth_max - depth_min) / depth_values.shape[0]
        out = {"fmt_stage1": feats_fmt["stage1"]}
        depth = view_weights = None
        scales = [4, 2, 1]
        for s, nd in enumerate(self.ndepths):
            hs, ws = h // scales[s], w // scales[s]
            if depth is None:
                hyp_d = depth_hypotheses_full(depth_min, depth_max, nd)
                hyp = hyp_d[:, None, None].expand(nd, hs, ws)
            else:
                # reference order: previous depth up to full resolution, then
                # to stage resolution (a shrink at stage 2), then hypotheses
                cur = depth.detach() if self.grad_method == "detach" else depth
                cur_full = upsample_depth(cur, (h, w))
                cur_stage = upsample_depth(cur_full, (hs, ws))
                interval = self.depth_intervals_ratio[s] * depth_interval
                hyp = depth_hypotheses_around(cur_stage, nd, interval)
            if s > 0:
                view_weights = resize_nearest(
                    view_weights, (view_weights.shape[0], hs, ws))
            st, view_weights = self._run_stage(
                s, feats_fmt[f"stage{s + 1}"], projs[f"stage{s + 1}"],
                hyp, view_weights, train)
            depth = st["depth"]
            out[f"stage{s + 1}"] = st
        return out

    def forward(self, imgs: torch.Tensor,
                proj_matrices: Dict[str, torch.Tensor],
                depth_values: torch.Tensor, train: bool = False) -> Dict:
        """imgs (V, H, W, 3); proj_matrices stage -> (V, 2, 4, 4);
        depth_values (D0,) hypotheses in mm."""
        v, h, w, _ = imgs.shape
        feats = self.feature(imgs, train)
        rots = []
        for r in range(v):
            order = [(r + i) % v for i in range(v)]
            rots.append(self._rotation(
                {k: f[order] for k, f in feats.items()},
                {k: p[order] for k, p in proj_matrices.items()},
                depth_values, (h, w), train))
        # pair features come from rotation 0's FMT-transformed stage1 (the
        # reference mutates its backbone feature dicts in place)
        fmt_stage1_rot0 = rots[0]["fmt_stage1"]
        aug0, aug1 = self.fmt_with_pathway.extract_cross_features(fmt_stage1_rot0, v)
        stages = [f"stage{s + 1}" for s in range(len(self.ndepths))]
        return {
            "feat_stage1": fmt_stage1_rot0,
            "cost_volumes": {st: torch.stack([rt[st]["cost_volume"] for rt in rots])
                             for st in stages},
            "mvs_depth": torch.stack([rt[stages[-1]]["depth"] for rt in rots]),
            "aug0": aug0,
            "aug1": aug1,
            # pretraining aux: rotation 0's (D, h, w) per stage
            "rot0": {st: {k: rots[0][st][k] for k in ("prob_volume", "depth_values")}
                     for st in stages},
        }
