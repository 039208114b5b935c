"""FMT: cross-view Feature Matching Transformer with FPN pathway.

Counterpart of the JAX package's ``models/fmt.py`` (reference
code1/encoder_utils/fmt/FMT.py:115-315). One stack of linear-attention
layers serves three modes:
  * ref mode: self-attention over the reference view, keeping the output
    after every 'self' layer;
  * src mode: self layers, and cross layers attending to the saved
    reference outputs;
  * cross mode: symmetric pairwise matching; cross layers attend to the
    raw position-encoded swapped pack.
Features are channels-last (N, H, W, C) like the JAX module.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.posenc import sine_image_pe
from ..ops.resize import resize_linear
from .attention import FMTEncoderLayer
from .layers import Conv2d


def _flatten(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h * w, c)


class FMT(nn.Module):
    """The shared attention stack."""

    def __init__(self, d_model: int = 32, n_heads: int = 8,
                 layer_names: Sequence[str] = ("self", "cross") * 4):
        super().__init__()
        self.d_model = d_model
        self.layer_names = tuple(layer_names)
        for i in range(len(layer_names)):
            setattr(self, f"layer_{i}", FMTEncoderLayer(d_model, n_heads))

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(len(self.layer_names))]

    def _pos_encode(self, feat: torch.Tensor) -> torch.Tensor:
        h, w = feat.shape[1:3]
        pe = torch.as_tensor(sine_image_pe(self.d_model, h, w), device=feat.device)
        return feat + pe.to(feat.dtype)

    def ref_forward(self, feat: torch.Tensor) -> List[torch.Tensor]:
        h, w = feat.shape[1:3]
        x = _flatten(self._pos_encode(feat))
        outs = []
        for layer, name in zip(self.layers(), self.layer_names):
            if name == "self":
                x = layer(x, x)
                outs.append(x.reshape(x.shape[0], h, w, -1))
        return outs

    def src_forward(self, ref_list: List[torch.Tensor], feat: torch.Tensor) -> torch.Tensor:
        """Layer ``i`` in cross mode attends to ``ref_list[i // 2]``,
        broadcast over the packed source views."""
        h, w = feat.shape[1:3]
        x = _flatten(self._pos_encode(feat))
        n_src = x.shape[0]
        for i, (layer, name) in enumerate(zip(self.layers(), self.layer_names)):
            if name == "self":
                x = layer(x, x)
            else:
                ref = _flatten(ref_list[i // 2])
                if ref.shape[0] != n_src:
                    ref = ref.repeat_interleave(n_src // ref.shape[0], dim=0)
                x = layer(x, ref)
        return x.reshape(n_src, h, w, -1)

    def cross_forward(self, feat0: torch.Tensor,
                      feat1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h, w = feat0.shape[1:3]
        n = feat0.shape[0]
        f0 = _flatten(self._pos_encode(feat0))
        f1 = _flatten(self._pos_encode(feat1))
        pack = torch.cat([f0, f1], dim=0)
        swap = torch.cat([f1, f0], dim=0)
        for layer, name in zip(self.layers(), self.layer_names):
            pack = layer(pack, pack if name == "self" else swap)
        out = pack.reshape(2 * n, h, w, -1)
        return out[:n], out[n:]


class FMTWithPathway(nn.Module):
    """FMT on stage1 + FPN pathway into stage2/stage3."""

    def __init__(self, base_channels: int = 8, d_model: int = 32,
                 n_heads: int = 8,
                 layer_names: Sequence[str] = ("self", "cross") * 4):
        super().__init__()
        b = base_channels
        self.fmt = FMT(d_model, n_heads, layer_names)
        self.dim_reduction_1 = Conv2d(4 * b, 2 * b, 1, bias=False)
        self.dim_reduction_2 = Conv2d(2 * b, b, 1, bias=False)
        self.smooth_1 = Conv2d(2 * b, 2 * b, 3, padding=1, bias=False)
        self.smooth_2 = Conv2d(b, b, 3, padding=1, bias=False)

    @staticmethod
    def _conv_cl(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def _pathway(self, stage1, stage2, stage3):
        """stage2 = smooth(up(dimred(stage1)) + stage2); same for stage3."""
        def up(x, like):
            return resize_linear(x, (x.shape[0],) + tuple(like.shape[1:3]) + (x.shape[3],))

        r1 = self._conv_cl(self.dim_reduction_1, stage1)
        s2 = self._conv_cl(self.smooth_1, up(r1, stage2) + stage2)
        r2 = self._conv_cl(self.dim_reduction_2, s2)
        s3 = self._conv_cl(self.smooth_2, up(r2, stage3) + stage3)
        return s2, s3

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """View 0 is the reference. Returns the transformed stages."""
        s1, s2, s3 = features["stage1"], features["stage2"], features["stage3"]
        ref_list = self.fmt.ref_forward(s1[0:1])
        src_s1 = self.fmt.src_forward(ref_list, s1[1:])
        new_s1 = torch.cat([ref_list[-1], src_s1], dim=0)
        new_s2, new_s3 = self._pathway(new_s1, s2, s3)
        return {"stage1": new_s1, "stage2": new_s2, "stage3": new_s3}

    def extract_cross_features(self, stage1: torch.Tensor,
                               n_views: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pairwise matching features over the pairs (i, j), i < j:
        (aug0, aug1), each (P, H, W, C); aug0[p] is view i matched
        against view j."""
        pairs = [(a, b) for a in range(n_views - 1) for b in range(a + 1, n_views)]
        i_idx = [p[0] for p in pairs]
        j_idx = [p[1] for p in pairs]
        return self.fmt.cross_forward(stage1[i_idx], stage1[j_idx])
