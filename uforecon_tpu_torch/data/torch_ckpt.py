"""The reference's PyTorch (Lightning) checkpoint names -> flax leaf paths.

A numpy copy of the exact name maps of the JAX package's
``data/torch_ckpt.py`` (``_convert_tensor`` and the ``*_name_map`` helpers
down to ``uforecon_name_map``) and of ``convert_named``, whose tree walks
become dict walks. The port's module tree carries the flax scope names, so
a flax leaf path is also a port ``state_dict`` key (``convert.py``); the
shapes of the flax leaves come from the port model's own tensors.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np


def _convert_tensor(name: str, arr: np.ndarray, target_shape: Tuple[int, ...]
                    ) -> Optional[np.ndarray]:
    """Layout-convert a torch tensor to match a flax leaf shape, or None."""
    a = np.asarray(arr)
    # canonical layout conversion FIRST: for square linear/conv weights the
    # raw tensor also matches the target shape, but torch (out, in) / OIHW
    # must still be transposed — identity is only a last-resort fallback
    cands = []
    if a.ndim == 4:                       # conv OIHW -> HWIO
        cands.append(a.transpose(2, 3, 1, 0))
    if a.ndim == 5:                       # conv3d OIDHW -> DHWIO
        cands.append(a.transpose(2, 3, 4, 1, 0))
    if a.ndim == 2:                       # linear (out, in) -> (in, out)
        cands.append(a.T)
    cands.append(a)
    for c in cands:
        if tuple(c.shape) == tuple(target_shape):
            return c
    if a.size == int(np.prod(target_shape)) and a.ndim <= 1:
        return a.reshape(target_shape)
    return None


def _convbn(tp, fp):
    """Reference Conv2d/Conv3d wrapper (.conv/.bn) -> our ConvBnRelu."""
    return {
        f"{tp}.conv.weight": ("params", fp + ("Conv_0", "kernel")),
        f"{tp}.bn.weight": ("params", fp + ("BatchNorm_0", "scale")),
        f"{tp}.bn.bias": ("params", fp + ("BatchNorm_0", "bias")),
        f"{tp}.bn.running_mean": ("batch_stats", fp + ("BatchNorm_0", "mean")),
        f"{tp}.bn.running_var": ("batch_stats", fp + ("BatchNorm_0", "var")),
    }


def _plain(tp, fp, bias=True):
    m = {f"{tp}.weight": ("params", fp + ("kernel",))}
    if bias:
        m[f"{tp}.bias"] = ("params", fp + ("bias",))
    return m


def _deconvbn(tp, fp):
    """Reference Deconv2d/Deconv3d wrapper -> our DeconvBnRelu (the flax
    submodule auto-name is ConvTranspose_0, not Conv_0)."""
    return {
        f"{tp}.conv.weight": ("params", fp + ("ConvTranspose_0", "kernel")),
        f"{tp}.bn.weight": ("params", fp + ("BatchNorm_0", "scale")),
        f"{tp}.bn.bias": ("params", fp + ("BatchNorm_0", "bias")),
        f"{tp}.bn.running_mean": ("batch_stats", fp + ("BatchNorm_0", "mean")),
        f"{tp}.bn.running_var": ("batch_stats", fp + ("BatchNorm_0", "var")),
    }


def _bn(tp, fp):
    return {
        f"{tp}.weight": ("params", fp + ("scale",)),
        f"{tp}.bias": ("params", fp + ("bias",)),
        f"{tp}.running_mean": ("batch_stats", fp + ("mean",)),
        f"{tp}.running_var": ("batch_stats", fp + ("var",)),
    }


def _dcn(tp, fp):
    return {
        f"{tp}.weight": ("params", fp + ("weight",)),
        f"{tp}.bias": ("params", fp + ("bias",)),
        f"{tp}.conv_offset_mask.weight":
            ("params", fp + ("conv_offset_mask", "kernel")),
        f"{tp}.conv_offset_mask.bias":
            ("params", fp + ("conv_offset_mask", "bias")),
    }


def _fmt_layer(tp, fp):
    """Reference fmt EncoderLayer -> our FMTEncoderLayer."""
    m = {}
    for tn, fn in [("attention.query_projection", "q_proj"),
                   ("attention.key_projection", "k_proj"),
                   ("attention.value_projection", "v_proj"),
                   ("attention.out_projection", "out_proj"),
                   ("linear1", "ff1"), ("linear2", "ff2")]:
        m.update(_plain(f"{tp}.{tn}", fp + (fn,)))
    for n in ("norm1", "norm2"):
        m[f"{tp}.{n}.weight"] = ("params", fp + (n, "scale"))
        m[f"{tp}.{n}.bias"] = ("params", fp + (n, "bias"))
    return m


def _loftr_layer(tp, fp):
    """Reference attention/transformer LoFTREncoderLayer (bias-free)."""
    m = {}
    for tn, fn in [("q_proj", "q_proj"), ("k_proj", "k_proj"),
                   ("v_proj", "v_proj"), ("merge", "merge"),
                   ("mlp.0", "mlp1"), ("mlp.2", "mlp2")]:
        m.update(_plain(f"{tp}.{tn}", fp + (fn,), bias=False))
    for n in ("norm1", "norm2"):
        m[f"{tp}.{n}.weight"] = ("params", fp + (n, "scale"))
        m[f"{tp}.{n}.bias"] = ("params", fp + (n, "bias"))
    return m


def featurenet_name_map(tp="", fp=()):
    """fmt/module.py FeatureNet -> models/featurenet.py FeatureNet."""
    m = {}
    convs = (
        [(f"conv0.{i}", f"ConvBnRelu_{i}") for i in range(2)]
        + [(f"conv1.{i}", f"ConvBnRelu_{2 + i}") for i in range(3)]
        + [(f"conv2.{i}", f"ConvBnRelu_{5 + i}") for i in range(3)]
    )
    for t, f in convs:
        m.update(_convbn(tp + t, fp + (f,)))
    for k in (1, 2, 3):
        o = f"out{k}"
        m.update(_convbn(f"{tp}{o}.0", fp + (o, "ConvBnRelu_0")))
        m.update(_dcn(f"{tp}{o}.1", fp + (o, "dcn0")))
        m.update(_bn(f"{tp}{o}.2", fp + (o, "BatchNorm_0")))
        m.update(_dcn(f"{tp}{o}.4", fp + (o, "dcn1")))
        m.update(_bn(f"{tp}{o}.5", fp + (o, "BatchNorm_1")))
        m.update(_dcn(f"{tp}{o}.7", fp + (o, "dcn2")))
    m.update(_plain(tp + "inner1", fp + ("inner1",)))
    m.update(_plain(tp + "inner2", fp + ("inner2",)))
    return m


def fmt_pathway_name_map(tp="", fp=(), n_layers=8):
    """fmt/FMT.py FMT_with_pathway -> models/fmt.py FMTWithPathway."""
    m = {}
    for i in range(n_layers):
        m.update(_fmt_layer(f"{tp}FMT.layers.{i}", fp + ("fmt", f"layer_{i}")))
    for n in ("dim_reduction_1", "dim_reduction_2", "smooth_1", "smooth_2"):
        m.update(_plain(tp + n, fp + (n,), bias=False))
    return m


def pixelwise_name_map(tp="", fp=()):
    m = {}
    m.update(_convbn(tp + "conv0", fp + ("Conv3dBnRelu_0",)))
    m.update(_convbn(tp + "conv1", fp + ("Conv3dBnRelu_1",)))
    m.update(_plain(tp + "conv2", fp + ("Conv_0",)))
    return m


def costregnet_name_map(tp="", fp=()):
    """fmt/module.py CostRegNet (Conv3d/Deconv3d wrappers + final prob)."""
    m = {}
    order = [("conv0", "Conv3dBnRelu_0"), ("conv1", "Conv3dBnRelu_1"),
             ("conv2", "Conv3dBnRelu_2"), ("conv3", "Conv3dBnRelu_3"),
             ("conv4", "Conv3dBnRelu_4"), ("conv5", "Conv3dBnRelu_5"),
             ("conv6", "Conv3dBnRelu_6")]
    for t, f in order:
        m.update(_convbn(tp + t, fp + (f,)))
    for t, f in [("conv7", "Deconv3dBnRelu_0"), ("conv9", "Deconv3dBnRelu_1"),
                 ("conv11", "Deconv3dBnRelu_2")]:
        m.update(_deconvbn(tp + t, fp + (f,)))
    m.update(_plain(tp + "prob", fp + ("Conv_0",), bias=False))
    return m


def costregnetweight_name_map(tp="", fp=()):
    """fmt/module.py CostRegNetWeight (plain Conv3d/ConvTranspose3d)."""
    m = {}
    for n in ("conv0", "conv1", "conv2", "conv3", "conv4", "conv5", "conv6",
              "conv7", "conv9", "conv11"):
        m.update(_plain(tp + n, fp + (n,)))
    m.update(_plain(tp + "features", fp + ("features",), bias=False))
    m.update(_plain(tp + "weights", fp + ("weights",), bias=False))
    return m


def featurevolume_name_map(tp="", fp=()):
    """code1/feature_volume.py FeatureVolume (featuregrid path) -> ours.

    Reference submodules: ``linear`` (3 Linears), ``volume_regularization``
    (cnn3d.py:42-73 — conv3dBNReLU uses attribute ``.BN``, capital; its
    convs carry a bias that eval-mode BN makes redundant — transplant tests
    zero it on the torch side since our Conv3dBnRelu is bias-free).
    """
    m = {}
    for t_i, f_i in [(0, 0), (2, 1), (4, 2)]:
        m.update(_plain(f"{tp}linear.{t_i}", fp + ("MLP_0", f"Dense_{f_i}")))

    def cbr(t, f, bias_ok=False):
        reg = fp + ("VolumeRegularization_0",)
        out = {
            f"{tp}volume_regularization.{t}.conv.weight":
                ("params", reg + (f, "Conv_0" if not f.startswith("Deconv")
                                  else "ConvTranspose_0", "kernel")),
            f"{tp}volume_regularization.{t}.BN.weight":
                ("params", reg + (f, "BatchNorm_0", "scale")),
            f"{tp}volume_regularization.{t}.BN.bias":
                ("params", reg + (f, "BatchNorm_0", "bias")),
            f"{tp}volume_regularization.{t}.BN.running_mean":
                ("batch_stats", reg + (f, "BatchNorm_0", "mean")),
            f"{tp}volume_regularization.{t}.BN.running_var":
                ("batch_stats", reg + (f, "BatchNorm_0", "var")),
        }
        if bias_ok:  # conv3dBNReLU convs have a (BN-redundant) bias
            out[f"{tp}volume_regularization.{t}.conv.bias"] = None
        return out

    m.update(cbr("cnn3d0", "Conv3dBnRelu_0", bias_ok=True))
    m.update(cbr("cnn3d1.0", "Conv3dBnRelu_1", bias_ok=True))
    m.update(cbr("cnn3d1.1", "Conv3dBnRelu_2", bias_ok=True))
    m.update(cbr("cnn3d2.0", "Conv3dBnRelu_3", bias_ok=True))
    m.update(cbr("cnn3d2.1", "Conv3dBnRelu_4", bias_ok=True))
    m.update(cbr("cnn3d3.0", "Conv3dBnRelu_5", bias_ok=True))
    m.update(cbr("cnn3d3.1", "Conv3dBnRelu_6", bias_ok=True))
    m.update(cbr("d_cnn3d1", "Deconv3dBnRelu_0"))
    m.update(cbr("d_cnn3d2", "Deconv3dBnRelu_1"))
    m.update(cbr("d_cnn3d3", "Deconv3dBnRelu_2"))
    m.update(_plain(tp + "volume_regularization.last",
                    fp + ("VolumeRegularization_0", "Conv_0")))
    return m


def ray_transformer_name_map(tp="", fp=()):
    """code1/ray_transformer.py RayTransformer -> ours."""
    m = {}
    for t_i, f_i in [(0, 0), (2, 1), (4, 2)]:
        m.update(_plain(f"{tp}pre_sim_mlp.{t_i}",
                        fp + ("pre_sim_mlp", f"Dense_{f_i}")))
        m.update(_plain(f"{tp}DensityMLP.{t_i}",
                        fp + ("density_mlp", f"Dense_{f_i}")))
        m.update(_plain(f"{tp}linear_radianceweight_1_softmax.{t_i}",
                        fp + ("linear_radianceweight_1_softmax",
                              f"Dense_{f_i}")))
    m.update(_loftr_layer(tp + "density_view_transformer.layers.0",
                          fp + ("density_view_transformer", "layer_0")))
    m.update(_loftr_layer(tp + "density_ray_transformer.layers.0",
                          fp + ("density_ray_transformer", "layer_0")))
    m[tp + "viewToken.view_token"] = ("params", fp + ("view_token",))
    # constant NeRF-PE frequency buffers (not learned; we recompute them)
    for pe in ("depthcode", "dircode"):
        m[f"{tp}{pe}._freqs"] = None
        m[f"{tp}{pe}._phases"] = None
    return m


def transmvsnet_name_map(tp="", fp=(), share_cr=False):
    """Full TransMVSNet -> our CascadeMatcher subtree."""
    m = {}
    m.update(featurenet_name_map(tp + "feature.", fp + ("feature",)))
    m.update(fmt_pathway_name_map(tp + "FMT_with_pathway.",
                                  fp + ("fmt_with_pathway",)))
    m.update(pixelwise_name_map(tp + "DepthNet.pixel_wise_net.",
                                fp + ("pixel_wise_net",)))
    if share_cr:
        m.update(costregnet_name_map(tp + "cost_regularization.",
                                     fp + ("cost_reg_shared",)))
    else:
        for i in range(3):
            m.update(costregnet_name_map(f"{tp}cost_regularization.{i}.",
                                         fp + (f"cost_reg_{i}",)))
    return m


def uforecon_name_map(share_cr=False, volume_type="correlation"):
    """Full reference UFORecon (model.py attribute names) -> our UFORecon."""
    m = {}
    m.update(transmvsnet_name_map("transmvsnet.", ("matcher",),
                                  share_cr=share_cr))
    if volume_type == "featuregrid":
        # reference model.py:61-62: self.feature_volume = FeatureVolume(reso)
        m.update(featurevolume_name_map("feature_volume.",
                                        ("feature_volume",)))
    else:
        m.update(costregnetweight_name_map("feature_volume.cost_reg_2.",
                                           ("mvs_volume",)))
    m.update(ray_transformer_name_map("ray_transformer.",
                                      ("ray_transformer",)))
    m["deviation_network.variance"] = ("params", ("variance",))
    # dead module: model.py:70 pre_conv is constructed but never called
    m["pre_conv.weight"] = None
    return m


def convert_named(
    state_dict: Mapping[str, np.ndarray],
    name_map: Dict[str, Tuple[str, Tuple[str, ...]]],
    leaf_shape,
) -> Dict[str, Dict]:
    """Exact-name transplant: every reference tensor lands on its named
    flax leaf with layout conversion. ``leaf_shape(coll, path)`` gives a
    leaf's flax shape, or None where the model has no such leaf. Returns
    ``{"params": ..., "batch_stats": ...}`` nested dicts holding only the
    mapped leaves. Raises on a tensor without a mapping, a leaf the model
    lacks and a shape that does not convert."""
    variables: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, arr in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        if name in name_map and name_map[name] is None:
            continue  # explicitly skipped (constant buffers, dead modules)
        tgt = name_map.get(name)
        if tgt is None:
            raise KeyError(f"no mapping for reference tensor {name}")
        coll, path = tgt
        shape = leaf_shape(coll, path)
        if shape is None:
            raise KeyError(f"flax leaf missing: {'/'.join(path)}")
        conv = _convert_tensor(name, np.asarray(arr), shape)
        if conv is None:
            raise ValueError(f"{name} shape {np.shape(arr)} not convertible to "
                             f"{'/'.join(path)} {tuple(shape)}")
        node = variables[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(conv, np.float32)
    return variables
