"""Weights: the bridge from the JAX package's flax variables, checkpoint
files (``load_weights``), and a seeded initialiser for runs without them.

The port's submodules carry the flax scope names (``matcher``,
``mvs_volume``, ``ray_transformer``, ``Conv_0``, ``BatchNorm_0``,
``Dense_0``, ``layer_0``, ``q_proj`` ...), so a flax leaf maps to a
``state_dict`` key by renaming its last element and fixing its layout
(rules of the JAX package's ``data/torch_ckpt.py:48 _convert_tensor``):

  * ``kernel`` -> ``weight``: Dense (in, out) -> Linear (out, in); Conv
    HWIO / DHWIO -> OIHW / OIDHW. A flax ``ConvTranspose(transpose_kernel=
    True)`` kernel (k..., out, in) takes the same permutation to torch's
    (in, out, k...) ``ConvTranspose3d`` weight;
  * DCN ``weight`` (K, K, C, Cout) -> (Cout, C, K, K);
  * BatchNorm ``scale``/``bias`` + batch_stats ``mean``/``var`` ->
    ``weight``/``bias``/``running_mean``/``running_var``; LayerNorm
    ``scale`` -> ``weight``;
  * ``view_token`` and ``variance`` as they are.
Any leaf left unmapped or unused raises. A model without explicit
similarity has no ``ray_transformer.pre_sim_mlp``, in flax as in the port,
so each tree fills only the model of its own configuration.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

_RENAME = {"kernel": "weight", "scale": "weight",
           "mean": "running_mean", "var": "running_var"}


def _layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf in ("kernel", "weight"):
        if arr.ndim == 2:
            return arr.T
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 5:
            return arr.transpose(4, 3, 0, 1, 2)
    return arr


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """{"params", "batch_stats"} nested dicts of arrays -> flat torch keys."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(coll, {})):
            key = ".".join(path[:-1] + (_RENAME.get(path[-1], path[-1]),))
            if key in out:
                raise ValueError(f"two flax leaves map to {key}")
            out[key] = _layout(np.asarray(leaf, np.float32), path[-1])
    return out


def _inverse_layout(shape, leaf: str):
    """The flax shape of a port tensor of ``shape`` (``_layout`` undone)."""
    shape = tuple(shape)
    if leaf in ("kernel", "weight"):
        if len(shape) == 2:
            return shape[::-1]
        if len(shape) == 4:
            return tuple(shape[i] for i in (2, 3, 1, 0))
        if len(shape) == 5:
            return tuple(shape[i] for i in (2, 3, 4, 1, 0))
    return shape


def _state_key(path) -> str:
    return ".".join(tuple(path[:-1]) + (_RENAME.get(path[-1], path[-1]),))


def load_state(model: nn.Module, src: Mapping[str, np.ndarray],
               source: str = "state-dict entries") -> None:
    """Fill ``model``'s parameters and BN statistics from a flat dict of its
    ``state_dict`` keys. Raises on any entry left unmapped, unused or of
    the wrong shape (``num_batches_tracked`` is ignored)."""
    src = {k: v for k, v in src.items() if not k.endswith("num_batches_tracked")}
    dst = {k: v for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    unused = sorted(set(src) - set(dst))
    missing = sorted(set(dst) - set(src))
    if unused or missing:
        raise ValueError(f"weight mismatch: unused {source} {unused}, "
                         f"torch entries without a source {missing}")
    with torch.no_grad():
        for k, t in dst.items():
            a = np.asarray(src[k], np.float32)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{k}: source shape {a.shape} -> {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a, np.float32, order="C")))


def load_flax_variables(model: nn.Module, variables: Mapping) -> None:
    """Fill ``model``'s parameters and BN statistics from the JAX package's
    variables (nested dicts of numpy arrays). Raises on any leaf left
    unmapped, unused or of the wrong shape."""
    load_state(model, flax_to_state_dict(variables), source="flax leaves")


def save_state_dict(path: str, variables: Mapping) -> None:
    """Write the JAX package's variables as a state-dict file (torch
    tensors under the port's keys) that ``load_weights`` reads. Run where
    the variables are, e.g. after the JAX package's
    ``pipeline.checkpoint.load_eval_variables`` on an orbax directory."""
    torch.save({k: torch.from_numpy(np.array(v, np.float32, order="C"))
                for k, v in flax_to_state_dict(variables).items()}, path)


def _torch_load(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # a Lightning checkpoint pickles its hyper-parameters and loop state
        return torch.load(path, map_location="cpu", weights_only=False)


def load_weights(model: nn.Module, path: str) -> None:
    """Fill ``model`` from a checkpoint file, in either of two formats:

      * a state-dict file under the port's keys (``save_state_dict``, or
        ``torch.save(model.state_dict())``);
      * the reference's PyTorch Lightning ``.ckpt`` (or its bare state
        dict): its tensors are renamed by the reference name map
        (``data/torch_ckpt.py uforecon_name_map``, of the model's
        ``share_cr`` and ``volume_type``) onto flax leaves.

    An orbax checkpoint directory (the JAX package's ``--load_ckpt``)
    raises: convert it with ``save_state_dict`` on a host with JAX. Any
    tensor left unmapped and any model entry left without a source raise.
    """
    from .data import torch_ckpt

    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?); "
            "the port reads checkpoint files. Convert it on a host with JAX: "
            "variables = uforecon_tpu.pipeline.checkpoint.load_eval_variables"
            f"({path!r}); uforecon_tpu_torch.convert.save_state_dict(file, "
            "variables); then pass that file")
    obj = _torch_load(path)
    sd = obj.get("state_dict", obj) if isinstance(obj, Mapping) else None
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: not a state dict or Lightning checkpoint "
                         f"({type(obj).__name__})")
    sd = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
          for k, v in sd.items()}
    if not any(k.startswith("transmvsnet.") for k in sd):
        load_state(model, sd)
        return
    own = model.state_dict()

    def leaf_shape(coll, path):
        t = own.get(_state_key(path))
        return None if t is None else _inverse_layout(t.shape, path[-1])

    cfg = model.cfg
    name_map = torch_ckpt.uforecon_name_map(share_cr=cfg.share_cr,
                                            volume_type=cfg.volume_type)
    load_flax_variables(model, torch_ckpt.convert_named(sd, name_map, leaf_shape))


def _trunc_normal(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard normal draws truncated to [-2, 2], by the inverse CDF of
    uniform draws between the bounds' CDFs (``jax.random.truncated_normal``'s
    method)."""
    lo, hi = (float(torch.special.ndtr(torch.tensor(b))) for b in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64)
    return torch.special.ndtri(u).clamp(-2.0, 2.0).float()


# std of the standard normal truncated at +-2 (flax's variance_scaling
# divides by it so the truncated draws keep the variance asked for)
TRUNC_STD = 0.87962566103423978


def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Seeded random weights from flax's initialisers, parameter by
    parameter, the draws from one ``torch.Generator``:
      * Dense, Conv and ConvTranspose kernels: ``lecun_normal``, a normal
        truncated at 2 sigma and scaled to variance 1 / fan_in, fan_in as
        flax counts it: the input features x the kernel taps; for flax's
        ``ConvTranspose(transpose_kernel=True)`` kernel (k..., out, in) the
        second-to-last axis, the transposed conv's output channels;
      * the DCN weights: ``variance_scaling(1/3, fan_in, uniform)``, uniform
        in +-sqrt(1 / fan_in) (JAX ``models/featurenet.py:51-54``);
      * biases 0, norms at identity, BN running statistics (0, 1), the DCN
        offset/mask convs 0 (a plain conv with 0.5 modulation at start), the
        view token normal(0, 1) and the NeuS variance 0.3."""
    from .models.featurenet import DCN

    gen = torch.Generator().manual_seed(seed)

    def lecun_(w: torch.Tensor, fan_in: int) -> None:
        w.copy_(_trunc_normal(w.shape, gen) * (np.sqrt(1.0 / fan_in) / TRUNC_STD))

    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.BatchNorm2d, nn.BatchNorm3d, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, (nn.BatchNorm2d, nn.BatchNorm3d)):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
            elif isinstance(mod, DCN):
                limit = np.sqrt(1.0 / mod.weight[0].numel())
                mod.weight.copy_((torch.rand(mod.weight.shape, generator=gen) * 2 - 1)
                                 * limit)
                mod.bias.zero_()
                mod.conv_offset_mask.weight.zero_()
                mod.conv_offset_mask.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                if name.endswith("conv_offset_mask"):
                    continue    # zeroed with its DCN
                w = mod.weight
                # torch's ConvTranspose weight is (in, out, k...): flax's
                # fan-in axis is its out
                fan_in = (w.shape[1] * w[0, 0].numel()
                          if isinstance(mod, nn.ConvTranspose3d) else w[0].numel())
                lecun_(w, fan_in)
                if mod.bias is not None:
                    mod.bias.zero_()
        model.ray_transformer.view_token.copy_(
            torch.randn(model.ray_transformer.view_token.shape, generator=gen))
        model.variance.fill_(0.3)
