"""Training: losses, the optimizer, and the train, grad, apply, validation
and MVS-pretraining steps.

Counterpart of the JAX package's ``pipeline/trainer.py`` (reference
code1/model.py:72-87 configure_optimizers, 492-575 training_step,
607-758 validation_step):

  * Adam(lr=1e-4) over everything EXCEPT the matcher, whose parameters are
    frozen (``requires_grad_(False)``), as the reference (model.py:82-83)
    and the JAX optimizer's ``set_to_zero`` label do;
  * loss = weight_rgb * (mse(rgb_c) + mse(rgb_f))
         + weight_depth * (masked l1(depth_c) + masked l1(depth_f)),
    depth masked to valid ground truth inside [near, far] (model.py:552-566);
  * MVS pretraining of the matcher with the cascade entropy loss
    (reference fmt/module.py:568-641).

Render training keeps every BatchNorm on its running statistics (the JAX
render loss applies the model without ``train``); only MVS pretraining
runs the matcher's BatchNorms on batch statistics. The model's
``train()`` / ``eval()`` mode is never read.

The JAX steps draw their samples from a key; here they come from a
``torch.Generator`` or from explicit uniform draws ``(u_coarse, u_fine)``,
which the tests take from the JAX key schedule.

Parameters change only through the optimizer's in-place updates, never
through ``.data``: the head kernels cache their weight packs by each
tensor's ``_version`` (``ops/cuda_build.PackCache``), which only
in-place operations through the dispatcher bump (Adam's for-loop and
foreach implementations do; its fused one does not, and is refused).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import Config
from ..models.uforecon import SceneInputs, UFORecon
from ..ops.resize import resize_nearest
from ..ops.sampling import chunk_draws
from ..parallel import sharding

Draws = Optional[Tuple[torch.Tensor, torch.Tensor]]


class TrainState(NamedTuple):
    model: UFORecon
    optimizer: torch.optim.Optimizer
    step: int = 0


def trainable_parameters(model: UFORecon) -> List[Tuple[str, torch.nn.Parameter]]:
    """The (name, parameter) pairs render training updates: all but the
    matcher's."""
    return [(n, p) for n, p in model.named_parameters() if not n.startswith("matcher.")]


def make_optimizer(cfg: Config, model: UFORecon, **adam_kw) -> torch.optim.Adam:
    """Adam over the non-matcher parameters; the matcher frozen
    (model.py:72-87). optax's Adam defaults are torch's (betas 0.9, 0.999,
    eps 1e-8). ``fused=True`` is refused: the fused Adam writes the
    parameters without bumping their ``_version``, so the head kernels
    would launch stale weight packs."""
    if adam_kw.get("fused"):
        raise ValueError("fused Adam does not bump the parameters' _version, which "
                         "the head kernels' weight-pack cache keys on; use the "
                         "for-loop or foreach implementation")
    for p in model.matcher.parameters():
        p.requires_grad_(False)
    params = [p for _, p in trainable_parameters(model)]
    for p in params:
        p.requires_grad_(True)
    return torch.optim.Adam(params, lr=cfg.uforecon_lr, **adam_kw)


def depth_mask(depth_gt: torch.Tensor, near, far) -> torch.Tensor:
    """1 where the depth loss counts a ray: ground truth present and inside
    [near, far] (model.py:552-566)."""
    return ((depth_gt != 0) & (depth_gt >= near) & (depth_gt <= far)).float()


def render_losses(cfg: Config, out: Dict, rgb_gt: torch.Tensor,
                  depth_gt: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                  totals: Optional[Tuple[int, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RGB mse + masked depth l1 over the coarse and fine passes
    (model.py:552-566): the means over these rays, or with ``totals``
    (rays, rays with a depth loss) of a whole step of which these rays are
    one rank's share, over the step's counts, so that the ranks' terms add
    up to the step's (JAX's loss over rays sharded along the mesh)."""
    c, f = out["coarse"], out["fine"]
    mask = depth_mask(depth_gt, near, far)
    n_rays, n_depth = totals if totals is not None else (rgb_gt.shape[0], mask.sum())
    n_rgb = n_rays * rgb_gt.shape[-1]
    loss_rgb_c = torch.sum((c["rgb"] - rgb_gt) ** 2) / n_rgb
    loss_rgb_f = torch.sum((f["rgb"] - rgb_gt) ** 2) / n_rgb
    denom = torch.clamp(n_depth, min=1.0)
    loss_d_c = torch.sum(torch.abs(c["depth"] - depth_gt) * mask) / denom
    loss_d_f = torch.sum(torch.abs(f["depth"] - depth_gt) * mask) / denom

    loss = cfg.weight_rgb * (loss_rgb_c + loss_rgb_f) + cfg.weight_depth * (
        loss_d_c + loss_d_f)
    logs = {
        "train/rgb_coarse": loss_rgb_c,
        "train/rgb_fine": loss_rgb_f,
        "train/depth_ray_coarse": loss_d_c,
        "train/depth_ray_fine": loss_d_f,
        "train/loss_all": loss,
        "train/variance": f["variance"],
    }
    return loss, logs


def grad_step(cfg: Config, model: UFORecon, scene: SceneInputs, ray_d: torch.Tensor,
              rgb_gt: torch.Tensor, depth_gt: torch.Tensor,
              generator: Optional[torch.Generator] = None, draws: Draws = None,
              coarse_only: bool = False) -> Dict[str, torch.Tensor]:
    """Loss and gradients of ONE scene's ray batch, the unit of
    ``batch_size`` accumulation: the gradients are added into each
    trainable parameter's ``.grad``. Returns the logged terms (detached).
    The draws not given are ``chunk_draws`` of the whole batch from
    ``generator``. ``coarse_only`` trains on the coarse pass alone (it
    stands in for both passes in the loss).

    In a process group (``parallel/sharding.py``) every rank is given the
    whole batch and draws and takes its contiguous share of the rays; the
    loss is normalised by the whole batch's ray and depth counts, so that
    the ranks' gradients and logged terms add up to the batch's
    (``all_reduce_step``). Every rank draws alike from its generator.

    A model whose kernel precision resolves to ``fast`` is refused, as the
    JAX trainer refuses it (``uforecon_tpu/pipeline/trainer.py:108-114``):
    its bf16 forward against the FP32 backward was measured to destabilise
    render training."""
    if model.kernel_precision == "fast":
        raise ValueError("kernel_precision 'fast' is inference-only: its bf16 "
                         "forward against the FP32 backward destabilises render "
                         "training; use 'high' or 'highest'")
    world, rank = sharding.world_size(), sharding.rank()
    totals = (ray_d.shape[0], depth_mask(depth_gt, scene.near, scene.far).sum())
    if draws is None:
        draws = chunk_draws(ray_d.shape[0], model.cfg.samples, generator, ray_d.device,
                            coarse_only)
    ray_d, rgb_gt, depth_gt, u_c, u_f = (
        None if a is None else sharding.shard_rays(a, rank, world)
        for a in (ray_d, rgb_gt, depth_gt, *draws))
    out = model.render_chunk(scene, model.encode(scene), ray_d, generator, u_coarse=u_c,
                             u_fine=u_f, coarse_only=coarse_only)
    loss, logs = render_losses(cfg, out, rgb_gt, depth_gt, scene.near, scene.far, totals)
    loss.backward()
    return {k: v.detach() for k, v in logs.items()}


def all_reduce_step(model: UFORecon, logs: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Sum the trainable gradients and the logged terms of ``grad_step``
    over the ranks (one all-reduce each; JAX's psum), once per optimizer
    step; ``train/variance``, which every rank computes alike, is
    averaged. Returns the logs; outside a process group they and the
    gradients stay as they are."""
    world = sharding.world_size()
    sharding.all_reduce_sum_([p.grad for _, p in trainable_parameters(model)
                              if p.grad is not None])
    names = list(logs)
    vals = torch.stack([logs[k].float().reshape(()) for k in names])
    sharding.all_reduce_sum_([vals])
    out = dict(zip(names, vals.unbind()))
    if "train/variance" in out:
        out["train/variance"] = out["train/variance"] / world
    return out


def apply_step(optimizer: torch.optim.Optimizer, n_scenes: int) -> None:
    """One optimizer update from the gradients of ``n_scenes`` scenes
    summed in ``.grad``: their mean, as the reference's batched loss."""
    if n_scenes != 1:
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.div_(n_scenes)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def train_step(cfg: Config, state: TrainState, scene: SceneInputs, ray_d, rgb_gt,
               depth_gt, generator=None, draws: Draws = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One scene, one optimizer update (the JAX ``make_train_step``)."""
    logs = grad_step(cfg, state.model, scene, ray_d, rgb_gt, depth_gt, generator, draws)
    apply_step(state.optimizer, 1)
    return state._replace(step=state.step + 1), logs


@torch.no_grad()
def val_step(cfg: Config, model: UFORecon, scene: SceneInputs, enc, ray_d, rgb_gt,
             depth_gt, generator=None, draws: Draws = None):
    """Validation losses of a ray chunk, and its fine rgb and depth
    (model.py:707-726). ``enc`` is the scene's ``model.encode``: the JAX
    step encodes again for every chunk, with the same result."""
    u_c, u_f = draws if draws is not None else (None, None)
    out = model.render_chunk(scene, enc, ray_d, generator, u_coarse=u_c, u_fine=u_f)
    _, logs = render_losses(cfg, out, rgb_gt, depth_gt, scene.near, scene.far)
    return logs, out["fine"]["rgb"], out["fine"]["depth"]


# --------------------------------------------------------------------------
# MVS (cascade) pretraining: the reference relies on a pretrained
# TransMVSNet checkpoint; these losses train it from scratch.
# --------------------------------------------------------------------------


def mvs_entropy_loss(prob_volume: torch.Tensor, depth_gt: torch.Tensor,
                     mask: torch.Tensor, depth_values: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy against the one-hot nearest-hypothesis bin, and the
    winner-take-all depth (reference fmt/module.py:578-614). prob_volume
    and depth_values (D, H, W); depth_gt and mask (H, W)."""
    d = prob_volume.shape[0]
    gt_idx = torch.argmin(torch.abs(depth_values - depth_gt[None]), dim=0)
    onehot = F.one_hot(gt_idx, d).permute(2, 0, 1).to(prob_volume.dtype)
    ce = -torch.sum(onehot * torch.log(prob_volume + 1e-6), dim=0)
    valid = torch.clamp(mask.sum(), min=1e-6)
    loss = torch.sum(ce * mask) / valid
    wta = torch.gather(depth_values, 0, torch.argmax(prob_volume, dim=0)[None])[0]
    return loss, wta


def make_pretrain_optimizer(cfg: Config, model: UFORecon) -> torch.optim.Adam:
    """Adam over the matcher, the only part the entropy loss reaches (the
    JAX pretraining's Adam over every parameter moves no other: their
    gradients are zero)."""
    for p in model.matcher.parameters():
        p.requires_grad_(True)
    return torch.optim.Adam(model.matcher.parameters(), lr=cfg.uforecon_lr)


def mvs_pretrain_step(model: UFORecon, optimizer: torch.optim.Optimizer,
                      scene: SceneInputs, depth_gt_mm: torch.Tensor, mask: torch.Tensor,
                      dlossw: Sequence[float] = (0.5, 1.0, 2.0)
                      ) -> Dict[str, torch.Tensor]:
    """One update of the cascade matcher on ground-truth depth
    (TransMVSNet-style): the entropy loss of rotation 0 (view 0 as the MVS
    reference) per stage, weighted 2 * dlossw like the reference's
    trans_mvsnet_loss (module.py:617-641), the matcher's BatchNorms on
    batch statistics. The ground truth is shrunk to each stage by
    ``jax.image.resize``'s nearest rule. Returns the logged terms."""
    enc = model.matcher(scene.source_imgs, scene.proj_matrices, scene.depth_values,
                        train=True)
    total = 0.0
    logs = {}
    for s, w in zip(range(1, 4), dlossw):
        aux = enc["rot0"][f"stage{s}"]
        prob, dv = aux["prob_volume"], aux["depth_values"]
        d_gt = resize_nearest(depth_gt_mm, prob.shape[1:])
        m = resize_nearest(mask, prob.shape[1:])
        loss, _ = mvs_entropy_loss(prob, d_gt, m, dv)
        total = total + 2.0 * w * loss
        logs[f"mvs/entropy_stage{s}"] = loss.detach()
    logs["mvs/loss"] = total.detach()
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    optimizer.step()
    return logs
