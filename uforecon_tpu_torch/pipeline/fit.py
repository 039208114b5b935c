"""The training loop: epochs, validation, checkpoints, logging.

Counterpart of the JAX package's ``pipeline/fit.py`` (reference
main.py:195-230 pl.Trainer; code1/model.py:492-575 training_step, 607-758
validation_step, 578-604 validation_epoch_end), on one device:

  * one step = ``batch_size`` scene samples, each with ``train_ray_num``
    rays drawn without replacement (reference model.py:537); the
    gradients of the scenes are averaged;
  * validation renders each validation sample in ``train_ray_num``-ray
    chunks and logs the losses and the fine PSNR, averaged over samples;
  * checkpoints monitor ``val/loss_depth_fine``, keep the top 15;
  * a thread pool loads samples ahead (the DataLoader workers).

The scene order and each scene's rays come from
``np.random.default_rng(cfg.seed)`` in the JAX loop's order, so both
packages train on the same rays. The render draws come from a
``torch.Generator`` seeded with ``cfg.seed`` (validation: ``cfg.seed + 7``),
or from ``draws``: one ``(u_coarse, u_fine)`` pair per scene step.

Everything runs on ``device``: the card unless the caller asks for the
CPU; without a card it raises.

In a process group of N ranks (``parallel/sharding.py``; the JAX loop's
mesh, ``fit.py:296-313,331-332``) ``fit`` is data parallel along the ray
axis: every rank starts from rank 0's weights, draws the same scenes,
``rn = ceil(train_ray_num / N) * N`` rays and draws, takes its contiguous
share of them (``trainer.grad_step``), and the gradients are
summed over the ranks once per optimizer step (``trainer.all_reduce_step``),
JAX's psum step. Rank 0 validates, logs and checkpoints while the others
wait. ``pretrain_mvs`` and ``validate_only`` run on one device, as in JAX.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..convert import init_weights, load_weights
from ..data.convert import scene_inputs_from_sample
from ..device import DEFAULT, resolve_device
from ..models.uforecon import UFORecon
from ..parallel import sharding
from ..utils.logging import Log, MetricWriter
from ..utils.metrics import psnr
from .checkpoint import CheckpointManager
from .trainer import (TrainState, all_reduce_step, apply_step, grad_step,
                      make_optimizer, make_pretrain_optimizer, mvs_pretrain_step, val_step)

PKG_DATA = os.path.join(os.path.dirname(__file__), "..", "data", "dtu")


def default_split_paths() -> Dict[str, str]:
    return {
        "train": os.path.join(PKG_DATA, "lists", "train.txt"),
        "test": os.path.join(PKG_DATA, "lists", "test.txt"),
        "pair": os.path.join(PKG_DATA, "dtu_pairs.txt"),
    }


def make_train_val_datasets(cfg: Config):
    from ..data.dtu_train import MVSDataset

    paths = default_split_paths()
    if cfg.train_list:
        paths["train"] = cfg.train_list
    if cfg.val_list:
        paths["test"] = cfg.val_list
    if cfg.pair_file:
        paths["pair"] = cfg.pair_file
    train_ds = MVSDataset(
        root_dir=cfg.root_dir, split="train", split_filepath=paths["train"],
        pair_filepath=paths["pair"], n_views=cfg.train_n_view,
        view_selection_type=cfg.view_selection_type, ndepths=cfg.numdepth,
        seed=cfg.seed)
    val_ds = MVSDataset(
        root_dir=cfg.root_dir, split="test", split_filepath=paths["test"],
        pair_filepath=paths["pair"], n_views=cfg.test_n_view,
        test_ref_views=list(cfg.test_ref_view), view_selection_type="best",
        ndepths=cfg.numdepth, seed=cfg.seed)
    return train_ds, val_ds


def _prefetch(dataset, order, n_workers: int = 8, lookahead: int = 4) -> Iterator:
    """Samples of ``order`` loaded ahead by a thread pool."""
    if n_workers <= 0:
        for i in order:
            yield dataset[i]
        return
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        order = list(order)
        futures = [pool.submit(dataset.__getitem__, i) for i in order[:lookahead]]
        nxt = lookahead
        for _ in order:
            fut = futures.pop(0)
            if nxt < len(order):
                futures.append(pool.submit(dataset.__getitem__, order[nxt]))
                nxt += 1
            yield fut.result()


def _gather_ray_batch(extras: Dict, ray_idx: np.ndarray):
    """Ray directions, gt rgb and gt depth of the chosen rays
    (reference model.py:403-414)."""
    h, w = extras["hw"]
    rgb_gt = extras["ref_img"].reshape(h * w, 3)[ray_idx]
    if extras.get("depths_h") is not None:
        depth_gt = extras["depths_h"][0].reshape(h * w)[ray_idx]
    else:
        depth_gt = np.zeros(len(ray_idx), np.float32)
    ray_d = extras["ray_d"][ray_idx]
    return (ray_d.astype(np.float32), rgb_gt.astype(np.float32),
            depth_gt.astype(np.float32))


def _on(device, *arrays):
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device) for a in arrays)


def init_model(cfg: Config, seed: int = 0, device=DEFAULT) -> UFORecon:
    """A model with seeded random weights (``convert.init_weights``) on
    ``device``."""
    model = UFORecon(cfg)
    init_weights(model, seed)
    return model.to(resolve_device(device))


@torch.no_grad()
def run_validation(cfg: Config, model: UFORecon, val_ds, device=DEFAULT,
                   max_samples: Optional[int] = None) -> Dict[str, float]:
    """Chunked validation over the validation set (model.py:607-726)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 7)
    agg: Dict[str, list] = {}
    n = len(val_ds) if max_samples is None else min(max_samples, len(val_ds))
    for i in range(n):
        scene, extras = scene_inputs_from_sample(val_ds[i], device)
        h, w = extras["hw"]
        total, rn = h * w, cfg.train_ray_num
        idx_all = np.arange(total)
        enc = model.encode(scene)
        rgbs, logs_sum, n_chunks = [], None, 0
        for s in range(0, total, rn):
            idx = idx_all[s:s + rn]
            if len(idx) < rn:   # the last chunk wraps round (stats-neutral)
                idx = np.concatenate([idx, idx_all[: rn - len(idx)]])
            ray_d, rgb_gt, depth_gt = _on(device, *_gather_ray_batch(extras, idx))
            logs, rgb_f, _ = val_step(cfg, model, scene, enc, ray_d, rgb_gt, depth_gt, gen)
            rgbs.append(rgb_f)
            logs_sum = logs if logs_sum is None else {k: logs_sum[k] + v
                                                      for k, v in logs.items()}
            n_chunks += 1
        rgb_img = torch.cat(rgbs)[:total].reshape(h, w, 3).cpu()
        rec = {k.replace("train/", "val/loss_"): float(v) / n_chunks
               for k, v in logs_sum.items()}
        rec["val/psnr_fine"] = float(psnr(rgb_img, torch.as_tensor(extras["ref_img"])))
        for k, v in rec.items():
            agg.setdefault(k, []).append(v)
    out = {k: float(np.mean(v)) for k, v in agg.items()}
    # the reference's monitor name (main.py:199)
    if "val/loss_depth_ray_fine" in out:
        out["val/loss_depth_fine"] = out["val/loss_depth_ray_fine"]
    return out


def _checkpoint(state: TrainState) -> Dict:
    return {"state_dict": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(), "step": state.step}


def pretrain_mvs(cfg: Config, train_ds=None, model: Optional[UFORecon] = None,
                 max_steps: Optional[int] = None, log_every: int = 20,
                 n_workers: int = 8, device=DEFAULT) -> TrainState:
    """Train the cascade matcher on ground-truth depth (the entropy loss of
    the rotation-0 pass, ``trainer.mvs_pretrain_step``). The reference
    relies on a pretrained TransMVSNet checkpoint absent from its
    snapshot; this makes one."""
    device = resolve_device(device)
    if train_ds is None:
        train_ds, _ = make_train_val_datasets(cfg)
    rng_np = np.random.default_rng(cfg.seed)
    if model is None:
        Log.info("initializing model (mvs pretraining)...")
        model = init_model(cfg, cfg.seed, device)
    state = TrainState(model, make_pretrain_optimizer(cfg, model))

    logdir = os.path.join(cfg.logdir, cfg.exp_name + "_mvs")
    writer = MetricWriter(logdir)
    ckpt = CheckpointManager(os.path.join(logdir, "ckpt"), monitor="mvs/loss")
    total = max_steps or cfg.max_epochs * len(train_ds)
    logs = None
    try:
        while state.step < total:
            for sample in _prefetch(train_ds, rng_np.permutation(len(train_ds)),
                                    n_workers=n_workers):
                scene, extras = scene_inputs_from_sample(sample, device)
                # the raw mm gt of the MVS reference view: source view 0, the
                # stacked view 1 at train start_idx 1
                if extras["depths_mm"] is not None:
                    d = extras["depths_mm"]
                    depth_mm = d[1 if d.shape[0] > 1 else 0]
                elif extras["depths_h"] is not None:
                    d = extras["depths_h"]
                    depth_mm = d[1 if d.shape[0] > 1 else 0] / max(
                        float(sample["scale_factor"]), 1e-9)
                else:
                    continue
                depth_mm, = _on(device, depth_mm)
                logs = mvs_pretrain_step(model, state.optimizer, scene, depth_mm,
                                         (depth_mm > 0).float())
                state = state._replace(step=state.step + 1)
                if state.step % log_every == 0 or state.step == 1:
                    vals = {k: float(v) for k, v in logs.items()}
                    writer.scalars(state.step, vals)
                    Log.info(f"mvs step {state.step}/{total} loss={vals['mvs/loss']:.4f}")
                if state.step >= total:
                    break
            if logs is None:
                raise ValueError("no training sample carries a depth map")
            ckpt.save(state.step, _checkpoint(state), {"mvs/loss": float(logs["mvs/loss"])})
    finally:
        writer.close()
    return state


def _maybe_restore(model: UFORecon, load_ckpt: str) -> None:
    """Fill ``model`` from ``--load_ckpt`` (any format
    ``convert.load_weights`` reads)."""
    if load_ckpt:
        load_weights(model, load_ckpt)
        Log.info(f"restored params from {load_ckpt}")


def validate_only(cfg: Config, val_ds=None, model: Optional[UFORecon] = None,
                  device=DEFAULT) -> Dict[str, float]:
    """One validation pass without training (reference main.py:222-224
    ``--val_only``); returns the metrics."""
    if val_ds is None:
        _, val_ds = make_train_val_datasets(cfg)
    if model is None:
        model = init_model(cfg, cfg.seed, device)
    _maybe_restore(model, cfg.load_ckpt)
    metrics = run_validation(cfg, model, val_ds, device,
                             max_samples=1 if cfg.debug else None)
    Log.ok("val: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    return metrics


def fit(cfg: Config, train_ds=None, val_ds=None, model: Optional[UFORecon] = None,
        max_steps: Optional[int] = None, val_every: Optional[int] = None,
        log_every: int = 20, n_workers: int = 8, device=DEFAULT,
        draws: Optional[Iterable[Tuple[np.ndarray, np.ndarray]]] = None) -> TrainState:
    """Train the render side (matcher frozen); returns the final state.

    ``max_steps`` / ``val_every`` override the epoch structure (smoke runs);
    by default one epoch is one pass over ``train_ds`` and validation runs
    at each epoch's end (check_val_every_n_epoch=1, reference main.py:210).
    ``model`` (default: ``init_model`` with ``cfg.seed``) is trained in
    place; ``--load_ckpt`` fills it first. ``draws``: one ``(u_coarse,
    u_fine)`` pair of the whole step's rays per scene step (each rank
    takes its rows)."""
    device = resolve_device(device)
    world, main = sharding.world_size(), sharding.rank() == 0
    if train_ds is None or val_ds is None:
        tds, vds = make_train_val_datasets(cfg)
        train_ds = train_ds or tds
        val_ds = val_ds or vds
    rng_np = np.random.default_rng(cfg.seed)
    if model is None:
        Log.info("initializing model...")
        model = init_model(cfg, cfg.seed, device)
    _maybe_restore(model, cfg.load_ckpt)
    sharding.broadcast_module_(model)
    state = TrainState(model, make_optimizer(cfg, model))
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    draws = iter(draws) if draws is not None else None
    rn = -(-cfg.train_ray_num // world) * world

    logdir = os.path.join(cfg.logdir, cfg.exp_name)
    writer = MetricWriter(logdir) if main else None
    ckpt = CheckpointManager(os.path.join(logdir, "ckpt")) if main else None

    batch = max(1, cfg.batch_size)
    steps_per_epoch = max(1, len(train_ds) // batch)
    total_steps = max_steps or cfg.max_epochs * steps_per_epoch

    def validate():
        metrics = None
        if main:
            metrics = run_validation(cfg, model, val_ds, device,
                                     max_samples=1 if cfg.debug else None)
            writer.scalars(state.step, metrics)
            ckpt.save(state.step, _checkpoint(state), metrics)
        sharding.barrier()
        return metrics

    epoch = 0
    logs_sum, n_acc = None, 0
    try:
        while state.step < total_steps:
            order = rng_np.permutation(len(train_ds))
            if max_steps:
                # scenes already accumulated toward the next update carry over
                order = order[: (max_steps - state.step) * batch - n_acc]
            for sample in _prefetch(train_ds, order, n_workers=n_workers):
                scene, extras = scene_inputs_from_sample(sample, device)
                h, w = extras["hw"]
                ray_idx = rng_np.permutation(h * w)[:rn]
                ray_d, rgb_gt, depth_gt = _on(device, *_gather_ray_batch(extras, ray_idx))
                u = None if draws is None else _on(device, *next(draws))
                logs = grad_step(cfg, model, scene, ray_d, rgb_gt, depth_gt, gen, u)
                logs_sum = logs if logs_sum is None else {k: logs_sum[k] + v
                                                          for k, v in logs.items()}
                n_acc += 1
                if n_acc < batch:
                    continue
                logs_sum = all_reduce_step(model, logs_sum)
                apply_step(state.optimizer, n_acc)
                logs = {k: float(v) / n_acc for k, v in logs_sum.items()}
                logs_sum, n_acc = None, 0
                state = state._replace(step=state.step + 1)
                if main and (state.step % log_every == 0 or state.step == 1):
                    writer.scalars(state.step, logs)
                    Log.info(f"step {state.step}/{total_steps} "
                             f"loss={logs['train/loss_all']:.4f}")
                if val_every and state.step % val_every == 0:
                    validate()
                if state.step >= total_steps:
                    break
            epoch += 1
            if not val_every and state.step <= total_steps:
                metrics = validate()
                if main:
                    Log.ok(f"epoch {epoch}: "
                           + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    finally:
        if writer is not None:
            writer.close()
    return state
