"""What one rank of the multi-card tests runs (``parallel.sharding.spawn``
imports this module, which imports no JAX, in each new rank process).

``rank_checks`` renders one view's rays with the generator and with given
draws, takes one sharded gradient step, and checks that a weight pack
built before a broadcast or a ``load_state_dict`` is not reused after it;
``cli_debug_rank`` runs ``cli.run --debug``'s work on one rank, on the
learn_sanity sphere.
"""
import numpy as np
import torch

from uforecon_tpu_torch.config import EXACT, Config
from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
from uforecon_tpu_torch.models.uforecon import UFORecon
from uforecon_tpu_torch.ops.cuda_build import PackCache
from uforecon_tpu_torch.ops.fused_point_head import _flat_params
from uforecon_tpu_torch.parallel import sharding
from uforecon_tpu_torch.pipeline import trainer
from uforecon_tpu_torch.pipeline.renderer import SceneRenderer
from uforecon_tpu_torch.script import learn_sanity

SAMPLES = 4
SMALL = dict(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"), coarse_sample=SAMPLES,
             fine_sample=SAMPLES, test_sample_coarse=SAMPLES, test_sample_fine=SAMPLES,
             numdepth=16, train_n_view=3)
CHUNK = 96          # 1024 rays: 11 chunks on one rank, 12 on two


def sample():
    """The learn_sanity sphere: 3 views at 32x32, 16 hypotheses."""
    return learn_sanity.SphereDataset(learn_sanity.build_scene_views(4, 32, 32),
                                      n_src=2, ndepth=16)[0]


def port_model(state_dict, device="cpu"):
    """The tiny model on the exact path with ``state_dict``'s weights (the
    JAX package's, bridged by ``convert.flax_to_state_dict``)."""
    model = UFORecon(Config(**SMALL, **EXACT))
    model.load_state_dict(state_dict)
    return model.to(device)


def render(model, device="cpu", draws=None, seed=0):
    """All rays of the sample's reference view, at its near/far; rank 0
    gets (rgb, depth, opacity), the others None."""
    scene, extras = scene_inputs_from_sample(sample(), device)
    n = extras["ray_d"].shape[0]
    near = np.full(n, float(scene.near), np.float32)
    far = np.full(n, float(scene.far), np.float32)
    with torch.no_grad():
        enc = model.encode(scene)
    gen = torch.Generator(device=device).manual_seed(seed)
    return SceneRenderer(model, device, chunk=CHUNK).render_rays(
        scene, enc, extras["ray_d"], near, far, gen, draws)


def grad_step(model, device, rays, draws):
    """One gradient step over the whole batch ``rays`` (each rank its
    share, all-reduced); returns the logs and the trainable gradients."""
    scene, _ = scene_inputs_from_sample(sample(), device)
    rays = [torch.as_tensor(a, device=device) for a in rays]
    draws = tuple(torch.as_tensor(u, device=device) for u in draws)
    trainer.make_optimizer(model.cfg, model)
    logs = trainer.grad_step(model.cfg, model, scene, *rays, draws=draws)
    logs = trainer.all_reduce_step(model, logs)
    grads = {n: p.grad.cpu().numpy() for n, p in trainer.trainable_parameters(model)
             if p.grad is not None}
    return {k: float(v) for k, v in logs.items()}, grads


def pack_rebuilds(model):
    """Whether the point head's pack is built anew after a broadcast of
    the weights and after a ``load_state_dict``, and reused otherwise."""
    cache = PackCache()

    def head():
        return _flat_params(model.ray_transformer.point_head_params())

    cache.get(head(), object)
    reused = not cache.get(head(), object)[1]
    sharding.broadcast_module_(model)
    after_broadcast = cache.get(head(), object)[1]
    model.load_state_dict(model.state_dict())
    after_load = cache.get(head(), object)[1]
    return {"reused": reused, "broadcast": after_broadcast, "load_state_dict": after_load}


def rank_checks(device, state_dict, jax_draws, rays, step_draws):
    """Rank 0's renders (generator, JAX's draws), gradient step and pack
    checks; every rank's pack checks."""
    model = port_model(state_dict, device)
    out = {"render_gen": render(model, device),
           "render_jax": render(model, device, draws=jax_draws),
           "step": grad_step(model, device, rays, step_draws),
           "packs": pack_rebuilds(model), "world": sharding.world_size()}
    return out if sharding.rank() == 0 else {"packs": out["packs"]}


def sphere_datasets(cfg):
    """The learn_sanity sphere in place of the DTU training layout: 4
    training samples, the first as the validation set."""
    ds = learn_sanity.SphereDataset(learn_sanity.build_scene_views(4, 32, 32), 2, 16)
    return ds, [ds[0]]


def cli_debug_rank(device, argv, logdir):
    """``cli.run``'s work on one rank of the CLI's ranks (``run.run``, what
    ``run.main`` gives each rank it starts) on the sphere: the step count,
    rank 0's weights, and the files this rank sees under ``logdir``."""
    import os

    from uforecon_tpu_torch.cli import run
    from uforecon_tpu_torch.pipeline import fit

    fit.make_train_val_datasets = sphere_datasets
    cfg, _ = run.config_from_args(argv)
    state = run.run(cfg, device)
    sharding.barrier()
    files = sorted(os.path.relpath(os.path.join(d, f), logdir)
                   for d, _, names in os.walk(logdir) for f in names)
    return {"step": state.step, "files": files,
            "state_dict": {k: v.clone() for k, v in state.model.state_dict().items()}
            if sharding.rank() == 0 else None}
