"""Shared set-up of the port's training tests for the JAX package's other
model configurations and precision policies (``tests/test_torch_port_
train_configs*.py``; not a test module).

The size is ``test_torch_port_train.py``'s: the learn_sanity sphere (3
views at 32x32, 16 hypotheses), cascade depths 8/8/8, one FMT self/cross
pair, 8 + 8 samples, 64 rays off the border, JAX's initialiser and its draws. The JAX
side's init, encode and gradient are jitted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from uforecon_tpu.config import Config as JaxConfig
from uforecon_tpu.data.convert import scene_inputs_from_sample as jax_scene_inputs
from uforecon_tpu.pipeline import trainer as jax_trainer
from uforecon_tpu.pipeline.fit import init_model as jax_init_model

from uforecon_tpu_torch.config import EXACT, Config
from uforecon_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
from uforecon_tpu_torch.models.uforecon import UFORecon
from uforecon_tpu_torch.pipeline.fit import _gather_ray_batch
from uforecon_tpu_torch.script import learn_sanity

RN, SAMPLES, SEED = 64, 8, 0
SMALL = dict(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"), coarse_sample=SAMPLES,
             fine_sample=SAMPLES, train_ray_num=RN, numdepth=16, train_n_view=3)
JAX_EXACT = dict(volume_merge="never", volume_dtype="float32",
                 image_gather_dtype="float32")
# configuration -> its flags in both packages' Config (test_torch_port_
# configs.py's, at a 16^3 feature grid; share_cr on the default model)
CONFIGS = {
    "featuregrid": dict(volume_type="featuregrid", volume_reso=16, mvs_depth_guide=0,
                        depth_pos_encoding=False),
    "featuregrid_guided": dict(volume_type="featuregrid", volume_reso=16),
    "no_depth_pe": dict(depth_pos_encoding=False),
    "no_depth_guide": dict(mvs_depth_guide=0),
    "dir_srdf": dict(use_dir_srdf=True),
    "no_volume": dict(volume_reso=0),
    "share_cr": dict(share_cr=True),
}


def np_tree(tree):
    """A JAX tree as float32 numpy arrays."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def state_tree(tree):
    """A JAX params tree under the port's state-dict keys and layouts."""
    return flax_to_state_dict({"params": tree})


def rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def sample():
    views = learn_sanity.build_scene_views(4, 32, 32)
    return learn_sanity.SphereDataset(views, n_src=2, ndepth=16)[0]


def jax_setup(flags):
    """The JAX model of ``flags`` at this size, its variables, its scene, one
    ray batch and the draws of its key."""
    cfg = JaxConfig(**SMALL, **JAX_EXACT, **flags)
    smp = sample()
    model, variables = jax_init_model(cfg, smp, SEED)
    scene, extras = jax_scene_inputs(smp)
    # rays off the reference view's border: there the in-bounds mask is a
    # float tie that each package's last bit decides (test_torch_port_
    # configs.py)
    inner = np.arange(32 * 32).reshape(32, 32)[1:-1, 1:-1].ravel()
    idx = np.random.default_rng(SEED).permutation(inner)[:RN]
    rays = tuple(map(jnp.asarray, _gather_ray_batch(extras, idx)))
    key = jax.random.PRNGKey(1)
    k_c, k_f = jax.random.split(key)
    draws = (np.asarray(jax.random.uniform(k_c, (RN, SAMPLES), jnp.float32)),
             np.asarray(jax.random.uniform(k_f, (RN, SAMPLES), jnp.float32)))
    return dict(cfg=cfg, model=model, variables=variables, scene=scene, rays=rays,
                key=key, sample=smp, idx=idx, draws=draws)


def jax_grads(js, coarse_only=True):
    """JAX's render loss and its gradient over the params: the coarse pass
    alone, or both."""
    cfg, model, variables, scene, rays, key = (js[k] for k in (
        "cfg", "model", "variables", "scene", "rays", "key"))

    def loss(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        enc = model.apply(v, scene, method=model.encode)
        out = model.apply(v, scene, enc, rays[0], key, None, None, coarse_only,
                          method=model.render_chunk)
        return jax_trainer.render_losses(cfg, out, rays[1], rays[2], scene.near, scene.far)

    (_, logs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return np_tree(logs), np_tree(grads)


def port_setup(js, flags, **knobs):
    """The port's model of ``flags`` on JAX's weights (its exact knobs), its
    scene, rays and draws."""
    model = UFORecon(Config(**SMALL, **EXACT, **flags, **knobs))
    load_flax_variables(model, np_tree(js["variables"]))
    scene, extras = scene_inputs_from_sample(js["sample"], "cpu")
    rays = [torch.as_tensor(a) for a in _gather_ray_batch(extras, js["idx"])]
    draws = tuple(torch.tensor(u) for u in js["draws"])
    return model, scene, rays, draws


def check_grads(model, want, tol, names):
    """Each leaf's gradient within ``tol`` (a number, or a dict by leaf) of
    its largest (``test_torch_port_train.py``'s rule). A leaf whose
    gradient is zero up to rounding (below 1e-6 of the largest of all
    ``names``) must be so on both sides."""
    assert names
    params = dict(model.named_parameters())
    top = max(np.abs(want[n]).max() for n in names)
    errors = {}
    for name in names:
        g = params[name].grad
        assert g is not None, name
        w = want[name]
        if np.abs(w).max() < 1e-6 * top:
            assert np.abs(g.numpy()).max() < 1e-6 * top, name
            continue
        errors[name] = np.abs(g.numpy() - w).max() / np.abs(w).max()
    bad = {n: (e, tol[n] if isinstance(tol, dict) else tol) for n, e in errors.items()
           if e > (tol[n] if isinstance(tol, dict) else tol)}
    assert not bad, bad


def port_coarse_step(js, flags, perturb=0.0, **knobs):
    """The port's coarse-only ``grad_step`` on JAX's weights (each moved by
    a relative ``perturb``, seeded) and draws: its model and logs."""
    from uforecon_tpu_torch.pipeline import trainer

    model, scene, rays, draws = port_setup(js, flags, **knobs)
    if perturb:
        gen = torch.Generator().manual_seed(SEED + 5)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + perturb * torch.randn(p.shape, generator=gen))
    trainer.make_optimizer(model.cfg, model)
    logs = trainer.grad_step(model.cfg, model, scene, *rays, draws=draws, coarse_only=True)
    return model, logs


def gradient_spread(model, other, names):
    """Each leaf's gradient movement between two runs, over its largest."""
    a, b = dict(model.named_parameters()), dict(other.named_parameters())
    return {n: ((a[n].grad - b[n].grad).abs().max()
                / a[n].grad.abs().max().clamp_min(1e-30)).item() for n in names}


def check_coarse_grad_step(js, flags):
    """The port's coarse-only ``grad_step`` on JAX's draws against JAX's:
    the logs within 1e-5 relative; every trainable leaf within 1e-4 of its
    largest gradient, or, where the step's own float32 rounding moves a
    leaf further, within 4x what a 1e-7 relative change of the weights
    moves the port's own gradient of that leaf (the saturated render of a
    random init makes some configurations' gradients that sensitive:
    measured up to 3.5e-3 for the feature grid without the depth guide);
    the matcher without gradients. Returns the port's model."""
    from uforecon_tpu_torch.pipeline import trainer

    logs_j, grads_j = jax_grads(js)
    model, logs = port_coarse_step(js, flags)
    assert set(logs) == set(logs_j)
    for k, v in logs_j.items():
        assert rel(logs[k], v) <= 1e-5, (k, float(logs[k]), float(v))
    names = [n for n, _ in trainer.trainable_parameters(model)]
    want = state_tree(grads_j)
    assert set(names) == {n for n in want if not n.startswith("matcher.")}
    spread = gradient_spread(model, port_coarse_step(js, flags, perturb=1e-7)[0], names)
    check_grads(model, want, {n: max(1e-4, 4 * s) for n, s in spread.items()}, names)
    assert all(p.grad is None for p in model.matcher.parameters())
    return model
