"""The port's training steps (``pipeline/trainer.py``) against the JAX trainer.

One tiny scene (the port's learn_sanity sphere: 3 views, 32x32, 16
hypotheses), a tiny model (cascade depths 8/8/8, one FMT self/cross pair,
8 + 8 samples, 64 rays) initialised by the JAX package and bridged into
the port (``load_flax_variables``), the same rays and the same uniform
draws (JAX's key schedule: ``render_chunk`` splits its key into the coarse
and the fine draws). The JAX side runs once per module, jitted.

Tolerances (f32 with another summation order through the model):
  * train-mode BatchNorm: outputs 1e-5, running mean and var 1e-6 after
    one update;
  * the MVS pretraining step: stage entropies and loss 1e-5 relative, the
    BatchNorm statistics after the step 1e-5. Its gradient at a random
    init is not a stable function of the forward's rounding: PixelwiseNet
    takes a max over hypotheses, stages 2 and 3 take their hypotheses
    around a winner-take-all depth, and the batch-statistics BatchNorms
    see few pixels, so the port's own matcher gradients move by up to
    ~5 % of a leaf's largest under a 1e-6 relative change of the weights,
    and so do JAX's against the port's. Held: stage 1's cost regulariser
    (no max or winner-take-all between it and its loss) within 1e-4 of
    each leaf's largest gradient; every other leaf within 5e-2; the whole
    matcher gradient at cosine >= 0.999; the leaves whose gradient is zero
    up to rounding zero on both sides;
  * ``render_losses``' terms 1e-5; the coarse-only gradient step: every
    trainable leaf within 1e-4 of its largest gradient (a leaf whose
    gradient is zero up to rounding, below 1e-6 of the largest, is so on
    both sides);
  * the full step's loss and terms 1e-3 relative: a ~1e-7 difference can
    move an importance-sampling bin of a ray, and with it the fine pass;
  * Adam on identical gradients: parameters 1e-6 after two updates (Adam's
    first update is ~lr * sign(g), so parameters are compared only on the
    same gradients);
  * ``mvs_entropy_loss``, the nearest downsampling: equal; PSNR, SSIM 1e-5.
The stale-pack guard: Adam's for-loop and foreach implementations bump
the ``_version`` of every trainable parameter they update, so the head
kernels' pack cache builds anew after each step; the fused one does not,
and the trainer refuses it.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu.config import Config as JaxConfig
from uforecon_tpu.data.convert import scene_inputs_from_sample as jax_scene_inputs
from uforecon_tpu.models import layers as jax_layers
from uforecon_tpu.pipeline import trainer as jax_trainer
from uforecon_tpu.pipeline.fit import init_model as jax_init_model
from uforecon_tpu.utils import metrics as jax_metrics

from uforecon_tpu_torch.config import EXACT, Config
from uforecon_tpu_torch.convert import flax_to_state_dict, init_weights, load_flax_variables
from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
from uforecon_tpu_torch.models import layers
from uforecon_tpu_torch.models.uforecon import UFORecon
from uforecon_tpu_torch.ops.cuda_build import PackCache
from uforecon_tpu_torch.ops.resize import resize_nearest
from uforecon_tpu_torch.pipeline import trainer
from uforecon_tpu_torch.pipeline.fit import _gather_ray_batch
from uforecon_tpu_torch.script import learn_sanity
from uforecon_tpu_torch.utils import metrics

torch.set_num_threads(1)

RN, SAMPLES, SEED = 64, 8, 0
SMALL = dict(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"), coarse_sample=SAMPLES,
             fine_sample=SAMPLES, train_ray_num=RN, numdepth=16, train_n_view=3)


def _jax_cfg():
    return JaxConfig(**SMALL, volume_type="correlation", volume_merge="never",
                     volume_dtype="float32", image_gather_dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sample():
    views = learn_sanity.build_scene_views(4, 32, 32)
    return learn_sanity.SphereDataset(views, n_src=2, ndepth=16)[0]


def _jax_pretrain_loss(model, variables, scene, depth_mm, mask, dlossw=(0.5, 1.0, 2.0)):
    """The loss of the JAX ``make_mvs_pretrain_step`` (trainer.py:225-245),
    its batch_stats and its logs, as a function of params."""
    def loss_fn(params):
        enc, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            scene.source_imgs, scene.proj_matrices, scene.depth_values, True,
            method=lambda m, *a: m.matcher(*a), mutable=["batch_stats"])
        total, logs = 0.0, {}
        for s, w in zip(range(1, 4), dlossw):
            aux = enc["rot0"][f"stage{s}"]
            prob, dv = aux["prob_volume"], aux["depth_values"]
            hs, ws = prob.shape[1:]
            d_gt = jax.image.resize(depth_mm, (hs, ws), method="nearest")
            m = jax.image.resize(mask, (hs, ws), method="nearest")
            loss, _ = jax_trainer.mvs_entropy_loss(prob, d_gt, m, dv)
            total = total + 2.0 * w * loss
            logs[f"mvs/entropy_stage{s}"] = loss
        logs["mvs/loss"] = total
        return total, (logs, mutated["batch_stats"])

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model's variables and, on one ray batch with one set of
    draws, its full and coarse-only gradient steps, two Adam updates on
    the full step's gradients, and its MVS pretraining step."""
    cfg = _jax_cfg()
    sample = _sample()
    model, variables = jax_init_model(cfg, sample, SEED)
    scene, extras = jax_scene_inputs(sample)
    idx = np.random.default_rng(SEED).permutation(32 * 32)[:RN]
    ray_d, rgb_gt, depth_gt = _gather_ray_batch(extras, idx)
    key = jax.random.PRNGKey(1)
    k_c, k_f = jax.random.split(key)
    draws = (np.asarray(jax.random.uniform(k_c, (RN, SAMPLES), jnp.float32)),
             np.asarray(jax.random.uniform(k_f, (RN, SAMPLES), jnp.float32)))
    state = jax_trainer.create_train_state(cfg, variables)
    rays = tuple(map(jnp.asarray, (ray_d, rgb_gt, depth_gt)))

    grads, logs = jax_trainer.make_grad_step(cfg, model)(state, scene, *rays, key)

    def coarse_loss(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        enc = model.apply(v, scene, method=model.encode)
        out = model.apply(v, scene, enc, rays[0], key, None, None, True,
                          method=model.render_chunk)
        return jax_trainer.render_losses(cfg, out, rays[1], rays[2], scene.near, scene.far)

    (_, coarse_logs), coarse_grads = jax.jit(jax.value_and_grad(coarse_loss, has_aux=True))(
        variables["params"])

    apply = jax_trainer.make_apply_step(jax_trainer.make_optimizer(cfg))
    adam = apply(apply(state, grads, 1.0), grads, 1.0)

    depth_mm = jnp.asarray(extras["depths_mm"][1])
    (_, (mvs_logs, mvs_stats)), mvs_grads = _jax_pretrain_loss(
        model, variables, scene, depth_mm, (depth_mm > 0).astype(jnp.float32))
    return dict(sample=sample, variables=_np(variables), idx=idx, draws=draws,
                grads=_np(grads), logs=_np(logs), coarse_grads=_np(coarse_grads),
                coarse_logs=_np(coarse_logs), adam_params=_np(adam.params),
                mvs_logs=_np(mvs_logs), mvs_stats=_np(mvs_stats), mvs_grads=_np(mvs_grads))


def _port(jax_side):
    """A port model on the JAX weights (the JAX side's exact knobs), and the
    scene, rays and draws."""
    model = UFORecon(Config(**SMALL, **EXACT))
    load_flax_variables(model, jax_side["variables"])
    scene, extras = scene_inputs_from_sample(jax_side["sample"], "cpu")
    rays = [torch.as_tensor(a) for a in _gather_ray_batch(extras, jax_side["idx"])]
    draws = tuple(torch.as_tensor(u) for u in jax_side["draws"])
    return model, scene, extras, rays, draws


def _state_tree(tree):
    """A JAX params tree under the port's state-dict keys and layouts."""
    return flax_to_state_dict({"params": tree})


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def _check_grads(model, want, tol, names):
    """Each leaf's gradient within ``tol`` of its largest. A leaf whose
    gradient is zero up to rounding (below 1e-6 of the largest gradient of
    all ``names``; e.g. the last bias of the radiance softmax, which shifts
    every view's logit alike) must be so on both sides."""
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
    bad = {n: e for n, e in errors.items() if e > tol}
    assert not bad, bad


# --------------------------------------------------------------------------
# train-mode BatchNorm
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [2, 3])
def test_batchnorm_train_mode_matches_flax(dims):
    rng = np.random.default_rng(dims)
    shape = (2, 6, 7, 5) if dims == 2 else (1, 4, 6, 7, 5)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    jmod = jax_layers.ConvBnRelu(8) if dims == 2 else jax_layers.Conv3dBnRelu(8)
    variables = _np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    # running statistics away from their (0, 1) start, and a non-unit scale
    variables["batch_stats"]["BatchNorm_0"] = {
        "mean": rng.standard_normal(8).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}
    variables["params"]["BatchNorm_0"] = {
        "scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
        "bias": rng.standard_normal(8).astype(np.float32)}
    want, mutated = jmod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    port = (layers.ConvBnRelu(5, 8) if dims == 2 else layers.Conv3dBnRelu(5, 8))
    load_flax_variables(port, variables)
    # module.training is not read: only the explicit flag selects train mode
    port.eval()
    got = port(torch.as_tensor(np.moveaxis(x, -1, 1)), train=True)
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    bn = port.BatchNorm_0
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], rtol=0, atol=1e-6)
    # eval mode leaves the running statistics alone
    before = bn.running_mean.clone()
    port.train()
    port(torch.as_tensor(np.moveaxis(x, -1, 1)))
    assert torch.equal(bn.running_mean, before)


def test_deform_conv_gradients_match_jax_at_pixel_positions():
    """The DCN's gradients, offsets included, where taps sit on pixels (the
    zero-initialised offsets: every tap at the first pretraining step),
    off them, and beyond the border: JAX's clip/abs derivatives, copied."""
    from uforecon_tpu.ops.deform_conv import deform_conv2d as jax_dcn

    from uforecon_tpu_torch.ops.deform_conv import deform_conv2d

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 7, 3)).astype(np.float32)
    off = np.zeros((2, 6, 7, 9, 2), np.float32)
    frac = rng.random(off.shape) > 0.5
    off[frac] = rng.uniform(-1.5, 1.5, frac.sum())
    off[0, 0, :, 0] = -1.0                         # on pixels outside the image
    mask = rng.random((2, 6, 7, 9)).astype(np.float32)
    wk = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    g = rng.standard_normal((2, 6, 7, 4)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_dcn(*a) * g), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, off, mask, wk)))
    ts = [torch.tensor(a, requires_grad=True)
          for a in (x, off, mask, wk.transpose(3, 2, 0, 1))]
    (deform_conv2d(*ts) * torch.as_tensor(g)).sum().backward()
    got = [t.grad.numpy() for t in ts]
    got[3] = got[3].transpose(2, 3, 1, 0)
    for name, a, b in zip(("x", "offsets", "mask", "weight"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=name)


# --------------------------------------------------------------------------
# losses and the MVS pretraining step
# --------------------------------------------------------------------------


def test_mvs_entropy_loss_and_nearest_downsample_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((8, 12, 10)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(0, keepdims=True)
    dv = np.sort(rng.uniform(2.0, 6.0, (8, 12, 10)), axis=0).astype(np.float32)
    gt = rng.uniform(1.5, 6.5, (12, 10)).astype(np.float32)
    mask = (rng.random((12, 10)) > 0.3).astype(np.float32)
    want_l, want_w = jax_trainer.mvs_entropy_loss(*map(jnp.asarray, (prob, gt, mask, dv)))
    got_l, got_w = trainer.mvs_entropy_loss(*map(torch.as_tensor, (prob, gt, mask, dv)))
    np.testing.assert_allclose(got_l.item(), float(want_l), rtol=1e-6)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    depth = rng.uniform(400, 900, (32, 40)).astype(np.float32)
    for hw in ((8, 10), (16, 20), (32, 40), (11, 13)):
        want = jax.image.resize(jnp.asarray(depth), hw, method="nearest")
        np.testing.assert_array_equal(resize_nearest(torch.as_tensor(depth), hw).numpy(),
                                      np.asarray(want))


def test_render_losses_match_jax():
    rng = np.random.default_rng(2)
    out = {p: {"rgb": rng.random((RN, 3)).astype(np.float32),
               "depth": rng.uniform(2, 6, RN).astype(np.float32),
               "variance": np.float32(0.05)} for p in ("coarse", "fine")}
    rgb_gt = rng.random((RN, 3)).astype(np.float32)
    depth_gt = np.where(rng.random(RN) > 0.3, rng.uniform(1.5, 6.5, RN), 0).astype(np.float32)
    cfg = Config(weight_rgb=0.7, weight_depth=1.3)
    want_l, want = jax_trainer.render_losses(
        JaxConfig(weight_rgb=0.7, weight_depth=1.3), jax.tree_util.tree_map(jnp.asarray, out),
        jnp.asarray(rgb_gt), jnp.asarray(depth_gt), jnp.float32(2.8), jnp.float32(5.2))
    t_out = {p: {k: torch.as_tensor(v) for k, v in d.items()} for p, d in out.items()}
    got_l, got = trainer.render_losses(cfg, t_out, torch.as_tensor(rgb_gt),
                                       torch.as_tensor(depth_gt), torch.tensor(2.8),
                                       torch.tensor(5.2))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got_l.item(), float(want_l), rtol=1e-5)


def test_mvs_pretrain_step_matches_jax(jax_side):
    model, scene, extras, _, _ = _port(jax_side)
    opt = trainer.make_pretrain_optimizer(model.cfg, model)
    depth_mm = torch.as_tensor(extras["depths_mm"][1])
    logs = trainer.mvs_pretrain_step(model, opt, scene, depth_mm, (depth_mm > 0).float())
    want = jax_side["mvs_logs"]
    assert set(logs) == set(want)
    for k in want:
        assert _rel(logs[k], want[k]) <= 1e-5, (k, float(logs[k]), float(want[k]))
    want = _state_tree({"matcher": jax_side["mvs_grads"]["matcher"]})
    got = {n: p.grad.numpy() for n, p in model.matcher.named_parameters(prefix="matcher")}
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    # stage 1's cost regulariser: no max or winner-take-all between it and
    # its loss, so its gradient is stable; held at 1e-4
    stable = [n for n in got if n.startswith("matcher.cost_reg_0.")]
    assert stable
    _check_grads(model, want, 1e-4, stable)
    flat_g = np.concatenate([got[n].ravel() for n in sorted(got)])
    flat_w = np.concatenate([want[n].ravel() for n in sorted(got)])
    assert flat_g @ flat_w / (np.linalg.norm(flat_g) * np.linalg.norm(flat_w)) >= 0.999
    for n, w in want.items():
        if np.abs(w).max() < 1e-6 * top:
            # a zero gradient up to rounding (a bias under a batch-statistics
            # BatchNorm, PixelwiseNet's last bias under the view-weight
            # normalisation): zero up to rounding on both sides
            assert np.abs(got[n]).max() < 1e-6 * top, n
        else:
            err = np.abs(got[n] - w).max() / np.abs(w).max()
            assert err <= 5e-2, (n, err)
    stats = flax_to_state_dict({"batch_stats": jax_side["mvs_stats"]})
    state = model.state_dict()
    assert stats
    for k, v in stats.items():
        np.testing.assert_allclose(state[k].numpy(), v, rtol=1e-5, atol=1e-5, err_msg=k)


# --------------------------------------------------------------------------
# render training: gradients, the full step, Adam
# --------------------------------------------------------------------------


def test_coarse_only_grad_step_matches_jax(jax_side):
    model, scene, _, rays, draws = _port(jax_side)
    trainer.make_optimizer(model.cfg, model)
    logs = trainer.grad_step(model.cfg, model, scene, *rays, draws=draws, coarse_only=True)
    for k, v in jax_side["coarse_logs"].items():
        assert _rel(logs[k], v) <= 1e-5, (k, float(logs[k]), float(v))
    names = [n for n, _ in trainer.trainable_parameters(model)]
    assert "variance" in names and any(n.startswith("mvs_volume.") for n in names)
    _check_grads(model, _state_tree(jax_side["coarse_grads"]), 1e-4, names)
    assert all(p.grad is None for p in model.matcher.parameters())


def test_full_grad_step_matches_jax(jax_side):
    model, scene, _, rays, draws = _port(jax_side)
    trainer.make_optimizer(model.cfg, model)
    logs = trainer.grad_step(model.cfg, model, scene, *rays, draws=draws)
    want = jax_side["logs"]
    assert set(logs) == set(want)
    for k in want:
        assert _rel(logs[k], want[k]) <= 1e-3, (k, float(logs[k]), float(want[k]))
    assert float(want["train/depth_ray_coarse"]) > 0   # the rays hit the sphere


def test_adam_on_identical_gradients_matches_optax(jax_side):
    model, *_ = _port(jax_side)
    opt = trainer.make_optimizer(model.cfg, model)
    grads = _state_tree(jax_side["grads"])
    params = dict(trainer.trainable_parameters(model))
    for _ in range(2):
        for n, p in params.items():
            p.grad = torch.as_tensor(grads[n]).clone()
        trainer.apply_step(opt, 1)
    want = _state_tree(jax_side["adam_params"])
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-6, err_msg=n)


def test_render_training_moves_only_the_trainable_parameters(jax_side):
    """Two steps: the matcher and every BatchNorm's statistics stay bit for
    bit; the volume head and the NeuS variance move."""
    model, scene, _, rays, _ = _port(jax_side)
    before = copy.deepcopy(model.state_dict())
    state = trainer.TrainState(model, trainer.make_optimizer(model.cfg, model))
    gen = torch.Generator().manual_seed(SEED)
    for _ in range(2):
        state, logs = trainer.train_step(model.cfg, state, scene, *rays, gen)
        assert np.isfinite(float(logs["train/loss_all"]))
    after = model.state_dict()
    for k, v in before.items():
        if k.startswith("matcher."):
            assert torch.equal(v, after[k]), k
    assert not torch.equal(before["variance"], after["variance"])
    assert any(not torch.equal(v, after[k]) for k, v in before.items()
               if k.startswith("mvs_volume."))
    assert state.step == 2


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------


def test_psnr_and_ssim_match_jax():
    rng = np.random.default_rng(3)
    x = rng.random((40, 36, 3)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    for a, b in ((x, y), (x, x), (x[..., 0], y[..., 0])):
        ta, tb = torch.as_tensor(a), torch.as_tensor(b)
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        np.testing.assert_allclose(metrics.psnr(ta, tb).item(),
                                   float(jax_metrics.psnr(ja, jb)), rtol=1e-5)
        np.testing.assert_allclose(metrics.ssim(ta, tb).item(),
                                   float(jax_metrics.ssim(ja, jb)), rtol=1e-5, atol=1e-5)
    got = metrics.EvalTools().set_inputs(x, y).get_metrics()
    want = jax_metrics.EvalTools().set_inputs(x, y).get_metrics()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


# --------------------------------------------------------------------------
# the stale-pack guard
# --------------------------------------------------------------------------


@pytest.mark.parametrize("foreach", [False, True], ids=["for-loop", "foreach"])
def test_optimizer_step_bumps_every_trainable_version(foreach):
    """Adam's for-loop and foreach implementations update in place through
    the dispatcher, which bumps ``_version``: the head packs (cached by
    (data_ptr, _version)) are built anew after a step. A write through
    ``.data`` would not be seen; nothing in the trainer writes that way."""
    cfg = Config(**SMALL)
    model = UFORecon(cfg)
    init_weights(model, SEED)
    opt = trainer.make_optimizer(cfg, model, foreach=foreach)
    params = dict(trainer.trainable_parameters(model))

    def head():
        rp = model.ray_transformer.ray_head_params()
        return [t for x in rp for t in (x if isinstance(x, tuple) else (x,))]

    cache = PackCache()
    pack, built = cache.get(head(), lambda: object())
    assert built and cache.get(head(), lambda: object()) == (pack, False)
    versions = {n: p._version for n, p in params.items()}
    for p in params.values():
        p.grad = torch.full_like(p, 0.5)
    trainer.apply_step(opt, 1)
    assert [n for n, p in params.items() if p._version > versions[n]] == list(params)
    assert cache.get(head(), lambda: object())[1]


def test_fused_adam_is_refused():
    """The fused Adam writes the parameters without bumping ``_version``
    (on this CPU build): the pack cache would hand the head kernels stale
    packs, so ``make_optimizer`` refuses it."""
    w = torch.nn.Parameter(torch.ones(4))
    try:
        opt = torch.optim.Adam([w], fused=True)
    except RuntimeError:
        opt = None    # a build without a fused CPU Adam
    if opt is not None:
        before = w._version
        w.grad = torch.ones(4)
        opt.step()
        assert not torch.equal(w.detach(), torch.ones(4))
        assert w._version == before
    model = UFORecon(Config(**SMALL))
    with pytest.raises(ValueError, match="fused Adam"):
        trainer.make_optimizer(model.cfg, model, fused=True)
