"""The JAX package's two bf16 precision policies through the port, against
the JAX model at ``torch_train_configs_common.py``'s size, weights and
draws (the default model; one JAX init serves every policy: the dtypes do
not change the parameter tree).

  * ``--encoder_dtype bfloat16`` (mixed: the frozen matcher in bf16, the
    trained half in float32, kernels 1 and 2 on the card): the render and
    its coarse-only gradients, the port fed JAX's bf16 matcher outputs,
    are held at the float32 rules (``test_torch_port_train_configs.py``):
    coarse depth and rgb within 2e-4, the logs 1e-5 relative, each
    trainable leaf 1e-4 of its largest gradient (or 4x its own spread
    under a 1e-7 change of the weights);
  * ``--compute_dtype bfloat16`` (the volume head and the ray transformer
    in bf16 too: no head kernel, as JAX's gates say), against JAX run
    eagerly (a jitted XLA program may keep a fused chain of bf16 operations
    in float32; flax's program rounds after each, as the port does): the
    coarse render by the bf16 effect's median and 97th percentile (the
    median difference within the median effect, the 97th percentile within
    twice the effect's), the trainable gradient as a whole (each leaf over
    its largest; those zero up to rounding left out) within twice the
    effect's norm;
  * the port's own bf16 matcher's encoding against JAX's: the stage-1
    features and pair maps by the bf16 rule, stage 1's cost volume within
    2 bf16 ulps, the later stages and the MVS depths (winner-take-all
    hypotheses) by the median of the effect.

The bf16 rule (``chip_smoke.py``'s for ``fast``): an output's difference
from JAX's bf16 result no larger than twice the bf16 effect (JAX's bf16
result against JAX's float32 result on the same inputs: the mixed policy's
for ``--compute_dtype bfloat16``, the float32 policy's for the encoder) on
>= 97 % of its elements, its median difference within its median effect.
The per-element form is held where the two packages round the same sums
in other orders only (the layers, ``test_torch_port_bf16_layers.py``; the
features here). Through the whole bf16 render and its backward those
one-step differences add up like the bf16 effect itself: measured, the
port's render and leaf gradients differ from JAX's by 0.5-1.5x the
effect's median, 81-94 % of rays and 34-100 % of a leaf's elements within
twice their own effect, as two roundings of one bf16 computation would.
So there the rule is held over the distribution.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_bf16_model.py -q
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu.config import Config as JaxConfig
from uforecon_tpu.models.cascade import CascadeMatcher
from uforecon_tpu.models.uforecon import UFORecon as JaxUFORecon
from uforecon_tpu.pipeline import trainer as jax_trainer

from uforecon_tpu_torch.pipeline import trainer

from torch_train_configs_common import (JAX_EXACT, SMALL, check_grads, gradient_spread,
                                        jax_setup, port_setup, rel, state_tree)

torch.set_num_threads(1)

SHARE = 0.97
POLICIES = {"f32": dict(), "mixed": dict(encoder_dtype="bfloat16"),
            "bf16": dict(compute_dtype="bfloat16")}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)),
                                  tree)


def bf16_rule(got, want, want32, share=SHARE, axis=None):
    """|got - want| <= 2 |want - want32| on >= ``share`` of the elements (or
    of the rows along ``axis``, all of a row's elements), and the median
    difference within the median effect."""
    got, want, want32 = (np.asarray(a, np.float64) for a in (got, want, want32))
    diff, effect = np.abs(got - want), np.abs(want - want32)
    ok = diff <= 2.0 * effect
    if axis is not None:
        ok = ok.reshape(ok.shape[0], -1).all(axis=1)
    assert ok.mean() >= share, (ok.mean(), diff.max(), effect.max())
    assert np.median(diff) <= np.median(effect), (np.median(diff), np.median(effect))


def bf16_effect_bounds(got, want, want32, name=""):
    """The bf16 rule over the distribution: the median difference within
    the median bf16 effect, the difference's 97th percentile within twice
    the effect's."""
    got, want, want32 = (np.asarray(a, np.float64) for a in (got, want, want32))
    diff, effect = np.abs(got - want), np.abs(want - want32)
    assert np.median(diff) <= np.median(effect), (name, np.median(diff), np.median(effect))
    q_d, q_e = np.percentile(diff, 100 * SHARE), np.percentile(effect, 100 * SHARE)
    assert q_d <= 2.0 * q_e, (name, q_d, q_e)


def _matcher(model, variables, scene):
    return jax.jit(lambda v: model.apply(
        v, scene.source_imgs, scene.proj_matrices, scene.depth_values, False,
        method=lambda m, *a: m.matcher(*a)))(variables)


@pytest.fixture(scope="module")
def jax_side():
    """One JAX init; the bf16 matcher's outputs (the mixed and bf16
    policies' matcher) and the float32 one's; per policy the coarse render
    and the coarse-only gradient (jitted) on the bf16 matcher's outputs,
    which the port is fed too (a matcher compiled into another program may
    round a bf16 sum the other way)."""
    js = jax_setup({})
    variables, scene, rays, key = js["variables"], js["scene"], js["rays"], js["key"]
    models = {name: (cfg, JaxUFORecon(cfg)) for name, cfg in (
        (name, JaxConfig(**SMALL, **JAX_EXACT, **flags)) for name, flags in POLICIES.items())}
    out = {"js": js, "matcher": _matcher(models["mixed"][1], variables, scene),
           "matcher_f32": _matcher(models["f32"][1], variables, scene)}

    def fed(next_fun, args, kwargs, context):
        if isinstance(context.module, CascadeMatcher) and context.method_name == "__call__":
            return out["matcher"]
        return next_fun(*args, **kwargs)

    for name in ("mixed", "bf16"):
        cfg, model = models[name]

        def loss(params, model=model, cfg=cfg):
            v = {"params": params, "batch_stats": variables["batch_stats"]}
            with nn.intercept_methods(fed):
                enc = model.apply(v, scene, method=model.encode)
            o = model.apply(v, scene, enc, rays[0], key, None, None, True,
                            method=model.render_chunk)
            total, logs = jax_trainer.render_losses(cfg, o, rays[1], rays[2], scene.near,
                                                    scene.far)
            return total, (logs, o["coarse"])

        # the bf16 policy eagerly: a jitted XLA program may keep a fused
        # chain of bf16 operations in float32 (excess precision), where
        # flax's program rounds after each operation, as the port does
        grad = jax.value_and_grad(loss, has_aux=True)
        (_, (logs, coarse)), grads = (grad if name == "bf16" else jax.jit(grad))(
            variables["params"])
        out[name] = dict(logs=_f32(logs), coarse=_f32(coarse), grads=_f32(grads))
    return out


def _torch_matcher(enc):
    """JAX matcher outputs as the port's matcher returns them (bf16 stays
    bf16)."""
    def t(a):
        x = torch.as_tensor(np.asarray(jnp.asarray(a).astype(jnp.float32)))
        return x.bfloat16() if a.dtype == jnp.bfloat16 else x

    return {"feat_stage1": t(enc["feat_stage1"]), "aug0": t(enc["aug0"]),
            "aug1": t(enc["aug1"]), "mvs_depth": t(enc["mvs_depth"]),
            "cost_volumes": {k: t(v) for k, v in enc["cost_volumes"].items()}}


def _port_step(jax_side, policy, perturb=0.0):
    """The port's coarse-only grad_step of ``policy`` fed JAX's bf16 matcher
    outputs: its model, logs and coarse render."""
    model, scene, rays, draws = port_setup(jax_side["js"], POLICIES[policy])
    if perturb:
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + perturb * torch.randn(p.shape, generator=gen))
    fed = _torch_matcher(jax_side["matcher"])
    model.matcher.forward = lambda *a, **k: fed
    trainer.make_optimizer(model.cfg, model)
    out = {}
    render = model.render_chunk

    def keep(*a, **k):
        out.update(render(*a, **k))
        return out

    model.render_chunk = keep
    logs = trainer.grad_step(model.cfg, model, scene, *rays, draws=draws, coarse_only=True)
    return model, logs, {k: v.detach().float().numpy() for k, v in out["coarse"].items()}


def test_policies_resolve_as_jax():
    from uforecon_tpu_torch.config import Config

    for flags, enc, dt in ((POLICIES["mixed"], torch.bfloat16, torch.float32),
                           (POLICIES["bf16"], torch.bfloat16, torch.bfloat16)):
        cfg = Config(**flags)
        assert (cfg.encoder_torch_dtype, cfg.dtype) == (enc, dt)


def test_mixed_render_and_gradients_hold_the_float32_rules(jax_side):
    model, logs, coarse = _port_step(jax_side, "mixed")
    want = jax_side["mixed"]
    for k in ("depth", "rgb"):
        np.testing.assert_allclose(coarse[k], want["coarse"][k], rtol=2e-4, atol=2e-4,
                                   err_msg=k)
    for k, v in want["logs"].items():
        assert rel(logs[k], v) <= 1e-5, (k, float(logs[k]), float(v))
    names = [n for n, _ in trainer.trainable_parameters(model)]
    other = _port_step(jax_side, "mixed", perturb=1e-7)[0]
    spread = gradient_spread(model, other, names)
    check_grads(model, state_tree(want["grads"]), {n: max(1e-4, 4 * s)
                                                   for n, s in spread.items()}, names)
    # the trained half computes in float32
    assert model.ray_transformer.dtype == torch.float32
    assert model.matcher.cost_reg_0.Conv_0.compute_dtype == torch.bfloat16


def test_bf16_render_and_gradients_hold_the_bf16_effect(jax_side):
    """The coarse render by the bf16 effect's median and 97th percentile;
    the trainable gradient as a whole (each leaf over its largest JAX
    gradient, those zero up to rounding left out): its distance from JAX's
    bf16 gradient within twice the distance between JAX's bf16 and mixed
    gradients."""
    model, logs, coarse = _port_step(jax_side, "bf16")
    want, ref = jax_side["bf16"], jax_side["mixed"]
    for k in ("depth", "rgb", "opacity"):
        bf16_effect_bounds(coarse[k], want["coarse"][k], ref["coarse"][k], k)
    w, w32 = state_tree(want["grads"]), state_tree(ref["grads"])
    got = {n: p.grad.numpy() for n, p in trainer.trainable_parameters(model)}
    top = max(np.abs(w[n]).max() for n in got)
    # a leaf whose gradient is zero up to rounding has no scale of its own
    scale = {n: np.abs(w[n]).max() for n in got if np.abs(w[n]).max() >= 1e-6 * top}
    diff = np.concatenate([((got[n] - w[n]) / scale[n]).ravel() for n in sorted(scale)])
    effect = np.concatenate([((w[n] - w32[n]) / scale[n]).ravel() for n in sorted(scale)])
    assert np.linalg.norm(diff) <= 2.0 * np.linalg.norm(effect), (
        np.linalg.norm(diff), np.linalg.norm(effect))
    assert model.ray_transformer.dtype == torch.bfloat16
    assert model.mvs_volume.conv0.compute_dtype == torch.bfloat16


def test_bf16_encoding_holds_the_bf16_rule(jax_side):
    """The port's own bf16 matcher against JAX's, the float32 matcher the
    effect's reference: the stage-1 features and pair maps (float32 out of
    their LayerNorms on both sides) by the bf16 rule; stage 1's cost volume
    (bf16; no winner-take-all before it) within 2 bf16 ulps; the later
    stages' volumes and the MVS depths, which take their hypotheses from a
    winner-take-all depth, by the median of the bf16 effect."""
    from test_torch_port_bf16_layers import assert_bf16_ulps

    model, scene, _, _ = port_setup(jax_side["js"], POLICIES["mixed"])
    model.requires_grad_(False)
    got = model.matcher(scene.source_imgs, scene.proj_matrices, scene.depth_values)
    want, want32 = jax_side["matcher"], jax_side["matcher_f32"]
    for k in ("feat_stage1", "aug0", "aug1"):
        assert got[k].dtype == torch.float32
        bf16_rule(got[k].numpy(), _f32(want[k]), _f32(want32[k]))
    vols = got["cost_volumes"]
    assert all(v.dtype == torch.bfloat16 for v in vols.values())
    nv = vols["stage1"].shape[0]
    assert_bf16_ulps(vols["stage1"].float().numpy().reshape(nv, -1),
                     _f32(want["cost_volumes"]["stage1"]).reshape(nv, -1))
    for got_k, k in ((vols["stage2"], "stage2"), (vols["stage3"], "stage3"),
                     (got["mvs_depth"], None)):
        w = want["cost_volumes"][k] if k else want["mvs_depth"]
        w32 = want32["cost_volumes"][k] if k else want32["mvs_depth"]
        diff = np.abs(got_k.float().numpy() - _f32(w))
        assert np.median(diff) <= np.median(np.abs(_f32(w) - _f32(w32))), k
