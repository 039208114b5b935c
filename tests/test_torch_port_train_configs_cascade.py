"""The cascade flags of the JAX CLI through the port, against the JAX
package (``torch_train_configs_common.py``'s size, weights and draws):

  * ``--share_cr``: one cost-regularisation net (``cost_reg_shared``, base
    8) for every stage; the JAX tree loads, the optimizer takes each of
    its parameters once; its render training (a coarse-only step) and its
    MVS pretraining step against JAX's;
  * ``--grad_method undetached``, in the same pretraining step, whose
    gradient of the scene's depth hypotheses (the input the stages'
    hypotheses come from, which ``undetached`` lets the gradient reach
    through every stage) is held to JAX's at 1e-2 of its largest (the
    winner-take-all depths make it move with the forward's rounding:
    measured 2.7e-3). ``test_torch_port_train_configs_undetached.py``
    shows that the flag changes that gradient in both packages.

The pretraining step is held as ``test_torch_port_train.py``'s
``test_mvs_pretrain_step_matches_jax``: the stage entropies and the loss
1e-5 relative, the matcher's BatchNorm statistics after the step 1e-5,
every leaf 5e-2 of its largest and the whole matcher gradient at cosine
>= 0.999 (the max over hypotheses and the winner-take-all make it move
with the forward's rounding; the shared net takes every stage's loss, so
no leaf is held at that test's stable rule), zero-up-to-rounding leaves
zero on both sides.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_train_configs_cascade.py -q
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu.data.convert import scene_inputs_from_sample as jax_scene_inputs
from uforecon_tpu.pipeline import trainer as jax_trainer

from uforecon_tpu_torch.convert import flax_to_state_dict
from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
from uforecon_tpu_torch.pipeline import trainer

from torch_train_configs_common import (CONFIGS, check_coarse_grad_step, check_grads,
                                        jax_setup, np_tree, port_setup, rel)

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["share_cr"])
def test_coarse_grad_step_matches_jax(name):
    check_coarse_grad_step(jax_setup(CONFIGS[name]), CONFIGS[name])


def _pretrain(flags):
    """JAX's MVS pretraining loss (``make_mvs_pretrain_step``'s), its logs,
    batch statistics and gradients over the params and the scene's depth
    hypotheses; and the port's step on the same weights, with the gradient
    of its scene's hypotheses."""
    js = jax_setup(flags)
    model, variables, scene = js["model"], js["variables"], js["scene"]
    _, extras = jax_scene_inputs(js["sample"])
    depth_mm = jnp.asarray(extras["depths_mm"][1])
    mask = (depth_mm > 0).astype(jnp.float32)

    def loss_fn(params, dv):
        enc, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            scene.source_imgs, scene.proj_matrices, dv, True,
            method=lambda m, *a: m.matcher(*a), mutable=["batch_stats"])
        total, logs = 0.0, {}
        for s, w in zip(range(1, 4), (0.5, 1.0, 2.0)):
            aux = enc["rot0"][f"stage{s}"]
            prob, dvs = aux["prob_volume"], aux["depth_values"]
            hs, ws = prob.shape[1:]
            loss, _ = jax_trainer.mvs_entropy_loss(
                prob, jax.image.resize(depth_mm, (hs, ws), method="nearest"),
                jax.image.resize(mask, (hs, ws), method="nearest"), dvs)
            total = total + 2.0 * w * loss
            logs[f"mvs/entropy_stage{s}"] = loss
        logs["mvs/loss"] = total
        return total, (logs, mutated["batch_stats"])

    (_, (logs_j, stats_j)), (grads_j, dv_j) = jax.jit(
        jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
            variables["params"], scene.depth_values)
    port, p_scene, _, _ = port_setup(js, flags)
    p_scene.depth_values.requires_grad_(True)
    opt = trainer.make_pretrain_optimizer(port.cfg, port)
    d = torch.as_tensor(np.asarray(extras["depths_mm"][1]))
    logs = trainer.mvs_pretrain_step(port, opt, p_scene, d, (d > 0).float())
    return dict(variables=np_tree(variables), logs_j=np_tree(logs_j), stats_j=np_tree(stats_j),
                grads_j=np_tree(grads_j), dv_j=np.asarray(dv_j), port=port, logs=logs,
                dv=p_scene.depth_values.grad.numpy(), opt=opt)


# both cascade flags in one pretraining step (one JAX compile)
CASCADE = dict(share_cr=True, grad_method="undetached")


@pytest.fixture(scope="module")
def pretrain():
    return _pretrain(CASCADE)


def test_mvs_pretrain_step_matches_jax(pretrain):
    """The stage-1 regulariser is the shared net here, which every stage's
    loss reaches: no leaf is held at the stable rule's 1e-4."""
    pt = pretrain
    model, logs, want_logs = pt["port"], pt["logs"], pt["logs_j"]
    assert set(logs) == set(want_logs)
    for k in want_logs:
        assert rel(logs[k], want_logs[k]) <= 1e-5, (k, float(logs[k]), float(want_logs[k]))
    want = flax_to_state_dict({"params": {"matcher": pt["grads_j"]["matcher"]}})
    got = {n: p.grad.numpy() for n, p in model.matcher.named_parameters(prefix="matcher")}
    assert set(got) == set(want)
    assert any(n.startswith("matcher.cost_reg_shared.") for n in got)
    flat_g = np.concatenate([got[n].ravel() for n in sorted(got)])
    flat_w = np.concatenate([want[n].ravel() for n in sorted(got)])
    assert flat_g @ flat_w / (np.linalg.norm(flat_g) * np.linalg.norm(flat_w)) >= 0.999
    top = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        if np.abs(w).max() < 1e-6 * top:
            assert np.abs(got[n]).max() < 1e-6 * top, n
        else:
            err = np.abs(got[n] - w).max() / np.abs(w).max()
            assert err <= 5e-2, (n, err)
    stats = flax_to_state_dict({"batch_stats": pt["stats_j"]})
    state = model.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(state[k].numpy(), v, rtol=1e-5, atol=1e-5, err_msg=k)
    # the hypotheses' gradient (undetached: through every stage) is JAX's
    np.testing.assert_allclose(pt["dv"], pt["dv_j"], rtol=0,
                               atol=1e-2 * np.abs(pt["dv_j"]).max())


def test_share_cr_builds_one_net_for_every_stage(pretrain):
    """One ``cost_reg_shared`` at base 8 that each stage calls, none of
    its own; the JAX tree fills it; the pretraining optimizer holds each
    of its parameters once."""
    matcher, opt = pretrain["port"].matcher, pretrain["opt"]
    assert all(matcher.cost_reg(s) is matcher.cost_reg_shared for s in range(3))
    assert not any(hasattr(matcher, f"cost_reg_{s}") for s in range(3))
    assert matcher.cost_reg_shared.Conv3dBnRelu_0.Conv_0.weight.shape[0] == 8
    held = [p for group in opt.param_groups for p in group["params"]]
    assert len(held) == len({id(p) for p in held}) == len(list(matcher.parameters()))


def test_share_cr_init_draws_the_shared_net_as_flax(pretrain):
    """``convert.init_weights`` draws ``cost_reg_shared`` as flax does
    (``tests/test_torch_port_init.py``'s rules): its kernels lecun_normal
    (a normal truncated at 2 sigma, variance 1 / fan_in), both packages'
    standard deviations within 6 sampling errors; the BatchNorms at
    identity."""
    from uforecon_tpu_torch.config import Config
    from uforecon_tpu_torch.convert import TRUNC_STD, init_weights
    from uforecon_tpu_torch.models.uforecon import UFORecon

    from torch_train_configs_common import SMALL

    port = UFORecon(Config(**SMALL, **CASCADE))
    init_weights(port, 0)
    got = port.state_dict()
    want = flax_to_state_dict(pretrain["variables"])
    names = [k for k in want if k.startswith("matcher.cost_reg_shared.")]
    assert names and set(names) == {k for k in got if k.startswith("matcher.cost_reg_shared.")
                                    and not k.endswith("num_batches_tracked")}
    for k in names:
        g, w = got[k].numpy(), want[k]
        if "BatchNorm" in k:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        # a torch Conv3d weight (O, I, k, k, k) or ConvTranspose3d (I, O, k, k, k):
        # flax's fan-in is every axis of its kernel but the last
        fan_in = g[0].size if "Deconv" not in k else g.shape[1] * g[0, 0].size
        sigma = np.sqrt(1.0 / fan_in)
        assert np.abs(g).max() <= 2 * sigma / TRUNC_STD * (1 + 1e-6), k
        se = sigma / np.sqrt(2 * g.size)
        for arr in (g, w):
            assert abs(arr.std() - sigma) <= 6 * se, (k, arr.std(), sigma)


@pytest.mark.parametrize("name", ["share_cr", "featuregrid"])
def test_reference_checkpoint_of_the_configuration_loads(pretrain, name, tmp_path):
    """The reference's Lightning ``.ckpt`` of a ``share_cr`` model (its
    ``cost_regularization`` net) and of a feature-grid model (its
    ``feature_volume``) loads through ``convert.load_weights`` as the flax
    variables do: the reference names of the JAX package's map for that
    configuration (``data/torch_ckpt.py``)."""
    from uforecon_tpu.data.torch_ckpt import uforecon_name_map

    from uforecon_tpu_torch.config import Config
    from uforecon_tpu_torch.convert import load_flax_variables, load_weights
    from uforecon_tpu_torch.models.uforecon import UFORecon

    from test_torch_port_weights import _leaf, _torch_layout
    from torch_train_configs_common import SMALL

    flags = CASCADE if name == "share_cr" else CONFIGS["featuregrid"]
    variables = (pretrain["variables"] if name == "share_cr"
                 else np_tree(jax_setup(flags)["variables"]))
    names = uforecon_name_map(share_cr=name == "share_cr",
                              volume_type=flags.get("volume_type", "correlation"))
    sd = {}
    for ref_name, tgt in names.items():
        leaf = _leaf(variables.get(tgt[0], {}), tgt[1]) if tgt else None
        if leaf is not None:
            sd[ref_name] = torch.from_numpy(np.array(_torch_layout(leaf), np.float32))
    path = tmp_path / "uforecon.ckpt"
    torch.save({"state_dict": sd}, path)
    got, want = (UFORecon(Config(**SMALL, **flags)) for _ in range(2))
    load_weights(got, str(path))
    load_flax_variables(want, variables)
    a, b = got.state_dict(), want.state_dict()
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
