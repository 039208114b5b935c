"""``--grad_method`` through the port, against the JAX package
(``torch_train_configs_common.py``'s size and weights), and ``--volume_reso
0``'s render training (a coarse-only step by the rules of
``test_torch_port_train_configs.py``, here so that the test workers take
the configuration files side by side).

``undetached`` lets the gradient of a stage's depth reach the next stage's
hypotheses. That depth is a winner-take-all gather from hypotheses that
depend on no parameter, so no parameter's gradient changes, in either
package (the stage-1 regulariser's gradient is the same under both
methods; MVS pretraining is the only step that differentiates the
matcher). What changes is the gradient of the scene's depth hypotheses,
the input the stages' hypotheses come from: here of the expected depth of
each stage of rotation 0 (the matcher on its running statistics, one JAX
compile per method). Both packages show the change, and the port's
gradient is JAX's under each method within 1e-4 of its largest.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_train_configs_undetached.py -q
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_configs_common import CONFIGS, check_coarse_grad_step, jax_setup, port_setup

torch.set_num_threads(1)


def test_coarse_grad_step_matches_jax():
    check_coarse_grad_step(jax_setup(CONFIGS["no_volume"]), CONFIGS["no_volume"])


def _hypotheses_gradient(method):
    """The gradient of sum over stages of sum(prob * hypotheses) of
    rotation 0 by the scene's depth hypotheses, in JAX and in the port."""
    flags = dict(grad_method=method)
    js = jax_setup(flags)
    model, variables, scene = js["model"], js["variables"], js["scene"]

    def expected(dv):
        enc = model.apply(variables, scene.source_imgs, scene.proj_matrices, dv, False,
                          method=lambda m, *a: m.matcher(*a))
        return sum(jnp.sum(enc["rot0"][f"stage{s}"]["prob_volume"]
                           * enc["rot0"][f"stage{s}"]["depth_values"]) for s in (1, 2, 3))

    want = np.asarray(jax.jit(jax.grad(expected))(scene.depth_values))
    port, p_scene, _, _ = port_setup(js, flags)
    port.requires_grad_(False)
    dv = p_scene.depth_values.clone().requires_grad_(True)
    enc = port.matcher(p_scene.source_imgs, p_scene.proj_matrices, dv)
    sum(torch.sum(enc["rot0"][f"stage{s}"]["prob_volume"]
                  * enc["rot0"][f"stage{s}"]["depth_values"]) for s in (1, 2, 3)).backward()
    return dv.grad.numpy(), want


@pytest.fixture(scope="module")
def gradients():
    return {m: _hypotheses_gradient(m) for m in ("detach", "undetached")}


@pytest.mark.parametrize("method", ["detach", "undetached"])
def test_hypotheses_gradient_matches_jax(gradients, method):
    got, want = gradients[method]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_undetached_changes_the_hypotheses_gradient_in_both_packages(gradients):
    (det, det_j), (und, und_j) = gradients["detach"], gradients["undetached"]
    for a, b in ((det, und), (det_j, und_j)):
        assert np.abs(a - b).max() > 0.5 * np.abs(b).max()
