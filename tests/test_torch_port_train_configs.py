"""Render training of the JAX package's other model configurations
through the port (``pipeline/trainer.grad_step``) against the JAX trainer's
gradient, on JAX's weights and draws (``torch_train_configs_common.py``):
the feature grid without and with the depth guide (the view transformer,
and at tokens of 72 the point head), no depth PE. Each case holds the
coarse-only step as ``test_torch_port_train.py`` holds the default
model's: the logs within 1e-5 relative, every trainable leaf within 1e-4
of its largest gradient, and a leaf whose gradient is zero up to rounding
zero on both sides. The other cases are in ``test_torch_port_train_
configs_more.py`` and ``_cascade.py``, so that the test workers take them
side by side.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_train_configs*.py -q
"""
import pytest
import torch

from torch_train_configs_common import CONFIGS, check_coarse_grad_step, jax_setup

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["featuregrid", "featuregrid_guided", "no_depth_pe"])
def test_coarse_grad_step_matches_jax(name):
    model = check_coarse_grad_step(jax_setup(CONFIGS[name]), CONFIGS[name])
    if model.cfg.feature_grid:
        # the grid's U-Net trains: its gradients come through the sampler
        assert model.feature_volume.VolumeRegularization_0.Conv_0.weight.grad.abs().max() > 0
