"""Render training of more of the JAX package's model configurations
through the port, by the rules of ``test_torch_port_train_configs.py``:
no depth guide (``--mvs_depth_guide 0``) and the view-direction PE
(``--use_dir_srdf``: view tokens of 104, the ray stage at 112), each a
coarse-only step; and one full
(coarse + fine) step of ``--use_dir_srdf``, its logs within 1e-3 relative
as ``test_torch_port_train.py`` holds the default model's full step (a
~1e-7 difference can move an importance-sampling bin, and with it the
fine pass). And for every configuration and precision policy, a training
state saved as the fit loop saves it reloads into the extraction model of
the same flags (no JAX).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_train_configs_more.py -q
"""
import pytest
import torch

from uforecon_tpu_torch.pipeline import trainer

from torch_train_configs_common import (CONFIGS, check_coarse_grad_step, jax_grads,
                                        jax_setup, port_setup, rel)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dir_srdf():
    return jax_setup(CONFIGS["dir_srdf"])


@pytest.mark.parametrize("name", ["no_depth_guide"])
def test_coarse_grad_step_matches_jax(name):
    check_coarse_grad_step(jax_setup(CONFIGS[name]), CONFIGS[name])


def test_dir_srdf_coarse_grad_step_matches_jax(dir_srdf):
    model = check_coarse_grad_step(dir_srdf, CONFIGS["dir_srdf"])
    assert model.ray_transformer.d_view == 104


def test_dir_srdf_full_grad_step_matches_jax(dir_srdf):
    logs_j, _ = jax_grads(dir_srdf, coarse_only=False)
    model, scene, rays, draws = port_setup(dir_srdf, CONFIGS["dir_srdf"])
    trainer.make_optimizer(model.cfg, model)
    logs = trainer.grad_step(model.cfg, model, scene, *rays, draws=draws)
    assert set(logs) == set(logs_j)
    for k, v in logs_j.items():
        assert rel(logs[k], v) <= 1e-3, (k, float(logs[k]), float(v))
    assert all(p.grad is not None for _, p in trainer.trainable_parameters(model))


@pytest.mark.parametrize("name", [*CONFIGS, "mixed", "bf16"])
def test_checkpoint_of_each_configuration_reloads_for_extraction(name, tmp_path):
    """A training state of each configuration and precision policy (one
    Adam update on seeded gradients), saved as the fit loop saves it, loads
    through ``convert.load_weights`` (``--load_ckpt``) into the extraction
    model of the same flags, tensor for tensor; the parameters and Adam's
    moments stay float32 in either bf16 policy, as optax keeps them."""
    from uforecon_tpu_torch.config import Config
    from uforecon_tpu_torch.convert import init_weights, load_weights
    from uforecon_tpu_torch.models.uforecon import UFORecon
    from uforecon_tpu_torch.pipeline.checkpoint import CheckpointManager

    from torch_train_configs_common import SMALL

    flags = {"mixed": dict(encoder_dtype="bfloat16"),
             "bf16": dict(compute_dtype="bfloat16")}.get(name, CONFIGS.get(name))
    model = UFORecon(Config(**SMALL, **flags))
    init_weights(model, 0)
    opt = trainer.make_optimizer(model.cfg, model)
    gen = torch.Generator().manual_seed(1)
    for _, p in trainer.trainable_parameters(model):
        p.grad = torch.randn(p.shape, generator=gen)
    trainer.apply_step(opt, 1)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == torch.float32 for st in opt.state.values()
               for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    path = mgr.save(1, {"state_dict": model.state_dict(), "optimizer": opt.state_dict(),
                        "step": 1}, {"val/loss_depth_fine": 0.5})
    extract = UFORecon(Config(**SMALL, **flags, extract_geometry=True))
    load_weights(extract, path)
    a, b = model.state_dict(), extract.state_dict()
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
