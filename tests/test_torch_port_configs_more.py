"""The other model configurations of test_torch_port_configs.py:
``--use_dir_srdf`` (d_view 104: the direction PE, 24 wide; ray-head width
112), ``--volume_reso 0`` (no volume features) and 128 + 128 samples per
ray (the default model), by the same rules, in a file of their own so that
the test workers take them beside the others.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_configs_more.py -q
"""
import numpy as np
import pytest
import torch

from uforecon_tpu.ops.posenc import nerf_posenc as jax_nerf_posenc

from uforecon_tpu_torch.ops.posenc import nerf_posenc

from test_torch_port_configs import check_render, check_widths, make_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["dir_srdf", "no_volume", "samples_128"])
def pair(request):
    return make_pair(request.param)


def test_widths_match_jax(pair):
    check_widths(pair)


@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_render_chunk_matches_jax(pair, encoder):
    check_render(pair, encoder)


def test_no_volume_and_direction_widths():
    """d_view by configuration, as the JAX model builds it: the direction
    PE is 24 wide (the JAX config's dir_dim says 27, which the model does
    not build)."""
    from uforecon_tpu.config import Config as JaxConfig

    from uforecon_tpu_torch.config import Config

    for flags, d_view in ((dict(use_dir_srdf=True), 104), (dict(volume_reso=0), 56),
                          (dict(volume_type="featuregrid", mvs_depth_guide=0), 64),
                          (dict(volume_type="featuregrid"), 72),
                          (dict(depth_pos_encoding=False, explicit_similarity=False), 56),
                          (dict(volume_reso=0, explicit_similarity=False,
                                depth_pos_encoding=False), 32)):
        cfg = Config(**flags)
        assert cfg.view_trans_dim == d_view and cfg.ray_trans_dim == d_view + 8
        jcfg = JaxConfig(**flags)
        assert (cfg.effective_fea_volume_dim, cfg.depth_dim, cfg.sim_feat_fix) == \
            (jcfg.effective_fea_volume_dim, jcfg.depth_dim, jcfg.sim_feat_fix)
    assert JaxConfig(use_dir_srdf=True).dir_dim == 27 and Config(use_dir_srdf=True).dir_dim == 24


@pytest.mark.parametrize("include_input", [False, True])
def test_nerf_posenc_matches_jax(include_input):
    x = np.random.default_rng(0).standard_normal((5, 7, 3)).astype(np.float32)
    got = nerf_posenc(torch.as_tensor(x), 4, include_input=include_input).numpy()
    want = np.asarray(jax_nerf_posenc(x, 4, include_input=include_input))
    assert got.shape == want.shape == (5, 7, 24 + 3 * include_input)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
