"""The feature grid with the depth guide and the similarity
(``--volume_type featuregrid`` with the JAX defaults otherwise) against
the JAX model, by the rules of test_torch_port_configs.py. Every point
has the full feature set there, so JAX's gate sends the per-point stage
to the point head, at tokens of 72 (img 32 | the grid's 16 | sim 16 | depth
PE 8) and heads of 9: the port takes its point head too (v1 and v2), on
the CPU their plain versions; the JAX model takes its flax path, which
computes the same function.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_configs_guided.py -q
"""
import numpy as np
import pytest
import torch

from uforecon_tpu_torch.models import ray_transformer

from test_torch_port_configs import check_render, check_widths, make_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return make_pair("featuregrid_guided")


def test_widths_match_jax(pair):
    check_widths(pair)
    assert pair["port"].ray_transformer.d_view == 72
    assert pair["port"].cfg.full_point_features


@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_render_chunk_matches_jax(pair, encoder):
    check_render(pair, encoder)


@pytest.mark.parametrize("head", ["v1", "v2"])
def test_the_point_head_takes_the_feature_grid(pair, monkeypatch, head):
    """Each coarse and fine pass runs the chosen point head on the grid's 16
    volume features; v2 computes what v1 does."""
    name = "point_head_v1" if head == "v1" else "point_head2"
    calls = []
    real = getattr(ray_transformer, name)

    def counted(inp, *args, **kwargs):
        calls.append(tuple(inp.vol_feat.shape))
        return real(inp, *args, **kwargs)

    monkeypatch.setattr(ray_transformer, name, counted)
    sp = pair
    model = sp["port"].with_knobs(point_head=head)
    rays = sp["ray_d"][:8]
    draws = dict(u_coarse=sp["u_c"][:8], u_fine=sp["u_f"][:8])
    out = model.render_chunk(sp["scene"], sp["port_enc"], rays, **draws)
    assert len(calls) == 2 and all(shape[-1] == 16 for shape in calls)
    ref = sp["port"].render_chunk(sp["scene"], sp["port_enc"], rays, **draws)
    for key in ("depth", "rgb", "opacity"):
        np.testing.assert_allclose(out["fine"][key].numpy(), ref["fine"][key].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
