"""The port's two kernel modules: plain versions against the JAX package.

``point_head_reference`` / ``ray_head_reference`` are what the CUDA
kernels are held to on the card (chip_smoke.py and the GPU tests of
test_torch_port_kernels.py), so here they are held to the JAX references
on the same numpy inputs at atol 1e-5 (f32, another summation order). The
port is point-major, the JAX point head feature-major: the test
transposes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu.ops import fused_point_head as jph
from uforecon_tpu.ops import fused_ray_head as jrh

from uforecon_tpu_torch.ops import fused_point_head as pph
from uforecon_tpu_torch.ops import fused_ray_head as prh

from test_torch_port_kernels import _point_case, _port_params, _ray_case, _t

torch.set_num_threads(1)


def _jax_point(inputs, params):
    fm = lambda a: jnp.asarray(np.swapaxes(a, -1, -2))   # point- -> feature-major
    inp = jph.PointHeadInputs(
        img_feat=fm(inputs["img_feat"]), vol_feat=fm(inputs["vol_feat"]),
        sim_feat=fm(inputs["sim_feat"]), depth_dist=jnp.asarray(inputs["depth_dist"]),
        dir_rel=fm(inputs["dir_rel"]), rgb=fm(inputs["rgb"]),
        mask=jnp.asarray(inputs["mask"]))
    p = jph.PointHeadParams(**{k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
                                   else jnp.asarray(v)) for k, v in params.items()})
    tok, rad = jph.point_head_reference(inp, p)
    return np.asarray(tok).T, np.asarray(rad).T


# volume width 24 (the correlation volume) and 16 (the feature grid, tokens
# of 72: JAX's gate sends it to the point head too)
@pytest.mark.parametrize("c_vol", [24, 16])
@pytest.mark.parametrize("nv", [2, 3])
def test_point_head_reference_matches_jax(rng, nv, c_vol):
    inputs, params = _point_case(rng, nv=nv, c_vol=c_vol)
    tok_ref, rad_ref = _jax_point(inputs, params)
    tok, rad = pph.point_head_reference(
        pph.PointHeadInputs(**{k: _t(v) for k, v in inputs.items()}),
        _port_params(pph.PointHeadParams, params))
    np.testing.assert_allclose(tok.numpy(), tok_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rad.numpy(), rad_ref, rtol=1e-5, atol=1e-5)
    # a point masked in every view blends the views uniformly, never NaN
    np.testing.assert_allclose(rad.numpy()[:5], inputs["rgb"][:, :5].mean(0),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sn", [8, 64])
def test_ray_head_reference_matches_jax(rng, sn):
    y, params = _ray_case(rng, rn=6, sn=sn)
    ref = jrh.ray_head_reference(
        jnp.asarray(y),
        jrh.RayHeadParams(**{k: (tuple(jnp.asarray(x) for x in v)
                                 if isinstance(v, tuple) else jnp.asarray(v))
                             for k, v in params.items()}))
    got = prh.ray_head_reference(_t(y), _port_params(prh.RayHeadParams, params))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
