"""The port's render-glue modules against the JAX package.

The three knobs ``fused_similarity``, ``fused_volume_fusion`` and
``fused_neus_epilogue`` route the render path to three kernel modules:
``ops/fused_similarity.py``, ``ops/fused_volume_fusion.py`` and
``ops/fused_ray_head.py ray_head_neus``. Their plain versions are what the
CUDA kernels are held to on the card, so here each is held to the JAX
reference and to the JAX Pallas kernel, which runs in interpret mode on the
CPU, on the same numpy inputs. The JAX package keeps its interpret-mode
NeuS-epilogue test in its slow set, so the NeuS route is held to the JAX
plain reference.

Tolerances: 1e-6 for the grouped cosine and the volume fusion (a few f32
roundings in another order); 1e-5 for the NeuS route (as the ray-head
modules: an attention layer and an MLP before the compositing).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu.config import Config as JaxConfig
from uforecon_tpu.ops import fused_ray_head as jrh
from uforecon_tpu.ops import fused_similarity as jsim
from uforecon_tpu.ops import fused_volume_fusion as jvf

from uforecon_tpu_torch.config import Config
from uforecon_tpu_torch.ops import fused_ray_head as prh
from uforecon_tpu_torch.ops import fused_similarity as psim
from uforecon_tpu_torch.ops import fused_volume_fusion as pvf

from helpers import make_synthetic_scene
from test_torch_port_kernels import (_cosine_case, _fusion_case, _neus_case,
                                     _port_params, _ray_case, _t)

torch.set_num_threads(1)

GLUE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nv", [2, 3, 5])
def test_grouped_cosine_matches_jax(rng, nv):
    x = _cosine_case(rng, nv=nv, n=300)
    ref = np.asarray(jsim.grouped_cosine_reference(jnp.asarray(x), 8))
    pallas = np.asarray(jsim.grouped_cosine_fused(jnp.asarray(x), 8))
    got = psim.grouped_cosine_reference(_t(x), 8).numpy()
    assert got.shape == (300, 8)
    np.testing.assert_allclose(got, ref, **GLUE_TOL)
    np.testing.assert_allclose(got, pallas, **GLUE_TOL)
    np.testing.assert_array_equal(psim.grouped_cosine(_t(x), 8).numpy(), got)
    assert psim.pair_slots(nv) == jsim.pair_slots(nv)
    assert psim.view_pairs(nv) == jsim.view_pairs(nv)


@pytest.mark.parametrize("nv", [2, 3, 4, 5])
def test_volume_fusion_matches_jax(rng, nv):
    fws = _fusion_case(rng, nv=nv, n=300, zero_rows=7)
    ref = np.asarray(jvf.volume_fusion_reference([jnp.asarray(f) for f in fws]))
    pallas = np.asarray(jvf.volume_fusion_fused([jnp.asarray(f) for f in fws]))
    got = pvf.volume_fusion_reference([_t(f) for f in fws]).numpy()
    assert got.shape == (300, 24)
    np.testing.assert_allclose(got, ref, **GLUE_TOL)
    np.testing.assert_allclose(got, pallas, **GLUE_TOL)
    np.testing.assert_array_equal(pvf.volume_fusion(*[_t(f) for f in fws]).numpy(), got)
    # points with zero weight in every view fuse to 0, never NaN
    np.testing.assert_array_equal(got[:7], 0.0)


@pytest.mark.parametrize("nv", [3, 5])
def test_volume_fusion_channel_first_matches_jax_kernel(rng, nv):
    """The layout the main path hands the kernel: F.grid_sample's channel-
    first memory seen as (NV, P, 9), strides (9 P, 1, P), through the
    port's wrapper, against the JAX Pallas kernel on the same values."""
    fws = _fusion_case(rng, nv=nv, n=300, zero_rows=7)
    views = [_t(np.ascontiguousarray(f.transpose(0, 2, 1))).permute(0, 2, 1) for f in fws]
    assert views[0].stride() == (9 * 300, 1, 300)
    pallas = np.asarray(jvf.volume_fusion_fused([jnp.asarray(f) for f in fws]))
    got = pvf.volume_fusion(*views).numpy()
    np.testing.assert_allclose(got, pallas, **GLUE_TOL)
    np.testing.assert_array_equal(got[:7], 0.0)
    np.testing.assert_array_equal(got, pvf.volume_fusion_reference([_t(f) for f in fws]))


def test_volume_fusion_all_zero_weights_match_jax(rng):
    fws = _fusion_case(rng, n=64, zero_rows=64)
    pallas = np.asarray(jvf.volume_fusion_fused([jnp.asarray(f) for f in fws]))
    got = pvf.volume_fusion_reference([_t(f) for f in fws]).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_allclose(got, pallas, **GLUE_TOL)


@pytest.mark.parametrize("sn", [8, 64])
def test_ray_head_neus_reference_matches_jax(rng, sn):
    y, params = _ray_case(rng, rn=6, sn=sn)
    z, rad, inv_s = _neus_case(rng, 6, sn)
    jp = jrh.RayHeadParams(**{k: (tuple(jnp.asarray(x) for x in v)
                                  if isinstance(v, tuple) else jnp.asarray(v))
                              for k, v in params.items()})
    ref = jrh.ray_head_neus_reference(jnp.asarray(y), jnp.asarray(z), jnp.asarray(rad),
                                      jnp.asarray(inv_s), jp)
    got = prh.ray_head_neus_reference(_t(y), _t(z), _t(rad), _t(inv_s),
                                      _port_params(prh.RayHeadParams, params))
    for name, a, b in zip(("srdf", "weight", "rgb", "depth", "opacity"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_along_ray_neus_is_along_ray_then_neus_render(rng):
    """The model-level route: along_ray_neus == along_ray + neus_render,
    with the srdf and the unclamped variance of the JAX along_ray_neus."""
    from uforecon_tpu_torch.models.ray_transformer import RayTransformer
    from uforecon_tpu_torch.ops.rendering import neus_render

    rt = RayTransformer()
    torch.manual_seed(0)
    for prm in rt.parameters():
        prm.data.normal_(0.0, 0.2)
    token = _t(rng.standard_normal((5, 16, rt.d_view)))
    z, rad, inv_s = (_t(a) for a in _neus_case(rng, 5, 16))
    with torch.no_grad():
        got = rt.along_ray_neus(token, z, rad, inv_s)
        srdf = rt.along_ray(token)
        want = neus_render(z, rad, srdf, inv_s)
    want["srdf"] = srdf
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def _pair_maps(rng, nv, h=8, w=10, c=32):
    n_pairs = nv * (nv - 1) // 2
    return [rng.standard_normal((n_pairs, h, w, c)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("pair_quirk", [True, False])
def test_query_similarity_fused_matches_jax(rng, pair_quirk):
    from uforecon_tpu.models.ray_transformer import query_similarity as jq
    from uforecon_tpu_torch.models.ray_transformer import query_similarity as pq

    nv = 3
    aug0, aug1 = _pair_maps(rng, nv)
    scene, _ = make_synthetic_scene(n_views=nv, h=32, w=32)
    pts = rng.uniform(-0.8, 0.8, (4, 6, 3)).astype(np.float32)
    ref = jq(jnp.asarray(pts), scene.source_poses, jnp.asarray(aug0),
             jnp.asarray(aug1), nv, pair_quirk=pair_quirk, fused="always")
    args = (_t(pts), _t(scene.source_poses), _t(aug0), _t(aug1), nv)
    outs = {f: pq(*args, pair_quirk=pair_quirk, fused=f)
            for f in ("never", "auto", "always")}
    for f, got in outs.items():
        for a, b in zip(got, outs["never"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **GLUE_TOL)
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_query_correlation_volume_fused_matches_jax(rng):
    from uforecon_tpu.models.ray_transformer import query_correlation_volume as jq
    from uforecon_tpu.ops import grid_sample as jgs
    from uforecon_tpu_torch.models.ray_transformer import query_correlation_volume as pq

    scene, _ = make_synthetic_scene(n_views=3, h=32, w=32)
    shapes = {"stage1": (8, 8, 8), "stage2": (8, 16, 16), "stage3": (8, 32, 32)}
    vols = {k: rng.standard_normal((3,) + s + (9,)).astype(np.float32)
            for k, s in shapes.items()}
    for v in vols.values():
        v[..., -1] = np.abs(v[..., -1])          # sigmoid weights are >= 0
    # points beyond [-1, 1] sample zeros in every view: zero weights
    pts = rng.uniform(-1.3, 1.3, (5, 7, 3)).astype(np.float32)
    ref = jq(jnp.asarray(pts), scene.source_poses,
             {k: jgs.pack_volume_corners(jnp.asarray(v)) for k, v in vols.items()},
             (scene.near, scene.far), fused="always")
    args = (_t(pts), _t(scene.source_poses),
            {k: _t(v).permute(0, 4, 1, 2, 3) for k, v in vols.items()},
            (_t(scene.near), _t(scene.far)))
    off = pq(*args, fused="never")
    for f in ("auto", "always"):
        torch.testing.assert_close(pq(*args, fused=f), off, rtol=0, atol=0, msg=f)
    assert np.all(np.isfinite(off.numpy()))
    # the JAX side samples corner-packed volumes: 1e-4 as the unfused test
    np.testing.assert_allclose(off.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


KNOBS = {"fused_similarity": ("auto", "always", "never"),
         "fused_volume_fusion": ("auto", "always", "never"),
         "fused_neus_epilogue": ("auto", "never")}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_config_knobs_validate_like_jax(knob):
    assert getattr(Config(), knob) == getattr(JaxConfig(), knob) == "never"
    for value in KNOBS[knob]:
        assert getattr(Config(**{knob: value}), knob) == value
        JaxConfig(**{knob: value})
    for bad in ("on", "ALWAYS", "always" if knob == "fused_neus_epilogue" else "sometimes"):
        with pytest.raises(ValueError, match=knob):
            Config(**{knob: bad})
        with pytest.raises(ValueError, match=knob):
            JaxConfig(**{knob: bad})
    on = dataclasses.replace(Config(), **{knob: KNOBS[knob][0]})
    assert getattr(on, knob) == "auto"
