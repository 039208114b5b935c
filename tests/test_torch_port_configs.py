"""The JAX package's other model configurations, through the port, against
the JAX model with bridged weights and the JAX draws.

Each configuration is one flag set of the JAX CLI that the port used to
refuse: the feature grid (``--volume_type featuregrid``, here without the
depth guide, as the reference's live configuration runs it), no depth PE
(no ``--depth_pos_encoding``), ``--use_dir_srdf``, ``--volume_reso 0`` and
128 + 128 samples. Both sides run the exact path (``EXACT``, JAX's
``volume_merge='never'``, float32 sources, ``highest``); the JAX model
takes its flax path on the CPU, the port its kernels' plain versions. The
render is held as ``test_torch_port_slice.py`` holds it: on the JAX
encoding, coarse depth and rgb within 2e-4 and the fine outputs within
2e-4 on >= 99 % of rays (a fine sample moves with the coarse weights'
rounding); on the port's own encoding every output on >= 99 % of rays.
The encodings themselves: the feature grid within 1e-4 on >= 99 % of
cells (a cell downstream of a flipped winner-take-all pixel differs, as in
the slice's volumes).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_configs*.py -q
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu.config import Config as JaxConfig
from uforecon_tpu.models.uforecon import UFORecon as JaxUFORecon

from uforecon_tpu_torch.config import EXACT, Config
from uforecon_tpu_torch.convert import load_flax_variables
from uforecon_tpu_torch.models.uforecon import EncoderOutputs, SceneInputs, UFORecon

from helpers import make_synthetic_scene

torch.set_num_threads(1)

BASE = dict(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"))
JAX_EXACT = dict(volume_merge="never", volume_dtype="float32",
                 image_gather_dtype="float32")
# configuration -> (model flags of both packages, rays, samples per pass)
CASES = {
    "featuregrid": (dict(volume_type="featuregrid", volume_reso=16, mvs_depth_guide=0,
                         depth_pos_encoding=False), 64, 8),
    # the point head at tokens of 72 (test_torch_port_configs_guided.py)
    "featuregrid_guided": (dict(volume_type="featuregrid", volume_reso=16), 64, 8),
    "no_depth_pe": (dict(depth_pos_encoding=False), 64, 8),
    "dir_srdf": (dict(use_dir_srdf=True), 64, 8),
    "no_volume": (dict(volume_reso=0), 64, 8),
    "samples_128": (dict(), 8, 128),
}
TOL = dict(rtol=2e-4, atol=2e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def make_pair(name):
    """The JAX model of configuration ``name`` (init, eager encode and
    render_chunk) and the port's on the bridged weights, with the JAX
    draws."""
    flags, rn, samples = CASES[name]
    scene, extras = make_synthetic_scene(n_views=3, h=32, w=32, ndepth=16)
    sampling = dict(coarse_sample=samples, fine_sample=samples)
    jcfg = JaxConfig(**BASE, **sampling, **JAX_EXACT, **flags)
    model = JaxUFORecon(jcfg)
    key = jax.random.PRNGKey(0)
    # source view 0 is the reference camera, so the rays of its border rows
    # and columns project onto view 0's border exactly (NDC -1 or +1),
    # where each package's last bit of the projection decides the in-bounds
    # mask: the cases take their rays off that border
    ray_d = extras["ray_d"].reshape(32, 32, 3)[1:-1, 1:-1].reshape(-1, 3)[:rn]
    variables = jax.jit(model.init)(key, scene, ray_d[:4], key)
    # jitted: the flax path on the CPU, as eager but in half the time
    enc = jax.jit(lambda v, s: model.apply(v, s, method=model.encode))(variables, scene)
    out = jax.jit(lambda v, s, e, r, k: model.apply(v, s, e, r, k, method=model.render_chunk))(
        variables, scene, enc, ray_d, key)
    k_coarse, k_fine = jax.random.split(key)
    u_c = jax.random.uniform(k_coarse, (rn, samples), jnp.float32)
    u_f = jax.random.uniform(k_fine, (rn, samples), jnp.float32)

    port = UFORecon(Config(**BASE, **sampling, **EXACT, **flags))
    tree = _np_tree(variables)
    load_flax_variables(port, tree)
    port.requires_grad_(False)   # the render path: no autograd graph
    p_scene = SceneInputs(
        **{k: ({s: _t(p) for s, p in v.items()} if isinstance(v, dict) else _t(v))
           for k, v in scene._asdict().items()})
    return dict(jcfg=jcfg, tree=tree, jax_enc=_np_tree(enc), jax_out=_np_tree(out),
                port=port, scene=p_scene, port_enc=port.encode(p_scene),
                ray_d=_t(ray_d), u_c=_t(u_c), u_f=_t(u_f))


def bridge_encoder(jenc) -> EncoderOutputs:
    """JAX encoder outputs in the port's layout: the first corner block of
    each corner-packed (NV, D, h, w, 72) volume is the unpacked volume; the
    feature grid (Z, Y, X, 16) channels-first."""
    vols = {k: _t(v[..., :9]).permute(0, 4, 1, 2, 3).contiguous()
            for k, v in jenc.volumes.items()}
    grid = None if jenc.fea_grid is None else _t(jenc.fea_grid).permute(3, 0, 1, 2)
    return EncoderOutputs(source_feats=_t(jenc.source_feats), volumes=vols,
                          aug0=_t(jenc.aug0), aug1=_t(jenc.aug1),
                          mvs_depths=_t(jenc.mvs_depths), fea_grid=grid)


def _rays_close(got, want, rn):
    return np.isclose(got, want, **TOL).reshape(rn, -1).all(axis=1).mean()


def check_render(pair, encoder):
    """render_chunk on the JAX encoding (the render path alone) or on the
    port's own (the whole configuration) against JAX's chunk."""
    enc = bridge_encoder(pair["jax_enc"]) if encoder == "jax" else pair["port_enc"]
    out = pair["port"].render_chunk(pair["scene"], enc, pair["ray_d"],
                                    u_coarse=pair["u_c"], u_fine=pair["u_f"])
    ref, rn = pair["jax_out"], pair["ray_d"].shape[0]
    for key in ("depth", "rgb"):
        got = out["coarse"][key].numpy()
        if encoder == "jax":
            np.testing.assert_allclose(got, ref["coarse"][key], err_msg=key, **TOL)
        else:
            assert _rays_close(got, ref["coarse"][key], rn) >= 0.99, key
    for key in ("depth", "rgb", "opacity"):
        got = out["fine"][key].numpy()
        assert np.all(np.isfinite(got))
        assert _rays_close(got, ref["fine"][key], rn) >= 0.99, key
    return out


def check_widths(pair):
    """The port builds the JAX model's widths: d_view, the ray head's
    width, the flax tree's modules."""
    jcfg, port = pair["jcfg"], pair["port"]
    rt = port.ray_transformer
    params = pair["tree"]["params"]
    assert rt.d_view == port.cfg.view_trans_dim
    assert rt.ray_head_params().wq.shape == (rt.d_view + 8,) * 2
    assert port.cfg.effective_fea_volume_dim == jcfg.effective_fea_volume_dim
    assert port.cfg.depth_dim == jcfg.depth_dim
    assert ("mvs_volume" in params) == hasattr(port, "mvs_volume")
    assert ("feature_volume" in params) == hasattr(port, "feature_volume")
    assert params["ray_transformer"]["view_token"].shape == (1, rt.d_view)


# the cases are split over this file and test_torch_port_configs_more.py, so
# that the test workers take them side by side
@pytest.fixture(scope="module", params=["featuregrid", "no_depth_pe"])
def pair(request):
    return make_pair(request.param)


def test_widths_match_jax(pair):
    check_widths(pair)


@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_render_chunk_matches_jax(pair, encoder):
    check_render(pair, encoder)


def test_encodings_match_jax(pair):
    """The feature grid where there is one; the correlation volumes
    otherwise."""
    got, want = pair["port_enc"], bridge_encoder(pair["jax_enc"])
    if want.fea_grid is not None:
        assert got.fea_grid.shape == want.fea_grid.shape == (16,) + (16,) * 3
        assert not got.volumes and not want.volumes
        pairs = [(got.fea_grid, want.fea_grid)]
    else:
        assert got.fea_grid is None and set(got.volumes) == set(want.volumes)
        pairs = [(got.volumes[k], want.volumes[k]) for k in want.volumes]
    for a, b in pairs:
        assert np.isclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4).mean() >= 0.99


def test_the_view_transformer_takes_these_configurations(pair, monkeypatch):
    """JAX's gate: without the full feature set the per-point stage never
    reaches the point head, whatever fused_point_head says ('auto')."""
    from uforecon_tpu_torch.models import ray_transformer

    def refuse(*a, **k):
        raise AssertionError("the point head ran")

    monkeypatch.setattr(ray_transformer, "point_head_v1", refuse)
    sp = pair
    out = sp["port"].render_chunk(sp["scene"], sp["port_enc"], sp["ray_d"][:8],
                                  u_coarse=sp["u_c"][:8], u_fine=sp["u_f"][:8])
    assert np.isfinite(out["fine"]["depth"].numpy()).all()
