"""The port's per-point view-transformer route against the JAX package.

The route runs where the point-head kernel does not: with
``fused_point_head='never'`` and in the paper's ablation without explicit
similarity (``explicit_similarity=False``, d_view 64, ray-head width 72).
Its attention is ``ops/tiny_attention.py``, whose CUDA kernels are held to
the plain versions on the card; here the plain versions are held to the
JAX Pallas kernel, which runs in interpret mode on the CPU, and to its
gradient, on the same numpy inputs. The view transformer, the 72-wide ray
head and ``render_chunk`` of the ablation are held to the JAX modules with
bridged weights.

Tolerances: the attention forward at rtol = atol = 2e-5 and its gradients
at 3e-4, as the JAX package's own tests hold its kernel; the view
transformer and the ray head at 1e-5 (one attention layer and an MLP in
f32, another summation order); render_chunk as in test_torch_port_slice.py
(coarse at 2e-4, fine outputs on >= 99 % of rays).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_view_route.py -q
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu.config import Config as JaxConfig
from uforecon_tpu.models.attention import LocalFeatureTransformer as JaxLFT
from uforecon_tpu.models.uforecon import UFORecon as JaxUFORecon
from uforecon_tpu.ops import fused_ray_head as jrh
from uforecon_tpu.ops.pallas_attention import tiny_linear_attention as jax_tiny_attention

from uforecon_tpu_torch.config import EXACT, Config
from uforecon_tpu_torch.convert import load_flax_variables
from uforecon_tpu_torch.models.attention import LocalFeatureTransformer
from uforecon_tpu_torch.models.uforecon import SceneInputs, UFORecon
from uforecon_tpu_torch.ops import fused_ray_head as prh
from uforecon_tpu_torch.ops import tiny_attention as pta

from helpers import make_synthetic_scene
from test_torch_port_kernels import _neus_case, _port_params, _ray_case, _t
from test_torch_port_slice import (RN, SAMPLES, _bridge_encoder, _check_render,
                                   _np_tree)

torch.set_num_threads(1)

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)


def _qkv(rng, b, l, s, h, d, m):
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return r(b, l, h, d), r(b, s, h, d), r(b, s, h, m)


@pytest.mark.parametrize("b,l,s,h,d,m", [
    (300, 4, 4, 8, 10, 10),     # route (A): 3 views + the view token, 8 x 10
    (256, 6, 6, 8, 10, 10),     # 5-view sets
    (64, 4, 4, 8, 8, 8),        # the ablation: 8 x 8
])
def test_tiny_attention_matches_jax_kernel(rng, b, l, s, h, d, m):
    q, k, v = _qkv(rng, b, l, s, h, d, m)
    want = np.asarray(jax_tiny_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = pta.tiny_linear_attention(_t(q), _t(k), _t(v))
    assert got.shape == (b, l, h, m)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    # on the CPU the wrapper is the plain version
    torch.testing.assert_close(got, pta.tiny_linear_attention_reference(_t(q), _t(k), _t(v)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("b,l,s,h,d,m", [
    (64, 4, 4, 8, 10, 10),      # route (A)
    (48, 6, 6, 8, 8, 8),
    (40, 6, 6, 8, 10, 10),      # the training shape: the view token and train_n_view 5
])
def test_tiny_attention_gradients_match_jax(rng, b, l, s, h, d, m):
    """The JAX kernel's custom VJP (its backward kernel, interpret mode)
    against torch.autograd through the plain forward, and against the
    plain backward that the backward kernel is held to on the card."""
    q, k, v = _qkv(rng, b, l, s, h, d, m)
    target = rng.standard_normal((b, l, h, m)).astype(np.float32)
    loss = lambda q_, k_, v_: jnp.sum((jax_tiny_attention(q_, k_, v_) - target) ** 2)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = pta.tiny_linear_attention(qt, kt, vt)
    got = torch.autograd.grad(((out - _t(target)) ** 2).sum(), (qt, kt, vt))
    explicit = pta.tiny_linear_attention_backward(
        _t(q), _t(k), _t(v), 2.0 * (out.detach() - _t(target)))
    for name, a, c, w in zip("qkv", got, explicit, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_tiny_attention_backward_reference_matches_autograd(rng):
    """The plain backward (the formulas of the JAX _bwd_kernel) equals
    autograd of the plain forward, with inputs on both sides of phi's kink."""
    q, k, v = (_t(a).requires_grad_() for a in _qkv(rng, 40, 4, 4, 8, 10, 10))
    g = _t(rng.standard_normal((40, 4, 8, 10)))
    want = torch.autograd.grad(pta.tiny_linear_attention_reference(q, k, v), (q, k, v), g)
    got = pta.tiny_linear_attention_backward_reference(q.detach(), k.detach(), v.detach(), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _lft_pair(rng, d):
    """The JAX LocalFeatureTransformer and the port's, on the same weights."""
    x = rng.standard_normal((37, 4, d)).astype(np.float32)
    jmod = JaxLFT(d_model=d, n_heads=8)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    pmod = LocalFeatureTransformer(d, 8)
    load_flax_variables(pmod, _np_tree(variables))
    return x, jmod, variables, pmod


@pytest.mark.parametrize("d", [80, 64])
def test_view_transformer_matches_jax(rng, d):
    """One self-attention LoFTR layer over a view set's tokens: d_view 80
    (route A) and 64 (the ablation)."""
    x, jmod, variables, pmod = _lft_pair(rng, d)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = pmod(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sn", [8, 64])
def test_ray_head_width_72_matches_jax(rng, sn):
    """The ablation's ray head (64 view-token features + 8 order PE) and
    its NeuS variant against the JAX references, which are generic in C."""
    y, params = _ray_case(rng, rn=6, sn=sn, c=72)
    z, rad, inv_s = _neus_case(rng, 6, sn)
    jp = jrh.RayHeadParams(**{k: (tuple(jnp.asarray(x) for x in v)
                                  if isinstance(v, tuple) else jnp.asarray(v))
                              for k, v in params.items()})
    pp = _port_params(prh.RayHeadParams, params)
    np.testing.assert_allclose(prh.ray_head(_t(y), pp).numpy(),
                               np.asarray(jrh.ray_head_reference(jnp.asarray(y), jp)),
                               rtol=1e-5, atol=1e-5)
    want = jrh.ray_head_neus_reference(*map(jnp.asarray, (y, z, rad, inv_s)), jp)
    got = prh.ray_head_neus(_t(y), _t(z), _t(rad), _t(inv_s), pp)
    for name, a, b in zip(("srdf", "weight", "rgb", "depth", "opacity"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# --- configuration (B): the ablation without explicit similarity -------------


def _ablation_cfgs():
    jcfg = JaxConfig(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"),
                     coarse_sample=SAMPLES, fine_sample=SAMPLES,
                     volume_type="correlation", volume_merge="never",
                     volume_dtype="float32", image_gather_dtype="float32",
                     explicit_similarity=False)
    pcfg = Config(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"),
                  coarse_sample=SAMPLES, fine_sample=SAMPLES, explicit_similarity=False,
                  **EXACT)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def ablation_pair():
    scene, extras = make_synthetic_scene(n_views=3, h=32, w=32, ndepth=16)
    jcfg, pcfg = _ablation_cfgs()
    model = JaxUFORecon(jcfg)
    key = jax.random.PRNGKey(0)
    ray_d = extras["ray_d"][:RN]
    variables = jax.jit(model.init)(key, scene, ray_d[:4], key)
    enc = model.apply(variables, scene, method=model.encode)
    out = model.apply(variables, scene, enc, ray_d, key, method=model.render_chunk)
    k_coarse, k_fine = jax.random.split(key)
    u_c = jax.random.uniform(k_coarse, (RN, SAMPLES), jnp.float32)
    u_f = jax.random.uniform(k_fine, (RN, SAMPLES), jnp.float32)

    port = UFORecon(pcfg)
    tree = _np_tree(variables)
    load_flax_variables(port, tree)
    port.requires_grad_(False)   # the render path: no autograd graph
    p_scene = SceneInputs(
        **{k: ({s: _t(p) for s, p in v.items()} if isinstance(v, dict) else _t(v))
           for k, v in scene._asdict().items()})
    return dict(jax_enc=_np_tree(enc), jax_out=_np_tree(out), port=port, tree=tree,
                scene=p_scene, port_enc=port.encode(p_scene), ray_d=_t(ray_d),
                u_c=_t(u_c), u_f=_t(u_f))


def test_ablation_widths_match_jax(ablation_pair):
    """No pre_sim_mlp in the flax tree or the port, d_view 64, ray-head
    width 72."""
    jcfg, pcfg = _ablation_cfgs()
    assert "pre_sim_mlp" not in ablation_pair["tree"]["params"]["ray_transformer"]
    rt = ablation_pair["port"].ray_transformer
    assert not hasattr(rt, "pre_sim_mlp")
    assert (pcfg.sim_feat_fix, pcfg.view_trans_dim, pcfg.ray_trans_dim) == \
        (jcfg.sim_feat_fix, jcfg.view_trans_dim, jcfg.ray_trans_dim) == (0, 64, 72)
    assert rt.d_view == 64 and rt.ray_head_params().wq.shape == (72, 72)


@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_ablation_render_chunk_matches_jax(ablation_pair, encoder):
    """render_chunk without explicit similarity, on the JAX encoder outputs
    (the render path alone) and on the port's own (the whole slice)."""
    sp = ablation_pair
    enc = _bridge_encoder(sp["jax_enc"]) if encoder == "jax" else sp["port_enc"]
    out = sp["port"].render_chunk(sp["scene"], enc, sp["ray_d"],
                                  u_coarse=sp["u_c"], u_fine=sp["u_f"])
    # the ablation's random weights render surfaces: the check sees the
    # compositing, not only its floor
    assert np.median(sp["jax_out"]["fine"]["opacity"]) > 0.1
    _check_render(out, sp["jax_out"], encoder)


def test_ablation_knobs_take_the_same_route(ablation_pair):
    """Without the similarity, 'auto' and 'never' both take the view
    transformer: the same chunk, bit for bit."""
    sp = ablation_pair
    args = (sp["scene"], sp["port_enc"], sp["ray_d"])
    draws = dict(u_coarse=sp["u_c"], u_fine=sp["u_f"])
    auto = sp["port"].render_chunk(*args, **draws)
    never = sp["port"].with_knobs(fused_point_head="never").render_chunk(*args, **draws)
    for phase in ("coarse", "fine"):
        for key in ("rgb", "depth", "opacity"):
            torch.testing.assert_close(never[phase][key], auto[phase][key], rtol=0, atol=0)


def test_load_flax_variables_rejects_the_other_tree(ablation_pair):
    """The ablation's tree fills only the ablation's model: a pre_sim_mlp
    leaf it does not have, or the default model's widths, raise."""
    tree = ablation_pair["tree"]
    with_sim = copy.deepcopy(tree)
    with_sim["params"]["ray_transformer"]["pre_sim_mlp"] = {
        "Dense_0": {"kernel": np.zeros((8, 32), np.float32),
                    "bias": np.zeros(32, np.float32)}}
    _, pcfg = _ablation_cfgs()
    with pytest.raises(ValueError, match="unused flax leaves.*pre_sim_mlp"):
        load_flax_variables(UFORecon(pcfg), with_sim)
    default = UFORecon(Config(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross")))
    with pytest.raises(ValueError, match="pre_sim_mlp"):
        load_flax_variables(default, tree)


def test_fused_point_head_validates_like_jax():
    values = ("auto", "always", "never")
    assert Config().fused_point_head == JaxConfig().fused_point_head == "auto"
    assert Config().explicit_similarity and JaxConfig().explicit_similarity
    for value in values:
        assert Config(fused_point_head=value).fused_point_head == value
        JaxConfig(fused_point_head=value)
    for bad in ("on", "AUTO"):
        with pytest.raises(ValueError, match="fused_point_head"):
            Config(fused_point_head=bad)
    # the point-head kernel needs the full feature set: JAX raises when it
    # traces, the port when the configuration is made, and its gate too
    with pytest.raises(ValueError, match="fused_point_head='always'"):
        Config(fused_point_head="always", explicit_similarity=False)
    from uforecon_tpu_torch.models.ray_transformer import RayTransformer

    # JAX's gate (its _fused_ok): volume features of either kind (the
    # correlation volume's 24, the feature grid's 16), the similarity and
    # the depth distance, no direction PE
    rt, sim, dd = RayTransformer(), torch.zeros(1), torch.zeros(1)
    for vol in (torch.zeros(2, 24), torch.zeros(2, 16)):
        with pytest.raises(ValueError, match="fused_point_head='always'"):
            rt._fused_ok(vol, None, dd, "always")
        assert [rt._fused_ok(vol, sim, dd, v) for v in values] == [True, True, False]
        for lacking in ((vol, None, dd), (None, sim, dd), (vol, sim, None)):
            assert not rt._fused_ok(*lacking, "auto")
            with pytest.raises(ValueError, match="fused_point_head='always'"):
                rt._fused_ok(*lacking, "always")
        assert not RayTransformer(use_dir_srdf=True)._fused_ok(vol, sim, dd, "auto")
    for flags in (dict(depth_pos_encoding=False), dict(use_dir_srdf=True),
                  dict(volume_reso=0), dict(volume_type="featuregrid", mvs_depth_guide=0)):
        with pytest.raises(ValueError, match="fused_point_head='always'"):
            Config(fused_point_head="always", **flags)
    # the feature grid with the depth guide and the similarity: JAX builds
    # it with 'always' and its gate takes the point head
    assert Config(fused_point_head="always",
                  volume_type="featuregrid").full_point_features
    JaxConfig(fused_point_head="always", volume_type="featuregrid")
