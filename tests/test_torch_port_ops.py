"""The PyTorch port's ops and layers against the JAX package.

Each test makes its inputs with numpy from a seed, runs the JAX function
and its port, and compares. Layers get the same weights through
``load_flax_variables``. Tolerances: exact equality for numpy helpers and
integer index maths; 1e-5 for single f32 ops (another summation order or a
few ulp of a transcendental); 1e-4 for layers that chain several
projections.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uforecon_tpu.models import attention as jatt
from uforecon_tpu.models import featurenet as jfeat
from uforecon_tpu.models import layers as jlayers
from uforecon_tpu.models import volumes as jvol
from uforecon_tpu.ops import camera as jcam
from uforecon_tpu.ops import deform_conv as jdcn
from uforecon_tpu.ops import grid_sample as jgs
from uforecon_tpu.ops import posenc as jpe
from uforecon_tpu.ops import rendering as jrender
from uforecon_tpu.ops import sampling as jsampling

from uforecon_tpu_torch.convert import load_flax_variables
from uforecon_tpu_torch.models import attention as patt
from uforecon_tpu_torch.models import featurenet as pfeat
from uforecon_tpu_torch.models import layers as players
from uforecon_tpu_torch.models import volumes as pvol
from uforecon_tpu_torch.ops import camera as pcam
from uforecon_tpu_torch.ops import deform_conv as pdcn
from uforecon_tpu_torch.ops import grid_sample as pgs
from uforecon_tpu_torch.ops import posenc as ppe
from uforecon_tpu_torch.ops import rendering as prender
from uforecon_tpu_torch.ops import resize as presize
from uforecon_tpu_torch.ops import sampling as psampling

from helpers import make_synthetic_scene

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _randomize(tree, rng, scale=0.3):
    """Same tree with random biases, norm and BN statistics (variances kept
    positive). Kernels keep their flax initialisation, which holds the
    activations near unit scale, unless it is all zeros (the DCN offset
    conv), so that every leaf's mapping is exercised."""
    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']") and np.any(a):
            return a
        r = rng.standard_normal(np.shape(a)).astype(np.float32) * scale
        if name.endswith("['var']"):
            r = np.abs(r) + 0.5
        return r
    return jax.tree_util.tree_map_with_path(leaf, tree)


# --------------------------------------------------------------------------
# camera


def test_camera_numpy_helpers_equal_jax():
    np.testing.assert_array_equal(pcam.ndc_normalize_matrix(800, 640),
                                  jcam.ndc_normalize_matrix(800, 640))
    hp = pcam.homo_pixel_grid(40, 24)
    np.testing.assert_array_equal(hp, jcam.homo_pixel_grid(40, 24))
    scene, _ = make_synthetic_scene(n_views=3, h=24, w=40)
    pinv = np.linalg.inv(np.asarray(scene.source_poses[0]))
    for a, b in zip(pcam.build_rays(pinv, hp), jcam.build_rays(pinv, hp)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_near_far", [False, True])
def test_project_points_ndc_matches_jax(rng, with_near_far):
    scene, _ = make_synthetic_scene(n_views=3, h=32, w=32)
    pts = rng.uniform(-1.0, 1.0, (5, 7, 3)).astype(np.float32)
    nf = (scene.near, scene.far) if with_near_far else None
    ref = jcam.project_points_ndc(scene.source_poses, jnp.asarray(pts), nf)
    pnf = (_t(scene.near), _t(scene.far)) if with_near_far else None
    got = pcam.project_points_ndc(_t(scene.source_poses), _t(pts), pnf)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# grid sampling, one case per call-site convention


@pytest.mark.parametrize("align,padding", [(False, "zeros"), (True, "border")],
                         ids=["image_features", "pair_maps"])
def test_grid_sample_2d_matches_jax(rng, align, padding):
    img = rng.standard_normal((2, 9, 13, 5)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 6, 4, 2)).astype(np.float32)
    ref = jgs.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid), align, padding)
    got = pgs.grid_sample_2d(_t(img), _t(grid), align, padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_grid_sample_3d_volume_convention_matches_jax(rng):
    vol = rng.standard_normal((2, 5, 7, 6, 9)).astype(np.float32)  # (N,D,H,W,C)
    grid = rng.uniform(-1.2, 1.2, (2, 8, 3, 3)).astype(np.float32)
    ref = jgs.grid_sample_3d(jnp.asarray(vol), jnp.asarray(grid), True, "zeros")
    got = pgs.grid_sample_3d(_t(vol).permute(0, 4, 1, 2, 3), _t(grid), True, "zeros")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_in_bounds_mask_matches_jax(rng):
    grid = rng.uniform(-1.5, 1.5, (3, 10, 2)).astype(np.float32)
    np.testing.assert_array_equal(pgs.in_bounds_mask(_t(grid)).numpy(),
                                  np.asarray(jgs.in_bounds_mask(jnp.asarray(grid))))


# --------------------------------------------------------------------------
# positional encodings


def test_posenc_matches_jax(rng):
    np.testing.assert_array_equal(ppe.sine_image_pe(32, 6, 10),
                                  jpe.sine_image_pe(32, 6, 10))
    np.testing.assert_array_equal(ppe.order_posenc(8, 64), jpe.order_posenc(8, 64))
    x = rng.standard_normal((3, 11, 1)).astype(np.float32)
    np.testing.assert_allclose(ppe.nerf_posenc(_t(x), 4).numpy(),
                               np.asarray(jpe.nerf_posenc(jnp.asarray(x), 4)),
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# sampling with the JAX draws, NeuS compositing


def _rays(rng, rn):
    ray_o = np.tile(rng.standard_normal((1, 3)).astype(np.float32), (rn, 1))
    d = rng.standard_normal((rn, 3)).astype(np.float32)
    ray_d = d / np.linalg.norm(d, axis=1, keepdims=True)
    near = rng.uniform(1.0, 2.0, rn).astype(np.float32)
    return ray_o, ray_d, near, near + 2.0


def test_sample_coarse_matches_jax_with_same_draws(rng):
    rn, sn = 6, 16
    ray_o, ray_d, near, far = _rays(rng, rn)
    key = jax.random.PRNGKey(3)
    pts, z = jsampling.sample_coarse(key, jnp.asarray(ray_o), jnp.asarray(ray_d),
                                     sn, jnp.asarray(near), jnp.asarray(far))
    u = jax.random.uniform(key, (rn, sn), jnp.float32)
    p2, z2 = psampling.sample_coarse(_t(ray_o), _t(ray_d), sn, _t(near), _t(far), u=_t(u))
    np.testing.assert_allclose(z2.numpy(), np.asarray(z), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p2.numpy(), np.asarray(pts), rtol=1e-5, atol=1e-5)


def test_sample_importance_matches_jax_with_same_draws(rng):
    rn, sn, pn = 6, 16, 12
    ray_o, ray_d, near, _ = _rays(rng, rn)
    z_val = np.sort(near[:, None] + rng.uniform(0, 2, (rn, sn)), axis=1).astype(np.float32)
    weight = rng.uniform(0, 1, (rn, sn)).astype(np.float32)
    weight[0] = 0.0                      # a ray with no mass: all cdf 0
    key = jax.random.PRNGKey(5)
    pts, z = jsampling.sample_importance(key, jnp.asarray(ray_o), jnp.asarray(ray_d),
                                         jnp.asarray(weight), jnp.asarray(z_val), pn)
    u = jax.random.uniform(key, (rn, pn), jnp.float32)
    p2, z2 = psampling.sample_importance(_t(ray_o), _t(ray_d), _t(weight),
                                         _t(z_val), pn, u=_t(u))
    np.testing.assert_allclose(z2.numpy(), np.asarray(z), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p2.numpy(), np.asarray(pts), rtol=1e-5, atol=1e-5)


def test_sampling_draws_come_from_the_generator():
    ray_o, ray_d, near, far = (_t(a) for a in _rays(np.random.default_rng(0), 4))
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        outs.append(psampling.sample_coarse(ray_o, ray_d, 8, near, far, generator=g)[1])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_neus_render_matches_jax(rng):
    rn, sn = 5, 12
    z = np.sort(rng.uniform(1, 3, (rn, sn)), axis=1).astype(np.float32)
    rad = rng.uniform(0, 1, (rn, sn, 3)).astype(np.float32)
    srdf = rng.standard_normal((rn, sn)).astype(np.float32) * 0.2
    inv_s = np.float32(np.exp(3.0))
    ref = jrender.neus_render(jnp.asarray(z), jnp.asarray(rad), jnp.asarray(srdf),
                              jnp.asarray(inv_s))
    got = prender.neus_render(_t(z), _t(rad), _t(srdf), _t(inv_s))
    for k in ("rgb", "depth", "opacity", "weight", "variance"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# resize: jax.image.resize semantics, antialiased when an axis shrinks


@pytest.mark.parametrize("src,dst", [((32, 40), (16, 20)), ((8, 10), (32, 40)),
                                     ((32, 40), (32, 40)), ((12, 7), (5, 13))],
                         ids=["shrink_stage2", "enlarge", "identity", "mixed"])
def test_resize_linear_matches_jax(rng, src, dst):
    x = rng.standard_normal(src).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), dst, method="linear")
    got = presize.resize_linear(_t(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_resize_linear_shrink_differs_from_plain_bilinear(rng):
    """Why the port does not use F.interpolate for the stage-2 shrink."""
    x = rng.standard_normal((32, 40)).astype(np.float32)
    plain = F.interpolate(_t(x)[None, None], size=(16, 20), mode="bilinear",
                          align_corners=False)[0, 0]
    ours = presize.resize_linear(_t(x), (16, 20))
    assert (plain - ours).abs().max() > 1e-2


def test_resize_hypotheses_shrinks_depth_axis_like_jax(rng):
    from uforecon_tpu.models.cascade import resize_hypotheses as jresize
    from uforecon_tpu_torch.models.cascade import resize_hypotheses as presize_h

    vol = rng.standard_normal((48, 6, 8)).astype(np.float32)
    ref = jresize(jnp.asarray(vol), (32, 12, 16))
    got = presize_h(_t(vol), (32, 12, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_resize_nearest_matches_jax(rng):
    x = rng.standard_normal((2, 8, 10)).astype(np.float32)
    for shape in [(2, 16, 20), (2, 32, 40), (2, 5, 7)]:
        ref = jax.image.resize(jnp.asarray(x), shape, method="nearest")
        np.testing.assert_array_equal(presize.resize_nearest(_t(x), shape).numpy(),
                                      np.asarray(ref))


# --------------------------------------------------------------------------
# deformable convolution


def test_deform_conv_matches_jax_and_numpy_spec(rng):
    n, h, w, c, cout = 2, 6, 7, 4, 5
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = (rng.standard_normal((n, h, w, 9, 2)) * 1.5).astype(np.float32)
    mask = rng.uniform(0, 1, (n, h, w, 9)).astype(np.float32)
    wgt = rng.standard_normal((3, 3, c, cout)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    spec = jdcn.deform_conv2d_reference(x, off, mask, wgt, bias)
    jx = jdcn.deform_conv2d(*(jnp.asarray(a) for a in (x, off, mask, wgt, bias)))
    got = pdcn.deform_conv2d(_t(x), _t(off), _t(mask),
                             _t(wgt).permute(3, 2, 0, 1), _t(bias)).numpy()
    np.testing.assert_allclose(got, spec, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jx), rtol=1e-5, atol=1e-5)


def test_dcn_layer_matches_flax(rng):
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    mod = jfeat.DCN(features=5)
    variables = _randomize(_np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    ref = mod.apply(variables, jnp.asarray(x))
    port = pfeat.DCN(6, 5)
    load_flax_variables(port, variables)
    got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# attention


@pytest.mark.parametrize("s_len", [4, 96], ids=["qk_order", "kv_order"])
def test_linear_attention_matches_jax(rng, s_len):
    q = rng.standard_normal((3, 5, 4, 6)).astype(np.float32)
    k = rng.standard_normal((3, s_len, 4, 6)).astype(np.float32)
    v = rng.standard_normal((3, s_len, 4, 6)).astype(np.float32)
    ref = jatt.linear_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = patt.linear_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["loftr", "fmt"])
def test_encoder_layer_matches_flax(rng, kind):
    d, heads = 16, 4
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    src = rng.standard_normal((3, 7, d)).astype(np.float32)
    if kind == "loftr":
        mod, port = jatt.LoFTREncoderLayer(d, heads), patt.LoFTREncoderLayer(d, heads)
    else:
        mod, port = jatt.FMTEncoderLayer(d, heads), patt.FMTEncoderLayer(d, heads)
    variables = _randomize(_np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                             jnp.asarray(src))), rng)
    ref = mod.apply(variables, jnp.asarray(x), jnp.asarray(src))
    load_flax_variables(port, variables)
    got = port(_t(x), _t(src)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# 3D conv blocks: BN statistics and the ConvTranspose layout rule


def test_deconv3d_block_matches_flax(rng):
    x = rng.standard_normal((1, 3, 4, 5, 6)).astype(np.float32)    # NDHWC
    mod = jlayers.Deconv3dBnRelu(features=4)
    variables = _randomize(_np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    ref = mod.apply(variables, jnp.asarray(x))
    port = players.Deconv3dBnRelu(6, 4).eval()
    load_flax_variables(port, variables)
    got = port(_t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_cost_reg_net_weight_matches_flax(rng):
    x = rng.standard_normal((1, 8, 8, 8, 1)).astype(np.float32)
    mod = jvol.CostRegNetWeight(base_channels=4)
    variables = _randomize(_np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    f_ref, w_ref = mod.apply(variables, jnp.asarray(x))
    port = pvol.CostRegNetWeight(1, base_channels=4)
    load_flax_variables(port, variables)
    f, w = port(_t(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(f.detach().permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(f_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(w.detach().permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(w_ref), rtol=1e-4, atol=1e-4)


def test_load_flax_variables_rejects_unused_and_missing():
    port = patt.LoFTREncoderLayer(8, 2)
    mod = jatt.LoFTREncoderLayer(8, 2)
    x = jnp.zeros((1, 3, 8))
    variables = _np_tree(mod.init(jax.random.PRNGKey(0), x, x))
    extra = {"params": {**variables["params"], "stray": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(ValueError, match="stray"):
        load_flax_variables(port, extra)
    short = {"params": {k: v for k, v in variables["params"].items() if k != "merge"}}
    with pytest.raises(ValueError, match="merge"):
        load_flax_variables(port, short)


@pytest.mark.parametrize("pair_quirk", [True, False])
def test_query_similarity_matches_jax(rng, pair_quirk):
    from uforecon_tpu.models.ray_transformer import query_similarity as jq
    from uforecon_tpu_torch.models.ray_transformer import query_similarity as pq

    nv, h, w, c = 3, 8, 10, 32
    aug0 = rng.standard_normal((3, h, w, c)).astype(np.float32)
    aug1 = rng.standard_normal((3, h, w, c)).astype(np.float32)
    scene, _ = make_synthetic_scene(n_views=nv, h=32, w=32)
    pts = rng.uniform(-0.8, 0.8, (4, 6, 3)).astype(np.float32)
    ref = jq(jnp.asarray(pts), scene.source_poses, jnp.asarray(aug0),
             jnp.asarray(aug1), nv, pair_quirk=pair_quirk, fused="never")
    got = pq(_t(pts), _t(scene.source_poses), _t(aug0), _t(aug1), nv,
             pair_quirk=pair_quirk)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_query_correlation_volume_matches_jax(rng):
    """The per-stage exact branch: JAX samples corner-packed volumes, the
    port the unpacked (NV, 9, D, h, w) ones."""
    from uforecon_tpu.models.ray_transformer import query_correlation_volume as jq
    from uforecon_tpu_torch.models.ray_transformer import query_correlation_volume as pq

    scene, _ = make_synthetic_scene(n_views=3, h=32, w=32)
    shapes = {"stage1": (8, 8, 8), "stage2": (8, 16, 16), "stage3": (8, 32, 32)}
    vols = {k: rng.standard_normal((3,) + s + (9,)).astype(np.float32)
            for k, s in shapes.items()}
    for v in vols.values():
        v[..., -1] = np.abs(v[..., -1])          # sigmoid weights are >= 0
    pts = rng.uniform(-1.0, 1.0, (5, 7, 3)).astype(np.float32)
    ref = jq(jnp.asarray(pts), scene.source_poses,
             {k: jgs.pack_volume_corners(jnp.asarray(v)) for k, v in vols.items()},
             (scene.near, scene.far), fused="never")
    got = pq(_t(pts), _t(scene.source_poses),
             {k: _t(v).permute(0, 4, 1, 2, 3) for k, v in vols.items()},
             (_t(scene.near), _t(scene.far)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
