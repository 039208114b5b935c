"""The port's modules in bfloat16 against the JAX package's same modules in
bfloat16 (flax ``dtype=bfloat16``, float32 parameters), on the same
weights and seeded inputs.

In both packages a bf16 module's convolutions and dense layers take
bf16-rounded inputs and weights, sum in float32 and round their output to
bf16; BatchNorm and LayerNorm compute in float32 and return float32; the
sigmoid and the softmax go op by op in bf16 (``models/layers.py``). The
two sides differ only where a float32 sum in another order lands on the
other side of a bf16 rounding, which moves that output by one bf16 step.

Rule: every element within 2 bf16 ulps of JAX's output, the ulp taken at
the larger of the element's magnitude and its row's RMS (the last axis:
an element that cancels to near zero carries the rounding of its larger
terms, which a LayerNorm or BatchNorm then scales). Measured: the dense
MLP, the feature grid and CostRegNetWeight's weight head bit-equal to
JAX; Conv + BN, the FMT layer, the DCN block and CostRegNetWeight's
features within float32 rounding of it (under 0.02 ulps); CostRegNet one
ulp on 0.05 % of its elements; a LoFTR layer 1.1 ulps at worst.

The float32 islands inside these modules each have a check that a bf16
rounding would fail: BatchNorm and LayerNorm return float32; the DCN's
sampling positions (a float32 pixel grid plus bf16 offsets) and its
contraction (float32 taps against the float32 weight) stay float32, so
the DCN block agrees with JAX at float32's 1e-5; the cascade's warp grid
stays float32 under bf16 features (the correlation of bf16 stage features
against JAX's at float32's 1e-5, where a bf16 pixel coordinate would be
off by up to a pixel).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_bf16_layers.py -q
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu.models import attention as jax_attention
from uforecon_tpu.models import cascade as jax_cascade
from uforecon_tpu.models import featurenet as jax_featurenet
from uforecon_tpu.models import layers as jax_layers
from uforecon_tpu.models import volumes as jax_volumes

from uforecon_tpu_torch.convert import load_flax_variables
from uforecon_tpu_torch.models import attention, cascade, featurenet, layers, volumes

torch.set_num_threads(1)

BF16 = jnp.bfloat16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _cl(t):
    """A channels-first port output, channels-last as float32 numpy."""
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _cf(x):
    return torch.as_tensor(np.moveaxis(x, -1, 1).copy())


def assert_bf16_ulps(got, want, ulps=2.0):
    got, want = np.asarray(got, np.float32), _f32(want)
    assert got.shape == want.shape
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2, axis=-1, keepdims=True))
    mag = np.maximum(np.abs(want), rms)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    err = np.abs(got - want) / ulp
    assert err.max() <= ulps, (err.max(), np.unravel_index(err.argmax(), err.shape))


def _port(module, variables):
    load_flax_variables(module, variables)
    layers.set_compute_dtype(module, torch.bfloat16)
    module.requires_grad_(False)
    return module


def _bn_stats(variables, rng):
    """Running statistics away from (0, 1) in every BatchNorm."""
    def walk(tree):
        for k, v in tree.items():
            if "mean" in v and "var" in v:
                n = v["mean"].shape[0]
                tree[k] = {"mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                           "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
            else:
                walk(v)
    walk(variables.get("batch_stats", {}))
    return variables


def test_conv_bn_relu_2d_and_3d():
    rng = np.random.default_rng(0)
    for jmod, pmod, x in (
            (jax_layers.ConvBnRelu(16, dtype=BF16), layers.ConvBnRelu(8, 16),
             rng.standard_normal((2, 12, 14, 8))),
            (jax_layers.Conv3dBnRelu(16, dtype=BF16), layers.Conv3dBnRelu(8, 16),
             rng.standard_normal((1, 6, 8, 10, 8)))):
        x = x.astype(np.float32)
        v = _bn_stats(_np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
        want = jmod.apply(v, jnp.asarray(x))
        got = _port(pmod, v)(_cf(x))
        assert want.dtype == jnp.float32 and got.dtype == torch.float32   # BN: f32 out
        assert_bf16_ulps(_cl(got), want)


def test_dense_mlp_is_bit_equal():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 5, 40)).astype(np.float32)
    jmod = jax_layers.MLP((32, 16, 1), dtype=BF16)
    v = _np(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = jmod.apply(v, jnp.asarray(x))
    got = _port(layers.MLP(40, (32, 16, 1)), v)(torch.as_tensor(x))
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


@pytest.mark.parametrize("kind", ["loftr", "fmt"])
def test_attention_layer(kind):
    """A LoFTR layer (the view transformer's: 5 tokens, the short qk-order
    attention) and an FMT layer (256 tokens: the kv-order); their
    LayerNorms return float32."""
    rng = np.random.default_rng(2)
    if kind == "loftr":
        x = rng.standard_normal((300, 5, 80)).astype(np.float32)
        jmod, pmod = jax_attention.LoFTREncoderLayer(80, 8, dtype=BF16), \
            attention.LoFTREncoderLayer(80, 8)
    else:
        x = rng.standard_normal((2, 256, 32)).astype(np.float32)
        jmod, pmod = jax_attention.FMTEncoderLayer(32, 8, dtype=BF16), \
            attention.FMTEncoderLayer(32, 8)
    v = _np(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(x)))
    want = jmod.apply(v, jnp.asarray(x), jnp.asarray(x))
    got = _port(pmod, v)(torch.as_tensor(x), torch.as_tensor(x))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert pmod.norm1(torch.ones(2, x.shape[-1], dtype=torch.bfloat16)).dtype == torch.float32
    assert_bf16_ulps(got.numpy(), want)


def test_dcn_block_keeps_its_positions_and_contraction_in_float32():
    """Conv + BN, three DCNs with BN between; dcn0's offsets and mask
    non-zero (its offset conv drawn at random)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 14, 16)).astype(np.float32)
    jmod = jax_featurenet._DCNBlock(16, 16, first_kernel=3, dtype=BF16)
    v = _bn_stats(_np(jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))), rng)
    om = v["params"]["dcn0"]["conv_offset_mask"]
    om["kernel"] = (0.1 * rng.standard_normal(om["kernel"].shape)).astype(np.float32)
    om["bias"] = (0.1 * rng.standard_normal(om["bias"].shape)).astype(np.float32)
    want = jmod.apply(v, jnp.asarray(x))
    pmod = _port(featurenet.DCNBlock(16, 16, 16, first_kernel=3), v)
    got = pmod(_cf(x))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    # the offset conv computes in bf16, the rest in float32
    assert pmod.dcn0.conv_offset_mask(_cf(x)).dtype == torch.bfloat16
    np.testing.assert_allclose(_cl(got), _f32(want), rtol=0,
                               atol=1e-5 * np.abs(_f32(want)).max())
    want32 = jax_featurenet._DCNBlock(16, 16, first_kernel=3).apply(v, jnp.asarray(x))
    assert np.abs(_f32(want32) - _f32(want)).max() > 1e-3 * np.abs(_f32(want)).max()


@pytest.mark.parametrize("head", ["cost_reg", "cost_reg_weight"])
def test_cost_regularisation_nets(head):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 16, 16, 1)).astype(np.float32)
    if head == "cost_reg":
        jmod, pmod = jax_cascade.CostRegNet(8, dtype=BF16), cascade.CostRegNet(1, 8)
    else:
        jmod, pmod = jax_volumes.CostRegNetWeight(8, dtype=BF16), \
            volumes.CostRegNetWeight(1, 8)
    v = _bn_stats(_np(jmod.init(jax.random.PRNGKey(4), jnp.asarray(x))), rng)
    want = jmod.apply(v, jnp.asarray(x))
    got = _port(pmod, v)(_cf(x))
    for w, g in zip(*((want, got) if head == "cost_reg_weight" else ((want,), (got,)))):
        assert w.dtype == BF16 and g.dtype == torch.bfloat16
        assert_bf16_ulps(_cl(g), w)


def test_feature_volume():
    """The feature grid: bf16 MLP, float32 mean and variance over the
    views, the bf16 U-Net (its BatchNorms in float32), a bf16 grid."""
    rng = np.random.default_rng(5)
    nv, r = 3, 8
    feats = rng.standard_normal((nv, 8, 8, 32)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (nv, 1, 1))
    poses[:, 2, 3] = 2.0 + np.arange(nv)
    poses[:, :2, :3] += (0.1 * rng.standard_normal((nv, 2, 3))).astype(np.float32)
    jmod = jax_volumes.FeatureVolume(r, dtype=BF16)
    v = _bn_stats(_np(jmod.init(jax.random.PRNGKey(5), jnp.asarray(feats),
                                jnp.asarray(poses))), rng)
    want = jmod.apply(v, jnp.asarray(feats), jnp.asarray(poses))     # (Z, Y, X, 16)
    got = _port(volumes.FeatureVolume(r), v)(torch.as_tensor(feats), torch.as_tensor(poses))
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    assert_bf16_ulps(got.permute(1, 2, 3, 0).float().numpy(), want)


def test_warp_grid_stays_float32_under_bf16_features():
    """The correlation of bf16 stage features at W = 640: float32 on both
    sides, JAX's within float32 rounding (a bf16 grid is ~2 px off)."""
    rng = np.random.default_rng(6)
    v, h, w, c, d = 3, 4, 640, 8, 3
    feats = rng.standard_normal((v, h, w, c)).astype(np.float32)
    fb = jnp.asarray(feats).astype(BF16)
    k = np.array([[500.0, 0, 320], [0, 500.0, 2], [0, 0, 1]], np.float32)
    projs = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    projs[:, :3, :3] = k
    projs[1:, 0, 3] = [40.0, -60.0]
    dv = np.broadcast_to(np.linspace(400, 900, d, dtype=np.float32)[:, None, None],
                         (d, h, w)).copy()
    want = jax_cascade._correlate_chunked(fb[1:], jnp.asarray(projs[1:]),
                                          jnp.asarray(projs[0]), fb[0], jnp.asarray(dv))
    fp = torch.as_tensor(_f32(fb)).bfloat16()
    got = cascade._correlate_chunked(fp[1:], torch.as_tensor(projs[1:]),
                                     torch.as_tensor(projs[0]), fp[0], torch.as_tensor(dv))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _f32(want)[..., 0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_learn_sanity_dtype_reaches_the_config(dtype):
    """``script/learn_sanity.py --dtype`` is the JAX script's: the Config's
    ``compute_dtype`` (the matcher follows it, as ``encoder_dtype`` is
    empty), and so the dtype of the model it trains."""
    from uforecon_tpu_torch.models.uforecon import UFORecon
    from uforecon_tpu_torch.script import learn_sanity

    cfg = learn_sanity.build_config(learn_sanity.parse_args(["--dtype", dtype]))
    assert cfg.compute_dtype == dtype and cfg.encoder_dtype == ""
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    model = UFORecon(cfg)
    assert model.ray_transformer.dtype == want
    assert model.mvs_volume.conv0.compute_dtype == want
    assert model.matcher.cost_reg_0.Conv_0.compute_dtype == want
    with pytest.raises(SystemExit):
        learn_sanity.parse_args(["--dtype", "float16"])
