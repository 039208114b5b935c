"""The port's seeded initialiser (``convert.init_weights``) draws each
parameter from the distribution flax draws it from in the JAX package.

For every parameter of a small model (its Dense, Conv, ConvTranspose,
DCN, BatchNorm and LayerNorm layers), the JAX ``init`` (seed 0) and the
port's ``init_weights`` (seed 0), leaf by leaf through the weight bridge's
names:
  * Dense, Conv and ConvTranspose kernels: ``lecun_normal`` (flax's
    default), a normal truncated at 2 sigma with variance 1 / fan_in, fan_in
    by flax's rule (the product of all axes but the last of the flax
    kernel); both packages' standard deviations within 6 sampling errors
    (sigma / sqrt(2 n)) of that, and the port's |w| within the truncation;
  * the DCN weights: uniform in +-sqrt(1 / fan_in) (std limit / sqrt(3)),
    the same way;
  * biases, the DCN offset/mask convs, the BatchNorm biases and running
    means exactly 0; norm scales and running variances exactly 1; the view
    token normal(0, 1); the NeuS variance 0.3.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_init.py -q
"""
import jax
import numpy as np
import pytest
import torch

from uforecon_tpu.config import Config as JaxConfig
from uforecon_tpu.models.uforecon import UFORecon as JaxUFORecon

from uforecon_tpu_torch.config import Config
from uforecon_tpu_torch.convert import TRUNC_STD, flax_to_state_dict, init_weights
from uforecon_tpu_torch.models.uforecon import UFORecon

from helpers import make_synthetic_scene

BASE = dict(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def inits():
    scene, extras = make_synthetic_scene(n_views=3, h=32, w=32, ndepth=16)
    model = JaxUFORecon(JaxConfig(**BASE))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(model.init)(key, scene, extras["ray_d"][:4], key)
    port = UFORecon(Config(**BASE))
    init_weights(port, 0)
    leaves = {path: arr for coll in ("params", "batch_stats")
              for path, arr in _flat(jax.tree_util.tree_map(np.asarray,
                                                           variables[coll]), (coll,))}
    return leaves, flax_to_state_dict(variables), port.state_dict()


_RENAME = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}


def test_every_parameter_is_drawn_as_flax_draws_it(inits):
    leaves, bridged, port = inits
    assert set(bridged) == {k for k in port if not k.endswith("num_batches_tracked")}
    seen = {"lecun": 0, "dcn": 0, "other": 0}
    for path, jax_arr in leaves.items():
        key = ".".join(path[1:-1] + (_RENAME.get(path[-1], path[-1]),))
        got = port[key].numpy()
        # flax kernels; the DCN weights are the only "weight" leaves
        kind = {"kernel": "lecun", "weight": "dcn"}.get(path[-1], "other")
        seen[kind] += 1
        if kind == "other":
            if path[-1] == "view_token":
                se = 1 / np.sqrt(2 * got.size)
                assert abs(got.std() - 1) <= 6 * se and abs(jax_arr.std() - 1) <= 6 * se
            else:      # biases, norms, BN statistics, the variance
                np.testing.assert_array_equal(got, jax_arr.reshape(got.shape), err_msg=key)
            continue
        if np.abs(jax_arr).max() == 0:          # the DCN offset/mask convs
            assert np.abs(got).max() == 0, key
            continue
        fan_in = int(np.prod(jax_arr.shape[:-1]))
        limit = np.sqrt(1.0 / fan_in)
        if kind == "lecun":
            sigma, bound = limit, 2 * limit / TRUNC_STD
        else:
            sigma, bound = limit / np.sqrt(3.0), limit
        assert np.abs(got).max() <= bound * (1 + 1e-6), key
        se = sigma / np.sqrt(2 * got.size)
        for name, arr in (("port", got), ("jax", jax_arr)):
            assert abs(arr.std() - sigma) <= 6 * se, (name, key, arr.std(), sigma)
        assert abs(got.mean()) <= 6 * sigma / np.sqrt(got.size), key
    # the FeatureNet's nine DCN layers (three output heads of three convs)
    assert seen["lecun"] > 50 and seen["dcn"] == 9 and seen["other"] > 50


def test_init_weights_is_seeded():
    models = [UFORecon(Config(**BASE)) for _ in range(3)]
    for model, seed in zip(models, (0, 0, 1)):
        init_weights(model, seed)
    key = "ray_transformer.density_mlp.Dense_0.weight"
    a, b, c = (m.state_dict()[key] for m in models)
    assert torch.equal(a, b) and not torch.equal(a, c)
