"""Checkpoint files into the port (``convert.load_weights``).

The JAX package's initialised variables of a small model (cascade depths
8/8/8, one FMT self/cross pair) are written two ways:
  * as the reference's Lightning ``.ckpt``: every flax leaf under its
    reference name, in torch layout (the JAX package's name map
    ``data/torch_ckpt.py uforecon_name_map`` inverted, as its golden tests
    build reference state dicts), with the hyper-parameters pickled beside
    it and the tensors the map skips;
  * as a state-dict file (``convert.save_state_dict``), and as
    ``torch.save(model.state_dict())``.
Each must load into the same port tensors as ``load_flax_variables``; a
tensor without a mapping, a model entry without a source and an orbax
directory raise; the CLI without ``--load_ckpt`` warns and seeds.
"""
import argparse

import jax
import numpy as np
import pytest
import torch

from uforecon_tpu.config import Config as JaxConfig
from uforecon_tpu.data.torch_ckpt import uforecon_name_map
from uforecon_tpu.models.uforecon import UFORecon as JaxUFORecon

from uforecon_tpu_torch.config import EXACT, Config
from uforecon_tpu_torch.convert import (init_weights, load_flax_variables,
                                        load_weights, save_state_dict)
from uforecon_tpu_torch.models.uforecon import UFORecon

from helpers import make_synthetic_scene

SMALL = dict(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"))


@pytest.fixture(scope="module")
def variables():
    scene, extras = make_synthetic_scene(n_views=3, h=32, w=32, ndepth=16)
    model = JaxUFORecon(JaxConfig(**SMALL, coarse_sample=4, fine_sample=4,
                                  volume_merge="never", volume_dtype="float32",
                                  image_gather_dtype="float32"))
    key = jax.random.PRNGKey(1)
    v = jax.jit(model.init)(key, scene, extras["ray_d"][:4], key)
    return jax.tree_util.tree_map(np.asarray, v)


def _leaf(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _torch_layout(a):
    a = np.asarray(a)
    if a.ndim == 2:
        return a.T
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 5:
        return a.transpose(4, 3, 0, 1, 2)
    return a


def reference_state_dict(variables):
    """The flax variables under the reference's names, in torch layout,
    with the tensors the name map skips."""
    sd = {}
    for name, tgt in uforecon_name_map().items():
        if tgt is None:
            continue
        leaf = _leaf(variables.get(tgt[0], {}), tgt[1])
        if leaf is not None:
            sd[name] = torch.from_numpy(np.array(_torch_layout(leaf), np.float32))
    sd["pre_conv.weight"] = torch.zeros(8, 3, 3, 3)
    sd["ray_transformer.depthcode._freqs"] = torch.ones(4)
    sd["transmvsnet.feature.conv0.0.bn.num_batches_tracked"] = torch.tensor(7)
    return sd


def _port(**kw):
    return UFORecon(Config(**SMALL, **EXACT, **kw))


def _assert_same_tensors(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def bridged(variables):
    m = _port()
    load_flax_variables(m, variables)
    return m


def test_lightning_ckpt_loads_like_flax_variables(variables, bridged, tmp_path):
    path = tmp_path / "uforecon.ckpt"
    torch.save({"state_dict": reference_state_dict(variables), "epoch": 3,
                "hyper_parameters": {"args": argparse.Namespace(volume_reso=96)}}, path)
    m = _port()
    load_weights(m, str(path))
    _assert_same_tensors(m, bridged)


def test_bare_reference_state_dict_loads_like_flax_variables(variables, bridged, tmp_path):
    path = tmp_path / "reference.pt"
    torch.save(reference_state_dict(variables), path)
    m = _port()
    load_weights(m, str(path))
    _assert_same_tensors(m, bridged)


def test_state_dict_files_load_like_flax_variables(variables, bridged, tmp_path):
    save_state_dict(str(tmp_path / "bridge.pt"), variables)
    m = _port()
    load_weights(m, str(tmp_path / "bridge.pt"))
    _assert_same_tensors(m, bridged)
    torch.save(bridged.state_dict(), tmp_path / "own.pt")
    m2 = _port()
    load_weights(m2, str(tmp_path / "own.pt"))
    _assert_same_tensors(m2, bridged)


@pytest.mark.parametrize("fault", ["unmapped tensor", "missing tensor", "wrong shape",
                                   "missing state-dict entry"])
def test_a_leaf_left_unmapped_raises(variables, tmp_path, fault):
    sd = reference_state_dict(variables)
    name = "ray_transformer.DensityMLP.0.weight"
    if fault == "unmapped tensor":
        sd["transmvsnet.unknown_module.weight"] = torch.zeros(3, 3)
        err, match = KeyError, "no mapping for reference tensor"
    elif fault == "missing tensor":
        del sd[name]
        err, match = ValueError, "without a source.*density_mlp"
    elif fault == "wrong shape":
        sd[name] = torch.zeros(5, 5)
        err, match = ValueError, "not convertible"
    else:
        sd = {k: v for k, v in _port().state_dict().items() if "pre_sim_mlp" not in k}
        err, match = ValueError, "without a source.*pre_sim_mlp"
    torch.save({"state_dict": sd}, tmp_path / "x.ckpt")
    with pytest.raises(err, match=match):
        load_weights(_port(), str(tmp_path / "x.ckpt"))


def test_ablation_model_refuses_the_full_models_weights(variables, tmp_path):
    """A checkpoint with explicit similarity has a pre_sim_mlp, which the
    ablation model does not: its leaf is missing, and that raises."""
    torch.save({"state_dict": reference_state_dict(variables)}, tmp_path / "x.ckpt")
    with pytest.raises(KeyError, match="flax leaf missing.*pre_sim_mlp"):
        load_weights(_port(explicit_similarity=False), str(tmp_path / "x.ckpt"))


def test_orbax_directory_raises(tmp_path):
    (tmp_path / "ckpt" / "params").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax.*save_state_dict"):
        load_weights(_port(), str(tmp_path / "ckpt"))


def test_no_checkpoint_warns_and_renders_seeded_weights(monkeypatch):
    from uforecon_tpu_torch.cli import run

    models = []
    monkeypatch.setattr(run, "DtuFitSparse", lambda **kw: [])
    monkeypatch.setattr(run, "extract_geometry_for_dataset",
                        lambda model, ds, **kw: models.append(model) or {
                            "views": 0, "rays_per_sec": 0.0, "merged": False,
                            "kernel_precision": model.kernel_precision})
    cfg = Config(**SMALL, **EXACT, test_scan="scan24", seed=5)
    with pytest.warns(UserWarning, match="random weights"):
        run.run_extract(cfg, "cpu")
    want = _port()
    init_weights(want, 5)
    _assert_same_tensors(models[0], want)
