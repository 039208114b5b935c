"""The port's training loop, data, checkpoints, CLI and learn_sanity
against the JAX package.

  * ``MVSDataset`` (``data/dtu_train.py``): the samples of the fixture of
    ``test_train_dataset.py`` equal the JAX dataset's, for 'best' view
    selection and the validation filter; 'random' draws the same views
    (the fixture has images for 6 of the 49 views only);
  * ``CheckpointManager``: top-k retention by the monitored metric, the
    latest step always kept, restore and the one-shot save/load;
  * a 3-step ``fit`` in both packages from the same JAX init on the
    learn_sanity sphere (4 samples at 32x32), with the JAX key schedule's
    draws fed to the port: the coarse loss terms of each step within 1e-4
    relative (the fine pass can move an importance-sampling bin);
  * a checkpoint of the training loop loads through ``cli.run
    --extract_geometry --load_ckpt`` and renders (``cli.run --debug``
    itself: ``test_torch_cli_train.py``);
  * the port's ``learn_sanity`` at tiny settings: its sphere samples equal
    the repository script's, training and ``--resume`` run end to end;
  * the training entry points ask for the card by default.
"""
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu.config import Config as JaxConfig
from uforecon_tpu.data.dtu_train import MVSDataset as JaxMVSDataset
from uforecon_tpu.pipeline import fit as jax_fit

from uforecon_tpu_torch.cli import run
from uforecon_tpu_torch.config import EXACT, Config
from uforecon_tpu_torch.convert import load_flax_variables
from uforecon_tpu_torch.data.dtu_train import MVSDataset
from uforecon_tpu_torch.models.uforecon import UFORecon
from uforecon_tpu_torch.pipeline import fit as port_fit
from uforecon_tpu_torch.pipeline.checkpoint import (CheckpointManager, load_eval_variables,
                                                    load_params, save_params)
from uforecon_tpu_torch.script import learn_sanity, make_dtu_fixture

from test_train_dataset import dtu_train_dir  # noqa: F401  (a module fixture)

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)


# --------------------------------------------------------------------------
# MVSDataset
# --------------------------------------------------------------------------


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert set(g) == set(w), k
            for s in w:
                np.testing.assert_allclose(g[s], w[s], rtol=1e-6, atol=1e-6, err_msg=k)
        elif isinstance(w, str) or np.isscalar(w) and not isinstance(w, np.floating):
            assert g == w, k
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("selection", ["best", "random", "val"])
def test_mvs_dataset_matches_jax(dtu_train_dir, selection):  # noqa: F811
    root, split, pair = dtu_train_dir
    kw = {"best": dict(split="train", n_views=4),
          "random": dict(split="train", n_views=3, view_selection_type="random", seed=1),
          "val": dict(split="val", n_views=3, test_ref_views=[1, 2, 3])}[selection]
    split_name = kw.pop("split")
    got = MVSDataset(root, split_name, split, pair, **kw)
    want = JaxMVSDataset(root, split_name, split, pair, **kw)
    assert got.metas == want.metas and len(got) > 0
    if selection == "random":
        return   # its views may have no images on disk
    for i in (0, len(want) - 1):
        _assert_samples_equal(got[i], want[i])


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def test_checkpoint_manager_topk(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), save_top_k=2)
    tree = {"a": torch.arange(3.0), "b": {"c": torch.tensor(1.0)}}
    mgr.save(1, tree, {"val/loss_depth_fine": 3.0})
    mgr.save(2, {**tree, "b": {"c": torch.tensor(2.0)}}, {"val/loss_depth_fine": 1.0})
    mgr.save(3, tree, {"val/loss_depth_fine": 2.0})
    mgr.save(4, tree, {"val/loss_depth_fine": 9.0})
    # the top 2 by the metric are steps 2 and 3; the latest (4) is kept; 1 goes
    assert {int(s) for s in mgr._index} == {2, 3, 4}
    assert sorted(os.listdir(mgr.dir)) == ["index.json", "step_2.pt", "step_3.pt",
                                           "step_4.pt"]
    assert mgr.best_step() == 2 and mgr.latest_step() == 4
    assert float(mgr.restore(2)["b"]["c"]) == 2.0
    # the index survives a new manager on the same directory
    again = CheckpointManager(str(tmp_path / "ck"), save_top_k=2)
    assert again.best_step() == 2 and again.latest_step() == 4


def test_save_load_params_roundtrip(tmp_path):
    tree = {"w": torch.as_tensor(np.random.default_rng(0).random((4, 4), np.float32))}
    save_params(str(tmp_path / "p.pt"), tree)
    np.testing.assert_array_equal(load_params(str(tmp_path / "p.pt"))["w"], tree["w"])
    # a bare state dict and a saved training state give the same variables
    save_params(str(tmp_path / "s.pt"), {"state_dict": tree, "step": 3})
    for name in ("p.pt", "s.pt"):
        assert torch.equal(load_eval_variables(str(tmp_path / name))["w"], tree["w"])


# --------------------------------------------------------------------------
# a 3-step fit in both packages
# --------------------------------------------------------------------------

FIT = dict(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"), coarse_sample=8,
           fine_sample=8, train_ray_num=64, numdepth=16, train_n_view=3, max_epochs=1,
           uforecon_lr=1e-3, seed=5)


def _losses(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if "train/loss_all" in r]


def test_three_step_fit_matches_jax(tmp_path):
    views = learn_sanity.build_scene_views(4, 32, 32)
    ds = learn_sanity.SphereDataset(views, n_src=2, ndepth=16)
    jcfg = JaxConfig(**FIT, volume_type="correlation", volume_merge="never",
                     volume_dtype="float32", image_gather_dtype="float32",
                     logdir=str(tmp_path / "jax"))
    _, variables = jax_fit.init_model(jcfg, ds[0], jcfg.seed)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    jax_fit.fit(jcfg, train_ds=ds, val_ds=[], variables=variables, max_steps=3,
                log_every=1, n_workers=0)

    # the draws of the JAX loop: one key per step, split by render_chunk
    key, draws = jax.random.PRNGKey(jcfg.seed), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        k_c, k_f = jax.random.split(sub)
        draws.append((np.asarray(jax.random.uniform(k_c, (64, 8), jnp.float32)),
                      np.asarray(jax.random.uniform(k_f, (64, 8), jnp.float32))))
    cfg = Config(**FIT, **EXACT, logdir=str(tmp_path / "port"))
    model = UFORecon(cfg)
    load_flax_variables(model, variables)
    state = port_fit.fit(cfg, train_ds=ds, val_ds=[], model=model, max_steps=3,
                         log_every=1, n_workers=0, device="cpu", draws=draws)
    assert state.step == 3

    got, want = _losses(cfg.logdir + "/uforecon_tpu"), _losses(jcfg.logdir + "/uforecon_tpu")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        for k in ("train/rgb_coarse", "train/depth_ray_coarse"):
            assert w[k] > 0
            assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]), (g["step"], k, g[k], w[k])
        assert abs(g["train/loss_all"] - w["train/loss_all"]) <= 1e-3 * w["train/loss_all"]
    mgr = CheckpointManager(os.path.join(cfg.logdir, cfg.exp_name, "ckpt"))
    assert mgr.latest_step() == 3


# --------------------------------------------------------------------------
# the extraction CLI on a checkpoint of the training loop (the training CLI
# itself: tests/test_torch_cli_train.py)
# --------------------------------------------------------------------------

SMALL_MODEL = ["--depth_pos_encoding", "--explicit_similarity", "--ndepths", "8,8,8"]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixture")
    make_dtu_fixture.main([str(root), "--views", "23", "24", "33", "--wh", "320", "240"])
    return root


def test_cli_extracts_from_a_training_checkpoint(fixture_root, tmp_path, monkeypatch):
    """A checkpoint as ``fit`` writes it (``CheckpointManager.save`` of
    ``fit._checkpoint``: weights, Adam state, step) loads through
    ``cli.run --extract_geometry --load_ckpt``, which renders with its
    weights."""
    cfg, _ = run.config_from_args(SMALL_MODEL)
    model = port_fit.init_model(cfg, 3, "cpu")
    state = port_fit.TrainState(model, port_fit.make_optimizer(cfg, model), 3)
    ckpt = CheckpointManager(str(tmp_path / "ckpt")).save(
        3, port_fit._checkpoint(state), {"val/loss_depth_fine": 0.5})
    loaded = []
    extract = run.extract_geometry_for_dataset

    def spy(m, ds, **kw):
        loaded.append(m)
        return extract(m, ds, **kw)

    out = tmp_path / "out"
    monkeypatch.setattr(run, "extract_geometry_for_dataset", spy)
    stats = run.main(SMALL_MODEL + [
        "--extract_geometry", "--root_dir", str(fixture_root), "--out_dir", str(out),
        "--test_scan", "scan24", "--test_ref_view", "23", "24", "33", "--img_wh",
        "160", "128", "--test_sample_coarse", "4", "--test_sample_fine", "4",
        "--load_ckpt", ckpt, "--device", "cpu"])
    assert stats["scan24"]["views"] == 3
    for i in range(3):
        d = np.load(out / "depth" / "scan24" / f"{i:08d}.npy", allow_pickle=True).item()
        assert d["depth"].shape == (128, 160) and np.all(np.isfinite(d["depth"]))
    # it rendered with the checkpoint's weights
    for k, v in model.state_dict().items():
        assert torch.equal(loaded[0].state_dict()[k], v), k


def test_training_asks_for_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        run.main(SMALL_MODEL + ["--debug", "--logdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        learn_sanity.main(["--logdir", str(tmp_path)])


# --------------------------------------------------------------------------
# learn_sanity
# --------------------------------------------------------------------------


def test_learn_sanity_samples_match_the_script():
    sys.path.insert(0, str(ROOT / "script"))
    try:
        import learn_sanity as jax_script
    finally:
        sys.path.remove(str(ROOT / "script"))
    got = learn_sanity.SphereDataset(learn_sanity.build_scene_views(5, 32, 64), 3, 16)
    want = jax_script.SphereDataset(jax_script.build_scene_views(5, 32, 64), 3, 16, 32, 64)
    for i in (0, 4):
        _assert_samples_equal(got[i], want[i])


def test_learn_sanity_runs_and_resumes(tmp_path, capsys):
    args = ["--h", "32", "--w", "32", "--views", "4", "--n_src", "2", "--ndepth", "16",
            "--device", "cpu", "--logdir", str(tmp_path), "--mesh_eval"]
    code = learn_sanity.main(args + ["--mvs_steps", "2", "--render_steps", "2"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == (0 if res["pass"] and res["mesh_pass"] else 1)
    assert np.isfinite(res["depth_l1_before"]) and np.isfinite(res["depth_l1_after"])
    assert "mesh_pass" in res
    learn_sanity.main(args + ["--resume"])
    res2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res2["resumed_step"] == 2
    assert res2["depth_l1"] == res["depth_l1_after"]
