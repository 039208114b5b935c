"""The port's extract CLI (``cli/run.py``) against the JAX package.

The parity test writes the fixture (``script/make_dtu_fixture.py``, views
23 24 33 at 320x240) and runs, on the CPU:
  * the JAX package's ``extract_geometry_for_dataset`` on its
    ``DtuFitSparse`` at ``img_wh`` 160x128, cascade depths 8/8/8 and 8 + 8
    samples, on the exact path (``volume_merge='never'``,
    ``kernel_precision='highest'``, f32 gather sources and volumes), in a
    process of its own (the JAX package keeps one kernel-precision mode per
    process), with its own initialised weights;
  * ``python -m uforecon_tpu_torch.cli.run`` with the same flags, the
    exact path's four (``EXACT_FLAGS``; the port's defaults are the JAX
    package's evaluation defaults, ``test_torch_port_shipped.py``),
    ``--device cpu`` and those weights bridged into a state-dict file
    (``--load_ckpt``), the JAX key schedule's uniform draws fed through
    ``extract_geometry_for_dataset``'s ``draws``: one key per view split
    from ``PRNGKey(seed)``, one per 1024-ray chunk, split into coarse and
    fine (``pipeline/extract.py:85``, ``pipeline/renderer.py:82``,
    ``models/uforecon.py:388``).
The depth maps agree within 2e-4 relative on >= 99 % of pixels (the slice
tolerance: a ~1e-7 difference can flip an importance-sampling bin), and
their extrinsic and intrinsic to 1e-6.

The other tests hold the flag handling: every option of the JAX parser
with its default, the six flags the JAX package leaves unread accepted and
dropped, each flag set the port cannot build raising with the flag named
(a ``--mesh_shape`` of several cards, an unknown ``--volume_type``), the
flag sets it used to refuse reaching the Config, the 15-scan loop, and
every CLI of the port asking for the card by default.
"""
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uforecon_tpu_torch import config
from uforecon_tpu_torch.cli import clean_mesh, depth_fusion, dtu_eval, run, tsdf_fusion
from uforecon_tpu_torch.config import EXACT, Config, config_from_args
from uforecon_tpu_torch.convert import save_state_dict
from uforecon_tpu_torch.script import make_dtu_fixture

ROOT = Path(__file__).resolve().parent.parent
SEED = 3
FLAGS = ["--extract_geometry", "--set", "0", "--volume_type", "correlation",
         "--volume_reso", "96", "--depth_pos_encoding", "--mvs_depth_guide", "1",
         "--explicit_similarity", "--test_n_view", "3", "--test_ray_num", "800",
         "--test_ref_view", "23", "24", "33", "--test_scan", "scan24"]
SMALL = ["--img_wh", "160", "128", "--ndepths", "8,8,8", "--test_sample_coarse", "8",
         "--test_sample_fine", "8", "--seed", str(SEED)]
# the JAX package's exact path, which the JAX run below pins
EXACT_FLAGS = ["--volume_merge", "never", "--volume_dtype", "float32",
               "--image_gather_dtype", "float32", "--kernel_precision", "highest"]

_JAX_EXTRACT = """
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from uforecon_tpu.config import Config
from uforecon_tpu.data.dtu_test import DtuFitSparse
from uforecon_tpu.pipeline.extract import extract_geometry_for_dataset
from uforecon_tpu.pipeline.fit import init_model
from uforecon_tpu.pipeline.renderer import SceneRenderer
root, out, path, seed = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
cfg = Config(extract_geometry=True, test_sample_coarse=8, test_sample_fine=8,
             ndepths=(8, 8, 8), volume_merge="never", kernel_precision="highest",
             image_gather_dtype="float32", volume_dtype="float32", test_ray_num=800,
             seed=seed)
ds = DtuFitSparse(root_dir=root, scan_id="scan24", n_views=3, set=0,
                  test_view_pair=[23, 24, 33], img_wh=[160, 128])
_, variables = init_model(cfg, ds[0], seed)
extract_geometry_for_dataset(cfg, variables, ds, out_dir=out, seed=seed)
chunk = SceneRenderer(cfg, variables).chunk
n_chunks = -(-160 * 128 // chunk)
key, draws = jax.random.PRNGKey(seed), []
for _ in range(len(ds)):
    key, sub = jax.random.split(key)
    view = []
    for k in jax.random.split(sub, n_chunks):
        kc, kf = jax.random.split(k)
        view.append((np.asarray(jax.random.uniform(kc, (chunk, 8), jnp.float32)),
                     np.asarray(jax.random.uniform(kf, (chunk, 8), jnp.float32))))
    draws.append(view)
with open(path, "wb") as f:
    pickle.dump((jax.tree_util.tree_map(np.asarray, variables), draws), f)
"""


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixture")
    make_dtu_fixture.main([str(root), "--views", "23", "24", "33", "--wh", "320", "240"])
    return root


@pytest.fixture(scope="module")
def jax_run(fixture_root, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_extract")
    out, path = tmp / "out", tmp / "io.pkl"
    res = subprocess.run(
        [sys.executable, "-c", _JAX_EXTRACT, str(fixture_root), str(out), str(path),
         str(SEED)], capture_output=True, text=True, timeout=900, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "UFO_PLATFORM": "cpu",
             "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])})
    assert res.returncode == 0, res.stderr[-3000:]
    with open(path, "rb") as f:
        variables, draws = pickle.load(f)
    return out, variables, draws


def test_cli_depth_maps_match_jax(fixture_root, jax_run, tmp_path, monkeypatch):
    jax_out, variables, draws = jax_run
    ckpt = tmp_path / "weights.pt"
    save_state_dict(str(ckpt), variables)
    monkeypatch.setattr(run, "extract_geometry_for_dataset", functools.partial(
        run.extract_geometry_for_dataset, draws=draws))
    stats = run.main(FLAGS + SMALL + EXACT_FLAGS + [
        "--root_dir", str(fixture_root), "--out_dir", str(tmp_path / "out"),
        "--load_ckpt", str(ckpt), "--device", "cpu"])
    assert stats["scan24"]["views"] == 3 and stats["scan24"]["rays"] == 3 * 160 * 128
    for i in range(3):
        name = f"scan24/{i:08d}"
        got = np.load(tmp_path / "out" / "depth" / f"{name}.npy", allow_pickle=True).item()
        want = np.load(jax_out / "depth" / f"{name}.npy", allow_pickle=True).item()
        assert set(got) == set(want) == {"depth", "extrinsic", "intrinsic"}
        for k in ("extrinsic", "intrinsic"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        assert got["depth"].shape == want["depth"].shape == (128, 160)
        assert np.all(np.isfinite(got["depth"]))
        close = np.isclose(got["depth"], want["depth"], rtol=2e-4, atol=0)
        assert close.mean() >= 0.99, (i, close.mean())
        # the layout beside the maps: depth previews as the JAX package, rgb as PNG
        assert (tmp_path / "out" / "scan24" / "depth" / f"{i:08d}.png").exists()
        assert (tmp_path / "out" / "rgb" / f"{name}.png").exists()


@pytest.mark.parametrize("similarity", [True, False])
def test_cli_renders_with_and_without_explicit_similarity(fixture_root, tmp_path,
                                                          monkeypatch, similarity):
    """--explicit_similarity is store_true, as in JAX: without it the CLI
    builds the paper's ablation (no pre_sim_mlp), and both render."""
    models = []
    extract = run.extract_geometry_for_dataset
    monkeypatch.setattr(run, "extract_geometry_for_dataset",
                        lambda model, ds, **kw: models.append(model) or extract(
                            model, ds, **kw))
    flags = [f for f in FLAGS if similarity or f != "--explicit_similarity"]
    with pytest.warns(UserWarning, match="random weights"):
        run.main(flags + SMALL + ["--root_dir", str(fixture_root), "--out_dir",
                                  str(tmp_path), "--device", "cpu", "--test_coarse_only"])
    assert models[0].cfg.explicit_similarity is similarity
    assert hasattr(models[0].ray_transformer, "pre_sim_mlp") is similarity
    for i in range(3):
        d = np.load(tmp_path / "depth" / "scan24" / f"{i:08d}.npy", allow_pickle=True).item()
        assert d["depth"].shape == (128, 160) and np.all(np.isfinite(d["depth"]))


def _parser(config_from_args_fn, argv):
    """The ArgumentParser that ``config_from_args_fn`` builds, caught as it
    parses ``argv``."""
    import argparse

    seen = []
    parse = argparse.ArgumentParser.parse_args
    with pytest.MonkeyPatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args",
                  lambda self, *a, **k: seen.append(self) or parse(self, *a, **k))
        config_from_args_fn(argv)
    return {a.dest: a for a in seen[0]._actions if a.dest != "help"}


def test_flag_defaults_are_the_jax_ones():
    from uforecon_tpu.config import config_from_args as jax_config_from_args

    argv = ["--extract_geometry", "--depth_pos_encoding", "--explicit_similarity"]
    # every option of the JAX parser, with its spelling, arity, type and default
    want_opts, got_opts = _parser(jax_config_from_args, argv), _parser(config_from_args,
                                                                         argv)
    assert len(want_opts) == 58 and set(want_opts) <= set(got_opts)
    for dest, w in want_opts.items():
        g = got_opts[dest]
        assert (g.option_strings, g.nargs, g.const, g.type, g.default) == \
            (w.option_strings, w.nargs, w.const, w.type, w.default), dest
    assert set(got_opts) - set(want_opts) == {
        "volume_merge", "merge_depth", "merge_pad", "merge_max_bytes", "volume_dtype",
        "image_gather_dtype", "kernel_precision", "device"}
    cfg, device = config_from_args(argv)
    want = jax_config_from_args(argv)
    assert device == "cuda"
    for field in ("root_dir", "out_dir", "seed", "load_ckpt",
                  "test_sample_coarse", "test_sample_fine",
                  "extract_geometry", "test_n_view", "test_ray_num", "test_ref_view",
                  "test_scan", "set", "test_coarse_only", "img_wh", "ndepths",
                  "depth_inter_r", "cr_base_chs", "explicit_similarity",
                  "volume_type", "volume_reso", "mvs_depth_guide", "depth_pos_encoding",
                  "use_dir_srdf",
                  "test_general", "dataset", "use_mask", "extract_similarity",
                  "sim_reso", "sim_threshold",
                  # the evaluation approximations, which the JAX CLI sets by
                  # its defaults (its UFO_* environment overrides aside)
                  "volume_merge", "merge_depth", "merge_pad", "merge_max_bytes",
                  "volume_dtype", "image_gather_dtype", "kernel_precision"):
        assert getattr(cfg, field) == getattr(want, field), field
    assert cfg.samples == (want.test_sample_coarse, want.test_sample_fine)
    # without the flag, JAX builds the no-similarity ablation: so does the port
    cfg, _ = config_from_args(["--extract_geometry", "--depth_pos_encoding"])
    assert cfg.explicit_similarity is False
    # the port's flags for them, which stand in for the UFO_* overrides
    cfg, _ = config_from_args(["--extract_geometry", "--depth_pos_encoding", *EXACT_FLAGS,
                               "--merge_depth", "12", "--merge_pad",
                               "--merge_max_bytes", "0"])
    assert {k: getattr(cfg, k) for k in EXACT} == EXACT
    assert (cfg.merge_depth, cfg.merge_pad, cfg.merge_max_bytes) == (12, True, 0)
    with pytest.raises(SystemExit):
        config_from_args(["--extract_geometry", "--depth_pos_encoding",
                          "--kernel_precision", "bogus"])


EXTRACT = ["--extract_geometry", "--depth_pos_encoding"]


# the flag set the port refuses, naming its flag: a volume type the JAX
# package does not build
@pytest.mark.parametrize("argv,named", [
    (EXTRACT + ["--volume_type", "grid"], "--volume_type grid"),
])
def test_unsupported_flag_sets_raise(argv, named):
    with pytest.raises(ValueError, match=named):
        run.main(argv)


# --mesh_shape, refused until the port ran on several cards, reaches the
# Config as the JAX CLI's Config has it (its resolution to ranks:
# tests/test_torch_port_sharding.py)
@pytest.mark.parametrize("argv", [
    EXTRACT + ["--mesh_shape", "2"],
    ["--depth_pos_encoding", "--mesh_shape", "1,2"],
    EXTRACT + ["--mesh_shape", "4,2"],
])
def test_mesh_shape_reaches_the_config(argv):
    from uforecon_tpu.config import config_from_args as jax_config_from_args

    cfg, _ = config_from_args(argv)
    jcfg = jax_config_from_args(argv)
    assert cfg.mesh_shape == jcfg.mesh_shape
    assert cfg.extract_geometry == jcfg.extract_geometry


# the flag sets the port used to refuse: every model configuration trains,
# and the cascade flags and precision policies train and extract, each
# reaching the Config as the JAX CLI's Config has it
@pytest.mark.parametrize("argv", [
    [],
    ["--depth_pos_encoding", "--mvs_depth_guide", "0"],
    ["--depth_pos_encoding", "--use_dir_srdf"],
    ["--depth_pos_encoding", "--volume_type", "featuregrid"],
    ["--depth_pos_encoding", "--volume_reso", "0"],
    EXTRACT + ["--share_cr"],
    EXTRACT + ["--compute_dtype", "bfloat16"],
    EXTRACT + ["--encoder_dtype", "bfloat16"],
    ["--depth_pos_encoding", "--grad_method", "undetached", "--share_cr",
     "--encoder_dtype", "bfloat16"],
])
def test_formerly_refused_flag_sets_reach_the_config(argv):
    from uforecon_tpu.config import config_from_args as jax_config_from_args

    cfg, _ = config_from_args(argv)
    jcfg = jax_config_from_args(argv)
    for field in ("extract_geometry", "share_cr", "grad_method", "compute_dtype",
                  "encoder_dtype", "volume_type", "volume_reso", "mvs_depth_guide",
                  "depth_pos_encoding", "use_dir_srdf"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("field,value", [("compute_dtype", "float16"),
                                         ("encoder_dtype", "bf16"),
                                         ("grad_method", "detached")])
def test_unknown_precision_and_cascade_values_raise(field, value):
    with pytest.raises(ValueError, match=field):
        config_from_args(EXTRACT + [f"--{field}", value])


# the JAX package's other model configurations: each extracts, with its
# JAX widths (view-token width d_view = image 32 + volume 24 / 16 / 0 +
# similarity 16 / 0 + depth PE 8 / 0 + direction PE 24 / 0; the ray head's
# is d_view + 8); without --explicit_similarity the CLI builds the ablation
@pytest.mark.parametrize("flags,d_view", [
    (["--extract_geometry"], 56),                              # no depth PE
    (EXTRACT + ["--mvs_depth_guide", "0"], 56),
    (EXTRACT + ["--use_dir_srdf"], 88),
    (EXTRACT + ["--explicit_similarity", "--use_dir_srdf"], 104),
    (EXTRACT + ["--volume_type", "featuregrid"], 56),
    (["--extract_geometry", "--volume_type", "featuregrid", "--mvs_depth_guide", "0",
      "--explicit_similarity"], 64),
    (EXTRACT + ["--volume_reso", "0", "--explicit_similarity"], 56),
    (EXTRACT + ["--test_sample_coarse", "128", "--test_sample_fine", "96"], 64),
])
def test_model_configuration_flags_are_accepted(flags, d_view):
    from uforecon_tpu.config import config_from_args as jax_config_from_args

    cfg, _ = config_from_args(flags)
    jcfg = jax_config_from_args(flags)
    for field in ("volume_type", "volume_reso", "mvs_depth_guide", "depth_pos_encoding",
                  "use_dir_srdf", "explicit_similarity", "test_sample_coarse",
                  "test_sample_fine", "effective_fea_volume_dim", "depth_dim",
                  "sim_feat_fix"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.view_trans_dim == d_view and cfg.ray_trans_dim == d_view + 8
    # only the default configuration merges its (correlation) volumes
    assert config.use_volume_merge(cfg, 3, 640, 800) == (cfg.volume_type == "correlation"
                                                         and cfg.volume_reso > 0)


@pytest.mark.parametrize("flags", [
    ["--test_dir", "some/dir"], ["--depth_dir", "some/dir"], ["--patch_size", "3"],
    ["--sW", "2"], ["--sH", "2"], ["--only_reference_frustum"],
    ["--grad_method", "detach"]])
def test_inert_jax_flags_are_accepted_and_dropped(flags):
    """The flags the JAX package accepts and never reads (its
    ``config.py:7-15``) parse, and change nothing; ``detach`` is what the
    port always does."""
    base = ["--extract_geometry", "--depth_pos_encoding"]
    assert config_from_args(base + flags) == config_from_args(base)


def test_general_and_similarity_flags_reach_the_config():
    cfg, _ = config_from_args(["--extract_geometry", "--depth_pos_encoding",
                               "--test_general", "--dataset", "blendedmvs", "--use_mask",
                               "--extract_similarity", "--sim_reso", "64",
                               "--sim_threshold", "0.9"])
    assert (cfg.test_general, cfg.dataset, cfg.use_mask, cfg.extract_similarity,
            cfg.sim_reso, cfg.sim_threshold) == (True, "blendedmvs", True, True, 64, 0.9)


def test_supported_dtype_flags_parse():
    for extra in ([], ["--encoder_dtype", "float32"], ["--compute_dtype", "float32"]):
        cfg, _ = config_from_args(["--extract_geometry", "--depth_pos_encoding"] + extra)
        assert cfg.extract_geometry


@pytest.mark.parametrize("scan,want", [("", run.TEST_SCANS), ("scan1", run.TEST_SCANS),
                                       ("scan24", [24])])
def test_scan_loop_visits_the_dtu_test_scans(monkeypatch, scan, want):
    visited = []
    monkeypatch.setattr(run, "DtuFitSparse", lambda **kw: visited.append(kw) or [])
    monkeypatch.setattr(run, "extract_geometry_for_dataset",
                        lambda model, ds, **kw: {"views": 0, "rays_per_sec": 0.0,
                                                 "merged": False,
                                                 "kernel_precision": "fast"})
    monkeypatch.setattr(run, "init_weights", lambda model, seed: None)
    with pytest.warns(UserWarning, match="random weights"):
        stats = run.main(["--extract_geometry", "--depth_pos_encoding", "--test_scan",
                          scan, "--img_wh", "160", "128", "--device", "cpu"])
    assert [kw["scan_id"] for kw in visited] == [f"scan{s}" for s in want]
    assert list(stats) == [f"scan{s}" for s in want]
    assert all(kw["img_wh"] == [160, 128] and kw["test_view_pair"] == [23, 24, 33]
               for kw in visited)
    assert run.TEST_SCANS == [24, 37, 40, 55, 63, 65, 69, 83, 97, 105, 106, 110,
                              114, 118, 122]


def test_render_chunk_coarse_only_returns_the_coarse_pass():
    from uforecon_tpu_torch.convert import init_weights
    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.models.uforecon import UFORecon

    from helpers import make_synthetic_sample

    sample = make_synthetic_sample(n_views=3, h=32, w=32, ndepth=16, start_idx=0)
    model = UFORecon(Config(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"),
                            extract_geometry=True, test_sample_coarse=6,
                            test_sample_fine=4))
    init_weights(model, 0)
    scene, extras = scene_inputs_from_sample(sample, device="cpu")
    enc = model.encode(scene)
    ray_d = torch.as_tensor(extras["ray_d"][:32])
    gen = torch.Generator().manual_seed(0)
    u_c, u_f = torch.rand((32, 6), generator=gen), torch.rand((32, 4), generator=gen)
    full = model.render_chunk(scene, enc, ray_d, u_coarse=u_c, u_fine=u_f)
    coarse = model.render_chunk(scene, enc, ray_d, u_coarse=u_c, coarse_only=True)
    assert full["coarse"]["srdf"].shape == (32, 6)     # test_sample_coarse
    assert full["fine"]["srdf"].shape == (32, 10)      # + test_sample_fine
    for k in ("depth", "rgb", "opacity"):
        torch.testing.assert_close(coarse["fine"][k], full["coarse"][k], rtol=0, atol=0)
        assert coarse["fine"][k] is coarse["coarse"][k]


@pytest.mark.parametrize("cli", ["run", "tsdf_fusion", "depth_fusion", "clean_mesh",
                                 "dtu_eval"])
def test_every_cli_asks_for_the_card(tmp_path, monkeypatch, cli):
    """Without --device the CLIs run on the card and, where there is none,
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"run": FLAGS + ["--root_dir", str(tmp_path), "--out_dir", str(tmp_path)],
            "tsdf_fusion": ["--out_dir", str(tmp_path), "--test_scan", "scan24"],
            "depth_fusion": ["--out_dir", str(tmp_path), "--test_scan", "scan24"],
            "clean_mesh": ["--out_dir", str(tmp_path), "--root_dir", str(tmp_path),
                           "--test_scan", "scan24"],
            "dtu_eval": ["--mesh_dir", str(tmp_path), "--dataset_dir", str(tmp_path),
                         "--log_dir", str(tmp_path), "--scans", "24"]}[cli]
    main = {"run": run.main, "tsdf_fusion": tsdf_fusion.main,
            "depth_fusion": depth_fusion.main, "clean_mesh": clean_mesh.main,
            "dtu_eval": dtu_eval.main}[cli]
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        main(argv)
    assert os.listdir(tmp_path) == []
