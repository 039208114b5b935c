"""The JAX package's shipped extraction configuration through the CLI:
``cli.run`` at its defaults against the JAX package's extract at its
defaults (``Config(extract_geometry=True)``: merged, bf16 volumes and
sources, ``fast``) on the sphere fixture with the same weights and draws,
and ``cli.run`` with the exact flags on the exact path. On the CPU the JAX
heads take their flax path, so the port's ``fast`` heads are held to a run
that has no ``fast``: depth maps within 1e-3 relative on >= 99 % of pixels
(the exact path's CLI test holds 2e-4; the heads' bf16 products move depth
by ~1e-4 here). (The configuration's config, ops, model and kernels:
``test_torch_port_shipped.py``.)

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_shipped_cli.py -q
"""
import functools
import pickle

import numpy as np
import pytest
import torch

from uforecon_tpu_torch.cli import run
from uforecon_tpu_torch.convert import save_state_dict
from uforecon_tpu_torch.script import make_dtu_fixture

from test_torch_port_cli import FLAGS, SMALL
from test_torch_port_shipped import _subprocess, _wait

torch.set_num_threads(1)

_JAX_DEFAULT_EXTRACT = """
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
             ndepths=(8, 8, 8), test_ray_num=800, seed=seed)
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
    pickle.dump((jax.tree_util.tree_map(np.asarray, variables), draws, chunk), f)
"""


@pytest.fixture(scope="module")
def jax_default_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixture_shipped")
    make_dtu_fixture.main([str(root), "--views", "23", "24", "33", "--wh", "320", "240"])
    tmp = tmp_path_factory.mktemp("jax_default")
    proc = _subprocess(_JAX_DEFAULT_EXTRACT, root, tmp / "out", tmp / "io.pkl", 3)
    _wait(proc)
    with open(tmp / "io.pkl", "rb") as f:
        variables, draws, chunk = pickle.load(f)
    return root, tmp / "out", variables, draws, chunk


def test_cli_defaults_match_the_jax_cli_defaults(jax_default_run, tmp_path, monkeypatch,
                                                 capsys):
    root, jax_out, variables, draws, chunk = jax_default_run
    assert chunk == 1024          # both rules at test_ray_num 800
    ckpt = tmp_path / "weights.pt"
    save_state_dict(str(ckpt), variables)
    monkeypatch.setattr(run, "extract_geometry_for_dataset", functools.partial(
        run.extract_geometry_for_dataset, draws=draws))
    stats = run.main(FLAGS + SMALL + ["--root_dir", str(root), "--out_dir",
                                      str(tmp_path / "out"), "--load_ckpt", str(ckpt),
                                      "--device", "cpu"])["scan24"]
    assert stats["merged"] is True and stats["kernel_precision"] == "fast"
    assert "resolved: merged volumes, kernel_precision fast" in capsys.readouterr().out
    for i in range(3):
        name = f"scan24/{i:08d}.npy"
        got = np.load(tmp_path / "out" / "depth" / name, allow_pickle=True).item()["depth"]
        want = np.load(jax_out / "depth" / name, allow_pickle=True).item()["depth"]
        assert got.shape == want.shape == (128, 160) and np.all(np.isfinite(got))
        close = np.isclose(got, want, rtol=1e-3, atol=0)
        assert close.mean() >= 0.99, (i, close.mean())


def test_cli_exact_flags_render_the_exact_path(jax_default_run, tmp_path, capsys):
    root = jax_default_run[0]
    stats = run.main(FLAGS + SMALL + [
        "--root_dir", str(root), "--out_dir", str(tmp_path), "--device", "cpu",
        "--test_coarse_only", "--volume_merge", "never", "--volume_dtype", "float32",
        "--image_gather_dtype", "float32", "--kernel_precision", "highest"])["scan24"]
    assert stats["merged"] is False and stats["kernel_precision"] == "highest"
    assert "resolved: per-stage volumes, kernel_precision highest" in capsys.readouterr().out
