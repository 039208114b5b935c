"""The port's ray-axis sharding helpers and ``--mesh_shape`` against the
JAX package's (``parallel/sharding.py``, ``cli/run.py:27``,
``pipeline/fit.py:303``), and the extraction CLI on two CPU ranks.

  * ``pad_to_multiple`` equals JAX's (edge mode, the original length);
    ``shard_rays`` gives rank ``r`` the block JAX's ``shard_rays`` puts on
    device ``r`` of ``make_mesh(world)``;
  * ``--mesh_shape 2`` and ``1,2`` resolve as JAX resolves them:
    extraction ``min(mesh_shape[0], devices)``, training
    ``prod(mesh_shape)``; training with fewer cards raises, naming the
    flag (JAX quietly takes the devices it has);
  * under ``torchrun``, a ``WORLD_SIZE`` other than the ranks
    ``--mesh_shape`` resolves to raises, naming both;
  * ``cli.run --extract_geometry --mesh_shape 2 --device cpu`` writes the
    depth files of ``--mesh_shape 1`` bit for bit, 3 views at 64x32 with
    4 + 4 samples (each rank renders real chunks of every view, so a rank
    whose generator fell out of step with one rank's shows in the second
    view), with its two ranks started by the CLI and by ``torchrun``. On
    the CPU a GEMM's sums depend on the torch threads, so every run has
    one thread a rank.
"""
import contextlib
import io
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from uforecon_tpu.config import config_from_args as jax_config_from_args
from uforecon_tpu.parallel import sharding as jax_sharding

from uforecon_tpu_torch.cli import run
from uforecon_tpu_torch.config import config_from_args
from uforecon_tpu_torch.parallel import sharding
from uforecon_tpu_torch.script import make_dtu_fixture

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("shape,multiple,axis", [
    ((10,), 4, 0), ((8,), 4, 0), ((7, 3), 5, 0), ((4, 6, 2), 4, 1), ((0, 3), 4, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    a = np.arange(math.prod(shape), dtype=np.float32).reshape(shape) * 0.5
    got, n = sharding.pad_to_multiple(a, multiple, axis)
    want, n_want = jax_sharding.pad_to_multiple(a, multiple, axis)
    assert n == n_want == shape[axis]
    np.testing.assert_array_equal(got, want)
    assert got.shape[axis] % multiple == 0


@pytest.mark.parametrize("world", [2, 4])
def test_shard_rays_is_the_jax_device_block(world):
    a = np.random.default_rng(world).standard_normal((24, 3)).astype(np.float32)
    placed = jax_sharding.shard_rays(jax_sharding.make_mesh(world), a)
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for r, dev in enumerate(jax.devices()[:world]):
        np.testing.assert_array_equal(sharding.shard_rays(a, r, world), by_device[dev])


def test_shard_bounds_split_evenly_or_raise():
    assert [sharding.shard_bounds(12, r, 3) for r in range(3)] == [(0, 4), (4, 8), (8, 12)]
    with pytest.raises(ValueError, match="do not split evenly"):
        sharding.shard_bounds(10, 0, 3)


def test_outside_a_process_group_there_is_one_rank():
    assert (sharding.rank(), sharding.world_size()) == (0, 1)
    assert sharding.rank_device("cuda", 3) == torch.device("cuda", 3)
    assert sharding.rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert sharding.rank_device("cpu", 3) == torch.device("cpu")
    assert sharding.backend_for("cuda:1") == "nccl" and sharding.backend_for("cpu") == "gloo"


@pytest.mark.parametrize("mesh", ["2", "1,2"])
@pytest.mark.parametrize("extract", [True, False])
def test_mesh_shape_resolves_as_jax(mesh, extract):
    argv = ["--depth_pos_encoding", "--mesh_shape", mesh] + (
        ["--extract_geometry"] if extract else [])
    cfg, _ = config_from_args(argv)
    jcfg = jax_config_from_args(argv)
    assert cfg.mesh_shape == jcfg.mesh_shape
    devices = len(jax.devices())              # 8 host devices (conftest)
    want = (min(jcfg.mesh_shape[0], devices) if extract
            else int(np.prod(jcfg.mesh_shape)))
    assert run.mesh_size(cfg, "cuda", cards=devices) == want
    assert run.mesh_size(cfg, "cpu") == want
    if extract:            # one card: the extraction renders on it
        assert run.mesh_size(cfg, "cuda", cards=1) == 1
    else:                  # training never runs on fewer cards than asked
        with pytest.raises(ValueError, match=f"--mesh_shape {mesh}: training takes 2 cards"):
            run.mesh_size(cfg, "cuda", cards=1)


def test_val_only_validates_on_one_rank():
    """JAX's ``--val_only`` validates without a mesh."""
    cfg, _ = config_from_args(["--val_only", "--mesh_shape", "2"])
    assert run.mesh_size(cfg, "cuda", cards=1) == run.mesh_size(cfg, "cpu") == 1


@pytest.mark.parametrize("world,mesh", [("2", "1"), ("4", "2")])
def test_a_torchrun_world_other_than_the_mesh_raises(monkeypatch, world, mesh):
    monkeypatch.setenv("WORLD_SIZE", world)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(ValueError, match=f"--mesh_shape {mesh} -> {mesh} cpu ranks?, "
                                         f"and torchrun started WORLD_SIZE={world}"):
        run.main(EXTRACT + ["--mesh_shape", mesh])


EXTRACT = ["--extract_geometry", "--depth_pos_encoding", "--explicit_similarity",
           "--ndepths", "8,8,8", "--test_sample_coarse", "4", "--test_sample_fine", "4",
           "--img_wh", "64", "32", "--test_scan", "scan24", "--test_ref_view", "23", "24",
           "33", "--device", "cpu"]


@contextlib.contextmanager
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixture")
    make_dtu_fixture.main([str(root), "--views", "23", "24", "33", "--wh", "320", "240"])
    return root


@pytest.fixture(scope="module")
def one_rank(fixture_root, tmp_path_factory):
    """``--mesh_shape 1``'s output directory, statistics and printed lines."""
    out = tmp_path_factory.mktemp("one_rank")
    printed = io.StringIO()
    with _one_thread(), contextlib.redirect_stdout(printed):
        stats = run.main(EXTRACT + ["--root_dir", str(fixture_root), "--mesh_shape", "1",
                                    "--out_dir", str(out)])
    return out, stats, printed.getvalue()


def _same_depth_files(got_dir, want_dir):
    for i in range(3):
        got, want = (np.load(d / "depth" / "scan24" / f"{i:08d}.npy", allow_pickle=True).item()
                     for d in (got_dir, want_dir))
        assert got["depth"].shape == (32, 64) and np.all(np.isfinite(got["depth"]))
        for k in ("depth", "extrinsic", "intrinsic"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_extract_on_two_ranks_writes_the_one_rank_depth_files(fixture_root, one_rank,
                                                              tmp_path):
    out, stats, printed = one_rank
    assert "--mesh_shape 1 -> 1 cpu rank\n" in printed
    with _one_thread():       # the ranks split this process's one thread: one each
        stats2 = run.main(EXTRACT + ["--root_dir", str(fixture_root), "--mesh_shape", "2",
                                     "--out_dir", str(tmp_path)])
    assert stats2["scan24"]["views"] == stats["scan24"]["views"] == 3
    assert stats2["scan24"]["rays"] == 3 * 64 * 32
    _same_depth_files(tmp_path, out)


def test_extract_under_torchrun_uses_its_ranks(fixture_root, one_rank, tmp_path):
    """``torchrun`` starts the two ranks (one thread each, its default);
    the CLI joins its process group and prints once, from rank 0."""
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "uforecon_tpu_torch.cli.run", *EXTRACT, "--root_dir",
         str(fixture_root), "--mesh_shape", "2", "--out_dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(ROOT), os.environ.get("PYTHONPATH", "")])})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("--mesh_shape 2 -> 2 cpu ranks") == 1, res.stdout
    assert res.stdout.count("scan24: 3 views") == 1
    _same_depth_files(tmp_path, one_rank[0])
