"""The port's last tools against the JAX package on the same inputs:
``cli/log_to_csv.py``, ``postproc/trajectory.py`` (``interpolate_poses``,
``render_mesh_frame``, ``render_trajectory``), ``cli/render_trajectory.py``
and ``utils/profiling.py`` (``PhaseTimer``, ``trace``).

Both packages' frames are cast through the port's BVH intersector, so
they differ only if the camera rays or the shading do: held equal.
Interpolated poses: 1e-6 (the same float64 Slerp, cast to float32).
"""
import csv
import json
import os
import time

import numpy as np
import pytest
import torch

from uforecon_tpu.cli import log_to_csv as jax_log_to_csv
from uforecon_tpu.postproc import trajectory as jax_trajectory
from uforecon_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer

from uforecon_tpu_torch.cli import log_to_csv, render_trajectory as render_trajectory_cli
from uforecon_tpu_torch.data.image import read_png
from uforecon_tpu_torch.data.io import read_cam_file, write_ply
from uforecon_tpu_torch.postproc import trajectory
from uforecon_tpu_torch.postproc.raycast import RayMeshIntersector
from uforecon_tpu_torch.script import make_dtu_fixture
from uforecon_tpu_torch.utils import profiling

from helpers import look_at
from test_postproc import grid_sphere

LOG = ("INFO:root:scan: 24 0.5000 0.6000 0.5500\n"
       "INFO:root:loading scan 37\n"
       "INFO:root:scan: 37 1.0000 2.0000 1.5000\n"
       "scan: 110 3.25e-1 4.5E-1 0.3875\n"
       "INFO:root:mean: 0.7500 1.3000 1.0250\n")


def test_log_to_csv_matches_jax(tmp_path):
    path = tmp_path / "eval_final.log"
    path.write_text(LOG)
    assert log_to_csv.parse_log(str(path)) == jax_log_to_csv.parse_log(str(path))
    got, want = tmp_path / "port.csv", tmp_path / "jax.csv"
    log_to_csv.main(["--log", str(path), "--out", str(got)])
    jax_log_to_csv.main(["--log", str(path), "--out", str(want)])
    assert got.read_text() == want.read_text()
    with open(got) as f:
        rows = list(csv.DictReader(f))
    assert [r["scan"] for r in rows] == ["24", "37", "110", "mean"]


def test_log_to_csv_without_chamfer_lines_writes_the_header(tmp_path):
    path = tmp_path / "eval_final.log"
    path.write_text("INFO:root:nothing scored\n")
    out = tmp_path / "out.csv"
    log_to_csv.main(["--log", str(path), "--out", str(out)])
    assert out.read_text().strip() == "scan,d2s,s2d,all"


CAMERAS = [look_at([0, 0, -5]), look_at([5, 0, 0]), look_at([1, 3, -4])]


@pytest.mark.parametrize("n_frames,closed", [(11, False), (7, True), (2, False)])
def test_interpolate_poses_matches_jax(n_frames, closed):
    got = trajectory.interpolate_poses(CAMERAS, n_frames, closed=closed)
    want = jax_trajectory.interpolate_poses(CAMERAS, n_frames, closed=closed)
    assert len(got) == len(want) == n_frames
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], CAMERAS[0], atol=1e-5)


def test_interpolate_poses_needs_two_cameras():
    with pytest.raises(ValueError, match="two cameras"):
        trajectory.interpolate_poses(CAMERAS[:1], 4)


@pytest.mark.parametrize("colored", [False, True])
def test_render_mesh_frame_matches_jax(colored):
    v, f = grid_sphere(16, radius=1.0)
    v, f = v.astype(np.float32), f.astype(np.int32)
    colors = (np.random.default_rng(0).integers(0, 256, (len(v), 3)).astype(np.uint8)
              if colored else None)
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    inter = RayMeshIntersector(v, f)
    for pose in (look_at([0, 0, -4]), look_at([2, 0.5, -3.5])):
        got = trajectory.render_mesh_frame(inter, v, f, pose, K, (64, 48), colors=colors)
        want = jax_trajectory.render_mesh_frame(inter, v, f, pose, K, (64, 48),
                                                colors=colors)
        assert got.shape == (48, 64, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        # the sphere fills the centre, the corner is background
        assert got[24, 32].mean() < got[0, 0].mean() == 255


def test_render_trajectory_cli_writes_the_frames(tmp_path):
    root = tmp_path / "dtu"
    make_dtu_fixture.main([str(root), "--views", "23", "24", "--wh", "320", "240"])
    v, f = grid_sphere(24, radius=200.0)
    out = tmp_path / "out"
    os.makedirs(out / "mesh")
    write_ply(str(out / "mesh" / "scan24.ply"), v.astype(np.float32), faces=f)
    render_trajectory_cli.main(["--out_dir", str(out), "--root_dir", str(root),
                                "--test_scan", "scan24", "--test_ref_view", "23", "24",
                                "--n_frames", "3", "--img_wh", "80", "60"])
    frames = sorted(os.listdir(out / "video" / "scan24"))
    assert frames == ["0000.png", "0001.png", "0002.png"]
    # the first frame is the first camera's view, as the JAX package renders it
    cams = [read_cam_file(str(root / "cameras" / f"{vid:08d}_cam.txt")) for vid in (23, 24)]
    K = cams[1]["intrinsic"].copy()
    K[0] *= 80 / 1600
    K[1] *= 60 / 1200
    want = jax_trajectory.render_trajectory(v.astype(np.float32), f, [c["extrinsic"] for c in cams],
                                            K, wh=(80, 60), n_frames=3)
    for name, w in zip(frames, want):
        np.testing.assert_array_equal(read_png(str(out / "video" / "scan24" / name)), w)


def test_render_trajectory_cli_takes_the_jax_command_line(tmp_path):
    """JAX's ``--video PATH --fps N``: the frames go to PATH without its
    extension."""
    root = tmp_path / "dtu"
    make_dtu_fixture.main([str(root), "--views", "23", "24", "--wh", "320", "240"])
    v, f = grid_sphere(24, radius=200.0)
    out = tmp_path / "out"
    os.makedirs(out / "mesh" / "final")
    write_ply(str(out / "mesh" / "final" / "scan24.ply"), v.astype(np.float32), faces=f)
    render_trajectory_cli.main(["--out_dir", str(out), "--root_dir", str(root),
                                "--test_scan", "scan24", "--test_ref_view", "23", "24",
                                "--n_frames", "2", "--img_wh", "80", "60", "--fps", "24",
                                "--video", str(tmp_path / "clips" / "turn.mp4")])
    assert sorted(os.listdir(tmp_path / "clips" / "turn")) == ["0000.png", "0001.png"]
    assert not os.path.exists(out / "video")


def test_phase_timer_matches_jax():
    got, want = profiling.PhaseTimer(), JaxPhaseTimer()
    for timer in (got, want):
        for name, s in (("encode", 0.02), ("render", 0.01), ("encode", 0.02)):
            with timer.phase(name):
                time.sleep(s)
    assert got.counts == want.counts == {"encode": 2, "render": 1}
    assert set(got.totals) == set(want.totals)
    for k in got.totals:
        assert abs(got.totals[k] - want.totals[k]) < 0.015, k
    assert [line.split()[0] for line in got.report().splitlines()] == \
        [line.split()[0] for line in want.report().splitlines()] == ["encode", "render"]
    # a phase synchronized on a CPU tensor or device times as without
    with got.phase("sync", sync=torch.zeros(1)):
        pass
    with got.phase("sync", sync="cpu"):
        pass
    assert got.counts["sync"] == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)
