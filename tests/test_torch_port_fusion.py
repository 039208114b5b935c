"""The port's fusion, mesh cleaning and scoring against the JAX package.

Inputs: analytic z-depth maps of the fixture's sphere
(``script/make_dtu_fixture.py sphere_depth``) through the fixture's
cameras 23 24 33 at 160x128, in the extract layout. Held to the JAX
functions on the same inputs:
  * TSDF integration (the port's torch ops on the CPU): TSDF and weight
    volumes within 1e-5 on >= 99.9 % of voxels, and every voxel off by
    more a rounding tie, counted: in some view its pixel coordinate within
    1e-3 of a half integer, or its depth difference within 1e-3 mm of the
    truncation band's edge (XLA and torch may round the last bit of the
    projection apart, and there that picks another pixel or band side);
  * marching cubes: identical vertices and faces on identical volumes;
  * ``fuse_scan``, depth-fusion masks and points, ``clean_mesh``'s faces,
    ``eval_scan`` (within 1e-6 relative), the DTU mesh sampling and radius
    downsampling;
  * each tool CLI writes the files the JAX CLI writes;
  * the native BVH against the numpy first hit.
"""
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from uforecon_tpu.eval import dtu_eval as jax_eval
from uforecon_tpu.fusion import depth_fusion as jax_depth_fusion
from uforecon_tpu.fusion import marching as jax_marching
from uforecon_tpu.fusion import tsdf as jax_tsdf
from uforecon_tpu.postproc import clean_mesh as jax_clean

from uforecon_tpu_torch.data.io import read_ply, write_ply
from uforecon_tpu_torch.eval import dtu_eval
from uforecon_tpu_torch.fusion import depth_fusion, marching, tsdf
from uforecon_tpu_torch.postproc import clean_mesh, raycast
from uforecon_tpu_torch.script import make_dtu_fixture as fixture

ROOT = Path(__file__).resolve().parent.parent
W, H = 160, 128
VIEWS = (23, 24, 33)
SCAN = "scan24"


def _views():
    cams = fixture.cameras()
    k = fixture.intrinsic((W, H)).astype(np.float32)
    return [(cams[v].astype(np.float32), k) for v in VIEWS]


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """{root}: the fixture's cameras (no images needed), {out}: sphere depth
    maps in the extract layout."""
    base = tmp_path_factory.mktemp("sphere")
    root, out = base / "fixture", base / "out"
    fixture.main([str(root), "--views", *map(str, VIEWS), "--wh", "32", "24"])
    os.makedirs(out / "depth" / SCAN)
    for i, (e, k) in enumerate(_views()):
        np.save(out / "depth" / SCAN / f"{i:08d}.npy",
                {"depth": fixture.sphere_depth(e, k, W, H), "extrinsic": e, "intrinsic": k})
    return root, out


def _entries(out):
    return [np.load(out / "depth" / SCAN / f"{i:08d}.npy", allow_pickle=True).item()
            for i in range(3)]


def _tie_voxels(idx, origin, voxel, entries, trunc, eps=1e-3):
    """Which voxels (idx (N, 3)) sit on a rounding tie in some view
    (float64): a pixel coordinate within eps of a half integer (which pixel
    is read), or a depth difference within eps mm of -trunc (the band
    edge)."""
    xyz = origin.astype(np.float64) + idx * voxel
    tie = np.zeros(len(idx), bool)
    for e in entries:
        w2c = np.linalg.inv(np.linalg.inv(e["extrinsic"]).astype(np.float32)).astype(np.float64)
        k = e["intrinsic"].astype(np.float64)
        cam = xyz @ w2c[:3, :3].T + w2c[:3, 3]
        pix = []
        for c, f, o in ((0, k[0, 0], k[0, 2]), (1, k[1, 1], k[1, 2])):
            p = f * cam[:, c] / cam[:, 2] + o
            tie |= np.abs(p - np.floor(p) - 0.5) < eps
            pix.append(np.clip(np.round(p), 0, e["depth"].shape[1 - c] - 1).astype(int))
        d = e["depth"][pix[1], pix[0]]
        tie |= (d > 0) & (np.abs(d - cam[:, 2] + trunc) < eps)
    return tie


@pytest.mark.parametrize("voxel", [4.0, 1.5])
def test_tsdf_matches_jax(layout, voxel):
    _, out = layout
    entries = _entries(out)
    bounds = tsdf.scan_bounds([(i, e) for i, e in enumerate(entries)])
    # the JAX TSDFVolume adjusts the bounds it is given in place
    jv = jax_tsdf.TSDFVolume(bounds.copy(), voxel)
    pv = tsdf.TSDFVolume(bounds, voxel, device="cpu")
    rng = np.random.default_rng(0)
    for e in entries:
        c2w = np.linalg.inv(e["extrinsic"])
        color = rng.random((H, W, 3)).astype(np.float32) * 255
        jv.integrate(e["depth"], e["intrinsic"], c2w, color_im=color)
        pv.integrate(e["depth"], e["intrinsic"], c2w, color_im=color)
    (jt, jw), (pt, pw) = jv.get_volume(), pv.get_volume()
    assert jt.shape == pt.shape and np.array_equal(jv.vol_bnds, pv.vol_bnds)
    off = (np.abs(jt - pt) > 1e-5) | (np.abs(jw - pw) > 1e-5)
    ties = _tie_voxels(np.argwhere(off), pv.origin, voxel, entries, pv.trunc_margin)
    print(f"voxel {voxel}: {jt.size} voxels, {off.sum()} off by more than 1e-5, "
          f"{ties.sum()} of them rounding ties; exactly equal {np.mean(jt == pt):.6f}")
    assert 1 - off.mean() >= 0.999
    assert ties.all(), np.argwhere(off)[~ties][:10]
    assert (jw > 0).mean() > 0.05                       # the sphere was seen
    cj, cp = np.asarray(jv.color), pv.color.numpy()
    assert np.mean(np.all(np.abs(cj - cp) <= 1e-3, axis=-1)) >= 0.999


def test_marching_cubes_identical_on_identical_volumes(layout):
    _, out = layout
    entries = [(i, e) for i, e in enumerate(_entries(out))]
    vol = jax_tsdf.TSDFVolume(tsdf.scan_bounds(entries), 3.0)
    for _, e in entries:
        vol.integrate(e["depth"], e["intrinsic"], np.linalg.inv(e["extrinsic"]))
    field, _ = vol.get_volume()
    for level in (0.0, 0.3):
        jv, jf = jax_marching.marching_cubes(field, level=level)
        pv, pf = marching.marching_cubes(field, level=level)
        assert len(pf) > 1000
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pf, jf)
    jv, jf = jax_marching.marching_tetrahedra(field)
    pv, pf = marching.marching_tetrahedra(field)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pf, jf)


def test_fuse_scan_matches_jax(layout):
    _, out = layout
    want = jax_tsdf.fuse_scan(str(out), SCAN, 3, voxel_size=4.0)
    got = tsdf.fuse_scan(str(out), SCAN, 3, voxel_size=4.0, device="cpu")
    np.testing.assert_array_equal(got["bounds"], want["bounds"])
    np.testing.assert_array_equal(got["faces"], want["faces"])
    np.testing.assert_allclose(got["verts"], want["verts"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got["colors"], want["colors"])


def test_depth_fusion_matches_jax(layout):
    _, out = layout
    entries = _entries(out)
    rng = np.random.default_rng(2)
    # a few inconsistent pixels, so that the masks are not all-or-nothing
    noisy = [dict(e, depth=e["depth"] * np.where(rng.random(e["depth"].shape) < 0.1,
                                                   1.05, 1.0).astype(np.float32))
             for e in entries]
    rgbs = [rng.integers(0, 256, (H, W, 3)).astype(np.uint8) for _ in entries]
    for thres in (1, 2):
        want = jax_depth_fusion.filter_depth_maps(noisy, geo_mask_thres=thres, rgb_images=rgbs)
        got = depth_fusion.filter_depth_maps(noisy, geo_mask_thres=thres, rgb_images=rgbs)
        for g, w in zip(got[2], want[2]):
            np.testing.assert_array_equal(g, w)
        assert 0 < np.mean(np.concatenate([m.ravel() for m in got[2]])) < 1
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_clean_mesh_keeps_the_same_faces(layout):
    _, out = layout
    fused = jax_tsdf.fuse_scan(str(out), SCAN, 3, voxel_size=3.0)
    views = _views()
    masks = [fixture.sphere_depth(e, k, W, H) > 0 for e, k in views]
    masks[1][:, : W // 2] = False                      # a mask that cuts the sphere
    args = (fused["verts"], fused["faces"], masks, [k for _, k in views],
            [e for e, _ in views])
    for kw in ({}, {"ray_stride": 3, "min_component_faces": 50, "minimal_vis": 0}):
        want = jax_clean.clean_mesh(*args, **kw)
        got = clean_mesh.clean_mesh(*args, **kw)
        assert 0 < len(got[1]) < len(fused["faces"])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


def test_dilate_mask_matches_opencv():
    import cv2

    rng = np.random.default_rng(3)
    m = rng.random((64, 80)) > 0.97
    m[0, :5] = m[-1, -3:] = True
    for size in (1, 3, 5, 11, 15):
        k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))
        np.testing.assert_array_equal(clean_mesh.ellipse_kernel(size), k)
        np.testing.assert_array_equal(clean_mesh.dilate_mask(m, size),
                                      cv2.dilate(m.astype(np.uint8), k).astype(bool))
    np.testing.assert_array_equal(clean_mesh.dilate_mask(m, 11, pad_to=(66, 82)),
                                  jax_clean.dilate_mask(m, 11, pad_to=(66, 82)))


def test_eval_matches_jax(layout):
    _, out = layout
    fused = jax_tsdf.fuse_scan(str(out), SCAN, 3, voxel_size=3.0)
    gt = np.concatenate([fixture.sphere_points(e, k, W, H) for e, k in _views()])
    want_pts = jax_eval.sample_mesh_surface(fused["verts"], fused["faces"], 0.5)
    got_pts = dtu_eval.sample_mesh_surface(fused["verts"], fused["faces"], 0.5)
    np.testing.assert_array_equal(got_pts, want_pts)
    want_pts = jax_eval.radius_downsample(want_pts, 0.5, np.random.default_rng(4))
    got_pts = dtu_eval.radius_downsample(got_pts, 0.5, np.random.default_rng(4))
    np.testing.assert_array_equal(got_pts, want_pts)
    lo = gt.min(0) - 5
    obs = (np.stack([lo, gt.max(0) + 5]), np.ones((60, 60, 60), bool), 5.0)
    obs[1][:, :, :20] = False
    plane = np.array([0.0, 1.0, 0.0, 10.0])
    for kw in ({}, {"obs_mask": obs, "ground_plane": plane, "max_dist": 3.0}):
        want = jax_eval.eval_scan(want_pts, gt, **kw)
        got = dtu_eval.eval_scan(got_pts, gt, **kw)
        for k in ("acc", "comp", "overall"):
            assert np.isfinite(got[k])
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_bvh_library_matches_numpy_first_hit():
    rng = np.random.default_rng(5)
    # a closed sphere mesh (marching cubes of a distance field) and random rays
    g = np.linspace(-1.5, 1.5, 24)
    field = np.sqrt(sum(a ** 2 for a in np.meshgrid(g, g, g, indexing="ij"))) - 1.0
    verts, faces = marching.marching_cubes(field)
    verts = verts * (g[1] - g[0]) + g[0]                # index -> world units
    origins = rng.normal(0, 0.3, (3000, 3)) + np.array([0, 0, -30.0])
    origins[:500] = rng.normal(0, 3, (500, 3))         # some from inside or beside
    dirs = np.array([0, 0, 30.0]) + rng.normal(0, 0.8, (3000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    tri, t = raycast.RayMeshIntersector(verts, faces).intersects_first(origins, dirs)
    tri_np, t_np = raycast.intersects_first_numpy(verts, faces, origins, dirs)
    hit = tri_np >= 0
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_array_equal(tri >= 0, hit)
    np.testing.assert_allclose(t[hit], t_np[hit], rtol=1e-5, atol=1e-5)
    same = tri[hit] == tri_np[hit]
    # a different triangle only where two meet at the same distance
    assert same.mean() > 0.99
    with pytest.raises(ValueError, match="outside the mesh"):
        raycast.RayMeshIntersector(verts, faces + len(verts))


def test_bvh_builds_without_openmp_where_the_compiler_has_none(tmp_path, monkeypatch):
    """A compiler without OpenMP (as on some GPU hosts) builds the same
    library without -fopenmp, with a warning; any other failure raises."""
    cxx = tmp_path / "cxx"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && '
                   '{ echo "cannot read spec file libgomp.spec" >&2; exit 1; }; done\n'
                   'exec g++ "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setattr(raycast, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(cxx))
    raycast.library.cache_clear()
    try:
        with pytest.warns(UserWarning, match="(?s)without OpenMP.*libgomp"):
            lib = raycast.library()
        assert lib.bvh_intersect_first is not None
        raycast.library.cache_clear()
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        monkeypatch.setattr(raycast, "BUILD_DIR", tmp_path / "build2")
        with pytest.raises((RuntimeError, OSError)):
            raycast.library()
    finally:
        raycast.library.cache_clear()


def _files(d):
    return sorted(os.path.relpath(os.path.join(p, f), d)
                  for p, _, fs in os.walk(d) for f in fs)


def test_tool_clis_write_the_jax_clis_files(layout, tmp_path, capsys):
    from uforecon_tpu.cli import clean_mesh as jax_clean_cli
    from uforecon_tpu.cli import depth_fusion as jax_depth_cli
    from uforecon_tpu.cli import tsdf_fusion as jax_tsdf_cli

    from uforecon_tpu_torch.cli import clean_mesh as clean_cli
    from uforecon_tpu_torch.cli import depth_fusion as depth_cli
    from uforecon_tpu_torch.cli import dtu_eval as eval_cli
    from uforecon_tpu_torch.cli import tsdf_fusion as tsdf_cli

    root, out = layout
    gt = tmp_path / "gt"
    os.makedirs(gt / "Points" / "stl")
    write_ply(gt / "Points" / "stl" / "stl024_total.ply",
              np.concatenate([fixture.sphere_points(e, k, W, H) for e, k in _views()]))
    def jax_eval_cli_main(argv):
        # in a process of its own: the JAX CLI logs through logging.basicConfig,
        # which does nothing where a logger is set up already (as under pytest)
        res = subprocess.run([sys.executable, "-m", "uforecon_tpu.cli.dtu_eval", *argv],
                             capture_output=True, text=True, timeout=300, cwd=ROOT,
                             env={**os.environ, "JAX_PLATFORMS": "cpu",
                                  "UFO_PLATFORM": "cpu"})
        assert res.returncode == 0, res.stderr[-2000:]

    jax_eval_cli = types.SimpleNamespace(main=jax_eval_cli_main)
    runs = {}
    for side, (t_cli, d_cli, c_cli, e_cli, dev) in {
            "jax": (jax_tsdf_cli, jax_depth_cli, jax_clean_cli, jax_eval_cli, []),
            "port": (tsdf_cli, depth_cli, clean_cli, eval_cli, ["--device", "cpu"])}.items():
        d = tmp_path / side
        shutil.copytree(out, d)
        t_cli.main(["--out_dir", str(d), "--n_view", "3", "--voxel_size", "4",
                    "--test_scan", SCAN] + dev)
        d_cli.main(["--out_dir", str(d), "--n_view", "3", "--test_scan", SCAN] + dev)
        c_cli.main(["--out_dir", str(d), "--root_dir", str(root), "--n_view", "3",
                    "--test_ref_view", *map(str, VIEWS), "--test_scan", SCAN,
                    "--ray_stride", "4", "--img_wh", str(W), str(H)] + dev)
        e_cli.main(["--mesh_dir", str(d / "mesh" / "final"), "--dataset_dir", str(gt),
                    "--log_dir", str(d), "--scans", "24"] + dev)
        runs[side] = d
        lines = capsys.readouterr().out.splitlines()
        assert lines[:3] == [f"{SCAN}: wrote {d}/mesh/{SCAN}.ply",
                             f"{SCAN}: wrote {d}/pcd_fusion/{SCAN}.ply",
                             f"{SCAN}: wrote {d}/mesh/final/{SCAN}.ply"], lines
    assert _files(runs["port"]) == _files(runs["jax"])
    for f in ("mesh/scan24.ply", "pcd/scan24.ply", "pcd_fusion/scan24.ply",
              "mesh/final/scan24.ply"):
        (gv, gf, gc), (wv, wf, wc) = (read_ply(runs[s] / f) for s in ("port", "jax"))
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-3, err_msg=f)
        for g, w in ((gf, wf), (gc, wc)):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)
    for i in range(3):
        m = f"mask/{SCAN}/{i:08d}_geo.npy"
        np.testing.assert_array_equal(np.load(runs["port"] / m), np.load(runs["jax"] / m))
    # the scores shuffle before downsampling, unseeded in both CLIs
    logs = [(runs[s] / "eval_final.log").read_text().split() for s in ("port", "jax")]
    assert [t for t in logs[0] if not t[0].isdigit()] == \
        [t for t in logs[1] if not t[0].isdigit()]
    nums = [np.array([float(t) for t in log if t[0].isdigit()]) for log in logs]
    np.testing.assert_allclose(nums[0], nums[1], rtol=0.05)
