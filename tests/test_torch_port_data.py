"""The port's data layer against OpenCV, PIL and the JAX package.

  * ``data/image.py``: the PNG decoder bit-equal to ``cv2.imread`` on the
    fixture's images and on PNGs that OpenCV writes with each row filter;
    the encoder read back by OpenCV; the resize within one level of
    ``cv2.resize`` (the share of pixels off by one is reported); PIL's
    ``convert("L")`` and NEAREST resize equal.
  * ``data/io.py`` round trips against the JAX package's ``data/io.py``.
  * ``script/make_dtu_fixture.py`` writes the cameras and pixels of the
    repository's fixture script.
  * ``DtuFitSparse`` samples against the JAX package's on the fixture at
    160x128: cameras, rays, projection matrices, near/far and depth values
    to 1e-6 relative, images within 1/255.
"""
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from uforecon_tpu.data import io as jax_io
from uforecon_tpu.data.dtu_test import DtuFitSparse as JaxDtuFitSparse

from uforecon_tpu_torch.data import image, io
from uforecon_tpu_torch.data.dtu_test import DtuFitSparse
from uforecon_tpu_torch.script import make_dtu_fixture

ROOT = Path(__file__).resolve().parent.parent
VIEWS = ["23", "24", "33"]


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The repository's fixture script (OpenCV) and the port's copy, both
    at 1600x1200, views 23 24 33."""
    jax_root = tmp_path_factory.mktemp("fixture_jax")
    port_root = tmp_path_factory.mktemp("fixture_port")
    res = subprocess.run([sys.executable, str(ROOT / "script" / "make_dtu_fixture.py"),
                          str(jax_root)], capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu",
                                        "UFO_PLATFORM": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    make_dtu_fixture.main([str(port_root), "--views", *VIEWS])
    return jax_root, port_root


def _image_rgb():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:64]
    smooth = np.stack([np.sin(xx / 7.0) * 100 + 120, np.cos(yy / 9.0) * 100 + 120,
                       (xx + yy) % 256], -1)
    return (smooth + rng.normal(0, 12, smooth.shape)).clip(0, 255).astype(np.uint8)


def test_fixture_png_decodes_as_opencv(fixtures):
    for root in fixtures:
        for v in VIEWS:
            path = root / "scan24" / "image" / f"{int(v):06d}.png"
            np.testing.assert_array_equal(image.imread_rgb(path),
                                          cv2.imread(str(path))[..., ::-1])


def test_fixture_script_matches_the_repository_one(fixtures):
    """Same cameras, same pixels (the port writes them with its own
    encoder)."""
    jax_root, port_root = fixtures
    for v in VIEWS:
        cam = f"cameras/{int(v):08d}_cam.txt"
        assert (port_root / cam).read_text() == (jax_root / cam).read_text()
        img = f"scan24/image/{int(v):06d}.png"
        np.testing.assert_array_equal(image.read_png(port_root / img),
                                      image.read_png(jax_root / img))


FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE, "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP, "avg": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH, "all": cv2.IMWRITE_PNG_ALL_FILTERS}


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filt", list(FILTERS))
def test_png_decode_matches_opencv_per_filter(tmp_path, filt, channels):
    rgb = _image_rgb()
    img = {1: rgb[..., 0], 3: rgb, 4: np.concatenate([rgb, rgb[..., 1:2]], -1)}[channels]
    bgr = img if channels == 1 else img[..., [2, 1, 0, 3][:channels]]
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, bgr, [cv2.IMWRITE_PNG_FILTER, FILTERS[filt]])
    np.testing.assert_array_equal(image.read_png(path), img)
    np.testing.assert_array_equal(image.imread_rgb(path), cv2.imread(path)[..., ::-1])


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_encode_reads_back_in_opencv(tmp_path, channels):
    rgb = _image_rgb()
    img = {1: rgb[..., 0], 3: rgb, 4: np.concatenate([rgb, rgb[..., 1:2]], -1)}[channels]
    path = tmp_path / "x.png"
    image.write_png(path, img)
    got = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, img if channels == 1
                                  else img[..., [2, 1, 0, 3][:channels]])
    np.testing.assert_array_equal(image.read_png(path), img)


@pytest.mark.parametrize("case", ["16-bit", "palette", "gray+alpha", "not a png"])
def test_png_decode_raises_on_what_it_does_not_cover(tmp_path, case):
    path = tmp_path / "x.png"
    rgb = _image_rgb()
    if case == "16-bit":
        cv2.imwrite(str(path), rgb.astype(np.uint16) * 257)
    elif case == "palette":
        Image.fromarray(rgb).convert("P").save(path)
    elif case == "gray+alpha":
        Image.fromarray(rgb[..., :2].copy(), "LA").save(path)
    else:
        path.write_bytes(b"GIF89a" + bytes(32))
    match = {"16-bit": "16-bit", "palette": "palette", "gray+alpha": "gray\\+alpha",
             "not a png": "not a PNG"}[case]
    with pytest.raises(ValueError, match=match):
        image.read_png(path)


@pytest.mark.parametrize("src_wh,dst_wh", [
    ((1600, 1200), (800, 640)), ((1600, 1200), (160, 128)),
    ((160, 120), (80, 60)), ((160, 120), (97, 53)), ((160, 120), (300, 250))])
def test_resize_within_one_level_of_opencv(src_wh, dst_wh):
    rng = np.random.default_rng(1)
    src = cv2.resize(_image_rgb(), src_wh)
    src = (src.astype(int) + rng.integers(-20, 20, src.shape)).clip(0, 255).astype(np.uint8)
    for img in (src, src[..., 0].copy()):
        got = image.resize_linear(img, dst_wh).astype(int)
        want = cv2.resize(img, dst_wh).astype(int)
        assert got.shape == want.shape
        off = np.abs(got - want)
        print(f"{src_wh} -> {dst_wh} {img.ndim}-d: share off by one {np.mean(off == 1):.6f}")
        assert off.max() <= 1


@pytest.mark.parametrize("wh", [(80, 60), (97, 53), (320, 240), (800, 640)])
def test_gray_and_nearest_resize_match_pil(wh):
    rgb = _image_rgb()
    want = np.asarray(Image.fromarray(rgb).convert("L").resize(wh, Image.NEAREST))
    np.testing.assert_array_equal(image.resize_nearest(image.to_gray(rgb), wh), want)


def test_io_round_trips_against_jax(tmp_path, rng):
    ext = np.eye(4, dtype=np.float32)
    ext[:3] = rng.standard_normal((3, 4))
    intr = np.array([[1446.0, 0, 400], [0, 1446.0, 320], [0, 0, 1]], np.float32)
    for writer, reader in ((io.write_cam_file, jax_io.read_cam_file),
                           (jax_io.write_cam_file, io.read_cam_file)):
        writer(tmp_path / "cam.txt", ext, intr, [425.0, 2.5, 192, 935.0])
        a, b = reader(tmp_path / "cam.txt"), io.read_cam_file(tmp_path / "cam.txt")
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    pairs = [(0, [(10, 0.5), (1, 0.25)]), (1, [(9, 1.0), (2, 0.125), (0, 0.0)])]
    jax_io.write_pair_file(tmp_path / "pair.txt", pairs)
    assert io.read_pair_file(tmp_path / "pair.txt") == jax_io.read_pair_file(
        tmp_path / "pair.txt") == [(0, [10, 1]), (1, [9, 2, 0])]
    for data in (rng.standard_normal((5, 7)), rng.standard_normal((5, 7, 3))):
        io.write_pfm(tmp_path / "a.pfm", data)
        jax_io.write_pfm(tmp_path / "b.pfm", data)
        assert (tmp_path / "a.pfm").read_bytes() == (tmp_path / "b.pfm").read_bytes()
        got, scale = io.read_pfm(tmp_path / "b.pfm")
        want, jscale = jax_io.read_pfm(tmp_path / "a.pfm")
        np.testing.assert_array_equal(got, want)
        assert scale == jscale == 1.0
    verts = rng.standard_normal((9, 3)).astype(np.float32)
    faces = rng.integers(0, 9, (4, 3))
    colors = rng.integers(0, 256, (9, 3)).astype(np.uint8)
    for kw in ({}, {"faces": faces}, {"colors": colors}, {"faces": faces, "colors": colors}):
        io.write_ply(tmp_path / "a.ply", verts, **kw)
        jax_io.write_ply(tmp_path / "b.ply", verts, **kw)
        assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
        for got, want in zip(io.read_ply(tmp_path / "b.ply"),
                             jax_io.read_ply(tmp_path / "a.ply")):
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got, want)
    ascii_ply = ("ply\nformat ascii 1.0\ncomment x\nelement vertex 3\nproperty float x\n"
                 "property float y\nproperty float z\nproperty uchar red\n"
                 "property uchar green\nproperty uchar blue\nelement face 1\n"
                 "property list uchar int vertex_indices\nend_header\n"
                 "0 0 0 1 2 3\n1 0 0 4 5 6\n0 1 0 7 8 9\n3 0 1 2\n")
    (tmp_path / "c.ply").write_text(ascii_ply)
    for got, want in zip(io.read_ply(tmp_path / "c.ply"),
                         jax_io.read_ply(tmp_path / "c.ply")):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("view", [0, 1, 2])
def test_dtu_fit_sparse_matches_jax(fixtures, view):
    jax_root, _ = fixtures
    kw = dict(root_dir=str(jax_root), scan_id="scan24", n_views=3,
              img_wh=[160, 128], set=0, test_view_pair=[23, 24, 33])
    got = DtuFitSparse(**kw)[view]
    want = JaxDtuFitSparse(**kw)[view]
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k == "meta" or isinstance(w, (int, str)):
            assert g == w, k
        elif isinstance(w, dict):
            assert set(g) == set(w)
            for s in w:
                np.testing.assert_allclose(g[s], w[s], rtol=1e-6, atol=1e-6, err_msg=k)
        elif k in ("ref_img", "source_imgs"):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert np.abs(g - w).max() <= 1 / 255 + 1e-7, k
        else:
            w = np.asarray(w)
            assert np.shape(g) == w.shape, k
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(w).max()),
                                       err_msg=k)
