"""The port's baseline-JPEG codec (``data/image.py``) against OpenCV.

``read_jpeg`` is held bit for bit to ``cv2.imread`` (OpenCV 5 links
libjpeg-turbo 3: the integer IDCT, fancy upsampling, the table-driven YCbCr
conversion), colour and ``cv2.imread(path, 0)``, on the repository's
GeneralFit fixture (images and masks), and on OpenCV-written noise and
photo-like images at qualities 50, 95 and 100, sampling 4:4:4, 4:2:2 and
4:2:0, gray files, sizes that are not multiples of the MCU, restart
intervals and an EXIF orientation. Progressive, arithmetic-coded and 12-bit
files raise. ``write_jpeg`` output decodes alike through OpenCV and
``read_jpeg``. ``imread_rgb`` / ``imread_gray`` tell PNG from JPEG by
their first bytes.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_jpeg.py -q
"""
import os
import struct
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from uforecon_tpu_torch.data.image import (imread_gray, imread_rgb, read_jpeg, write_jpeg,
                                           write_png)

ROOT = Path(__file__).resolve().parent.parent
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def _photo(h, w, seed=0):
    """Smooth gradients and texture with a little noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(xx / 17.0) * 90 + 120, np.cos(yy / 23.0) * 90 + 120,
                       (xx * yy / 300.0) % 256], -1)
    return (smooth + rng.normal(0, 6, smooth.shape)).clip(0, 255).astype(np.uint8)


def _noise(h, w, channels=3, seed=1):
    shape = (h, w, channels) if channels > 1 else (h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _assert_decodes_as_opencv(path):
    np.testing.assert_array_equal(read_jpeg(path), cv2.imread(str(path))[..., ::-1])
    np.testing.assert_array_equal(read_jpeg(path, gray=True), cv2.imread(str(path), 0))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("general")
    res = subprocess.run([sys.executable, str(ROOT / "script" / "make_general_fixture.py"),
                          str(root), "scan_sphere"], capture_output=True, text=True,
                         timeout=600, cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu", "UFO_PLATFORM": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    return root / "scan_sphere"


@pytest.mark.parametrize("kind", ["blended_images", "masks"])
def test_fixture_jpegs_decode_as_opencv(fixture_root, kind):
    files = sorted((fixture_root / kind).glob("*.jpg"))
    assert len(files) == 5
    for path in files:
        _assert_decodes_as_opencv(path)
        np.testing.assert_array_equal(imread_rgb(path), cv2.imread(str(path))[..., ::-1])
        np.testing.assert_array_equal(imread_gray(path), cv2.imread(str(path), 0))


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("source", ["noise", "photo"])
def test_decode_matches_opencv(tmp_path, source, quality, sampling):
    img = _noise(45, 53) if source == "noise" else _photo(61, 77)
    path = tmp_path / "x.jpg"
    assert cv2.imwrite(str(path), img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality,
                                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                   SAMPLING[sampling]])
    _assert_decodes_as_opencv(path)


@pytest.mark.parametrize("hw,sampling,restart", [
    ((1, 1), "420", 0), ((7, 9), "420", 0), ((17, 33), "422", 0), ((8, 16), "444", 0),
    ((64, 48), "420", 1), ((61, 77), "422", 3), ((45, 53), "444", 5), ((100, 130), "420", 7)])
def test_odd_sizes_and_restart_intervals_match_opencv(tmp_path, hw, sampling, restart):
    path = tmp_path / "x.jpg"
    params = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    assert cv2.imwrite(str(path), _noise(*hw)[..., ::-1], params)
    if restart:
        assert b"\xff\xdd" in path.read_bytes()           # a DRI segment
    _assert_decodes_as_opencv(path)


@pytest.mark.parametrize("quality", [50, 95, 100])
def test_gray_jpeg_matches_opencv(tmp_path, quality):
    path = tmp_path / "g.jpg"
    assert cv2.imwrite(str(path), _noise(37, 41, channels=1), [cv2.IMWRITE_JPEG_QUALITY,
                                                                quality])
    _assert_decodes_as_opencv(path)


def _with_exif_orientation(data: bytes, orientation: int) -> bytes:
    """Insert an APP1 Exif segment holding only the orientation tag."""
    tiff = b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1) + struct.pack(
        "<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0)
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_exif_orientation_applied_as_opencv(tmp_path, orientation):
    src = tmp_path / "x.jpg"
    cv2.imwrite(str(src), _photo(24, 40)[..., ::-1])
    path = tmp_path / "o.jpg"
    path.write_bytes(_with_exif_orientation(src.read_bytes(), orientation))
    want = cv2.imread(str(path))
    assert want.shape[:2] == ((24, 40) if orientation == 3 else (40, 24))
    _assert_decodes_as_opencv(path)


def test_rgb_coded_file_matches_opencv(tmp_path):
    """Without a JFIF segment, component ids 'R', 'G', 'B' mean the file
    holds RGB, not YCbCr; gray is then libjpeg's weighted sum."""
    src = tmp_path / "x.jpg"
    cv2.imwrite(str(src), _photo(40, 56)[..., ::-1], [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"]])
    data = bytearray(src.read_bytes())
    app0 = data.index(b"\xff\xe0")
    del data[app0:app0 + 2 + struct.unpack(">H", data[app0 + 2:app0 + 4])[0]]
    for marker, first, step in ((b"\xff\xc0", 10, 3), (b"\xff\xda", 5, 2)):
        at = data.index(marker)
        for k, cid in enumerate(b"RGB"):
            data[at + first + step * k] = cid
    path = tmp_path / "rgb.jpg"
    path.write_bytes(bytes(data))
    _assert_decodes_as_opencv(path)
    assert not np.array_equal(read_jpeg(path), read_jpeg(src))


@pytest.mark.parametrize("mode,patch", [
    ("progressive", None), ("arithmetic-coded", b"\xff\xc9"), ("12-bit", 12)])
def test_unsupported_modes_raise(tmp_path, mode, patch):
    path = tmp_path / "x.jpg"
    img = _photo(32, 32)[..., ::-1]
    if mode == "progressive":
        cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    else:
        cv2.imwrite(str(path), img)
        data = bytearray(path.read_bytes())
        sof = data.index(b"\xff\xc0")
        if isinstance(patch, bytes):
            data[sof:sof + 2] = patch
        else:
            data[sof + 4] = patch                        # sample precision
        path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=mode):
        read_jpeg(path)


@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("channels", [1, 3])
def test_encoder_output_decodes_alike(tmp_path, channels, quality):
    img = _photo(61, 77)
    img = img if channels == 3 else img[..., 1].copy()
    path = tmp_path / "w.jpg"
    write_jpeg(path, img, quality=quality)
    got = read_jpeg(path)
    np.testing.assert_array_equal(got, cv2.imread(str(path))[..., ::-1])
    np.testing.assert_array_equal(read_jpeg(path, gray=True), cv2.imread(str(path), 0))
    err = np.abs(got.astype(int) - (img if channels == 3 else img[..., None])).mean()
    assert err < {50: 6.0, 95: 3.0, 100: 2.0}[quality], err


def test_files_are_told_apart_by_their_bytes(tmp_path):
    img = _photo(16, 24)
    jpeg_named_png, png_named_jpg = tmp_path / "a.png", tmp_path / "b.jpg"
    write_jpeg(jpeg_named_png, img)
    write_png(png_named_jpg, img)
    np.testing.assert_array_equal(imread_rgb(jpeg_named_png), read_jpeg(jpeg_named_png))
    np.testing.assert_array_equal(imread_rgb(png_named_jpg), img)
    write_png(png_named_jpg, img[..., 0].copy())
    np.testing.assert_array_equal(imread_gray(png_named_jpg), img[..., 0])
    write_png(png_named_jpg, img)
    with pytest.raises(ValueError, match="colour PNG"):
        imread_gray(png_named_jpg)
