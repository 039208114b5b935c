"""The port's COLMAP readers and MVSNet export against the JAX package.

On ``tests/test_colmap.py``'s synthetic sparse models (text, and binary
written here from the same records): ``data/colmap.py``'s readers give the
JAX package's records, ``pair_score`` and ``depth_range`` its numbers,
``export_mvsnet`` (and ``python -m uforecon_tpu_torch.cli.colmap2mvsnet``)
byte-identical cam files and ``pair.txt``, and ``data/io.write_pair_file``
the JAX writer's bytes.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_colmap.py -q
"""
import struct

import numpy as np
import pytest

from uforecon_tpu.data import colmap as jax_colmap
from uforecon_tpu.data import io as jax_io
from uforecon_tpu.cli.colmap2mvsnet import main as jax_colmap2mvsnet

from uforecon_tpu_torch.cli.colmap2mvsnet import main as colmap2mvsnet
from uforecon_tpu_torch.data import colmap, io

from test_colmap import _make_text_model


def _write_binary_model(d, cameras, images, points):
    """COLMAP's binary layout (reconstruction_io.cc) of the given records."""
    model_ids = {name: k for k, (name, _) in colmap.CAMERA_MODELS.items()}
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for c in cameras.values():
            f.write(struct.pack("<iiQQ", c.id, model_ids[c.model], c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i4d3di", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode() + b"\x00")
            ids = list(im.point3d_ids) + [-1]           # an unmatched keypoint too
            f.write(struct.pack("<Q", len(ids)))
            for k, pid in enumerate(ids):
                f.write(struct.pack("<2dq", 10.0 + k, 20.0 + k, pid))
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pid, xyz in points.items():
            f.write(struct.pack("<Q3d3Bd", pid, *xyz, 128, 128, 128, 0.5))
            f.write(struct.pack("<Q", 2) + struct.pack("<ii", 1, 0) + struct.pack("<ii", 2, 0))


@pytest.fixture(params=["text", "binary"])
def model_dir(tmp_path, request):
    d = tmp_path / "sparse"
    d.mkdir()
    _make_text_model(d)
    if request.param == "binary":
        cams, imgs, pts = jax_colmap.read_model(str(d))
        for name in ("cameras.txt", "images.txt", "points3D.txt"):
            (d / name).unlink()
        _write_binary_model(d, cams, imgs, pts)
    return d


def test_readers_give_the_jax_records(model_dir):
    got, want = colmap.read_model(str(model_dir)), jax_colmap.read_model(str(model_dir))
    for g, w in zip(got[:2], want[:2]):
        assert sorted(g) == sorted(w)
        for k in w:
            gv, wv = vars(g[k]), vars(w[k])
            assert set(gv) == set(wv)
            for f in wv:
                np.testing.assert_array_equal(gv[f], wv[f], err_msg=f)
    cams = got[0]
    np.testing.assert_array_equal(cams[1].K, want[0][1].K)
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k].w2c, want[1][k].w2c)
        np.testing.assert_array_equal(got[1][k].center, want[1][k].center)
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k])


def test_scores_and_depth_ranges_are_the_jax_ones(model_dir):
    cams, imgs, pts = colmap.read_model(str(model_dir))
    jcams, jimgs, jpts = jax_colmap.read_model(str(model_dir))
    for a in imgs:
        assert colmap.depth_range(imgs[a], pts) == jax_colmap.depth_range(jimgs[a], jpts)
        for b in imgs:
            if a != b:
                assert colmap.pair_score(imgs[a], imgs[b], pts) == \
                    jax_colmap.pair_score(jimgs[a], jimgs[b], jpts)


@pytest.mark.parametrize("n_src", [2, 10])
def test_export_writes_the_jax_files(model_dir, tmp_path, n_src):
    colmap.export_mvsnet(str(model_dir), str(tmp_path / "port"), n_src=n_src)
    jax_colmap.export_mvsnet(str(model_dir), str(tmp_path / "jax"), n_src=n_src)
    names = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(names) == 5 and sorted(
        p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
        if p.is_file()) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    pairs = io.read_pair_file(tmp_path / "port" / "pair.txt")
    assert len(pairs) == 4 and all(1 <= len(s) <= min(n_src, 3) for _, s in pairs)


def test_cli_writes_the_jax_files(model_dir, tmp_path, capsys):
    dense = model_dir.parent
    colmap2mvsnet(["--dense_folder", str(dense), "--save_folder", str(tmp_path / "port"),
                   "--n_src", "3", "--max_d", "128", "--interval_scale", "1.06"])
    jax_colmap2mvsnet(["--dense_folder", str(dense), "--save_folder",
                       str(tmp_path / "jax"), "--n_src", "3", "--max_d", "128",
                       "--interval_scale", "1.06"])
    assert f"wrote MVSNet cams + pair.txt to {tmp_path / 'port'}" in capsys.readouterr().out
    for name in ["pair.txt"] + [f"cams/{k:08d}_cam.txt" for k in range(4)]:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_pair_file_writer_is_the_jax_one(tmp_path):
    pairs = [(0, [(1, 10.0), (2, 3.14159), (4, 0.5)]), (1, [(0, 7.25)]), (2, [])]
    io.write_pair_file(tmp_path / "port.txt", pairs)
    jax_io.write_pair_file(tmp_path / "jax.txt", pairs)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert io.read_pair_file(tmp_path / "port.txt") == [(0, [1, 2, 4]), (1, [0]), (2, [])]
