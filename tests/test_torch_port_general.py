"""The custom-capture data path of the port against the JAX package, on the CPU.

On the repository's GeneralFit fixture (``script/make_general_fixture.py``:
5 views of a sphere at 768x576, JPEGs written by OpenCV; ``images/`` holds
copies of ``blended_images/`` for the MVImgNet layout):
  * ``data/general_fit.GeneralFit`` samples equal the JAX package's on
    every key, images bit for bit and float keys within 1e-6, for
    ``blendedmvs``, ``mvimage`` and the CLI's default ``dtu`` (which takes
    the MVImgNet layout and size but not its near/far), with and without
    masks and ``img_wh``;
  * the port's fixture script writes the repository's cameras, pair file
    and rendered pixels;
  * ``similarity_mesh`` of one field gives the JAX package's vertices within
    1e-6 and its faces; ``extract_similarity_field`` asks the grouped-cosine
    wrapper (kernel 7 on the card), never the plain version directly.
``test_torch_port_general_cli.py`` holds the CLI and the field itself.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_general.py -q
"""
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from uforecon_tpu_torch.config import Config
from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
from uforecon_tpu_torch.data.general_fit import GeneralFit
from uforecon_tpu_torch.models import ray_transformer
from uforecon_tpu_torch.models.uforecon import UFORecon
from uforecon_tpu_torch.pipeline.extract import extract_similarity_field, similarity_mesh
from uforecon_tpu_torch.script import make_general_fixture

ROOT = Path(__file__).resolve().parent.parent
SCAN = "scan_sphere"


def _env():
    return {**os.environ, "JAX_PLATFORMS": "cpu", "UFO_PLATFORM": "cpu",
            "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """The repository's fixture (OpenCV JPEGs), with an ``images/`` copy
    for the MVImgNet layout."""
    root = tmp_path_factory.mktemp("general")
    res = subprocess.run([sys.executable, str(ROOT / "script" / "make_general_fixture.py"),
                          str(root), SCAN], capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env=_env())
    assert res.returncode == 0, res.stderr[-3000:]
    (root / SCAN / "images").mkdir()
    for vid in range(5):
        shutil.copy(root / SCAN / "blended_images" / f"{vid:08d}_masked.jpg",
                    root / SCAN / "images" / f"{vid:08d}.jpg")
    return root


# ---------------------------------------------------------------------------
# the dataset

def _assert_same(key, got, want):
    """Images bit for bit, strings and ints equal, float keys within 1e-6."""
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _assert_same(f"{key}.{k}", got[k], want[k])
    elif isinstance(want, (str, int)):
        assert got == want, key
    elif key in ("ref_img", "source_imgs"):
        assert got.dtype == np.asarray(want).dtype == np.float32, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("dataset,use_mask,img_wh,ref_views", [
    ("blendedmvs", True, None, [0, 1, 2]),
    ("blendedmvs", False, (128, 96), None),
    ("mvimage", True, (128, 96), [2, 3, 4]),
    ("mvimage", False, None, [0, 1, 2]),
    ("dtu", False, None, [0, 1, 2]),          # the CLI default under --test_general
    ("dtu", True, (160, 128), None),
])
def test_general_fit_samples_match_jax(fixture_root, dataset, use_mask, img_wh, ref_views):
    from uforecon_tpu.data.general_fit import GeneralFit as JaxGeneralFit

    kw = dict(root_dir=str(fixture_root), scan_id=SCAN, n_views=3, dataset=dataset,
              use_mask=use_mask, test_ref_view=ref_views,
              img_wh=list(img_wh) if img_wh else None)
    got_ds, want_ds = GeneralFit(**kw), JaxGeneralFit(**kw)
    assert got_ds.img_wh == want_ds.img_wh == (
        list(img_wh) if img_wh else [768, 576] if dataset == "blendedmvs" else [960, 544])
    assert got_ds.metas == want_ds.metas and len(got_ds) == (3 if ref_views else 5)
    for i in range(len(got_ds)):
        got, want = got_ds[i], want_ds[i]
        assert set(got) == set(want)
        for k, w in want.items():
            _assert_same(k, got[k], w)
    ref = got_ds.metas[0][0]
    assert got_ds[0]["meta"] == f"{fixture_root.name}-{SCAN}-refview{ref}"
    # only mvimage overrides the cam files' near/far (425 ... 905)
    assert got_ds._load_view(ref)[2] == want_ds._load_view(ref)[2] == (
        (400.0, 900.0) if dataset == "mvimage" else (425.0, 905.0))



def test_general_fit_decodes_each_file_once(fixture_root, monkeypatch):
    """The samples of a --test_ref_view set share their views: each image
    and mask is read from its file once per dataset, and a caller's writes
    to a sample do not reach the next one."""
    from uforecon_tpu_torch.data import general_fit

    reads = []

    def counted(fn):
        def read(path):
            reads.append(os.path.basename(path))
            return fn(path)
        return read

    for name in ("imread_rgb", "imread_gray"):
        monkeypatch.setattr(general_fit, name, counted(getattr(general_fit, name)))
    ds = GeneralFit(str(fixture_root), SCAN, n_views=3, test_ref_view=[0, 1, 2],
                    dataset="blendedmvs", use_mask=True, img_wh=[128, 96])
    first = ds[0]
    want = first["source_imgs"].copy()
    first["source_imgs"][:] = 0.0
    first["ref_img"][:] = 0.0
    samples = [ds[i] for i in range(len(ds))]
    assert sorted(reads) == sorted([f"{v:08d}_masked.jpg" for v in range(3)]
                                   + [f"{v:08d}_mask.jpg" for v in range(3)])
    np.testing.assert_array_equal(samples[0]["source_imgs"], want)
    np.testing.assert_array_equal(samples[1]["source_imgs"], want[[1, 0, 2]])

def test_fixture_script_matches_the_repository_one(fixture_root, tmp_path):
    """Same cameras, pair file and rendered arrays; the JPEGs differ by the
    two encoders."""
    spec = importlib.util.spec_from_file_location(
        "jax_make_general_fixture", ROOT / "script" / "make_general_fixture.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    make_general_fixture.main([str(tmp_path), SCAN])
    for name in ["pair.txt"] + [f"{v:08d}_cam.txt" for v in range(5)]:
        assert (tmp_path / SCAN / "cams" / name).read_text() == \
            (fixture_root / SCAN / "cams" / name).read_text(), name
    from uforecon_tpu_torch.data.image import read_jpeg

    k = make_general_fixture.intrinsic()
    for vid, e in enumerate(make_general_fixture.extrinsics()):
        img, hit = make_general_fixture.render(e, k)
        want_img, want_hit = ref.render(e, k)
        np.testing.assert_array_equal(img, want_img)
        np.testing.assert_array_equal(hit, want_hit)
        # write_jpeg (quality 95, 4:4:4) loses no more than OpenCV's quality
        # 95 (4:2:0) file of the same array
        name = f"blended_images/{vid:08d}_masked.jpg"
        err = np.abs(read_jpeg(tmp_path / SCAN / name).astype(int) - img).mean()
        assert err <= np.abs(read_jpeg(fixture_root / SCAN / name).astype(int) - img).mean()
        mask = read_jpeg(tmp_path / SCAN / "masks" / f"{vid:08d}_mask.jpg", gray=True)
        assert np.mean((mask > 127) == hit) > 0.995


@pytest.mark.parametrize("threshold", [0.2, 0.5, 0.9])
def test_similarity_mesh_matches_jax(threshold):
    from uforecon_tpu.pipeline.extract import similarity_mesh as jax_similarity_mesh

    # a smooth field with a -1 region, as the field of a view set has
    reso = 20
    axis = np.linspace(-1, 1, reso, dtype=np.float32)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    field = np.cos(2.5 * np.sqrt(x * x + 1.5 * y * y + 0.7 * z * z)).astype(np.float32)
    field[x > 0.8] = -1.0
    got_v, got_f = similarity_mesh(field, threshold=threshold)
    want_v, want_f = jax_similarity_mesh(field, threshold=threshold)
    assert len(want_v) > 0
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-6)
    assert np.all(np.abs(got_v) <= 1.0 + 1e-6)


def test_extract_similarity_field_asks_the_kernel_wrapper(monkeypatch):
    """JAX's ``fused='auto'`` on the accelerator: the field asks the
    wrapper, never the plain version directly; the wrapper launches kernel 7
    for CUDA tensors or raises (``test_torch_port_kernels.py``)."""
    calls = []
    monkeypatch.setattr(ray_transformer, "grouped_cosine_reference",
                        lambda *a, **k: calls.append("plain"))
    model = UFORecon(Config(extract_geometry=True, ndepths=(8, 8, 8),
                            fmt_layer_names=("self", "cross")))
    from uforecon_tpu_torch.convert import init_weights

    from helpers import make_synthetic_sample

    init_weights(model, 0)
    model.requires_grad_(False)
    scene, _ = scene_inputs_from_sample(make_synthetic_sample(
        n_views=3, h=32, w=32, ndepth=16, start_idx=0), device="cpu")
    field = extract_similarity_field(model, scene, reso=8, chunk=256)
    assert calls == [] and field.shape == (8, 8, 8)
    assert np.all((field >= -1.0) & (field <= 1.0 + 1e-5))
