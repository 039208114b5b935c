"""The custom-capture CLI and the similarity field of the port against the JAX
package, on the CPU.

On the repository's GeneralFit fixture (``script/make_general_fixture.py``),
one JAX process for the module extracts with its initialised weights and
keeps its uniform draws (as ``test_torch_port_cli.py``; a second renders
the ``fast`` chunk beside it), at
``tests/test_general_e2e.py``'s size (128x96, cascade depths 8/8/8, 3
views, masks) at ``test_torch_port_cli.py``'s 8 + 8 samples:
  * ``python -m uforecon_tpu_torch.cli.run --extract_geometry --test_general``
    with the exact flags: depth maps as close to JAX's as to the port's own
    under a 1e-7 move of its draws (``_hold_like_rounding``: this scene at
    random weights has only ~92-98 % of pixels within 2e-4 of that);
  * at the defaults (merged volumes, bf16 sources, ``fast``): the same with
    ``highest`` heads, the ``fast`` run through the bf16 heads, and with
    ``--extract_similarity`` the mesh of a field within 1e-5 of JAX's;
  * the scene's first 128 rays at the defaults against JAX's render with
    its heads in ``fast`` (the Pallas kernels in interpret mode, in a
    second JAX process), by the size of JAX's own bf16 effect;
  * ``extract_similarity_field`` at ``--sim_reso 24`` within 1e-5 of JAX's,
    with the same -1 cells; its cosine goes through the grouped-cosine
    wrapper (kernel 7 on the card) on a view of the sampler's output, not a
    copy.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_general_cli.py -q
"""
import functools
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uforecon_tpu_torch.cli import run
from uforecon_tpu_torch.config import Config
from uforecon_tpu_torch.convert import load_flax_variables, save_state_dict
from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
from uforecon_tpu_torch.data.general_fit import GeneralFit
from uforecon_tpu_torch.data.io import read_ply
from uforecon_tpu_torch.models import ray_transformer
from uforecon_tpu_torch.models.uforecon import EncoderOutputs, UFORecon
from uforecon_tpu_torch.pipeline.extract import extract_similarity_field, similarity_mesh

ROOT = Path(__file__).resolve().parent.parent
SEED = 5
SCAN = "scan_sphere"
FLAGS = ["--extract_geometry", "--test_general", "--dataset", "blendedmvs", "--use_mask",
         "--test_scan", SCAN, "--test_ref_view", "0", "1", "2", "--test_n_view", "3",
         "--img_wh", "128", "96", "--test_ray_num", "800", "--test_sample_coarse", "8",
         "--test_sample_fine", "8", "--ndepths", "8,8,8", "--numdepth", "32",
         "--volume_type", "correlation", "--mvs_depth_guide", "1", "--depth_pos_encoding",
         "--explicit_similarity", "--seed", str(SEED)]
EXACT_FLAGS = ["--volume_merge", "never", "--volume_dtype", "float32",
               "--image_gather_dtype", "float32", "--kernel_precision", "highest"]
SIM_RESO = 24

_JAX_GENERAL = """
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from uforecon_tpu.config import Config
from uforecon_tpu.data.convert import scene_inputs_from_sample
from uforecon_tpu.data.general_fit import GeneralFit
from uforecon_tpu.pipeline.extract import (extract_geometry_for_dataset,
                                           extract_similarity_field)
from uforecon_tpu.pipeline.fit import init_model
from uforecon_tpu.pipeline.renderer import SceneRenderer
root, out, path, seed, reso = (sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]),
                               int(sys.argv[5]))
small = dict(extract_geometry=True, test_general=True, dataset="blendedmvs",
             use_mask=True, test_sample_coarse=8, test_sample_fine=8,
             ndepths=(8, 8, 8), numdepth=32, test_ray_num=800, img_wh=(128, 96),
             seed=seed)
exact = Config(**small, volume_merge="never", kernel_precision="highest",
               image_gather_dtype="float32", volume_dtype="float32")
default = Config(**small)
ds = GeneralFit(root_dir=root, scan_id="scan_sphere", n_views=3, dataset="blendedmvs",
                use_mask=True, test_ref_view=[0, 1, 2], img_wh=[128, 96])
_, variables = init_model(exact, ds[0], seed)
chunks = {}
for name, cfg in (("exact", exact), ("default", default)):
    extract_geometry_for_dataset(cfg, variables, ds, out_dir=f"{out}/{name}", seed=seed)
    chunks[name] = SceneRenderer(cfg, variables).chunk
assert chunks["exact"] == chunks["default"], chunks
chunk = chunks["exact"]
scene, _ = scene_inputs_from_sample(ds[0])
field = extract_similarity_field(default, variables, scene, reso=reso)
n_chunks = -(-128 * 96 // chunk)
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
    pickle.dump((jax.tree_util.tree_map(np.asarray, variables), draws,
                 np.asarray(field)), f)
"""


# the scene's first rays at the defaults, the JAX heads through their Pallas
# kernels in 'fast' (interpret mode: one mode per process), and through the
# flax path (FP32) on the same encoding and draws
_JAX_FAST_CHUNK = """
import dataclasses, pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from uforecon_tpu.ops import kernel_precision
kernel_precision.set_mode("fast")
from uforecon_tpu.config import Config
from uforecon_tpu.data.convert import scene_inputs_from_sample
from uforecon_tpu.data.general_fit import GeneralFit
from uforecon_tpu.models.uforecon import UFORecon
from uforecon_tpu.pipeline.fit import init_model
root, path, seed, rn = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
small = dict(extract_geometry=True, test_general=True, dataset="blendedmvs",
             use_mask=True, test_sample_coarse=8, test_sample_fine=8,
             ndepths=(8, 8, 8), numdepth=32, test_ray_num=800, img_wh=(128, 96),
             seed=seed)
default = Config(**small)
ds = GeneralFit(root_dir=root, scan_id="scan_sphere", n_views=3, dataset="blendedmvs",
                use_mask=True, test_ref_view=[0, 1, 2], img_wh=[128, 96])
_, variables = init_model(default, ds[0], seed)
scene, extras = scene_inputs_from_sample(ds[0])
model = UFORecon(default)
enc = jax.jit(lambda v, s: model.apply(v, s, method=model.encode))(variables, scene)
cam_z = np.asarray(extras["cam_ray_d"][:rn, 2])
ray_d = jnp.asarray(extras["ray_d"][:rn])
near = jnp.asarray(np.float32(scene.near) / cam_z)
far = jnp.asarray(np.float32(scene.far) / cam_z)
key = jax.random.PRNGKey(seed)
kc, kf = jax.random.split(key)
out = {}
for name, fused in (("fast", "always"), ("highest", "never")):
    m = UFORecon(dataclasses.replace(default, fused_point_head=fused))
    res = m.apply(variables, scene, enc, ray_d, key, near_per_ray=near, far_per_ray=far,
                  method=m.render_chunk)
    out[name] = jax.tree_util.tree_map(np.asarray, res)
vols = {k: (np.array(v[..., :25 if k == "merged" else 9], np.float32),
            str(v.dtype)) for k, v in enc.volumes.items()}
enc_np = dict(source_feats=enc.source_feats, aug0=enc.aug0, aug1=enc.aug1,
              mvs_depths=enc.mvs_depths)
with open(path, "wb") as f:
    pickle.dump(dict(variables=jax.tree_util.tree_map(np.asarray, variables),
                     enc={k: np.asarray(v) for k, v in enc_np.items()}, volumes=vols,
                     ray_d=np.asarray(ray_d), near=np.asarray(near), far=np.asarray(far),
                     draws=(np.asarray(jax.random.uniform(kc, (rn, 8), jnp.float32)),
                            np.asarray(jax.random.uniform(kf, (rn, 8), jnp.float32))),
                     out=out), f)
"""
FAST_RAYS = 128


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


@pytest.fixture(scope="module")
def jax_fast_proc(fixture_root, tmp_path_factory):
    """The JAX fast chunk, started beside the JAX extract (``jax_run``)."""
    path = tmp_path_factory.mktemp("jax_fast") / "chunk.pkl"
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_FAST_CHUNK, str(fixture_root), str(path), str(SEED),
         str(FAST_RAYS)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=_env())
    yield proc, path
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_run(fixture_root, jax_fast_proc, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_general")
    res = subprocess.run(
        [sys.executable, "-c", _JAX_GENERAL, str(fixture_root), str(tmp / "out"),
         str(tmp / "io.pkl"), str(SEED), str(SIM_RESO)],
        capture_output=True, text=True, timeout=900, cwd=ROOT, env=_env())
    assert res.returncode == 0, res.stderr[-3000:]
    with open(tmp / "io.pkl", "rb") as f:
        variables, draws, field = pickle.load(f)
    return tmp / "out", variables, draws, field


@pytest.fixture(scope="module")
def jax_fast_chunk(jax_fast_proc):
    proc, path = jax_fast_proc
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# the CLI

def _run_cli(jax_run, fixture_root, out: Path, extra, shift: float = 0.0):
    """The port's CLI with the JAX run's weights and draws (its coarse
    draws moved by ``shift``); returns its statistics."""
    _, variables, draws, _ = jax_run
    ckpt = out.parent / "weights.pt"
    if not ckpt.exists():
        save_state_dict(str(ckpt), variables)
    if shift:
        draws = [[((c + shift).astype(np.float32), f) for c, f in view] for view in draws]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(run, "extract_geometry_for_dataset", functools.partial(
            run.extract_geometry_for_dataset, draws=draws))
        return run.main(FLAGS + extra + ["--root_dir", str(fixture_root), "--out_dir",
                                         str(out), "--load_ckpt", str(ckpt),
                                         "--device", "cpu"])[SCAN]


def _depth_maps(out: Path):
    return [np.load(out / "depth" / SCAN / f"refview{i}.npy", allow_pickle=True).item()
            for i in range(3)]


def _rel(a, b):
    return np.abs(a - b) / np.abs(b)


def _rounding_spread(got, shifted):
    """At random weights this scene's depth maps move under a float32
    rounding: the port's own maps with its coarse draws moved by 1e-7 have
    only ~92-98 % of pixels within 2e-4 of them (median ~1e-5 relative), at
    16 + 16 samples and at 8 + 8 alike. Returns that share and median."""
    return (np.isclose(got, shifted, rtol=2e-4, atol=0).mean(),
            np.median(_rel(got, shifted)))


def _hold_like_rounding(got, want, spread):
    """The maps held to JAX's as closely as to a rounding (``spread``): the
    share within 2e-4 at most 2 points below its share, the median relative
    distance at most twice its median."""
    share, median = np.isclose(got, want, rtol=2e-4, atol=0).mean(), np.median(_rel(got, want))
    assert share >= spread[0] - 0.02 and median <= 2 * spread[1], (share, median, spread)


@pytest.fixture(scope="module")
def port_exact(fixture_root, jax_run, tmp_path_factory):
    """The port's exact-path CLI: with JAX's draws, and with them moved by
    1e-7."""
    tmp = tmp_path_factory.mktemp("port_exact")
    stats = _run_cli(jax_run, fixture_root, tmp / "out", EXACT_FLAGS)
    _run_cli(jax_run, fixture_root, tmp / "shifted", EXACT_FLAGS, shift=1e-7)
    maps = _depth_maps(tmp / "out")
    return stats, maps, [_rounding_spread(m["depth"], s["depth"])
                         for m, s in zip(maps, _depth_maps(tmp / "shifted"))]


def test_cli_general_exact_matches_jax(jax_run, port_exact):
    stats, got_maps, spreads = port_exact
    assert stats["views"] == 3 and stats["rays"] == 3 * 128 * 96
    assert stats["merged"] is False and stats["kernel_precision"] == "highest"
    for i, (got, want) in enumerate(zip(got_maps, _depth_maps(jax_run[0] / "exact"))):
        assert set(got) == set(want) == {"depth", "extrinsic", "intrinsic"}
        for k in ("extrinsic", "intrinsic"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        assert got["depth"].shape == want["depth"].shape == (96, 128)
        assert np.all(np.isfinite(got["depth"]))
        _hold_like_rounding(got["depth"], want["depth"], spreads[i])


def test_cli_general_defaults_and_similarity_match_jax(fixture_root, jax_run, port_exact,
                                                       tmp_path, capsys):
    """At the defaults (merged volumes, bf16 volumes and sources, ``fast``),
    with ``--extract_similarity``. On the CPU the JAX extract's heads take
    their flax path, where ``fast`` changes nothing, so the port's defaults
    with ``--kernel_precision highest`` are held to JAX's defaults as the
    exact path is. The ``fast`` maps are finite and differ from those
    ``highest`` maps (the bf16 heads ran); at random weights this scene
    moves a depth map by millimetres under any change of rounding, so they
    are held to JAX's fast heads ray by ray in
    ``test_fast_chunk_matches_jax_fast``, not here. The mesh the CLI
    writes is ``similarity_mesh`` of a field within 1e-5 of JAX's."""
    stats = _run_cli(jax_run, fixture_root, tmp_path / "fast",
                     ["--extract_similarity", "--sim_reso", str(SIM_RESO),
                      "--sim_threshold", "0.5"])
    printed = capsys.readouterr().out
    assert "resolved: merged volumes, kernel_precision fast" in printed
    assert stats["merged"] is True and stats["kernel_precision"] == "fast"
    high = _run_cli(jax_run, fixture_root, tmp_path / "high",
                    ["--kernel_precision", "highest"])
    assert high["merged"] is True and high["kernel_precision"] == "highest"
    want_maps = _depth_maps(jax_run[0] / "default")
    for i, (fast, hi, want, spread) in enumerate(zip(
            _depth_maps(tmp_path / "fast"), _depth_maps(tmp_path / "high"), want_maps,
            port_exact[2])):
        fast, hi, want = fast["depth"], hi["depth"], want["depth"]
        assert fast.shape == hi.shape == want.shape == (96, 128)
        assert np.all(np.isfinite(fast)) and np.all(np.isfinite(hi))
        _hold_like_rounding(hi, want, spread)      # the exact path's spread
        assert np.abs(fast - hi).max() > 1e-3, i
    ply = tmp_path / "fast" / "similarity" / f"{SCAN}.ply"
    assert f"similarity field -> {ply} (" in printed and stats["similarity_s"] > 0
    verts, faces, _ = read_ply(ply)
    want_v, want_f = similarity_mesh(jax_run[3], threshold=0.5)
    assert len(want_v) > 0
    # the field is within 1e-5 of JAX's: the iso-surface within that of a
    # cell at the level's slope, the same triangles
    assert verts.shape == want_v.shape and np.array_equal(faces, want_f)
    np.testing.assert_allclose(verts, want_v, atol=1e-3)


def test_fast_chunk_matches_jax_fast(fixture_root, jax_fast_chunk):
    """The scene's first 128 rays at the CLI's defaults (merged bf16
    volumes, bf16 gather sources, ``fast`` heads) on JAX's encoding and
    draws, against JAX's render with its heads through the Pallas kernels
    in ``fast``. Outputs bf16 does not move (opacity) within 1e-5; the
    others by the size of JAX's own bf16 effect on them (its fast against
    its FP32 heads): the median ray within a fifth of that effect's median,
    none off by more than twice its largest. The median, because at random
    weights the fine pass moves under any rounding: the FP32 paths of the
    two packages already differ by half the bf16 effect's mean in fine rgb.
    Measured here: medians at 0.015-0.115 of the effect; with a bf16
    rounding at one site more (the products' outputs) or one fewer (the
    activations), at 0.26-0.67."""
    d = jax_fast_chunk
    model = UFORecon(Config(extract_geometry=True, ndepths=(8, 8, 8), numdepth=32,
                            test_sample_coarse=8, test_sample_fine=8))
    load_flax_variables(model, d["variables"])
    model.requires_grad_(False)
    assert model.kernel_precision == "fast"
    ds = GeneralFit(str(fixture_root), SCAN, n_views=3, test_ref_view=[0, 1, 2],
                    dataset="blendedmvs", use_mask=True, img_wh=[128, 96])
    scene, _ = scene_inputs_from_sample(ds[0], device="cpu")
    t = lambda a: torch.as_tensor(np.asarray(a))
    vols = {k: t(v).permute(0, 4, 1, 2, 3).contiguous().to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        for k, (v, dtype) in d["volumes"].items()}
    assert set(vols) == {"merged"} and vols["merged"].dtype == torch.bfloat16
    enc = EncoderOutputs(volumes=vols, **{k: t(v) for k, v in d["enc"].items()})
    out = model.render_chunk(scene, enc, t(d["ray_d"]), near_per_ray=t(d["near"]),
                             far_per_ray=t(d["far"]), u_coarse=t(d["draws"][0]),
                             u_fine=t(d["draws"][1]))
    fast, highest = d["out"]["fast"], d["out"]["highest"]
    # JAX's reference really is the bf16 variant
    assert np.abs(fast["fine"]["depth"] - highest["fine"]["depth"]).max() > 1e-4
    for phase in ("coarse", "fine"):
        for key in ("depth", "rgb", "opacity"):
            got = out[phase][key].numpy()
            f, h = fast[phase][key], highest[phase][key]
            assert got.shape == f.shape and np.all(np.isfinite(got)), (phase, key)
            diff, gap = np.abs(got - f), np.abs(f - h)
            if gap.max() <= 1e-5:
                np.testing.assert_allclose(got, f, rtol=1e-5, atol=1e-5)
            else:
                assert np.median(diff) <= 0.2 * np.median(gap) and \
                    diff.max() <= 2 * gap.max(), (phase, key, np.median(diff),
                                                  np.median(gap), diff.max(), gap.max())


def test_similarity_field_matches_jax(fixture_root, jax_run, monkeypatch):
    _, variables, _, want = jax_run
    model = UFORecon(Config(extract_geometry=True, ndepths=(8, 8, 8), numdepth=32,
                            test_sample_coarse=8, test_sample_fine=8))
    load_flax_variables(model, variables)
    model.requires_grad_(False)
    ds = GeneralFit(str(fixture_root), SCAN, n_views=3, test_ref_view=[0, 1, 2],
                    dataset="blendedmvs", use_mask=True, img_wh=[128, 96])
    scene, _ = scene_inputs_from_sample(ds[0], device="cpu")
    seen = []
    wrapper = ray_transformer.grouped_cosine

    def spy(x, n_groups=8):
        seen.append((tuple(x.shape), x.stride(), x.is_contiguous()))
        return wrapper(x, n_groups)

    monkeypatch.setattr(ray_transformer, "grouped_cosine", spy)
    got = extract_similarity_field(model, scene, reso=SIM_RESO, chunk=8192)
    assert got.shape == want.shape == (SIM_RESO,) * 3 and got.dtype == np.float32
    # two chunks of 8192 points, the last padded; the sampler's channel-
    # first output read through strides (NV, P, C) -> (P C, 1, P)
    c = 2 * 32
    assert seen == [((3, 8192, c), (c * 8192, 1, 8192), False)] * 2
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    assert 0 < np.mean(want == -1.0) < 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


