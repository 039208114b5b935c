"""The port at the view counts of DTU's evaluation set 1 (6 to 11 views)
against the JAX package.

``--set 1`` renders with up to 11 views (``SET1_VIEW_LIST``). The point-head
kernels (``csrc/point_head*.cu``) are compiled for 2..11 views and the
volume fusion (``csrc/volume_fusion.cu``) for 1..11; past them, as the JAX
kernels, they take any count (a custom capture's pair file with more than
10 sources, training at ``--train_n_view`` up to DTU's 49). Their plain
versions, which the kernels are held to on the card, are held here to the
JAX package on the same numpy inputs, with weights bridged by
``convert.load_flax_variables``:

  * the wrappers hand 12 and 49 views to the kernel extension;
  * kernels 1 and 4 at NV 6, 8, 11, 12 and 49: the FP32 plain versions and the
    plain versions with their tensor-core layers in emulated 3xTF32 (the
    split-weight head through the transcription of its kernel's algebra
    from its pack) against the JAX Pallas kernels ``point_head_fused`` and
    ``point_head2_fused`` in interpret mode at ``helpers.fused_fwd_tol()``
    (the JAX package's own tolerance for them) and against the JAX
    references at 1e-5; the ``fast`` plain versions against the JAX kernels
    run in ``fast``, by the size of JAX's own bf16 effect (the rule of
    ``test_torch_port_shipped.py``);
  * the fast plain product's sums, bit for bit the k-ordered FP32 FMAs of
    the fast kernel's layers from 6 views on;
  * the volume fusion at 11, 12 and 49 views, and ``query_similarity`` (55 pairs at
    11 views; its grouped cosine the JAX Pallas kernel) at 6 and 11, at
    1e-6 (``test_torch_port_fused_glue.py``'s tolerance);
  * ``render_chunk`` of a 32x32 scene of 6 and of 11 views against the JAX
    model on the exact path, by ``test_torch_port_configs.py``'s rules;
  * ``cli.run --extract_geometry --set 1 --test_n_view 11 --device cpu`` on
    the fixture's 11 views (``make_dtu_fixture --views`` of set 1) at 32x32 on the
    exact path, against the JAX extract with the same weights and draws:
    the JAX run renders the first two views (each view costs it a jitted
    encode of all 11), within 2e-4 relative on >= 99 % of pixels (the
    tolerance of ``test_torch_port_cli.py``); the port's other nine are
    finite.

The JAX runs (the kernels, one process per kernel precision: the JAX
package keeps one mode per process; the model; the extract) run in
subprocesses, started together by the module's first test.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_views.py -q
"""
import contextlib
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu.models.ray_transformer import query_similarity as jax_query_similarity
from uforecon_tpu.ops import fused_point_head as jph
from uforecon_tpu.ops import fused_point_head2 as jph2
from uforecon_tpu.ops import fused_volume_fusion as jvf

from uforecon_tpu_torch.cli import run
from uforecon_tpu_torch.config import EXACT, Config
from uforecon_tpu_torch.convert import load_flax_variables, save_state_dict
from uforecon_tpu_torch.data.dtu_test import SET1_VIEW_LIST
from uforecon_tpu_torch.models.ray_transformer import query_similarity
from uforecon_tpu_torch.models.uforecon import SceneInputs, UFORecon
from uforecon_tpu_torch.ops import cuda_build
from uforecon_tpu_torch.ops import fused_point_head as pph
from uforecon_tpu_torch.ops import fused_point_head2 as pph2
from uforecon_tpu_torch.ops import fused_volume_fusion as pvf
from uforecon_tpu_torch.script import make_dtu_fixture

from helpers import make_synthetic_scene
from test_torch_port_cli import EXACT_FLAGS
from test_torch_port_configs import bridge_encoder, check_render
from test_torch_port_fused_glue import GLUE_TOL, _pair_maps
from test_torch_port_heads import _jax_point
from test_torch_port_kernels import _fusion_case, _point_case, _port_params, _t
from test_torch_port_point_head2 import _split_algebra
from test_torch_port_shipped import _like_jax_fast
from test_torch_port_tc_heads import _jax_point_params, _ray_transformer, tc_linear, \
    tc_planes_mm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
KERNEL_VIEWS = (6, 8, 11, 12, 49)
RENDER_VIEWS = (6, 11)
POINTS = 300
TOL = dict(rtol=1e-5, atol=1e-5)
SEED = 3
WH = (32, 32)                  # the CLI run's render size
JAX_VIEWS_RENDERED = 2         # views the JAX extract renders


# ---------------------------------------------------------------------------
# The JAX runs, in subprocesses started together

# The JAX Pallas point heads in interpret mode at each view count, in one
# kernel-precision mode; the inputs point-major, JAX's v1 takes them
# feature-major
_JAX_KERNELS = """
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
path, mode = sys.argv[1], sys.argv[2]
sys.path.insert(0, sys.argv[3])
from uforecon_tpu.ops import kernel_precision
kernel_precision.set_mode(mode)
from uforecon_tpu.ops import fused_point_head as fph, fused_point_head2 as fph2
from helpers import fused_fwd_tol
with open(path, "rb") as f:
    cases = pickle.load(f)
J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
fm = lambda a: jnp.swapaxes(a, -1, -2)
out = {"tol": fused_fwd_tol()}
for nv, (inp, params) in cases.items():
    inp, p = J(inp), fph.PointHeadParams(**J(params))
    tok, rad = fph.point_head_fused(fph.PointHeadInputs(
        img_feat=fm(inp["img_feat"]), vol_feat=fm(inp["vol_feat"]),
        sim_feat=fm(inp["sim_feat"]), depth_dist=inp["depth_dist"],
        dir_rel=fm(inp["dir_rel"]), rgb=fm(inp["rgb"]), mask=inp["mask"]), p)
    out["point_head", nv] = (np.asarray(tok).T, np.asarray(rad).T)
    out["point_head2", nv] = tuple(map(np.asarray, fph2.point_head2_fused(
        fph2.PointHeadInputs2(**inp), p)))
with open(path, "wb") as f:
    pickle.dump(out, f)
"""

# The JAX package's extract on DTU's evaluation set 1 at 11 views, exact
# path, its own initialised weights; it renders the first views only, and
# writes the weights and the draws of every view (its key schedule)
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
root, out, path, seed, w, h, rendered = sys.argv[1:8]
seed, w, h, rendered = int(seed), int(w), int(h), int(rendered)
cfg = Config(extract_geometry=True, test_sample_coarse=8, test_sample_fine=8,
             ndepths=(8, 8, 8), volume_merge="never", kernel_precision="highest",
             image_gather_dtype="float32", volume_dtype="float32", test_ray_num=800,
             seed=seed)
ds = DtuFitSparse(root_dir=root, scan_id="scan24", n_views=11, set=1, img_wh=[w, h])


class First:
    def __len__(self):
        return rendered

    def __getitem__(self, i):
        return ds[i]


_, variables = init_model(cfg, ds[0], seed)
extract_geometry_for_dataset(cfg, variables, First(), out_dir=out, seed=seed)
chunk = SceneRenderer(cfg, variables).chunk
n_chunks = -(-w * h // chunk)
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


# The JAX model on the exact path (init, jitted encode and render_chunk) on
# a 32x32 scene of each view count, as test_torch_port_configs.py's
# make_pair runs it at 3 views; rays off the reference view's border, where
# each package's last bit of the projection decides view 0's in-bounds mask
_JAX_MODELS = """
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
path = sys.argv[1]
sys.path.insert(0, sys.argv[2])
from uforecon_tpu.config import Config
from uforecon_tpu.models.uforecon import UFORecon
from helpers import make_synthetic_scene
out, rn = {}, 64
for nv in map(int, sys.argv[3:]):
    scene, extras = make_synthetic_scene(n_views=nv, h=32, w=32, ndepth=16)
    model = UFORecon(Config(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"),
                            coarse_sample=8, fine_sample=8, volume_merge="never",
                            volume_dtype="float32", image_gather_dtype="float32"))
    key = jax.random.PRNGKey(0)
    ray_d = extras["ray_d"].reshape(32, 32, 3)[1:-1, 1:-1].reshape(-1, 3)[:rn]
    variables = jax.jit(model.init)(key, scene, ray_d[:4], key)
    enc = jax.jit(lambda v, s: model.apply(v, s, method=model.encode))(variables, scene)
    res = jax.jit(lambda v, s, e, r, k: model.apply(v, s, e, r, k,
                                                    method=model.render_chunk))(
        variables, scene, enc, ray_d, key)
    k_coarse, k_fine = jax.random.split(key)
    draws = [jax.random.uniform(k, (rn, 8), jnp.float32) for k in (k_coarse, k_fine)]
    out[nv] = jax.tree_util.tree_map(np.asarray, (variables, scene, enc, res, ray_d, draws))
with open(path, "wb") as f:
    pickle.dump(out, f)
"""


def _start(code, *args):
    return subprocess.Popen(
        [sys.executable, "-c", code, *map(str, args)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "UFO_PLATFORM": "cpu",
             "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])})


class _Run:
    """A subprocess and the pickle it writes, read once it has ended."""

    def __init__(self, proc, path):
        self.proc, self.path, self._out = proc, path, None

    def result(self):
        if self._out is None:
            _, err = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0, err[-3000:]
            with open(self.path, "rb") as f:
                self._out = pickle.load(f)
        return self._out


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """Starts the JAX runs at the module's first test, so that they run
    beside the tests that need none of them: the interpret-mode point heads
    in 'highest' and in 'fast' on the same inputs, the model at each of
    RENDER_VIEWS, and the set-1 extract on the fixture (written here at
    64x48, read at 32x32)."""
    tmp = tmp_path_factory.mktemp("jax_views")
    rng = np.random.default_rng(11)
    rt, tree = _ray_transformer(rng)
    rt.requires_grad_(False)
    cases = {nv: (_point_case(rng, nv=nv, n=POINTS)[0], _jax_point_params(tree))
             for nv in KERNEL_VIEWS}
    runs = {"cases": cases, "port_params": rt.point_head_params()}
    for mode in ("highest", "fast"):
        path = tmp / f"kernels_{mode}.pkl"
        with open(path, "wb") as f:
            pickle.dump(cases, f)
        runs[mode] = _Run(_start(_JAX_KERNELS, path, mode, TESTS), path)
    runs["models"] = _Run(_start(_JAX_MODELS, tmp / "models.pkl", TESTS, *RENDER_VIEWS),
                          tmp / "models.pkl")
    root = tmp / "fixture"
    make_dtu_fixture.main([str(root), "--views", *map(str, SET1_VIEW_LIST), "--wh", "64",
                           "48"])
    runs["fixture"] = root
    runs["jax_out"] = tmp / "jax_out"
    runs["extract"] = _Run(_start(_JAX_EXTRACT, root, runs["jax_out"], tmp / "extract.pkl",
                                  SEED, *WH, JAX_VIEWS_RENDERED), tmp / "extract.pkl")
    yield runs
    for key in ("highest", "fast", "models", "extract"):
        if runs[key].proc.poll() is None:
            runs[key].proc.kill()
            runs[key].proc.communicate()


# ---------------------------------------------------------------------------
# The kernels' limits, the fixture


@pytest.mark.parametrize("nv", [1])
def test_point_head_kernels_refuse_view_counts_past_their_limit(nv):
    """Two views or more; one view, a ValueError that names the count (the
    JAX head needs a source view too)."""
    inputs, params = _point_case(np.random.default_rng(0), nv=nv, n=8)
    inp = pph.PointHeadInputs(**{k: _t(v) for k, v in inputs.items()})
    p = _port_params(pph.PointHeadParams, params)
    for name, launch in (("point_head", pph._launch), ("point_head2", pph2._launch)):
        with pytest.raises(ValueError, match=f"{name} kernel takes 2 views or more, got {nv} "):
            launch(inp, p, 8)
    assert pph.KERNEL_COMPILED_VIEWS == 11 == len(SET1_VIEW_LIST)


class _Ext:
    """A kernel extension that records what the wrappers hand it."""

    def __init__(self):
        self.calls = []

    def point_head_weight_count(self, cv):
        return pph.pack_weights(_Ext.params).numel()

    def point_head_fast_pack_bytes(self, cv):
        return 4 * pph.fast_image(_Ext.params).numel()

    def point_head2_weight_count(self, cv):
        return pph2.pack_weights2(_Ext.params).numel()

    def point_head_scratch_floats(self, cv, nv, p):
        return 5

    def point_head2_scratch_floats(self, cv, nv, p):
        return 7

    def point_head(self, *args):
        self.calls.append(("point_head", args[0].shape[0], args[-2].numel(), args[-1]))

    def point_head2(self, *args):
        self.calls.append(("point_head2", args[0].shape[0], args[-2].numel(), args[-1]))

    def volume_fusion_stages(self):
        return 3

    def volume_fusion_features(self):
        return 8

    def volume_fusion_max_views(self):
        return 11

    def volume_fusion(self, *args):
        self.calls.append(("volume_fusion", args[0].shape[0]))


@pytest.mark.parametrize("nv", [12, 49])
def test_kernels_take_view_counts_past_the_compiled_ones(nv, monkeypatch):
    """The two point heads, in both precisions, and the volume fusion hand
    12 and 49 views to the kernel extension (past the 11 compiled in), the
    heads with the scratch the extension asks for; nothing falls back to a
    plain version and nothing raises over the count. CPU tensors stand in
    for the card's here: the device check and the device scope are
    bypassed, the extension a recorder."""
    rng = np.random.default_rng(nv)
    inputs, params = _point_case(rng, nv=nv, n=8)
    inp = pph.PointHeadInputs(**{k: _t(v) for k, v in inputs.items()})
    _Ext.params = p = _port_params(pph.PointHeadParams, params)
    ext = _Ext()
    monkeypatch.setattr(cuda_build, "extension", lambda: ext)
    monkeypatch.setattr(cuda_build, "check_tensors", lambda name, tensors: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    pvf._extension.cache_clear()
    cuda_build.clear_pack_caches()
    try:
        for precision in ("high", "fast"):
            pph._launch(inp, p, 8, precision)
            pph2._launch(inp, p, 8, precision)
        pvf._launch([_t(f) for f in _fusion_case(rng, nv=nv, n=8)])
    finally:
        pvf._extension.cache_clear()
        cuda_build.clear_pack_caches()
    assert ext.calls == [("point_head", nv, 5, False), ("point_head2", nv, 7, False),
                         ("point_head", nv, 5, True), ("point_head2", nv, 7, True),
                         ("volume_fusion", nv)]


def test_fixture_writes_set_1_with_a_camera_per_view():
    cams = make_dtu_fixture.cameras()
    assert set(make_dtu_fixture.ALL_VIEWS) >= set(SET1_VIEW_LIST)
    eyes = {v: -cams[v][:3, :3].T @ cams[v][:3, 3] for v in SET1_VIEW_LIST}
    dist = [np.linalg.norm(eyes[a] - eyes[b]) for a in eyes for b in eyes if a < b]
    assert min(dist) > 50.0                       # mm: no two views share a camera
    for e in eyes.values():                       # all at the first ring's distance
        assert 430 < np.linalg.norm(e - make_dtu_fixture.CENTER) < 470


@pytest.mark.parametrize("k, n", [(80, 80), (160, 160), (160, 80), (72, 72), (144, 144),
                                  (144, 72)])
def test_fast_layer_sums_are_the_kernels_k_ordered_fmas(k, n):
    """From 6 views on, the fast point-head kernel adds each bf16 product
    of its layers by one FP32 FMA, k in order (``csrc/point_head_fast_views.cu``
    fma_gemm; past 11 views ``csrc/tc_gemm.cuh`` kFmaSum); the plain version's fast product
    (``cuda_build.fast_linear``) sums the same way on the CPU, so the two
    agree bit for bit on the same operands (the layers' shapes at tokens of
    80 and 72)."""
    rng = np.random.default_rng(k * 1000 + n)
    x = torch.as_tensor(rng.standard_normal((1024, k)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32))
    got = cuda_build.fast_linear(x, w)
    xb, wb = cuda_build.bf16_round(x).double(), cuda_build.bf16_round(w).double()
    acc = torch.zeros(1024, n)
    for i in range(k):   # fmaf: the bf16 product is exact, the sum rounds once
        acc = (acc.double() + xb[:, i:i + 1] * wb[:, i]).float()
    assert torch.equal(got, acc)


@pytest.mark.parametrize("k, n", [(8, 32), (32, 32), (32, 16), (83, 16), (16, 8), (75, 16)])
def test_fast_small_layer_sums_add_the_bias_last(k, n):
    """The small MLPs' layers (pre-similarity 8 -> 32 -> 32 -> 16, radiance
    C + 3 -> 16 -> 8 at tokens of 80 and 72): the fast plain product sums
    its bf16 products by FP32 FMAs from zero, k in order, and adds the bias
    to the sum, bit for bit, the order fast kernel 1's FMA-summed small
    layers take from 6 views on (``csrc/point_head_fast_views.cu``
    ``fma_dot``)."""
    rng = np.random.default_rng(k * 100 + n)
    x = torch.as_tensor(rng.standard_normal((1024, k)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32))
    b = torch.as_tensor((0.1 * rng.standard_normal(n)).astype(np.float32))
    got = cuda_build.fast_linear(x, w, b)
    xb, wb = cuda_build.bf16_round(x).double(), cuda_build.bf16_round(w).double()
    acc = torch.zeros(1024, n)
    for i in range(k):
        acc = (acc.double() + xb[:, i:i + 1] * wb[:, i]).float()
    assert torch.equal(got, acc + b)


# ---------------------------------------------------------------------------
# The glue at 11 views


def test_volume_fusion_matches_jax_at_11_views(rng):
    fws = _fusion_case(rng, nv=11, n=300, zero_rows=7)
    ref = np.asarray(jvf.volume_fusion_reference([jnp.asarray(f) for f in fws]))
    pallas = np.asarray(jvf.volume_fusion_fused([jnp.asarray(f) for f in fws]))
    got = pvf.volume_fusion_reference([_t(f) for f in fws]).numpy()
    assert got.shape == (300, 24)
    np.testing.assert_allclose(got, ref, **GLUE_TOL)
    np.testing.assert_allclose(got, pallas, **GLUE_TOL)
    np.testing.assert_array_equal(pvf.volume_fusion(*[_t(f) for f in fws]).numpy(), got)
    np.testing.assert_array_equal(got[:7], 0.0)


@pytest.mark.parametrize("nv", [12, 49])
def test_volume_fusion_matches_jax_past_11_views(rng, nv):
    """Past the view counts compiled in, as test_volume_fusion_matches_jax_at_11_views
    holds 11: the plain version the kernel's runtime count is held to on
    the card, against JAX's reference and its Pallas kernel."""
    fws = _fusion_case(rng, nv=nv, n=300, zero_rows=7)
    ref = np.asarray(jvf.volume_fusion_reference([jnp.asarray(f) for f in fws]))
    pallas = np.asarray(jvf.volume_fusion_fused([jnp.asarray(f) for f in fws]))
    got = pvf.volume_fusion_reference([_t(f) for f in fws]).numpy()
    assert got.shape == (300, 24)
    np.testing.assert_allclose(got, ref, **GLUE_TOL)
    np.testing.assert_allclose(got, pallas, **GLUE_TOL)
    np.testing.assert_array_equal(pvf.volume_fusion(*[_t(f) for f in fws]).numpy(), got)
    np.testing.assert_array_equal(got[:7], 0.0)


@pytest.mark.parametrize("nv", [6, 11])
def test_query_similarity_matches_jax(rng, nv):
    """Every pair's grouped cosine (15 and 55 pairs), against JAX's XLA loop
    and its Pallas kernel."""
    aug0, aug1 = _pair_maps(rng, nv)
    scene, _ = make_synthetic_scene(n_views=nv, h=32, w=32)
    pts = rng.uniform(-0.8, 0.8, (4, 6, 3)).astype(np.float32)
    got = query_similarity(_t(pts), _t(scene.source_poses), _t(aug0), _t(aug1), nv)
    for fused in ("never", "always"):
        ref = jax_query_similarity(jnp.asarray(pts), scene.source_poses, jnp.asarray(aug0),
                                   jnp.asarray(aug1), nv, fused=fused)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **GLUE_TOL)
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# cli.run --set 1 --test_n_view 11


def test_cli_set_1_at_11_views_matches_jax(jax_runs, tmp_path, monkeypatch, capsys):
    root = jax_runs["fixture"]
    out = tmp_path / "out"
    flags = ["--extract_geometry", "--set", "1", "--test_n_view", "11", "--volume_type",
             "correlation", "--volume_reso", "96", "--depth_pos_encoding",
             "--mvs_depth_guide", "1", "--explicit_similarity", "--test_ray_num", "800",
             "--test_scan", "scan24", "--img_wh", *map(str, WH), "--ndepths", "8,8,8",
             "--test_sample_coarse", "8", "--test_sample_fine", "8", "--seed", str(SEED),
             "--root_dir", str(root), "--out_dir", str(out), "--device", "cpu", *EXACT_FLAGS]
    variables, draws = jax_runs["extract"].result()
    ckpt = tmp_path / "weights.pt"
    save_state_dict(str(ckpt), variables)
    monkeypatch.setattr(run, "extract_geometry_for_dataset", functools.partial(
        run.extract_geometry_for_dataset, draws=draws))
    stats = run.main(flags + ["--load_ckpt", str(ckpt)])["scan24"]
    assert stats["views"] == 11 and stats["rays"] == 11 * WH[0] * WH[1]
    assert "resolved: per-stage volumes, kernel_precision highest" in capsys.readouterr().out
    for i in range(11):
        name = f"scan24/{i:08d}.npy"
        got = np.load(out / "depth" / name, allow_pickle=True).item()
        assert got["depth"].shape == WH[::-1] and np.all(np.isfinite(got["depth"]))
        if i >= JAX_VIEWS_RENDERED:
            continue
        want = np.load(jax_runs["jax_out"] / "depth" / name, allow_pickle=True).item()
        for k in ("extrinsic", "intrinsic"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        close = np.isclose(got["depth"], want["depth"], rtol=2e-4, atol=0)
        assert close.mean() >= 0.99, (i, close.mean())


# ---------------------------------------------------------------------------
# render_chunk at 6 and 11 views


@pytest.fixture(scope="module", params=RENDER_VIEWS)
def pair(request, jax_runs):
    """The JAX model's encode and render_chunk on a 32x32 scene of nv
    views (from its subprocess), and the port on its weights, with the JAX
    draws: test_torch_port_configs.py's make_pair at nv views."""
    nv = request.param
    variables, scene, enc, out, ray_d, (u_c, u_f) = jax_runs["models"].result()[nv]
    port = UFORecon(Config(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"),
                           coarse_sample=8, fine_sample=8, **EXACT))
    load_flax_variables(port, variables)
    port.requires_grad_(False)
    p_scene = SceneInputs(
        **{k: ({s: _t(p) for s, p in v.items()} if isinstance(v, dict) else _t(v))
           for k, v in scene._asdict().items()})
    return dict(nv=nv, jax_enc=enc, jax_out=out, port=port, scene=p_scene,
                port_enc=port.encode(p_scene), ray_d=_t(ray_d), u_c=_t(u_c), u_f=_t(u_f))


@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_render_chunk_matches_jax(pair, encoder, monkeypatch):
    """On the JAX encoding (the render alone) and on the port's own; the
    port's per-point stage is its point head at nv views (JAX's gate), the
    JAX model's on the CPU its flax view transformer."""
    from uforecon_tpu_torch.models import ray_transformer

    views = []
    real = ray_transformer.point_head_v1

    def counted(inp, *args, **kwargs):
        views.append(inp.img_feat.shape[0])
        return real(inp, *args, **kwargs)

    monkeypatch.setattr(ray_transformer, "point_head_v1", counted)
    assert bridge_encoder(pair["jax_enc"]).volumes["stage1"].shape[0] == pair["nv"]
    check_render(pair, encoder)
    assert views == [pair["nv"]] * 2        # coarse and fine


# ---------------------------------------------------------------------------
# Kernels 1 and 4 at 6, 8, 11, 12 and 49 views against the JAX Pallas kernels


def _inputs(jax_runs, nv, v2=False):
    inputs, _ = jax_runs["cases"][nv]
    cls = pph2.PointHeadInputs2 if v2 else pph.PointHeadInputs
    return cls(**{k: _t(v) for k, v in inputs.items()})


@pytest.mark.parametrize("nv", KERNEL_VIEWS)
def test_point_head_plain_versions_match_jax_kernel(jax_runs, nv):
    """The FP32 plain version and the one with 3xTF32 tensor-core layers
    against JAX's interpret-mode kernel and its reference."""
    inputs, params = jax_runs["cases"][nv]
    p, inp = jax_runs["port_params"], _inputs(jax_runs, nv)
    want = jax_runs["highest"].result()
    rtol, atol = want["tol"]
    ref = _jax_point(inputs, params)
    for linear in (None, tc_linear):
        got = [t.numpy() for t in pph.point_head_reference(inp, p, linear=linear)]
        for a, b, r in zip(got, want["point_head", nv], ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
            np.testing.assert_allclose(a, r, **TOL)
        # points masked in every view blend the views uniformly, never NaN
        np.testing.assert_allclose(got[1][:5], inputs["rgb"][:, :5].mean(0), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("nv", KERNEL_VIEWS)
def test_point_head2_plain_versions_match_jax_kernel(jax_runs, nv):
    """The split-weight head: its FP32 plain version, and the transcription
    of its kernel's algebra from the pack with 3xTF32 tensor-core layers."""
    inputs, params = jax_runs["cases"][nv]
    p, inp = jax_runs["port_params"], _inputs(jax_runs, nv, v2=True)
    want = jax_runs["highest"].result()
    rtol, atol = want["tol"]
    ref = jph2.point_head2_reference(
        jph2.PointHeadInputs2(**{k: jnp.asarray(v) for k, v in inputs.items()}),
        jph.PointHeadParams(**jax.tree_util.tree_map(jnp.asarray, params)))
    with torch.no_grad():
        outs = (pph2.point_head2_reference(inp, p),
                _split_algebra(inp, pph2.pack_weights2(p), (80, 32, 24, 16, 32),
                               tc_mm=tc_planes_mm))
    for got in outs:
        for a, b, r in zip(got, want["point_head2", nv], ref):
            np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol)
            np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("nv", KERNEL_VIEWS)
@pytest.mark.parametrize("head", ["point_head", "point_head2"])
def test_fast_plain_versions_match_jax_kernels(jax_runs, head, nv):
    """In 'fast', by JAX's own bf16 effect (its fast run against its
    'highest' run): within 1e-5 on >= 97 % of the elements, the mean
    distance below 5 % of the effect's mean and none beyond half its
    largest."""
    p, inp = jax_runs["port_params"], _inputs(jax_runs, nv, v2=head == "point_head2")
    fn = pph.point_head if head == "point_head" else pph2.point_head2
    with torch.no_grad():
        got = [t.numpy() for t in fn(inp, p, precision="fast")]
    fast = jax_runs["fast"].result()[head, nv]
    highest = jax_runs["highest"].result()[head, nv]
    oks = [_like_jax_fast(g, f, h, 0.05, 0.5) for g, f, h in zip(got, fast, highest)]
    assert np.concatenate([o.reshape(-1) for o in oks]).mean() >= 0.97
    assert max(np.abs(f - h).max() for f, h in zip(fast, highest)) > 1e-4
