"""The JAX package's shipped extraction configuration in the port: merged
stage volumes, bf16 volume and image-gather sources and the ``fast`` kernel
precision, each held against the JAX package with the same setting.

  * Config: the seven fields' defaults and accepted values are the JAX
    package's; ``auto`` precision resolves per path; the merge guard's byte
    count; the trainer refuses ``fast``; the weight packs of the two
    precisions are apart.
  * Ops (``ops/volume_merge.py``) against the JAX functions on seeded numpy
    volumes (channel-last there, channel-first here): the identity where a
    stage's grid is the common one bit for bit, the query within 1e-6, the
    resamples within 1e-5. (Their positions are jnp.linspace's float32
    formula, but XLA's CPU division is not always the correctly rounded
    quotient: 15 x 5/7 comes out one ulp high, and the cells there differ
    by that ulp times their neighbours' difference, up to ~3e-6 here.)
  * The model, in this process at ``kernel_precision='highest'``: ``encode``
    and ``render_chunk`` of both packages with ``volume_merge='always'``,
    then bf16 ``volume_dtype``, then bf16 ``image_gather_dtype``, set alike
    on both sides. An element agrees when it is within 1e-5 (relative and
    absolute) or, where a bf16 rounding flips between the packages (an
    input 1e-7 apart rounds to the neighbouring bf16 value), within twice
    JAX's own gap between its bf16 and its f32 run at that element (a flip
    moves a value by one bf16 step, at most twice the rounding's gap). The
    volumes from the port's own encoder agree as the exact path's slice test
    holds them (1e-4 on >= 99 %: a matcher's winner-take-all pixel may flip),
    with the same allowance for bf16 flips. Renders are held by ray,
    as the exact path's slice test holds them: from the JAX encoding (the
    render alone) every element of >= 99 % of the rays (the exact path
    already leaves one ray of this chunk's 128 at 1.5e-4 in rgb: a point on
    the image border), from the port's own encoding at the slice test's
    2e-4 in place of 1e-5.
  * ``fast``, in subprocesses (the JAX package keeps one kernel-precision
    mode per process): the JAX Pallas kernels 1-4 in interpret mode and a
    whole ``render_chunk`` with ``fused_point_head='always'`` (which also
    takes the ray head through its kernel; on the CPU ``auto`` takes the
    flax path, where ``fast`` changes nothing), once in ``fast`` and once in
    ``highest``. Two computations of the same ``fast`` function still differ
    where an intermediate, summed in another order, lands on the other side
    of a bf16 rounding: that input moves by one bf16 step. So the port's
    ``fast`` plain versions are held to JAX's ``fast`` run by the size of
    JAX's own ``fast``-to-``highest`` gap (the bf16 effect): a kernel's
    outputs within 1e-5 on >= 97 % of elements, their mean distance below
    5 % of the gap's mean and none beyond half the gap's largest (measured
    at most 0.7 % and 19 %); a whole chunk, where such flips pass through
    both heads and the compositing, its mean distance below half the gap's
    mean and none beyond the gap's largest (measured at most 30 % and
    62 %; the exact path's border points of the render tests add theirs).
  * The CLI at its defaults: ``test_torch_port_shipped_cli.py``.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_shipped.py -q
"""
import contextlib
import os
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu import config as jax_config
from uforecon_tpu.models.uforecon import UFORecon as JaxUFORecon
from uforecon_tpu.ops import grid_sample as jgs
from uforecon_tpu.ops import kernel_precision as jkp
from uforecon_tpu.ops import volume_merge as jvm

from uforecon_tpu_torch import config
from uforecon_tpu_torch.convert import init_weights, load_flax_variables
from uforecon_tpu_torch.models.uforecon import EncoderOutputs, SceneInputs, UFORecon
from uforecon_tpu_torch.ops import cuda_build
from uforecon_tpu_torch.ops import fused_point_head as pph
from uforecon_tpu_torch.ops import fused_point_head2 as pph2
from uforecon_tpu_torch.ops import fused_ray_head as prh
from uforecon_tpu_torch.ops import volume_merge as pvm
from uforecon_tpu_torch.pipeline import trainer

from helpers import make_synthetic_scene
from test_torch_port_kernels import _neus_case, _point_case, _port_params, _ray_case, _t

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
KNOBS = ("volume_merge", "merge_depth", "merge_pad", "merge_max_bytes", "volume_dtype",
         "image_gather_dtype", "kernel_precision")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _subprocess(code, *args):
    return subprocess.Popen(
        [sys.executable, "-c", code, *map(str, args)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "UFO_PLATFORM": "cpu",
             "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])})


def _wait(proc, timeout=900):
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]


# ---------------------------------------------------------------------------
# Config


def test_knob_defaults_and_values_are_the_jax_ones():
    port, jax_cfg = config.Config(), jax_config.Config()
    for name in KNOBS:
        assert getattr(port, name) == getattr(jax_cfg, name), name
    values = {"volume_merge": ("auto", "always", "never"),
              "image_gather_dtype": ("float32", "bfloat16"),
              "kernel_precision": ("auto", "highest", "high", "fast")}
    for name, accepted in values.items():
        for v in accepted:
            config.Config(**{name: v})
            jax_config.Config(**{name: v})
        for pkg in (config, jax_config):
            with pytest.raises(ValueError, match=name):
                pkg.Config(**{name: "bogus"})
    # JAX does not validate volume_dtype (any value but float32 stores
    # bf16); the port takes the two it names and refuses the rest
    for v in ("float32", "bfloat16"):
        config.Config(volume_dtype=v)
    with pytest.raises(ValueError, match="volume_dtype"):
        config.Config(volume_dtype="float16")


@pytest.mark.parametrize("extract,knob,want", [
    (True, "auto", "fast"), (False, "auto", "high"), (True, "highest", "highest"),
    (False, "fast", "fast"), (True, "high", "high")])
def test_auto_precision_resolves_by_path(extract, knob, want):
    """JAX's rule (models/uforecon.py:79-90), per model: a model and its
    with_knobs copy resolve apart."""
    cfg = config.Config(extract_geometry=extract, kernel_precision=knob)
    assert config.resolve_kernel_precision(cfg) == want
    model = UFORecon(cfg)
    assert model.kernel_precision == want
    other = model.with_knobs(kernel_precision="highest")
    assert other.kernel_precision == "highest" and model.kernel_precision == want


@pytest.mark.parametrize("nv,merged", [(3, True), (4, False)])
def test_merge_guard_picks_the_jax_path_at_800x640(nv, merged):
    """JAX's byte count of its corner-packed merged volume against 6 GiB:
    4.9 GB at 3 views of 800x640 (merged), 6.6 GB at 4 (exact); the port's
    own unpacked volume is 8x smaller."""
    cfg = config.Config(extract_geometry=True)
    n_bytes = config.merge_guard_bytes(cfg, nv, 640, 800)
    assert n_bytes == nv * 8 * 640 * 800 * 8 * 25 * 2
    assert config.use_volume_merge(cfg, nv, 640, 800) is merged
    assert config.use_volume_merge(config.Config(extract_geometry=True, merge_max_bytes=0),
                                   nv, 640, 800)
    # 'always' ignores the guard, training takes 'auto' as off, and
    # merge_pad counts the JAX pack's 256-lane rows
    assert config.use_volume_merge(config.Config(volume_merge="always"), 5, 640, 800)
    assert not config.use_volume_merge(config.Config(), 3, 640, 800)
    padded = config.Config(extract_geometry=True, merge_pad=True)
    assert config.merge_guard_bytes(padded, nv, 640, 800) == n_bytes * 256 // 200


def test_auto_merge_falls_back_by_the_guard_with_a_warning():
    scene, _ = make_synthetic_scene(n_views=3, h=32, w=32, ndepth=16)
    cfg = config.Config(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"),
                        extract_geometry=True, merge_max_bytes=1000)
    model = UFORecon(cfg)
    init_weights(model, 0)
    model.requires_grad_(False)
    with pytest.warns(UserWarning, match="merge_max_bytes"):
        enc = model.encode(_port_scene(scene))
    assert set(enc.volumes) == {"stage1", "stage2", "stage3"}
    assert all(v.dtype == torch.bfloat16 for v in enc.volumes.values())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        enc = model.with_knobs(merge_max_bytes=6 << 30).encode(_port_scene(scene))
    assert set(enc.volumes) == {"merged"} and enc.volumes["merged"].shape == (3, 25, 8, 32, 32)


def test_trainer_refuses_fast():
    """As the JAX trainer (pipeline/trainer.py:108-114); 'auto' resolves to
    'high' in training."""
    scene, extras = make_synthetic_scene(n_views=3, h=32, w=32, ndepth=16)
    cfg = config.Config(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"))
    model = UFORecon(cfg)
    assert model.kernel_precision == "high"
    for knobs in (dict(kernel_precision="fast"), dict(extract_geometry=True)):
        with pytest.raises(ValueError, match="inference-only"):
            trainer.grad_step(model.cfg, model.with_knobs(**knobs), _port_scene(scene),
                              _t(extras["ray_d"][:4]), torch.zeros(4, 3), torch.zeros(4))


def test_pack_cache_keys_the_precision():
    """A with_knobs copy shares its weights: without the precision in the
    key it would get the other precision's pack."""
    inputs, params = _point_case(np.random.default_rng(0))
    p = _port_params(pph.PointHeadParams, params)
    before = pph.point_head.pack_builds
    high = pph.cached_pack_weights(p, "high")
    fast = pph.cached_pack_weights(p, "fast")
    assert pph.point_head.pack_builds == before + 2
    assert pph.cached_pack_weights(p, "fast") is fast and pph.cached_pack_weights(p) is high
    assert pph.point_head.pack_builds == before + 2
    torch.testing.assert_close(fast, pph.pack_weights(p, "fast"), rtol=0, atol=0)
    # the fast kernel's pack is its weight image; the streamed kernel's
    # (past 11 views) a third entry, in the 3xTF32 pack's layout
    assert torch.equal(fast, pph.fast_image(p))
    streamed = pph.cached_pack_weights(p, "fast", streamed=True)
    assert pph.cached_pack_weights(p, "fast", streamed=True) is streamed
    assert pph.point_head.pack_builds == before + 3
    assert not torch.equal(high, streamed) and high.numel() == streamed.numel()
    # bf16 values, then a zero plane where the lo plane was
    c = 80
    wq = streamed[c:c + 2 * c * c]
    assert torch.equal(wq[:c * c], cuda_build.bf16_round(p.wq.t().reshape(-1)))
    assert not wq[c * c:].any()
    with pytest.raises(ValueError, match="precision"):
        pph.cached_pack_weights(p, "auto")


def test_fast_pack2_carries_the_radiance_bias_in_float32():
    """The split pack's radiance bias rows: three bf16 rows that sum to the
    float32 bias in fast, the bias and zeros in 3xTF32."""
    _, params = _point_case(np.random.default_rng(1))
    p = _port_params(pph.PointHeadParams, params)
    lay = pph2.layout2(80, 32, 24, 16)
    rows = slice(40 + 3, 40 + 3 + pph2.BIAS_ROWS)
    for prec in ("high", "fast"):
        v_rad = pph2.split_weights2(p, precision=prec)["v_rad"][rows]
        if prec == "fast":
            assert torch.equal(v_rad, cuda_build.bf16_round(v_rad))
            torch.testing.assert_close(v_rad.double().sum(0), p.rad_b[0].double(),
                                       rtol=0, atol=1e-7)
        else:
            assert torch.equal(v_rad[0], p.rad_b[0]) and not v_rad[1:].any()
        assert pph2.pack_weights2(p, precision=prec).numel() == lay["total"][0]


# ---------------------------------------------------------------------------
# Ops against the JAX package


def _cl(x):  # port channel-first (NV, C, D, H, W) -> JAX channel-last
    return np.moveaxis(np.asarray(x, np.float32), 1, -1)


def _resampled_alike(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(8, 8), (1, 5), (4, 9), (16, 8), (5, 32)])
def test_resize_axis_linear_ac_matches_jax(n_in, n_out):
    vol = np.random.default_rng(n_in * 100 + n_out).standard_normal(
        (2, 3, n_in, 4, 5)).astype(np.float32)
    got = pvm.resize_axis_linear_ac(_t(vol), 2, n_out).numpy()
    want = np.asarray(jvm.resize_axis_linear_ac(jnp.asarray(_cl(vol)), 1, n_out))
    if n_in == n_out:
        assert np.array_equal(got, vol) and np.array_equal(want, _cl(vol))
    _resampled_alike(_cl(got), want)


def _stage_volumes(rng, nv=2, hw=(16, 20)):
    """feat||weight stage volumes at the cascade's three resolutions, the
    last at the common grid (8, h, w)."""
    h, w = hw
    fws = {}
    for stage, (d, s) in zip(("stage1", "stage2", "stage3"), ((12, 4), (6, 2), (8, 1))):
        fw = rng.standard_normal((nv, 9, d, h // s, w // s)).astype(np.float32)
        fw[:, 8] = rng.uniform(size=fw[:, 8].shape)
        fws[stage] = fw
    return fws


def test_resize_trilinear_ac_matches_jax():
    fw = _stage_volumes(np.random.default_rng(3))["stage1"]
    got = pvm.resize_trilinear_ac(_t(fw), (8, 16, 20)).numpy()
    want = np.asarray(jvm.resize_trilinear_ac(jnp.asarray(_cl(fw)), (8, 16, 20)))
    _resampled_alike(_cl(got), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_stage_volumes_matches_jax(dtype):
    fws = _stage_volumes(np.random.default_rng(4))
    got = pvm.merge_stage_volumes({k: _t(v) for k, v in fws.items()}, 8, (16, 20),
                                  getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 25, 8, 16, 20)
    packed = jvm.merge_stage_volumes({k: jnp.asarray(_cl(v)) for k, v in fws.items()}, 8,
                                     (16, 20), dtype=getattr(jnp, dtype))
    want = np.asarray(packed[..., :25].astype(jnp.float32))   # corner (0, 0, 0)
    got = _cl(got.float())
    # stage 3's grid is the common one: its features are copied, bit for bit
    assert np.array_equal(got[..., 16:24], want[..., 16:24])
    if dtype == "float32":
        assert np.array_equal(got[..., 16:24], _cl(fws["stage3"])[..., :8])
        _resampled_alike(got, want)
    else:
        # the f32 resamples differ a little and may round to neighbouring
        # bf16 values: one bf16 step apart at most
        close = np.isclose(got, want, rtol=1e-5, atol=1e-5)
        flip = np.abs(got - want) <= 2.0 ** -7 * np.abs(want)
        assert np.all(close | flip) and close.mean() >= 0.99


def test_merge_takes_the_stages_in_order():
    """Insertion order, not sorted names (the JAX sort permutes the
    channels past nine stages)."""
    fws = _stage_volumes(np.random.default_rng(5))
    names = {f"stage{10 - i}": fws[k] for i, k in enumerate(fws)}   # stage10, 9, 8
    got = pvm.merge_stage_volumes({k: _t(v) for k, v in names.items()}, 8, (16, 20),
                                  torch.float32)
    assert torch.equal(got[:, 16:24], _t(fws["stage3"][:, :8]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_merged_volume_matches_jax(dtype):
    rng = np.random.default_rng(6)
    vol = rng.standard_normal((3, 25, 8, 16, 20)).astype(np.float32)
    vol[:, 24] = rng.uniform(size=vol[:, 24].shape)
    vol[:, 24, :, :2] = 0.0                      # weightless cells: the 1e-8 guard
    xyz = rng.uniform(-1.1, 1.1, (3, 6, 7, 3)).astype(np.float32)
    src = _t(vol).to(getattr(torch, dtype))
    got = pvm.query_merged_volume(src, _t(xyz)).numpy()
    packed = jgs.pack_volume_corners(jnp.asarray(_cl(vol)).astype(getattr(jnp, dtype)))
    want = np.asarray(jvm.query_merged_volume(packed, jnp.asarray(xyz), 24))
    assert got.shape == want.shape == (6, 7, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The model in process, kernel_precision='highest'

RN, SAMPLES = 128, 8
BASE = dict(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"), coarse_sample=SAMPLES,
            fine_sample=SAMPLES, test_sample_coarse=SAMPLES, test_sample_fine=SAMPLES,
            kernel_precision="highest")
EXACT = dict(volume_merge="never", volume_dtype="float32", image_gather_dtype="float32")
CASES = {
    "merge": dict(EXACT, volume_merge="always"),
    "merge_bf16_volume": dict(EXACT, volume_merge="always", volume_dtype="bfloat16"),
    "bf16_volume": dict(EXACT, volume_dtype="bfloat16"),
    # image_gather_dtype acts under extract_geometry only, in both packages
    "bf16_gather": dict(EXACT, image_gather_dtype="bfloat16", extract_geometry=True),
}
# each case's f32 counterpart, for JAX's own bf16 gap
F32 = {"merge": "merge", "merge_bf16_volume": "merge", "bf16_volume": "exact",
       "bf16_gather": "exact_extract"}


@contextlib.contextmanager
def _jax_mode_scope():
    """The JAX model's setup sets the package's process-wide kernel mode
    from its config. The models here take the flax path on the CPU, which
    reads no mode; the mode is restored afterwards, so that no other test
    of this process runs a JAX kernel in a mode this file chose."""
    saved = jkp._mode, jkp._consumed
    jkp._consumed = False
    try:
        yield
    finally:
        jkp._mode, jkp._consumed = saved


def _port_scene(scene):
    return SceneInputs(**{k: ({s: _t(p) for s, p in v.items()} if isinstance(v, dict)
                              else _t(v)) for k, v in scene._asdict().items()})


def _bridge(jenc) -> EncoderOutputs:
    """JAX encoder outputs in the port's layout: the first corner block of
    each corner-packed volume is the unpacked volume, in its dtype."""
    vols = {}
    for k, v in jenc.volumes.items():
        c = 25 if k == "merged" else 9
        t = torch.as_tensor(np.array(v[..., :c], np.float32)).permute(0, 4, 1, 2, 3)
        vols[k] = t.contiguous().to(torch.bfloat16 if v.dtype == jnp.bfloat16
                                    else torch.float32)
    return EncoderOutputs(source_feats=_t(jenc.source_feats), volumes=vols,
                          aug0=_t(jenc.aug0), aug1=_t(jenc.aug1),
                          mvs_depths=_t(jenc.mvs_depths))


@pytest.fixture(scope="module")
def shipped_pair():
    scene, extras = make_synthetic_scene(n_views=3, h=32, w=32, ndepth=16)
    key = jax.random.PRNGKey(0)
    ray_d = extras["ray_d"][:RN]
    k_c, k_f = jax.random.split(key)
    draws = (jax.random.uniform(k_c, (RN, SAMPLES)), jax.random.uniform(k_f, (RN, SAMPLES)))
    cfgs = {"exact": dict(EXACT), "exact_extract": dict(EXACT, extract_geometry=True),
            **CASES}
    jax_runs = {}
    with _jax_mode_scope():
        model = JaxUFORecon(jax_config.Config(**BASE, volume_type="correlation", **EXACT))
        variables = jax.jit(model.init)(key, scene, ray_d[:4], key)
        for name, knobs in cfgs.items():
            m = JaxUFORecon(jax_config.Config(**BASE, volume_type="correlation", **knobs))
            enc = m.apply(variables, scene, method=m.encode)
            out = m.apply(variables, scene, enc, ray_d, key, method=m.render_chunk)
            jax_runs[name] = (enc, _np(out))
    port = UFORecon(config.Config(**BASE))
    load_flax_variables(port, _np(variables))
    port.requires_grad_(False)
    return dict(port=port, scene=_port_scene(scene), ray_d=_t(ray_d),
                draws=tuple(map(_t, draws)), jax=jax_runs, cfgs=cfgs,
                jax_call=(_np(variables), _np(scene), ray_d, key))


def _agree(got, want, gap):
    """Within 1e-5, or within twice JAX's own bf16 gap at the element."""
    return np.isclose(got, want, **TOL) | (np.abs(got - want) <= 2 * gap + TOL["atol"])


@pytest.mark.parametrize("case", list(CASES))
def test_encode_matches_jax(shipped_pair, case):
    sp = shipped_pair
    enc = sp["port"].with_knobs(**sp["cfgs"][case]).encode(sp["scene"])
    jenc = sp["jax"][case][0]
    assert set(enc.volumes) == set(jenc.volumes)
    bf16 = sp["cfgs"][case]["volume_dtype"] == "bfloat16"
    for k, vol in enc.volumes.items():
        assert vol.dtype == (torch.bfloat16 if bf16 else torch.float32)
        want = _bridge(jenc).volumes[k].float().numpy()
        got = vol.float().numpy()
        gap = np.abs(want - _bridge(sp["jax"][F32[case]][0]).volumes[k].float().numpy())
        # a cell downstream of a winner-take-all pixel that flipped in the
        # matcher differs: test_torch_port_slice.py holds the stage volumes
        # to 1e-4 on >= 99 %; here also where a bf16 rounding flips
        ok = np.isclose(got, want, rtol=1e-4, atol=1e-4) | (np.abs(got - want)
                                                           <= 2 * gap + 1e-4)
        assert ok.mean() >= 0.99, (k, ok.mean())


def _check_chunk(out, want, gap, tol_ok, share):
    for phase in ("coarse", "fine"):
        for key in ("depth", "rgb", "opacity"):
            got = out[phase][key].numpy()
            assert np.all(np.isfinite(got))
            ok = tol_ok(got, want[phase][key], gap[phase][key]).reshape(RN, -1).all(axis=1)
            assert ok.mean() >= share, (phase, key, ok.mean())


@pytest.mark.parametrize("encoder", ["jax", "port"])
@pytest.mark.parametrize("case", list(CASES))
def test_render_chunk_matches_jax(shipped_pair, case, encoder):
    """From the JAX encoding (the render alone) at 1e-5 or the bf16 flip
    rule; from the port's own encoding (the whole slice) at the exact
    path's 2e-4."""
    sp = shipped_pair
    model = sp["port"].with_knobs(**sp["cfgs"][case])
    jenc, want = sp["jax"][case]
    enc = _bridge(jenc) if encoder == "jax" else model.encode(sp["scene"])
    out = model.render_chunk(sp["scene"], enc, sp["ray_d"], u_coarse=sp["draws"][0],
                             u_fine=sp["draws"][1])
    ref = sp["jax"][F32[case]][1]
    gap = {ph: {k: np.abs(want[ph][k] - ref[ph][k]) for k in want[ph]} for ph in want}
    if encoder == "jax":
        _check_chunk(out, want, gap, _agree, 0.99)
    else:
        _check_chunk(out, want, gap, lambda a, b, g: np.isclose(a, b, rtol=2e-4, atol=2e-4)
                     | (np.abs(a - b) <= 2 * g + 2e-4), 0.99)


def test_merged_chunk_skips_the_fusion_kernel(shipped_pair, monkeypatch):
    """The merged query fuses by itself: the volume-fusion wrapper is not
    called, whatever fused_volume_fusion says (as in JAX)."""
    from uforecon_tpu_torch.models import ray_transformer as rt_mod

    sp = shipped_pair
    monkeypatch.setattr(rt_mod, "volume_fusion", lambda *a: pytest.fail("fusion called"))
    model = sp["port"].with_knobs(**sp["cfgs"]["merge"], fused_volume_fusion="always")
    model.render_chunk(sp["scene"], model.encode(sp["scene"]), sp["ray_d"][:8],
                       u_coarse=sp["draws"][0][:8], u_fine=sp["draws"][1][:8])


# ---------------------------------------------------------------------------
# 'fast': the JAX kernels in interpret mode, in a process per mode

_JAX_KERNELS = """
import dataclasses, pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from uforecon_tpu.ops import kernel_precision
path, mode = sys.argv[1], sys.argv[2]
kernel_precision.set_mode(mode)
from uforecon_tpu.config import Config
from uforecon_tpu.models.uforecon import UFORecon
from uforecon_tpu.ops import fused_point_head as fph, fused_point_head2 as fph2
from uforecon_tpu.ops import fused_ray_head as frh
with open(path, "rb") as f:
    d = pickle.load(f)
J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
out = {}
inp, p = J(d["point"][0]), J(d["point"][1])
fm = lambda a: jnp.swapaxes(a, -1, -2)
tok, rad = fph.point_head_fused(fph.PointHeadInputs(
    img_feat=fm(inp["img_feat"]), vol_feat=fm(inp["vol_feat"]), sim_feat=fm(inp["sim_feat"]),
    depth_dist=inp["depth_dist"], dir_rel=fm(inp["dir_rel"]), rgb=fm(inp["rgb"]),
    mask=inp["mask"]), fph.PointHeadParams(**p))
out["point_head"] = (np.asarray(tok).T, np.asarray(rad).T)
out["point_head2"] = tuple(map(np.asarray, fph2.point_head2_fused(
    fph2.PointHeadInputs2(**inp), fph.PointHeadParams(**p))))
for c, (y, rp) in d["ray"].items():
    out[f"ray_head_{c}"] = (np.asarray(frh.ray_head_fused(J(y), frh.RayHeadParams(**J(rp)))),)
y, z, rad_, inv_s, rp = J(d["neus"])
out["ray_head_neus"] = tuple(map(np.asarray, frh.ray_head_neus_fused(
    y, z, rad_, jnp.float32(inv_s), frh.RayHeadParams(**rp))))
cfg, variables, scene, ray_d, key = d["chunk"]
cfg = dataclasses.replace(cfg, fused_point_head="always", kernel_precision=mode)
model = UFORecon(cfg)
enc = model.apply(variables, scene, method=model.encode)
res = model.apply(variables, scene, enc, ray_d, key, method=model.render_chunk)
out["chunk"] = jax.tree_util.tree_map(np.asarray, res)
with open(path, "wb") as f:
    pickle.dump(out, f)
"""


def _j(params):
    return {k: (tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v))
            for k, v in params.items()}


@pytest.fixture(scope="module")
def fast_runs(shipped_pair, tmp_path_factory):
    rng = np.random.default_rng(7)
    point = _point_case(rng, nv=3, n=300)
    ray = {c: _ray_case(rng, rn=6, sn=16, c=c) for c in (88, 72)}
    y, rp = _ray_case(rng, rn=6, sn=16)
    z, rad, inv_s = _neus_case(rng, 6, 16)
    variables, scene, ray_d, key = shipped_pair["jax_call"]
    cfg = jax_config.Config(**BASE, volume_type="correlation", **EXACT)
    data = dict(point=point, ray=ray, neus=(y, z, rad, inv_s, rp),
                chunk=(cfg, variables, scene, np.asarray(ray_d), np.asarray(key)))
    tmp = tmp_path_factory.mktemp("jax_fast")
    procs = {}
    for mode in ("fast", "highest"):
        with open(tmp / mode, "wb") as f:
            pickle.dump(data, f)
        procs[mode] = _subprocess(_JAX_KERNELS, tmp / mode, mode)
    runs = {}
    for mode, proc in procs.items():
        _wait(proc)
        with open(tmp / mode, "rb") as f:
            runs[mode] = pickle.load(f)
    return data, runs


def _fast_twin(name, data):
    inputs, params = data["point"]
    if name.startswith("point_head"):
        inp = pph.PointHeadInputs(**{k: _t(v) for k, v in inputs.items()})
        p = _port_params(pph.PointHeadParams, params)
        fn = pph.point_head if name == "point_head" else pph2.point_head2
        return fn(inp, p, precision="fast")
    if name == "ray_head_neus":
        y, z, rad, inv_s, rp = data["neus"]
        return prh.ray_head_neus(_t(y), _t(z), _t(rad), _t(inv_s),
                                 _port_params(prh.RayHeadParams, rp), precision="fast")
    y, rp = data["ray"][int(name.rsplit("_", 1)[1])]
    return (prh.ray_head(_t(y), _port_params(prh.RayHeadParams, rp), precision="fast"),)


def _like_jax_fast(got, fast, highest, mean_ratio, max_ratio):
    """got against JAX's fast run, by the size of JAX's own bf16 effect
    (fast against highest) on that output; outputs that bf16 does not move
    (a saturated opacity) within 1e-5. Returns the elements within 1e-5."""
    d, gap = np.abs(got - fast), np.abs(fast - highest)
    if gap.max() <= TOL["atol"]:
        np.testing.assert_allclose(got, fast, **TOL)
    else:
        assert d.mean() <= mean_ratio * gap.mean(), (d.mean(), gap.mean())
        assert d.max() <= max_ratio * gap.max(), (d.max(), gap.max())
    return np.isclose(got, fast, **TOL)


@pytest.mark.parametrize("name", ["point_head", "point_head2", "ray_head_88",
                                  "ray_head_72", "ray_head_neus"])
def test_fast_plain_versions_match_the_jax_kernels(fast_runs, name):
    data, runs = fast_runs
    with torch.no_grad():
        got = [t.numpy() for t in _fast_twin(name, data)]
    fast, highest = runs["fast"][name], runs["highest"][name]
    oks = [_like_jax_fast(g, f, h, 0.05, 0.5) for g, f, h in zip(got, fast, highest)]
    assert np.concatenate([o.reshape(-1) for o in oks]).mean() >= 0.97
    # the two modes really differ: fast is not the FP32 function
    assert max(np.abs(f - h).max() for f, h in zip(fast, highest)) > 1e-4


def test_fast_chunk_matches_jax(shipped_pair, fast_runs):
    """A whole render_chunk in fast on the JAX encoding, against JAX's
    render_chunk with its point and ray heads through their kernels in
    fast."""
    sp = shipped_pair
    _, runs = fast_runs
    jenc = sp["jax"]["exact"][0]
    model = sp["port"].with_knobs(**EXACT, kernel_precision="fast")
    out = model.render_chunk(sp["scene"], _bridge(jenc), sp["ray_d"],
                             u_coarse=sp["draws"][0], u_fine=sp["draws"][1])
    fast, highest = runs["fast"]["chunk"], runs["highest"]["chunk"]
    for phase in ("coarse", "fine"):
        for key in ("depth", "rgb", "opacity"):
            got = out[phase][key].numpy()
            assert np.all(np.isfinite(got))
            _like_jax_fast(got, fast[phase][key], highest[phase][key], 0.5, 1.0)
