"""The PyTorch port's depth-render slice against the JAX package.

One tiny scene (3 views, 32x32, 16 hypotheses, cascade depths 8/8/8,
one FMT self/cross pair, 8 coarse + 8 fine samples) goes through the JAX
model (flax init, eager encode and render_chunk, on the CPU) and through
the port with the same weights (load_flax_variables) and the same uniform
draws. The JAX side is built once per module: its init plus eager forward
is the slow part of this file.

The port renders the chunk through its point-head route (the default)
and through its view-transformer route (``fused_point_head='never'``);
on the CPU the JAX model takes its flax view transformer, so its render is
the reference for both.

The same chunk is rendered again with the three render-glue knobs on
(``fused_similarity``, ``fused_volume_fusion``, ``fused_neus_epilogue``):
against the JAX model with the route's four Pallas kernels forced on
(grouped cosine, volume fusion, point head, ray head with the NeuS
epilogue; interpret mode, ``kernel_precision='highest'``, ~25 s in a
process of its own), and against the port with the knobs off on the same
loaded weights.

Tolerances: encoder features at 1e-4 (f32 with another summation order
through ~20 layers); mvs_depths on >= 99% of pixels (winner-take-all
argmax ties flip isolated pixels); coarse depth and rgb at rtol = atol =
2e-4 (as the JAX fused-kernel tests); fine outputs on >= 99% of rays (a
~1e-7 difference can flip an importance-sampling CDF bin of one ray).
"""
import inspect
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

from uforecon_tpu.config import Config as JaxConfig
from uforecon_tpu.models.uforecon import UFORecon as JaxUFORecon

from uforecon_tpu_torch.config import EXACT, FUSED_GLUE, Config
from uforecon_tpu_torch.convert import load_flax_variables
from uforecon_tpu_torch.models.uforecon import EncoderOutputs, SceneInputs, UFORecon

from helpers import make_synthetic_scene

torch.set_num_threads(1)

RN = 128      # rays in the rendered chunk
SAMPLES = 8


def _jax_cfg():
    return JaxConfig(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"),
                     coarse_sample=SAMPLES, fine_sample=SAMPLES,
                     volume_type="correlation", volume_merge="never",
                     volume_dtype="float32", image_gather_dtype="float32")


def _port_cfg():
    return Config(ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"),
                  coarse_sample=SAMPLES, fine_sample=SAMPLES, **EXACT)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


@pytest.fixture(scope="module")
def slice_pair():
    scene, extras = make_synthetic_scene(n_views=3, h=32, w=32, ndepth=16)
    model = JaxUFORecon(_jax_cfg())
    key = jax.random.PRNGKey(0)
    ray_d = extras["ray_d"][:RN]
    variables = jax.jit(model.init)(key, scene, ray_d[:4], key)
    # eager applies, as the JAX package's fused-kernel tests do
    enc = model.apply(variables, scene, method=model.encode)
    out = model.apply(variables, scene, enc, ray_d, key, method=model.render_chunk)
    k_coarse, k_fine = jax.random.split(key)
    u_c = jax.random.uniform(k_coarse, (RN, SAMPLES), jnp.float32)
    u_f = jax.random.uniform(k_fine, (RN, SAMPLES), jnp.float32)

    port = UFORecon(_port_cfg())
    load_flax_variables(port, _np_tree(variables))
    port.requires_grad_(False)   # the render path: no autograd graph
    p_scene = SceneInputs(
        **{k: ({s: _t(p) for s, p in v.items()} if isinstance(v, dict) else _t(v))
           for k, v in scene._asdict().items()})
    p_enc = port.encode(p_scene)
    return dict(jax_enc=_np_tree(enc), jax_out=_np_tree(out), port=port,
                scene=p_scene, port_enc=p_enc, ray_d=_t(ray_d),
                u_c=_t(u_c), u_f=_t(u_f),
                jax_call=(variables, scene, enc, ray_d, key))


# The JAX render_chunk with all four Pallas kernels of the route on:
# grouped cosine, volume fusion, the point head and the ray head with the
# NeuS epilogue, in interpret mode at exact f32. It runs in a process of its
# own: the JAX package keeps one kernel-precision mode per process.
_JAX_FUSED_RENDER = """
import dataclasses, pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
from uforecon_tpu.models.uforecon import UFORecon
path = sys.argv[1]
with open(path, "rb") as f:
    cfg, variables, scene, enc, ray_d, key = pickle.load(f)
cfg = dataclasses.replace(cfg, fused_similarity="always", fused_volume_fusion="always",
                          fused_point_head="always", fused_neus_epilogue="auto",
                          kernel_precision="highest")
model = UFORecon(cfg)
out = model.apply(variables, scene, enc, ray_d, key, method=model.render_chunk)
with open(path, "wb") as f:
    pickle.dump(jax.tree_util.tree_map(lambda a: jax.device_get(a), out), f)
"""


@pytest.fixture(scope="module")
def jax_out_fused(slice_pair, tmp_path_factory):
    variables, scene, enc, ray_d, key = slice_pair["jax_call"]
    path = tmp_path_factory.mktemp("jax_fused") / "io.pkl"
    with open(path, "wb") as f:
        pickle.dump((_jax_cfg(), *_np_tree((variables, scene, enc, ray_d, key))), f)
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", _JAX_FUSED_RENDER, str(path)],
                         capture_output=True, text=True, timeout=600, cwd=root,
                         env={**os.environ, "JAX_PLATFORMS": "cpu",
                              "PYTHONPATH": os.pathsep.join(
                                  [str(root), os.environ.get("PYTHONPATH", "")])})
    assert res.returncode == 0, res.stderr[-3000:]
    with open(path, "rb") as f:
        return _np_tree(pickle.load(f))


def _bridge_encoder(jenc) -> EncoderOutputs:
    """JAX encoder outputs in the port's layout: the first corner block of
    each corner-packed (NV, D, h, w, 72) volume is the unpacked volume."""
    vols = {k: _t(v[..., :9]).permute(0, 4, 1, 2, 3).contiguous()
            for k, v in jenc.volumes.items()}
    return EncoderOutputs(source_feats=_t(jenc.source_feats), volumes=vols,
                          aug0=_t(jenc.aug0), aug1=_t(jenc.aug1),
                          mvs_depths=_t(jenc.mvs_depths))


@pytest.mark.parametrize("name", ["source_feats", "aug0", "aug1"])
def test_encoder_features_match_jax(slice_pair, name):
    got = getattr(slice_pair["port_enc"], name).numpy()
    want = getattr(slice_pair["jax_enc"], name)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_encoder_volumes_match_jax(slice_pair, stage):
    got = slice_pair["port_enc"].volumes[stage].numpy()
    want = _bridge_encoder(slice_pair["jax_enc"]).volumes[stage].numpy()
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4)
    # a volume cell downstream of a flipped winner-take-all pixel differs
    assert close.mean() >= 0.99, close.mean()


def test_encoder_mvs_depths_match_jax(slice_pair):
    got = slice_pair["port_enc"].mvs_depths.numpy()
    want = slice_pair["jax_enc"].mvs_depths
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()


def _check_render(out, ref, encoder):
    coarse_tol = dict(rtol=2e-4, atol=2e-4)
    if encoder == "port":
        # rays through a flipped winner-take-all pixel see another depth PE
        for key in ("depth", "rgb"):
            ok = np.isclose(out["coarse"][key].numpy(), ref["coarse"][key],
                            **coarse_tol).reshape(RN, -1).all(axis=1)
            assert ok.mean() >= 0.99, (key, ok.mean())
    else:
        np.testing.assert_allclose(out["coarse"]["depth"].numpy(),
                                   ref["coarse"]["depth"], **coarse_tol)
        np.testing.assert_allclose(out["coarse"]["rgb"].numpy(),
                                   ref["coarse"]["rgb"], **coarse_tol)
    for key in ("depth", "rgb", "opacity"):
        got = out["fine"][key].numpy()
        assert np.all(np.isfinite(got))
        ok = np.isclose(got, ref["fine"][key], **coarse_tol).reshape(RN, -1).all(axis=1)
        assert ok.mean() >= 0.99, (key, ok.mean())


@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_render_chunk_matches_jax(slice_pair, encoder):
    """render_chunk with the JAX draws, on the JAX encoder outputs (the
    render path alone) and on the port's own (the whole slice)."""
    sp = slice_pair
    enc = _bridge_encoder(sp["jax_enc"]) if encoder == "jax" else sp["port_enc"]
    out = sp["port"].render_chunk(sp["scene"], enc, sp["ray_d"],
                                  u_coarse=sp["u_c"], u_fine=sp["u_f"])
    _check_render(out, sp["jax_out"], encoder)


@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_render_chunk_knobs_on_matches_jax(slice_pair, jax_out_fused, encoder):
    """The knobs-on route against the JAX model with its glue kernels on."""
    sp = slice_pair
    enc = _bridge_encoder(sp["jax_enc"]) if encoder == "jax" else sp["port_enc"]
    out = sp["port"].with_knobs(**FUSED_GLUE).render_chunk(
        sp["scene"], enc, sp["ray_d"], u_coarse=sp["u_c"], u_fine=sp["u_f"])
    assert set(out["coarse"]) == set(out["fine"]) >= {"rgb", "depth", "opacity",
                                                     "weight", "srdf"}
    _check_render(out, jax_out_fused, encoder)


@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_render_chunk_view_route_matches_jax(slice_pair, encoder):
    """The per-point stage through the view transformer
    (``fused_point_head='never'``) against the JAX model, which takes its
    flax view transformer on the CPU: the fixture's JAX render is this
    route's reference."""
    sp = slice_pair
    enc = _bridge_encoder(sp["jax_enc"]) if encoder == "jax" else sp["port_enc"]
    out = sp["port"].with_knobs(fused_point_head="never").render_chunk(
        sp["scene"], enc, sp["ray_d"], u_coarse=sp["u_c"], u_fine=sp["u_f"])
    _check_render(out, sp["jax_out"], encoder)


def test_knobs_read_the_same_weights(slice_pair):
    """The fused routes need no other weights: one load_flax_variables,
    rendered with the knobs off and on, gives the same chunk (on the CPU
    both routes run the same plain versions)."""
    sp = slice_pair
    args = (sp["scene"], sp["port_enc"], sp["ray_d"])
    draws = dict(u_coarse=sp["u_c"], u_fine=sp["u_f"])
    off = sp["port"].render_chunk(*args, **draws)
    on = sp["port"].with_knobs(**FUSED_GLUE).render_chunk(*args, **draws)
    for phase in ("coarse", "fine"):
        for key in ("rgb", "depth", "opacity", "weight", "srdf"):
            torch.testing.assert_close(on[phase][key], off[phase][key],
                                       rtol=0, atol=0, msg=f"{phase} {key}")


@pytest.mark.parametrize("entry", ["scene_inputs_from_sample", "SceneRenderer",
                                   "extract_geometry_for_dataset"])
def test_entry_points_default_to_the_card(tmp_path, monkeypatch, entry):
    """Called without a device, the entry points ask for the CUDA card and,
    where there is none, raise instead of running on the CPU."""
    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.pipeline.extract import extract_geometry_for_dataset
    from uforecon_tpu_torch.pipeline.renderer import SceneRenderer

    from helpers import make_synthetic_sample

    fn = {"scene_inputs_from_sample": scene_inputs_from_sample,
          "SceneRenderer": SceneRenderer,
          "extract_geometry_for_dataset": extract_geometry_for_dataset}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sample = make_synthetic_sample(n_views=3, h=32, w=32, ndepth=16, start_idx=0)
    model = UFORecon(_port_cfg())
    call = {"scene_inputs_from_sample": lambda: fn(sample),
            "SceneRenderer": lambda: fn(model),
            "extract_geometry_for_dataset":
                lambda: fn(model, [sample], out_dir=str(tmp_path))}[entry]
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        call()
    assert not (tmp_path / "depth").exists()


# every module of the port, the CLIs included
PORT_MODULES = [
    "uforecon_tpu_torch.pipeline.extract", "uforecon_tpu_torch.convert",
    "uforecon_tpu_torch.config", "uforecon_tpu_torch.data.io",
    "uforecon_tpu_torch.data.image", "uforecon_tpu_torch.data.scene_build",
    "uforecon_tpu_torch.data.dtu_test", "uforecon_tpu_torch.data.torch_ckpt",
    "uforecon_tpu_torch.ops.camera", "uforecon_tpu_torch.fusion.tsdf",
    "uforecon_tpu_torch.fusion.marching", "uforecon_tpu_torch.fusion.depth_fusion",
    "uforecon_tpu_torch.postproc.raycast", "uforecon_tpu_torch.postproc.clean_mesh",
    "uforecon_tpu_torch.eval.dtu_eval", "uforecon_tpu_torch.cli.run",
    "uforecon_tpu_torch.cli.tsdf_fusion", "uforecon_tpu_torch.cli.depth_fusion",
    "uforecon_tpu_torch.cli.clean_mesh", "uforecon_tpu_torch.cli.dtu_eval",
    "uforecon_tpu_torch.script.make_dtu_fixture", "chip_smoke",
]


def test_port_imports_without_jax():
    """The port's modules and chip_smoke.py import where importing jax, the
    JAX package, OpenCV or PIL raises."""
    blocked = ["jax", "uforecon_tpu", "cv2", "PIL"]
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in blocked)
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + f"assert not set({blocked!r}) & {{k for k, v in sys.modules.items() "
              "if v is not None}")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=Path(__file__).resolve().parent.parent)
    assert res.returncode == 0, res.stderr


def test_scene_inputs_from_sample_matches_jax():
    from uforecon_tpu.data.convert import scene_inputs_from_sample as jax_convert
    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample

    from helpers import make_synthetic_sample

    sample = make_synthetic_sample(n_views=3, h=32, w=32, ndepth=16, start_idx=0)
    ref, ref_extras = jax_convert(sample)
    got, extras = scene_inputs_from_sample(sample, device="cpu")
    for name, want in ref._asdict().items():
        have = getattr(got, name)
        if isinstance(want, dict):
            for k in want:
                np.testing.assert_array_equal(have[k].numpy(), np.asarray(want[k]))
        else:
            np.testing.assert_array_equal(have.numpy(), np.asarray(want), err_msg=name)
    for k in ("ray_d", "cam_ray_d", "scale_mat", "extrinsic_render_view",
              "intrinsic_render_view"):
        np.testing.assert_array_equal(extras[k], ref_extras[k])
    assert tuple(extras["hw"]) == tuple(ref_extras["hw"])


def test_extract_writes_the_depth_layout(tmp_path):
    """The port's entry point on a tiny dataset: the .npy layout that
    tsdf_fusion.py reads, a finite depth map of the image's shape, optional
    previews, and seeded reproducibility."""
    from uforecon_tpu_torch.convert import init_weights
    from uforecon_tpu_torch.pipeline.extract import extract_geometry_for_dataset

    from helpers import make_synthetic_sample

    sample = make_synthetic_sample(n_views=3, h=32, w=32, ndepth=16, start_idx=0)
    model = UFORecon(_port_cfg())
    init_weights(model, seed=0)
    depths = []
    for run in range(2):
        out = tmp_path / str(run)
        stats = extract_geometry_for_dataset(model, [sample], out_dir=str(out),
                                             device="cpu", seed=3,
                                             previews=(run == 0))
        assert stats["views"] == 1 and stats["rays"] == 32 * 32
        saved = np.load(out / "depth" / "scanS" / "00000000.npy", allow_pickle=True).item()
        assert set(saved) == {"depth", "extrinsic", "intrinsic"}
        assert saved["depth"].shape == (32, 32)
        assert np.all(np.isfinite(saved["depth"]))
        depths.append(saved["depth"])
    assert (tmp_path / "0" / "scanS" / "depth" / "00000000.png").exists()
    assert (tmp_path / "0" / "rgb" / "scanS" / "00000000.png").exists()
    assert not (tmp_path / "1" / "rgb").exists()
    np.testing.assert_array_equal(depths[0], depths[1])


def test_renderer_pads_rays_to_whole_chunks():
    """1000 rays in 384-ray chunks are edge-padded to 1152 and cut back to
    1000 finite outputs."""
    from uforecon_tpu_torch.convert import init_weights
    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.pipeline.renderer import SceneRenderer

    from helpers import make_synthetic_sample

    sample = make_synthetic_sample(n_views=3, h=32, w=32, ndepth=16, start_idx=0)
    model = UFORecon(_port_cfg())
    init_weights(model, seed=0)
    scene, extras = scene_inputs_from_sample(sample, device="cpu")
    enc = model.encode(scene)
    n = 1000
    near = np.full(n, float(scene.near), np.float32)
    far = np.full(n, float(scene.far), np.float32)
    out = SceneRenderer(model, device="cpu", chunk=384).render_rays(
        scene, enc, extras["ray_d"][:n], near, far, torch.Generator().manual_seed(0))
    assert out["rgb"].shape == (n, 3)
    assert out["depth"].shape == (n,) and out["opacity"].shape == (n,)
    assert np.all(np.isfinite(out["depth"]))


def test_previews_without_pil_raise_a_clear_error(tmp_path, monkeypatch):
    """The previews no longer need PIL (or OpenCV): with both unimportable,
    save_depth_outputs writes the .npy and, with previews, the depth and rgb
    previews as PNGs that decode to what was asked."""
    from uforecon_tpu_torch.data.image import read_png
    from uforecon_tpu_torch.pipeline.extract import save_depth_outputs

    depth = np.arange(20, dtype=np.float32).reshape(4, 5)
    rgb = np.linspace(0, 1, 60, dtype=np.float32).reshape(4, 5, 3)
    args = (str(tmp_path), "scanS", "00000000", depth, rgb, np.eye(4), np.eye(3))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    save_depth_outputs(*args, previews=False)          # .npy only
    assert (tmp_path / "depth" / "scanS" / "00000000.npy").exists()
    assert not (tmp_path / "rgb").exists()
    save_depth_outputs(*args, previews=True)
    np.testing.assert_array_equal(
        read_png(tmp_path / "scanS" / "depth" / "00000000.png"),
        (depth / depth.max() * 255).astype(np.uint8))
    np.testing.assert_array_equal(read_png(tmp_path / "rgb" / "scanS" / "00000000.png"),
                                  (rgb * 255).astype(np.uint8))
