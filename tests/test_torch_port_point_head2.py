"""The port's split-weight point head (``point_head='v2'``) against the JAX
package.

``point_head2_reference`` is what the CUDA kernel (``csrc/point_head2.cu``)
is held to on the card, so here it is held to the JAX
``point_head2_reference`` on the same numpy inputs (C 80, 2/3/5 views) and
to the JAX Pallas kernel ``point_head2_fused`` run in interpret mode at the
JAX test's small widths. The kernel cannot run here, so a plain
transcription of its split algebra, which reads ``pack_weights2``'s buffer
through ``layout2``, is held to the plain version: a wrong row slice or
orientation of the split shows on the CPU. ``render_chunk`` with
``with_knobs(point_head="v2")`` is held to the JAX render of
``test_torch_port_slice.py``'s fixture (on the CPU both routes compute the
same function), and the knob's routing is checked.

Tolerances: 1e-5 for the plain versions and the transcription (f32,
another summation order); the interpret-mode kernel at
``helpers.fused_fwd_tol()`` (as the JAX package's own test of it);
render_chunk as in ``test_torch_port_slice.py``.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_point_head2.py -q
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uforecon_tpu.ops import fused_point_head as jph
from uforecon_tpu.ops import fused_point_head2 as jph2

from uforecon_tpu_torch.config import Config
from uforecon_tpu_torch.models import ray_transformer as rt_mod
from uforecon_tpu_torch.models.ray_transformer import RayTransformer
from uforecon_tpu_torch.ops import fused_point_head as pph
from uforecon_tpu_torch.ops import fused_point_head2 as pph2

from test_torch_port_kernels import _point_case, _port_params, _t
from test_torch_port_slice import (_bridge_encoder, _check_render,  # noqa: F401
                                   slice_pair)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TESTS = Path(__file__).resolve().parent


def _jax_params(params):
    return jph.PointHeadParams(**{k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
                                      else jnp.asarray(v)) for k, v in params.items()})


def _port_inputs(inputs):
    return pph2.PointHeadInputs2(**{k: _t(v) for k, v in inputs.items()})


@pytest.mark.parametrize("c_vol", [24, 16])
@pytest.mark.parametrize("nv", [2, 3, 5])
def test_point_head2_reference_matches_jax(rng, nv, c_vol):
    inputs, params = _point_case(rng, nv=nv, c_vol=c_vol)
    tok_ref, rad_ref = jph2.point_head2_reference(
        jph2.PointHeadInputs2(**{k: jnp.asarray(v) for k, v in inputs.items()}),
        _jax_params(params))
    tok, rad = pph2.point_head2_reference(_port_inputs(inputs),
                                          _port_params(pph.PointHeadParams, params))
    np.testing.assert_allclose(tok.numpy(), np.asarray(tok_ref), **TOL)
    np.testing.assert_allclose(rad.numpy(), np.asarray(rad_ref), **TOL)


# The JAX Pallas kernel point_head2_fused at the small widths of the JAX
# package's own test (tests/test_fused_point_head2.py:_make: C 24, 4 heads,
# 37 points), interpret mode, exact f32 dots. It runs in a process of its
# own: the JAX package keeps one kernel-precision mode per process.
_JAX_V2_FUSED = """
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, sys.argv[2])
from uforecon_tpu.ops import kernel_precision
kernel_precision.set_mode("highest")
from uforecon_tpu.ops import fused_point_head2 as fph2
from helpers import fused_fwd_tol
from test_fused_point_head2 import _make
inp, p = _make(np.random.default_rng(0))
tok, rad = fph2.point_head2_fused(inp, p, n_heads=4)
to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
with open(sys.argv[1], "wb") as f:
    pickle.dump((to_np(inp._asdict()), to_np(p._asdict()), np.asarray(tok),
                 np.asarray(rad), fused_fwd_tol()), f)
"""


@pytest.fixture(scope="module")
def jax_v2_fused(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_v2") / "io.pkl"
    root = TESTS.parent
    res = subprocess.run([sys.executable, "-c", _JAX_V2_FUSED, str(path), str(TESTS)],
                         capture_output=True, text=True, timeout=600, cwd=root,
                         env={**os.environ, "JAX_PLATFORMS": "cpu",
                              "PYTHONPATH": os.pathsep.join(
                                  [str(root), os.environ.get("PYTHONPATH", "")])})
    assert res.returncode == 0, res.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def test_point_head2_reference_matches_jax_kernel(jax_v2_fused):
    inputs, params, tok_f, rad_f, (rtol, atol) = jax_v2_fused
    tok, rad = pph2.point_head2_reference(_port_inputs(inputs),
                                          _port_params(pph.PointHeadParams, params),
                                          n_heads=4)
    assert tok.shape == tok_f.shape == (37, 24) and rad.shape == rad_f.shape == (37, 3)
    np.testing.assert_allclose(tok.numpy(), tok_f, rtol=rtol, atol=atol)
    np.testing.assert_allclose(rad.numpy(), rad_f, rtol=rtol, atol=atol)


def _split_algebra(inp, pack, widths, n_heads=8, tc_mm=None):
    """csrc/point_head2.cu's algebra, written out plainly: every weight
    comes from pack_weights2's buffer at layout2's offsets, a tensor-core
    matrix as the sum of its hi and lo planes. ``widths`` are layout2's (C,
    img, vol, sim16, similarity hidden). ``tc_mm(x, planes)``, given,
    computes the products the kernel runs on the tensor cores from the
    planes (2, in, out) (the tests pass an emulation of 3xTF32)."""
    nv, n, _ = inp.img_feat.shape
    lay = pph2.layout2(*widths)
    assert pack.numel() == lay["total"][0]
    c = widths[0]
    c2, dk = 2 * c, c // n_heads

    def planes(name):
        off, shape = lay[name]
        return pack[off:off + int(np.prod(shape))].reshape(shape)

    def w(name):
        t = planes(name)
        return t[0] + t[1] if name in pph2.TC_MATRICES else t

    def mm(x, name, rows=slice(None)):
        """x @ the tensor-core matrix ``name`` (its rows ``rows``)."""
        if tc_mm is None:
            return x @ w(name)[rows]
        return tc_mm(x, planes(name)[:, rows])

    def ln(x, s, b):
        return F.layer_norm(x, (c,), w(s), w(b), pph.LN_EPS)

    def phi(x):
        return F.elu(x) + 1.0

    s = F.relu(inp.sim_feat @ w("sw0") + w("sb0"))
    s = F.relu(s @ w("sw1") + w("sb1"))
    sim16 = s @ w("sw2") + w("sb2")
    k = torch.arange(8)
    pe = torch.sin(inp.depth_dist[..., None] * (np.pi * 2.0 ** (k // 2)).float()
                   + (k % 2).float() * (np.pi / 2))                       # (NV, P, 8)
    shr = mm(torch.cat([inp.vol_feat, sim16], -1), "sh")                # (P, 5C + 16)
    xv = torch.cat([inp.img_feat, pe], -1)                              # (NV, P, img + pe)
    gv = xv.shape[-1]
    qkv = mm(xv, "v_qkv") + shr[:, :3 * c]                               # (NV, P, 3C)
    tq, tk, tv = w("tok_qkv")
    q = torch.cat([phi(tq).expand(1, n, c), phi(qkv[..., :c])])          # (L, P, C)
    kk = torch.cat([phi(tk).expand(1, n, c), phi(qkv[..., c:2 * c])])
    v = torch.cat([tv.expand(1, n, c), qkv[..., 2 * c:]])
    heads = lambda x: x.reshape(nv + 1, n, n_heads, dk)
    q, kk, v = heads(q), heads(kk), heads(v)
    # each head's 10 channels summed directly
    sc = (q[:, None] * kk[None]).sum(-1)                                 # (L, S, P, H)
    att = (sc[..., None] * v[None]).sum(1) / (sc.sum(1) + pph.EPS)[..., None]
    msg = ln(mm(att.reshape(nv + 1, n, c), "wm"), "n1s", "n1b")
    # the token rows: the message through w1[C:]; the view rows: [img | pe]
    # and the message through the view rows of w1a and w1[C:] at once
    y0 = F.relu(w("w1a_tok") + mm(msg[0], "v_w1", slice(gv, None)))
    yv = F.relu(mm(torch.cat([xv, msg[1:]], -1), "v_w1") + shr[:, 3 * c:3 * c + c2])
    m2 = ln(mm(torch.cat([y0[None], yv]), "w2"), "n2s", "n2b")
    token = w("tok") + m2[0]
    # radiance layer 0 over [img | pe | dir | 1 | 0...] and m2: the 1 takes
    # the bias row of v_rad
    pad = pph2.rad_rows(gv) - gv - 4
    xr = torch.cat([xv, inp.dir_rel, torch.ones(nv, n, 1), torch.zeros(nv, n, pad), m2[1:]], -1)
    z = F.relu(mm(xr, "v_rad") + shr[:, 3 * c + c2:])
    z = F.relu(z @ w("rw1") + w("rb1"))
    z = (z @ w("rw2") + w("rb2"))[..., 0]                                # (NV, P)
    z = torch.where(inp.mask == 0, torch.full_like(z, -1e9), z)
    rad = torch.einsum("vpc,vp->pc", inp.rgb, torch.softmax(z, dim=0))
    return token, rad


@pytest.mark.parametrize("c_vol", [24, 16])
@pytest.mark.parametrize("nv", [2, 3, 5])
def test_split_algebra_of_the_weight_pack_matches_plain(rng, nv, c_vol):
    """At the kernel's widths (C 80: img 32, vol 24, sim16 16, pe 8; with
    the feature grid's vol 16, C 72)."""
    inputs, params = _point_case(rng, nv=nv, c_vol=c_vol)
    inp = _port_inputs(inputs)
    p = _port_params(pph.PointHeadParams, params)
    tok, rad = _split_algebra(inp, pph2.pack_weights2(p), (56 + c_vol, 32, c_vol, 16, 32))
    tok_ref, rad_ref = pph2.point_head2_reference(inp, p)
    torch.testing.assert_close(tok, tok_ref, **TOL)
    torch.testing.assert_close(rad, rad_ref, **TOL)
    # points masked in every view blend the views uniformly, never NaN
    torch.testing.assert_close(rad[:5], inp.rgb[:, :5].mean(0), rtol=1e-5, atol=1e-6)


def test_split_algebra_matches_jax_kernel_at_small_widths(jax_v2_fused):
    """The JAX test's widths (img 8, vol 4, sim16 4, pe 8; 4 heads): the
    transcription against the JAX Pallas kernel."""
    inputs, params, tok_f, rad_f, (rtol, atol) = jax_v2_fused
    p = _port_params(pph.PointHeadParams, params)
    tok, rad = _split_algebra(_port_inputs(inputs), pph2.pack_weights2(p, c_img=8),
                              (24, 8, 4, 4, 16), n_heads=4)
    np.testing.assert_allclose(tok.numpy(), tok_f, rtol=rtol, atol=atol)
    np.testing.assert_allclose(rad.numpy(), rad_f, rtol=rtol, atol=atol)


@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_render_chunk_v2_matches_jax(slice_pair, encoder):
    """render_chunk through the split-weight point head on the same
    weights against the JAX render (the JAX model takes its flax view
    transformer on the CPU, which computes the same function)."""
    sp = slice_pair
    enc = _bridge_encoder(sp["jax_enc"]) if encoder == "jax" else sp["port_enc"]
    out = sp["port"].with_knobs(point_head="v2").render_chunk(
        sp["scene"], enc, sp["ray_d"], u_coarse=sp["u_c"], u_fine=sp["u_f"])
    _check_render(out, sp["jax_out"], encoder)


def _per_point_args(rng, sim: bool, nv=3, rn=4, sn=5):
    r = lambda *s: _t(rng.standard_normal(s))
    pts = r(rn, sn, 3)
    return dict(points=pts, source_imgs=_t(rng.uniform(size=(nv, 16, 16, 3))),
                source_feats=r(nv, 8, 8, 32), ref_cam_pos=r(3) + 5,
                src_cam_pos=r(nv, 3) + 5, src_w2cs=torch.eye(4).expand(nv, 4, 4),
                points_xy=_t(rng.uniform(-1, 1, (nv, rn, sn, 2))),
                valid_depth=torch.ones(nv, rn, sn), fea_volume_feat=r(rn, sn, 24),
                sim_feat=r(rn, sn, 8) if sim else None,
                mvs_depths=_t(rng.uniform(2, 3, (nv, 16, 16))))


@pytest.mark.parametrize("fused,sim,point_head,want", [
    ("auto", True, "v2", ["v2"]),
    ("always", True, "v2", ["v2"]),
    ("auto", True, "v1", ["v1"]),
    ("never", True, "v2", []),          # the view transformer
    ("auto", False, "v2", []),          # the ablation: the view transformer
])
def test_point_head_knob_routes_the_fused_branch(rng, monkeypatch, fused, sim,
                                                 point_head, want):
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(rt_mod, "point_head_v1", spy("v1", pph.point_head))
    monkeypatch.setattr(rt_mod, "point_head2", spy("v2", pph2.point_head2))
    torch.manual_seed(0)
    rt = RayTransformer(sim_feat_fix=16 if sim else 0)
    args = _per_point_args(rng, sim)
    with torch.no_grad():
        out = rt.per_point(**args, fused=fused, point_head=point_head)
        assert calls == want
        assert out["token"].shape == (4, 5, rt.d_view) and out["radiance"].shape == (4, 5, 3)
        if want == ["v2"]:
            # on the CPU both point heads are the same plain version
            ref = rt.per_point(**args, fused=fused, point_head="v1")
            for key in ("token", "radiance"):
                torch.testing.assert_close(out[key], ref[key], rtol=0, atol=0)


def test_config_point_head_knob():
    assert Config().point_head == "v1"
    assert Config(point_head="v2").point_head == "v2"
    with pytest.raises(ValueError, match="point_head"):
        Config(point_head="v3")
