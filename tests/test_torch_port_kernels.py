"""The port's kernel wrappers: routing, weight packs, the autograd
backward, and (``*_on_gpu``) the CUDA kernels against their plain
versions; those skip without a GPU.

This file imports no JAX, so the GPU tests run on a GPU machine without
it:

    python -m pytest --noconftest -k on_gpu tests/test_torch_port_kernels.py

Kernel tolerances: atol 2e-5 on token and srdf, 2e-6 on radiance (f32
with another summation order, the heads' layer GEMMs in 3xTF32;
chip_smoke.py measures ~7e-6 and ~4e-7);
1e-6 on the grouped cosine and the volume fusion (a few f32 roundings);
for the NeuS epilogue 2e-5 on srdf, weight, rgb and opacity and 2e-5
relative on depth (the compositing sums srdf-sized errors through
sigmoids; the scan of torch.cumprod on the card takes another order), and
NEUS_RTOL relative on weight, rgb and opacity where they reach 1e-2, on
inputs where compositing matters (``_compositing_matters``); the
tiny-attention forward at rtol = atol = 2e-5 and its gradients at 3e-4
(the JAX package's tolerances for its kernel); the split-weight point
head as the point head (the same function); the row gather bit for bit.
"""
import numpy as np
import pytest
import torch

from uforecon_tpu_torch.ops import fused_point_head as pph
from uforecon_tpu_torch.ops import fused_point_head2 as pph2
from uforecon_tpu_torch.ops import fused_ray_head as prh
from uforecon_tpu_torch.ops import fused_similarity as psim
from uforecon_tpu_torch.ops import fused_volume_fusion as pvf
from uforecon_tpu_torch.ops import row_gather as prg
from uforecon_tpu_torch.ops import tiny_attention as pta

torch.set_num_threads(1)

C = 80   # d_view at the default configuration
CR = 88  # + order PE
CR_ABLATION = 72  # ray-head width without explicit similarity
NEUS_RTOL = 2e-4  # chip_smoke.py measures 3.3e-5 at main-path shapes
# samples per ray: the main path's 64 and 128, and SN % 16 != 0, where the
# ray-head kernel pads its rows to whole m16 tiles
SN_CASES = [8, 20, 36, 64, 128]
# every ray-head width a JAX flag set gives (img 32 + volume 0/16/24 +
# similarity 0/16 + depth PE 0/8 + direction PE 0/24 + order PE 8), and
# sample counts from one through resident rays to streamed ones (SN 256 and
# 512 take several tiles at every width past 56; C 112 from SN 112 on)
RAY_WIDTHS = list(range(40, 113, 8))
RAY_LENGTHS = [1, 50, 64, 128, 256, 512]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _point_case(rng, nv=3, n=96, c_vol=24):
    """Point-head inputs and flax-oriented weights at volume width c_vol
    (24: the correlation volume, tokens of C = 80; 16: the feature grid,
    tokens of 72)."""
    c = 32 + c_vol + 16 + 8
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    mask = (rng.uniform(size=(nv, n)) > 0.3).astype(np.float32)
    mask[:, :5] = 0.0                      # points masked in every view
    inputs = dict(img_feat=r(nv, n, 32), vol_feat=r(n, c_vol), sim_feat=r(n, 8),
                  depth_dist=r(nv, n, scale=0.3), dir_rel=r(nv, n, 3, scale=0.1),
                  rgb=rng.uniform(size=(nv, n, 3)).astype(np.float32), mask=mask)
    w = lambda i, o: r(i, o, scale=1.0 / np.sqrt(i))   # flax (in, out)
    params = dict(view_token=r(c), wq=w(c, c), wk=w(c, c), wv=w(c, c),
                  wmerge=w(c, c), norm1_scale=1 + r(c, scale=0.1),
                  norm1_bias=r(c, scale=0.1), w1=w(2 * c, 2 * c), w2=w(2 * c, c),
                  norm2_scale=1 + r(c, scale=0.1), norm2_bias=r(c, scale=0.1),
                  sim_w=(w(8, 32), w(32, 32), w(32, 16)),
                  sim_b=(r(32, scale=0.1), r(32, scale=0.1), r(16, scale=0.1)),
                  rad_w=(w(c + 3, 16), w(16, 8), w(8, 1)),
                  rad_b=(r(16, scale=0.1), r(8, scale=0.1), r(1, scale=0.1)))
    return inputs, params


def _port_params(cls, params):
    """flax (in, out) matrices -> nn.Linear (out, in)."""
    def conv(v):
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return _t(v.T if np.ndim(v) == 2 else v)
    return cls(**{k: conv(v) for k, v in params.items()})


def _ray_case(rng, rn, sn, c=CR):
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    w = lambda i, o: r(i, o, scale=1.0 / np.sqrt(i))
    params = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wmerge=w(c, c),
                  norm1_scale=1 + r(c, scale=0.1), norm1_bias=r(c, scale=0.1),
                  w1=w(2 * c, 2 * c), w2=w(2 * c, c),
                  norm2_scale=1 + r(c, scale=0.1), norm2_bias=r(c, scale=0.1),
                  dens_w=(w(c, 32), w(32, 16), w(16, 1)),
                  dens_b=(r(32, scale=0.1), r(16, scale=0.1), r(1, scale=0.1)))
    return r(rn, sn, c), params


def _cosine_case(rng, nv=3, n=50, c=32):
    return rng.standard_normal((nv, n, (nv - 1) * c)).astype(np.float32)


def _fusion_case(rng, nv=3, n=50, zero_rows=5):
    """Three stages of (NV, P, 8 features || 1 sigmoid-range weight); the
    first ``zero_rows`` points have zero weight in every view and stage."""
    fws = []
    for _ in range(3):
        fw = rng.standard_normal((nv, n, 9)).astype(np.float32)
        fw[..., -1] = rng.uniform(size=(nv, n))
        fw[:, :zero_rows, -1] = 0.0
        fws.append(fw)
    return fws


def _neus_case(rng, rn, sn):
    z = np.sort(rng.uniform(2.0, 4.0, (rn, sn)), axis=1).astype(np.float32)
    rad = rng.uniform(size=(rn, sn, 3)).astype(np.float32)
    return z, rad, np.float32(np.exp(0.3 * 10))


def _attention_case(rng, b=40, l=4, s=4, h=8, d=10, m=10):
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return r(b, l, h, d), r(b, s, h, d), r(b, s, h, m)


def _gather_case(rng, n_blocks=3, rows=4096):
    src = _t(rng.standard_normal((n_blocks * rows, 128))).to(torch.bfloat16)
    idx = torch.as_tensor(rng.integers(0, rows, n_blocks * rows).astype(np.int32))
    return src, idx


def _launch_counts():
    return (pph.point_head.launches, prh.ray_head.launches,
            prh.ray_head_neus.launches, psim.grouped_cosine.launches,
            pvf.volume_fusion.launches, pta.tiny_linear_attention.launches,
            pta.tiny_linear_attention_backward.launches, pph2.point_head2.launches,
            prg.block_row_gather.launches)


def test_wrappers_take_the_plain_version_on_cpu(rng):
    before = _launch_counts()
    inputs, params = _point_case(rng, n=20)
    inp = pph.PointHeadInputs(**{k: _t(v) for k, v in inputs.items()})
    p = _port_params(pph.PointHeadParams, params)
    for a, b in zip(pph.point_head(inp, p), pph.point_head_reference(inp, p)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(pph2.point_head2(inp, p), pph2.point_head2_reference(inp, p)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    src, idx = _gather_case(rng, n_blocks=2, rows=64)
    torch.testing.assert_close(prg.block_row_gather(src, idx, 64),
                               prg.block_row_gather_reference(src, idx, 64), rtol=0, atol=0)
    y, rparams = _ray_case(rng, rn=3, sn=8)
    rp = _port_params(prh.RayHeadParams, rparams)
    torch.testing.assert_close(prh.ray_head(_t(y), rp),
                               prh.ray_head_reference(_t(y), rp), rtol=0, atol=0)
    z, rad, inv_s = (_t(a) for a in _neus_case(rng, 3, 8))
    for a, b in zip(prh.ray_head_neus(_t(y), z, rad, inv_s, rp),
                    prh.ray_head_neus_reference(_t(y), z, rad, inv_s, rp)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    x = _t(_cosine_case(rng))
    torch.testing.assert_close(psim.grouped_cosine(x, 8),
                               psim.grouped_cosine_reference(x, 8), rtol=0, atol=0)
    fws = [_t(f) for f in _fusion_case(rng)]
    torch.testing.assert_close(pvf.volume_fusion(*fws),
                               pvf.volume_fusion_reference(fws), rtol=0, atol=0)
    q, k, v = (_t(a).requires_grad_() for a in _attention_case(rng))
    out = pta.tiny_linear_attention(q, k, v)
    torch.testing.assert_close(out, pta.tiny_linear_attention_reference(q, k, v),
                               rtol=0, atol=0)
    g = torch.ones_like(out)
    for a, b in zip(pta.tiny_linear_attention_backward(q, k, v, g),
                    pta.tiny_linear_attention_backward_reference(q, k, v, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _launch_counts() == before


def test_kernel_launchers_reject_shapes_they_do_not_take(rng):
    inputs, params = _point_case(rng, n=8)
    inputs["img_feat"] = inputs["img_feat"][..., :16]
    with pytest.raises(ValueError, match="point_head kernel takes"):
        pph._launch(pph.PointHeadInputs(**{k: _t(v) for k, v in inputs.items()}),
                    _port_params(pph.PointHeadParams, params), 8)
    # volume widths the kernels are not built for: only 24 and 16 are
    inputs, params = _point_case(rng, n=8, c_vol=8)
    for launch, name in ((pph._launch, "point_head"), (pph2._launch, "point_head2")):
        with pytest.raises(ValueError, match=f"{name} kernel takes"):
            launch(pph.PointHeadInputs(**{k: _t(v) for k, v in inputs.items()}),
                   _port_params(pph.PointHeadParams, params), 8)
    y, rparams = _ray_case(rng, rn=2, sn=6, c=84)   # C not a multiple of 8
    with pytest.raises(ValueError, match="C % 8"):
        prh._launch(_t(y), _port_params(prh.RayHeadParams, rparams), 8)
    y, rparams = _ray_case(rng, rn=2, sn=6, c=40)
    with pytest.raises(ValueError, match="8 heads"):
        prh._launch(_t(y), _port_params(prh.RayHeadParams, rparams), 4)
    y, rparams = _ray_case(rng, rn=2, sn=8)
    z, rad, inv_s = _neus_case(rng, 2, 8)
    with pytest.raises(ValueError, match="ray_head_neus kernel takes"):
        prh._launch_neus(_t(y), _t(z[:, :4]), _t(rad), _t(inv_s),
                         _port_params(prh.RayHeadParams, rparams), 8)
    with pytest.raises(ValueError, match="grouped_cosine kernel takes"):
        psim._launch(_t(_cosine_case(rng, c=30)), 8)
    with pytest.raises(ValueError, match="grouped_cosine kernel takes a float32 CUDA"):
        psim._launch(_t(_cosine_case(rng)), 8)
    fws = [_t(f) for f in _fusion_case(rng)]
    with pytest.raises(ValueError, match="volume_fusion kernel takes 3 stages"):
        pvf._launch(fws[:2])
    with pytest.raises(ValueError, match="volume_fusion kernel takes 3 stages"):
        pvf._launch([fws[0], fws[1], fws[2][..., :5]])
    # past the 11 views compiled in the count passes, and the CPU tensors
    # are what is refused
    twelve = [_t(f) for f in _fusion_case(rng, nv=12)]
    with pytest.raises(ValueError, match="float32 tensors on one CUDA"):
        pvf._launch(twelve)
    with pytest.raises(ValueError, match="float32 tensors on one CUDA"):
        pvf._launch(fws)
    y, rparams = _ray_case(rng, rn=2, sn=8, c=120)   # wider than any flag set gives
    with pytest.raises(ValueError, match="C in"):
        prh._launch(_t(y), _port_params(prh.RayHeadParams, rparams), 8)
    # outside the JAX rule (L, S <= 8, head dim <= 16), or not on the card
    for shape in (dict(l=9), dict(s=9), dict(d=17), dict(m=17)):
        q, k, v = (_t(a) for a in _attention_case(rng, b=3, **shape))
        with pytest.raises(ValueError, match="tiny_attention kernel takes q"):
            pta._launch_fwd(q, k, v)
    q, k, v = (_t(a) for a in _attention_case(rng, b=3))
    with pytest.raises(ValueError, match="float32 tensors on one CUDA"):
        pta._launch_fwd(q, k, v)
    with pytest.raises(ValueError, match="float32 tensors on one CUDA"):
        pta._launch_bwd(q, k, v, torch.zeros(3, 4, 8, 10))


def test_volume_fusion_checks_the_kernel_layout_once(monkeypatch):
    """The wrapper asks the extension for its stage, feature and view
    counts once per process, not on every launch, and raises where they
    differ from its own."""
    from uforecon_tpu_torch.ops import cuda_build

    asked = []

    class Ext:
        def volume_fusion_stages(self):
            asked.append(1)
            return 3

        def volume_fusion_features(self):
            return 8

        def volume_fusion_max_views(self):
            return 11

    monkeypatch.setattr(cuda_build, "extension", Ext)
    pvf._extension.cache_clear()
    try:
        assert pvf._extension() is pvf._extension()
        assert len(asked) == 1
        monkeypatch.setattr(Ext, "volume_fusion_max_views", lambda self: 4)
        pvf._extension.cache_clear()
        with pytest.raises(ValueError, match="layout does not match"):
            pvf._extension()
    finally:
        pvf._extension.cache_clear()


def test_point_head2_and_row_gather_launchers_reject_what_they_do_not_take(rng):
    inputs, params = _point_case(rng, n=8)
    p = _port_params(pph.PointHeadParams, params)
    bad = dict(inputs, img_feat=inputs["img_feat"][..., :16])
    with pytest.raises(ValueError, match="point_head2 kernel takes"):
        pph2._launch(pph2.PointHeadInputs2(**{k: _t(v) for k, v in bad.items()}), p, 8)
    with pytest.raises(ValueError, match="point_head2 kernel takes 2 views or more, got 1"):
        one, _ = _point_case(rng, nv=1, n=8)
        pph2._launch(pph2.PointHeadInputs2(**{k: _t(v) for k, v in one.items()}), p, 8)
    with pytest.raises(ValueError, match="float32 tensors on one CUDA"):
        pph2._launch(pph2.PointHeadInputs2(**{k: _t(v) for k, v in inputs.items()}), p, 8)
    src, idx = _gather_case(rng, n_blocks=2, rows=64)
    with pytest.raises(ValueError, match="whole blocks"):
        prg._launch(src[:100], idx[:100], 64)
    with pytest.raises(ValueError, match="src \\(rows, 128\\)"):
        prg._launch(src[:, :64], idx, 64)
    with pytest.raises(ValueError, match="bfloat16 src and int32 idx on one CUDA"):
        prg._launch(src, idx, 64)
    with pytest.raises(ValueError, match="bfloat16 src and int32 idx on one CUDA"):
        prg._launch(src.float(), idx, 64)


def test_point_head2_weight_pack_matches_the_kernel_layout(rng):
    """The split pack's size equals csrc/point_head2.cu's N_W (derived from
    the same widths; the tensor-core matrices count twice, as a TF32 hi and
    a lo plane), and it starts as the kernel expects: the view token, the
    token's own q, k, v rows, w1a_tok, then the shared projection's hi
    plane (wq's vol and sim16 rows first) and its lo plane."""
    _, params = _point_case(rng, n=4)
    p = _port_params(pph.PointHeadParams, params)
    pack = pph2.pack_weights2(p)
    gs, gv, c2, nsh = 24 + 16, 32 + 8, 2 * C, 3 * C + 2 * C + 16
    n_w = C + 3 * C + c2 + 2 * (gs * nsh + gv * 3 * C + C * C) + 2 * C \
        + 2 * ((gv + C) * c2 + c2 * C) + 2 * C \
        + (8 * 32 + 32) + (32 * 32 + 32) + (32 * 16 + 16) \
        + 2 * (48 + C) * 16 + (16 * 8 + 8) + (8 + 1)
    assert pack.numel() == n_w == pph2.layout2(C, 32, 24, 16)["total"][0]
    torch.testing.assert_close(pack[:C], p.view_token)
    torch.testing.assert_close(pack[C:2 * C], p.view_token @ p.wq.t())
    o_sh = C + 3 * C + c2
    hi = pack[o_sh:o_sh + gs * nsh].view(gs, nsh)
    lo = pack[o_sh + gs * nsh:o_sh + 2 * gs * nsh].view(gs, nsh)
    torch.testing.assert_close(hi[:, :C] + lo[:, :C], p.wq.t()[32:72], rtol=2 ** -21, atol=0)
    torch.testing.assert_close(hi[:, :C], p.wq.t()[32:72], rtol=2 ** -11, atol=0)
    # every tensor-core plane starts on a 16-byte boundary, as cp.async reads it
    lay = pph2.layout2(C, 32, 24, 16)
    assert all(lay[name][0] % 4 == 0 for name in pph2.TC_MATRICES)
    # the split pack holds every weight element of the point head once or
    # more, and the two constants
    assert pack.numel() > sum(t.numel() for t in pph._flat_params(p))


def test_weight_packs_match_the_kernel_layout(rng):
    """Sizes of the packs equal the N_W constants of csrc/*.cu (derived
    from the same layer widths; the tensor-core matrices count twice, as a
    TF32 hi and a lo plane), and the pack starts as the kernels expect:
    the view token, then wq's hi plane, then its lo plane."""
    _, params = _point_case(rng, n=4)
    p = _port_params(pph.PointHeadParams, params)
    pack = pph.pack_weights(p)
    c2 = 2 * C
    n_w = C + 2 * (4 * C * C) + 2 * C + 2 * (c2 * c2 + c2 * C) + 2 * C \
        + (8 * 32 + 32) + (32 * 32 + 32) + (32 * 16 + 16) \
        + ((C + 3) * 16 + 16) + (16 * 8 + 8) + (8 + 1)
    assert pack.numel() == n_w
    torch.testing.assert_close(pack[:C], p.view_token)
    hi = pack[C:C + C * C].view(C, C)
    lo = pack[C + C * C:C + 2 * C * C].view(C, C)
    torch.testing.assert_close(hi + lo, p.wq.t(), rtol=2 ** -21, atol=0)
    torch.testing.assert_close(hi, p.wq.t(), rtol=2 ** -11, atol=0)
    for c in (CR, CR_ABLATION):
        _, rparams = _ray_case(rng, rn=1, sn=4, c=c)
        rp = _port_params(prh.RayHeadParams, rparams)
        c2 = 2 * c
        assert prh.pack_weights(rp).numel() == 2 * (4 * c * c + c2 * c2 + c2 * c) \
            + 2 * c + 2 * c + (c * 32 + 32) + (32 * 16 + 16) + (16 + 1)


@pytest.mark.parametrize("nv", [2, 3, 4, 5, 6])
def test_pair_slots_follow_the_kernel_closed_form(nv):
    """csrc/grouped_cosine.cu finds pair (i, j) at slot j - 1 of view i's
    row and at slot i of view j's row."""
    pairs = psim.view_pairs(nv)
    assert len(pairs) == nv * (nv - 1) // 2
    assert psim.pair_slots(nv) == [(j - 1, i) for i, j in pairs]


def test_query_views_are_the_sampler_layout(rng):
    """The kernels read the samplers' output in place: grid_sample's
    channel-first memory seen as (NV, P, C), strides (C P, 1, P)."""
    from uforecon_tpu_torch.ops.grid_sample import grid_sample_2d, grid_sample_3d

    img = _t(rng.standard_normal((3, 6, 7, 64)))
    grid = _t(rng.uniform(-1, 1, (3, 4, 5, 2)))
    flat = grid_sample_2d(img, grid).reshape(3, -1, 64)
    assert flat.stride() == (64 * 20, 1, 20)
    vol = _t(rng.standard_normal((3, 9, 4, 5, 6)))
    grid3 = _t(rng.uniform(-1, 1, (3, 4, 5, 3)))
    flat3 = grid_sample_3d(vol, grid3).reshape(3, -1, 9)
    assert flat3.stride() == (9 * 20, 1, 20)


@pytest.mark.parametrize("head", ["point", "point2", "ray", "ray_neus", "cosine", "fusion"])
def test_autograd_backward_goes_through_the_plain_version(rng, monkeypatch, head):
    """The kernel functions' backward (``cuda_build.kernel_function``):
    launch replaced by the plain forward so it runs on the CPU; gradients
    must equal plain autograd."""
    if head == "point":
        inputs, params = _point_case(rng, n=12)
        monkeypatch.setattr(pph, "_launch", pph.point_head_reference)
        # the mask only selects, it has no gradient
        inp = [_t(v).requires_grad_(k != "mask") for k, v in inputs.items()]
        par = [t.requires_grad_() for t in
               pph._flat_params(_port_params(pph.PointHeadParams, params))]

        def plain():
            return pph.point_head_reference(pph.PointHeadInputs(*inp),
                                            pph._unflat_params(par))

        def fused():
            return pph._point_head_fn((8, "high"), *inp, *par)
    elif head == "point2":
        inputs, params = _point_case(rng, n=12)
        monkeypatch.setattr(pph2, "_launch", pph2.point_head2_reference)
        inp = [_t(v).requires_grad_(k != "mask") for k, v in inputs.items()]
        par = [t.requires_grad_() for t in
               pph._flat_params(_port_params(pph.PointHeadParams, params))]

        def plain():
            return pph2.point_head2_reference(pph.PointHeadInputs(*inp),
                                              pph._unflat_params(par))

        def fused():
            return pph2._point_head2_fn((8, "high"), *inp, *par)
    elif head == "ray_neus":
        y, rparams = _ray_case(rng, rn=3, sn=8)
        monkeypatch.setattr(prh, "_launch_neus", prh.ray_head_neus_reference)
        inp = [_t(a).requires_grad_() for a in (y, *_neus_case(rng, 3, 8))]
        par = [t.requires_grad_() for t in
               prh._flat_params(_port_params(prh.RayHeadParams, rparams))]

        def plain():
            return prh.ray_head_neus_reference(*inp, prh._unflat_params(par))

        def fused():
            return prh._ray_head_neus_fn((8, "high"), *inp, *par)
    elif head == "cosine":
        monkeypatch.setattr(psim, "_launch", psim.grouped_cosine_reference)
        inp, par = [_t(_cosine_case(rng, n=12)).requires_grad_()], []

        def plain():
            return (psim.grouped_cosine_reference(inp[0], 8),)

        def fused():
            return (psim._grouped_cosine_fn(8, inp[0]),)
    elif head == "fusion":
        monkeypatch.setattr(pvf, "_launch", pvf.volume_fusion_reference)
        inp, par = [_t(f).requires_grad_() for f in _fusion_case(rng, n=12)], []

        def plain():
            return (pvf.volume_fusion_reference(inp),)

        def fused():
            return (pvf._volume_fusion_fn(None, *inp),)
    else:
        y, rparams = _ray_case(rng, rn=3, sn=8)
        monkeypatch.setattr(prh, "_launch", prh.ray_head_reference)
        inp = [_t(y).requires_grad_()]
        par = [t.requires_grad_() for t in
               prh._flat_params(_port_params(prh.RayHeadParams, rparams))]

        def plain():
            return (prh.ray_head_reference(inp[0], prh._unflat_params(par)),)

        def fused():
            return (prh._ray_head_fn((8, "high"), inp[0], *par),)

    leaves = [t for t in inp + par if t.requires_grad]
    _check_grads(plain, fused, leaves)


def _check_grads(plain, fused, leaves):
    g_plain = torch.autograd.grad(sum(o.square().sum() for o in plain()), leaves)
    g_fused = torch.autograd.grad(sum(o.square().sum() for o in fused()), leaves)
    for a, b in zip(g_fused, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_tiny_attention_function_runs_the_backward_wrapper(rng, monkeypatch):
    """The autograd Function of the tiny attention: forward through the
    forward launcher, backward through ``tiny_linear_attention_backward``
    (the backward kernel on the card). Launchers replaced by the plain
    versions so it runs on the CPU: the gradients equal plain autograd,
    and the backward wrapper ran."""
    calls = []

    def bwd(q, k, v, g):
        calls.append(g.shape)
        return pta.tiny_linear_attention_backward_reference(q, k, v, g)

    monkeypatch.setattr(pta, "_launch_fwd", pta.tiny_linear_attention_reference)
    monkeypatch.setattr(pta, "tiny_linear_attention_backward", bwd)
    inp = [_t(a).requires_grad_() for a in _attention_case(rng, b=12)]
    _check_grads(lambda: (pta.tiny_linear_attention_reference(*inp),),
                 lambda: (pta._TinyAttention.apply(*inp),), inp)
    assert calls == [(12, 4, 8, 10)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


# the view counts the point-head kernels are compiled for: --test_n_view 2
# to 11 (DTU's evaluation set 1 has 11 views; from 9 views on a block holds
# fewer than 16 points, and its rows are padded to whole m16 tiles), and two
# past them, which the streamed kernels take (12; 49, DTU's all views)
VIEW_COUNTS = list(range(2, pph.KERNEL_COMPILED_VIEWS + 1)) + [12, 49]


@pytest.mark.parametrize("n", [1000, 1001])
@pytest.mark.parametrize("nv", VIEW_COUNTS)
def test_point_head_kernel_matches_plain_on_gpu(rng, cuda_device, nv, n):
    """P not a multiple of the kernel's points per block (the outputs
    past P stay unwritten), the first 5 points masked in every view: a
    uniform blend, never NaN."""
    inputs, params = _point_case(rng, nv=nv, n=n)
    inp = pph.PointHeadInputs(**{k: _t(v).to(cuda_device) for k, v in inputs.items()})
    p = pph.PointHeadParams(*[(tuple(x.to(cuda_device) for x in v) if isinstance(v, tuple)
                               else v.to(cuda_device))
                              for v in _port_params(pph.PointHeadParams, params)])
    before = pph.point_head.launches
    tok, rad = pph.point_head(inp, p)
    tok_ref, rad_ref = pph.point_head_reference(inp, p)
    assert pph.point_head.launches == before + 1
    assert torch.isfinite(tok).all() and torch.isfinite(rad).all()
    torch.testing.assert_close(tok, tok_ref, rtol=0, atol=2e-5)
    torch.testing.assert_close(rad, rad_ref, rtol=0, atol=2e-6)
    torch.testing.assert_close(rad[:5], inp.rgb[:, :5].mean(0), rtol=0, atol=2e-6)


@pytest.mark.parametrize("nv", VIEW_COUNTS)
def test_point_head2_kernel_matches_plain_on_gpu(rng, cuda_device, nv):
    """A ragged P (not a multiple of the kernel's points per block), the
    first 5 points masked in every view: a uniform blend, never NaN."""
    inputs, params = _point_case(rng, nv=nv, n=1001)
    inp = pph2.PointHeadInputs2(**{k: _t(v).to(cuda_device) for k, v in inputs.items()})
    p = _on(cuda_device, _port_params(pph.PointHeadParams, params))
    before = pph2.point_head2.launches
    with torch.no_grad():
        tok, rad = pph2.point_head2(inp, p)
    tok_ref, rad_ref = pph2.point_head2_reference(inp, p)
    assert pph2.point_head2.launches == before + 1
    assert torch.isfinite(tok).all() and torch.isfinite(rad).all()
    torch.testing.assert_close(tok, tok_ref, rtol=0, atol=2e-5)
    torch.testing.assert_close(rad, rad_ref, rtol=0, atol=2e-6)
    torch.testing.assert_close(rad[:5], inp.rgb[:, :5].mean(0), rtol=0, atol=2e-6)


@pytest.mark.parametrize("n_blocks,rows", [(3, 4096), (5, 256), (1, 1)])
def test_row_gather_kernel_matches_plain_on_gpu(rng, cuda_device, n_blocks, rows):
    src, idx = (t.to(cuda_device) for t in _gather_case(rng, n_blocks, rows))
    before = prg.block_row_gather.launches
    got = prg.block_row_gather(src, idx, rows)
    assert prg.block_row_gather.launches == before + 1
    assert torch.equal(got, prg.block_row_gather_reference(src, idx, rows))


@pytest.mark.parametrize("sn", SN_CASES)
def test_ray_head_kernel_matches_plain_on_gpu(rng, cuda_device, sn):
    y, rparams = _ray_case(rng, rn=37, sn=sn)
    rp = prh.RayHeadParams(*[(tuple(x.to(cuda_device) for x in v) if isinstance(v, tuple)
                              else v.to(cuda_device))
                             for v in _port_params(prh.RayHeadParams, rparams)])
    yd = _t(y).to(cuda_device)
    before = prh.ray_head.launches
    got = prh.ray_head(yd, rp)
    assert prh.ray_head.launches == before + 1
    torch.testing.assert_close(got, prh.ray_head_reference(yd, rp), rtol=0, atol=2e-5)


def _on(device, params):
    return type(params)(*[(tuple(x.to(device) for x in v) if isinstance(v, tuple)
                           else v.to(device)) for v in params])


def _compositing_matters(weight, opacity):
    """srdf crosses zero inside the rays: most rays are mostly opaque and
    put a sizable weight on one sample, so alpha spans 0..1 and the
    transmittance product shapes the weights."""
    return bool(opacity.median() > 0.3
                and (weight.amax(dim=1) > 0.05).float().mean() >= 0.9)


def _composite(z, rad, srdf, inv_s, fault=None):
    """NeuS compositing written out, with one of three faults a kernel
    epilogue could have."""
    iv = z[:, 1:] - z[:, :-1]
    iv = torch.cat([iv[:, :1], iv, iv[:, -1:]], dim=1)
    iv = (iv[:, :-1] + iv[:, 1:]) * 0.5
    s = torch.clamp(inv_s, 1e-6, 1e6)
    prev, nxt = torch.sigmoid((srdf + 0.75 * iv) * s), torch.sigmoid((srdf - 0.75 * iv) * s)
    if fault == "swapped_cdfs":
        prev, nxt = nxt, prev
    alpha = torch.clamp((prev - nxt + 1e-5) / (prev + 1e-5), 0.0, 1.0)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-7], dim=1), dim=1)[:, :-1]
    weight = {"no_transmittance": alpha, "zero_weight": 0 * alpha}.get(fault, alpha * trans)
    return weight, (rad * weight[..., None]).sum(1), weight.sum(1)


@pytest.mark.parametrize("sn", SN_CASES)
def test_neus_gpu_case_shows_a_wrong_epilogue(rng, sn):
    """The inputs of test_ray_head_neus_kernel_matches_plain_on_gpu (the
    same draws) are in the regime where compositing matters, and there
    each of three wrong epilogues misses the kernel's 2e-5 tolerance on
    weight, rgb or opacity by more than a thousand times."""
    y, rparams = _ray_case(rng, rn=37, sn=sn)
    rp = _port_params(prh.RayHeadParams, rparams)
    y, z, rad, inv_s = (_t(a) for a in (y, *_neus_case(rng, 37, sn)))
    srdf, weight, rgb, _, opacity = prh.ray_head_neus_reference(y, z, rad, inv_s, rp)
    assert _compositing_matters(weight, opacity)
    for a, b in zip(_composite(z, rad, srdf, inv_s), (weight, rgb, opacity)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for fault in ("swapped_cdfs", "no_transmittance", "zero_weight"):
        err = max((a - b).abs().max().item() for a, b in
                  zip(_composite(z, rad, srdf, inv_s, fault), (weight, rgb, opacity)))
        assert err > 1000 * 2e-5, (fault, err)


@pytest.mark.parametrize("sn", SN_CASES)
def test_ray_head_neus_kernel_matches_plain_on_gpu(rng, cuda_device, sn):
    y, rparams = _ray_case(rng, rn=37, sn=sn)
    rp = _on(cuda_device, _port_params(prh.RayHeadParams, rparams))
    args = [_t(a).to(cuda_device) for a in (y, *_neus_case(rng, 37, sn))]
    before = prh.ray_head_neus.launches
    got = prh.ray_head_neus(*args, rp)
    assert prh.ray_head_neus.launches == before + 1
    want = prh.ray_head_neus_reference(*args, rp)
    assert _compositing_matters(want[1], want[4])
    for name, a, b in zip(("srdf", "weight", "rgb", "depth", "opacity"), got, want):
        torch.testing.assert_close(a, b, rtol=2e-5 if name == "depth" else 0,
                                   atol=2e-5, msg=name)
        if name in ("weight", "rgb", "opacity"):
            big = b.abs() >= 1e-2
            rel = ((a - b).abs()[big] / b.abs()[big]).max().item()
            assert rel <= NEUS_RTOL, (name, rel)


# kernel_precision 'fast': the kernel and its plain version both take
# products of bf16-rounded operands, summed in other orders, so now and then
# an intermediate lands on the other side of a bf16 rounding and moves an
# output by a bf16 step of that input (chip_smoke.py's FAST_SHARE: 95-99 %
# of elements within the tolerance on an H100); a kernel rounding at one
# site more or fewer than JAX misses on most elements
FAST_SHARE = 0.9


def _fast_close(got, fast, exact, per_ray=False, tol=2e-5):
    """A fast kernel's output against its fast plain version: within tol on
    FAST_SHARE of the elements (a per-sample output; a per-ray sum takes
    the flips of all its samples), none further off than the largest bf16
    effect on that output (fast plain against FP32 plain), which is of
    bf16's size."""
    d = (got - fast).abs()
    gap = (fast - exact).abs().max().item()
    if gap <= tol:                   # an output bf16 does not move (saturated)
        assert d.max().item() <= tol
        return
    assert per_ray or (d <= tol).float().mean().item() >= FAST_SHARE
    assert d.max().item() <= gap and gap < 0.5, (d.max().item(), gap)


def _fast_close_by_effect(got, fast, exact, tol=2e-5, per_ray=False):
    """A fast ray head's output against its fast plain version by the size
    of the bf16 effect (fast plain against FP32 plain), the rule of
    test_torch_port_ray_widths.py: the median distance at most 0.2 of the
    effect's median (a kernel that rounds at one site more or fewer than
    the plain version misses it) and every element within the effect's
    largest, each bound at least tol. The element-share rule
    (``_fast_close``) counts samples, and at widths past 100 and long rays
    the flips of single bf16 roundings nearly use it up: 0.922-0.926 of
    the elements within tol on 1024 rays at C 112, SN 256 on the card,
    whatever order the attention state is summed in, and on 37 rays that
    share spreads by several points (0.883-0.890 on the card). A per-ray
    sum (``per_ray``) is held by the median alone: a flip moves it by more
    than the largest bf16 effect on 37 rays now and then (1.4e-4 against
    8.5e-5 at C 48, SN 512 on the card), and the caller holds it to the
    kernel's own weights instead."""
    d = (got - fast).abs()
    gap = (fast - exact).abs()
    assert d.median().item() <= max(0.2 * gap.median().item(), tol), \
        (d.median().item(), gap.median().item())
    assert gap.max().item() < 0.5 and (per_ray or d.max().item() <= max(gap.max().item(), tol)), \
        (d.max().item(), gap.max().item())


@pytest.mark.parametrize("kernel", ["point_head", "point_head2", "ray_head_88",
                                    "ray_head_72", "ray_head_neus"])
def test_fast_kernel_matches_plain_on_gpu(rng, cuda_device, kernel):
    """The bf16 instantiation against the fast plain version: counted on
    ``launches_fast``, not on ``launches``, and away from the 3xTF32 kernel
    by bf16's size."""
    _check_fast_kernel(rng, cuda_device, kernel)


@pytest.mark.parametrize("nv", [v for v in VIEW_COUNTS if v != 3])
@pytest.mark.parametrize("kernel", ["point_head", "point_head2"])
def test_fast_point_head_kernels_match_plain_at_each_view_count_on_gpu(rng, cuda_device,
                                                                      kernel, nv):
    """The fast point heads at the other view counts a render gives them
    (``--test_n_view`` 2 to 11), as test_fast_kernel_matches_plain_on_gpu
    holds them at 3."""
    _check_fast_kernel(rng, cuda_device, kernel, nv=nv)


@pytest.mark.parametrize("nv", [6, 7, 9, 10])
def test_fast_point_head_at_the_feature_grid_width_at_each_view_count_on_gpu(rng, cuda_device,
                                                                            nv):
    """Fast kernel 1 at tokens of 72 at the view counts from 6 on that
    test_point_head_kernels_at_the_feature_grid_width_match_plain_on_gpu
    leaves out (it holds 8 and 11), each its own instance of
    ``point_head_fast_views.cu``."""
    _check_fast_kernel(rng, cuda_device, "point_head", nv=nv, c_vol=16)


@pytest.mark.parametrize("nv", [2, 3, 5, 8, 11, 12])
@pytest.mark.parametrize("kernel", ["point_head", "point_head2"])
def test_point_head_kernels_at_the_feature_grid_width_match_plain_on_gpu(rng, cuda_device,
                                                                       kernel, nv):
    """The feature grid's 16 volume features (tokens of 72, heads of 9),
    which JAX's gate sends to the point head too: the 3xTF32 kernel within
    the tolerances of test_point_head_kernel_matches_plain_on_gpu (a
    ragged P, the first 5 points masked in every view), the bf16 one by
    the rule of test_fast_kernel_matches_plain_on_gpu."""
    inputs, params = _point_case(rng, nv=nv, n=1001, c_vol=16)
    inp = pph.PointHeadInputs(**{k: _t(v).to(cuda_device) for k, v in inputs.items()})
    p = _on(cuda_device, _port_params(pph.PointHeadParams, params))
    mod = pph if kernel == "point_head" else pph2
    wrapper, plain = getattr(mod, kernel), getattr(mod, f"{kernel}_reference")
    before = wrapper.launches
    with torch.no_grad():
        tok, rad = wrapper(inp, p)
    tok_ref, rad_ref = plain(inp, p)
    assert wrapper.launches == before + 1 and tok.shape == (1001, 72)
    assert torch.isfinite(tok).all() and torch.isfinite(rad).all()
    torch.testing.assert_close(tok, tok_ref, rtol=0, atol=2e-5)
    torch.testing.assert_close(rad, rad_ref, rtol=0, atol=2e-6)
    torch.testing.assert_close(rad[:5], inp.rgb[:, :5].mean(0), rtol=0, atol=2e-6)
    _check_fast_kernel(rng, cuda_device, kernel, nv=nv, c_vol=16)


def _check_fast_kernel(rng, cuda_device, kernel, nv=3, c=None, sn=64, c_vol=24,
                       by_effect=False):
    if kernel.startswith("point_head"):
        inputs, params = _point_case(rng, nv=nv, n=1001, c_vol=c_vol)
        args = (pph.PointHeadInputs(**{k: _t(v).to(cuda_device) for k, v in inputs.items()}),
                _on(cuda_device, _port_params(pph.PointHeadParams, params)))
        mod = pph if kernel == "point_head" else pph2
        wrapper = getattr(mod, kernel)
        plain = getattr(mod, f"{kernel}_reference")
    else:
        c = c or (72 if kernel == "ray_head_72" else 88)
        rn = 37
        y, rparams = _ray_case(rng, rn=rn, sn=sn, c=c)
        rp = _on(cuda_device, _port_params(prh.RayHeadParams, rparams))
        extra = _neus_case(rng, rn, sn) if kernel == "ray_head_neus" else ()
        args = (*[_t(a).to(cuda_device) for a in (y, *extra)], rp)
        wrapper = prh.ray_head_neus if kernel == "ray_head_neus" else prh.ray_head
        plain = prh.ray_head_neus_reference if kernel == "ray_head_neus" else prh.ray_head_reference
    before = (wrapper.launches, wrapper.launches_fast)
    with torch.no_grad():
        got = wrapper(*args, precision="fast")
        assert (wrapper.launches, wrapper.launches_fast) == (before[0], before[1] + 1)
        tf32 = wrapper(*args, precision="high")
        assert (wrapper.launches, wrapper.launches_fast) == (before[0] + 1, before[1] + 1)
        fast, exact = plain(*args, precision="fast"), plain(*args)
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
    for i, (g, f, e) in enumerate(zip(*map(as_tuple, (got, fast, exact)))):
        assert g.shape == f.shape and torch.isfinite(g).all()
        if not g.numel():   # the NeuS weights of a one-sample ray are empty
            continue
        if by_effect:
            # the NeuS per-ray sums take every flip of their ray's samples
            # at once, where the bf16 effect on them partly cancels: held
            # by the median, and exactly to the kernel's own weights below
            _fast_close_by_effect(g, f, e, per_ray=kernel == "ray_head_neus" and i >= 2)
        else:
            # the NeuS outputs past srdf and weight are per-ray sums
            _fast_close(g, f, e, per_ray=kernel == "ray_head_neus" and i >= 2)
    if by_effect and kernel == "ray_head_neus":
        # rgb, depth and opacity: the sums of the kernel's own weights over
        # the ray's radiance, z and ones (float32 sums in another order)
        _, w, rgb, depth, opacity = got
        z, rad = args[1], args[2]
        for name, a, b in (("rgb", rgb, torch.einsum("rs,rsc->rc", w, rad[:, :w.shape[1]])),
                           ("depth", depth, (w * z[:, :w.shape[1]]).sum(-1)),
                           ("opacity", opacity, w.sum(-1))):
            torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5, msg=name)
    assert 1e-4 < max((g - t).abs().max().item()
                      for g, t in zip(*map(as_tuple, (got, tf32))) if g.numel()) < 0.5


@pytest.mark.parametrize("nv", [2, 3, 5])
@pytest.mark.parametrize("layout", ["channel_first", "point_major"])
def test_grouped_cosine_kernel_matches_plain_on_gpu(rng, cuda_device, nv, layout):
    x = _t(_cosine_case(rng, nv=nv, n=3001)).to(cuda_device)
    if layout == "channel_first":
        x = x.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    before = psim.grouped_cosine.launches
    got = psim.grouped_cosine(x, 8)
    assert psim.grouped_cosine.launches == before + 1
    torch.testing.assert_close(got, psim.grouped_cosine_reference(x, 8),
                               rtol=0, atol=1e-6)


# the kernel's blocks hold 64 points: P below one block and a ragged P
# above it
@pytest.mark.parametrize("n", [37, 3001])
@pytest.mark.parametrize("nv", [1, 2, 3, 4, 5, 8, 9, 10, 11, 12, 49])
@pytest.mark.parametrize("layout", ["channel_first", "point_major"])
def test_volume_fusion_kernel_matches_plain_on_gpu(rng, cuda_device, layout, nv, n):
    """Points with zero weight in every view and stage give exactly 0."""
    zero = min(n, 64)
    fws = [_t(f).to(cuda_device) for f in _fusion_case(rng, nv=nv, n=n, zero_rows=zero)]
    if layout == "channel_first":
        fws = [f.permute(0, 2, 1).contiguous().permute(0, 2, 1) for f in fws]
    before = pvf.volume_fusion.launches
    with torch.no_grad():
        got = pvf.volume_fusion(*fws)
    assert pvf.volume_fusion.launches == before + 1
    assert torch.all(got[:zero] == 0)
    torch.testing.assert_close(got, pvf.volume_fusion_reference(fws), rtol=0, atol=1e-6)


def test_volume_fusion_kernel_gradient_goes_through_the_plain_version_on_gpu(
        rng, cuda_device):
    """Where an input needs a gradient the wrapper launches inside the
    autograd Function, whose backward differentiates the plain version."""
    fws = [_t(f).to(cuda_device).requires_grad_() for f in _fusion_case(rng, n=300)]
    before = pvf.volume_fusion.launches
    got = torch.autograd.grad(pvf.volume_fusion(*fws).square().sum(), fws)
    assert pvf.volume_fusion.launches == before + 1
    want = torch.autograd.grad(pvf.volume_fusion_reference(fws).square().sum(), fws)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_default_config_gives_the_kernel_widths():
    """The repo's default DTU configuration is the one the kernels are
    built for: d_view 80 (img 32 + vol 24 + sim 16 + depth PE 8) and a
    ray-head width of 88."""
    from uforecon_tpu_torch.config import Config
    from uforecon_tpu_torch.models.ray_transformer import RayTransformer

    cfg = Config()
    assert (cfg.view_trans_dim, cfg.ray_trans_dim) == (C, CR)
    rt = RayTransformer(img_feat_dim=cfg.img_feat_dim, fea_volume_dim=cfg.fea_volume_dim,
                        sim_feat_fix=cfg.sim_feat_fix, depth_dim=cfg.depth_dim)
    assert rt.d_view == cfg.view_trans_dim
    assert rt.ray_head_params().wq.shape == (cfg.ray_trans_dim, cfg.ray_trans_dim)
    assert pph.pack_weights(rt.point_head_params()).numel() == \
        pph.pack_weights(_port_params(pph.PointHeadParams,
                                      _point_case(np.random.default_rng(0))[1])).numel()


# the forward kernel's tiles hold 4 points at L = 4, H = 8 (route A, D 10;
# route B, D 8): B below one tile, one past a multiple of it, and route B's
# D = 8 at the main path's ragged B; the view transformer of the other
# model configurations at D 9 (no depth PE) and 13 (use_dir_srdf; the
# feature grid without depth PE is D 8)
@pytest.mark.parametrize("b,l,h,d", [(65537, 4, 8, 10), (1000, 4, 8, 8), (333, 6, 8, 10),
                                     (77, 8, 3, 16), (5, 2, 1, 1), (3, 4, 8, 10),
                                     (1025, 4, 8, 10), (65537, 4, 8, 8),
                                     (65537, 4, 8, 9), (65537, 4, 8, 13)])
def test_tiny_attention_kernel_matches_plain_on_gpu(rng, cuda_device, b, l, h, d):
    q, k, v = (_t(a).to(cuda_device) for a in _attention_case(rng, b, l, l, h, d, d))
    before = pta.tiny_linear_attention.launches
    with torch.no_grad():
        got = pta.tiny_linear_attention(q, k, v)
    assert pta.tiny_linear_attention.launches == before + 1
    torch.testing.assert_close(got, pta.tiny_linear_attention_reference(q, k, v),
                               rtol=2e-5, atol=2e-5)


# the backward kernel's tiles hold 4 points at L = S = 4, H = 8 and 2 at
# L = S = 6 (the training shape): B below one tile and one past a multiple
# of it; L H not a multiple of 32; odd D and M, and L != S (float-wide rows)
@pytest.mark.parametrize("b,l,s,h,d,m", [(3, 4, 4, 8, 10, 10), (4097, 4, 4, 8, 10, 10),
                                         (301, 6, 6, 8, 10, 10), (300, 6, 6, 8, 8, 8),
                                         (77, 8, 8, 3, 16, 16), (257, 3, 5, 8, 7, 5),
                                         (64, 2, 2, 1, 1, 1)])
def test_tiny_attention_backward_kernel_matches_autograd_on_gpu(rng, cuda_device,
                                                               b, l, s, h, d, m):
    """The backward kernel, through the autograd Function, against
    torch.autograd of the plain forward."""
    q, k, v = (_t(a).to(cuda_device).requires_grad_()
               for a in _attention_case(rng, b, l, s, h, d, m))
    g = _t(rng.standard_normal((b, l, h, m))).to(cuda_device)
    want = torch.autograd.grad(pta.tiny_linear_attention_reference(q, k, v), (q, k, v), g)
    before = pta.tiny_linear_attention_backward.launches
    got = torch.autograd.grad(pta.tiny_linear_attention(q, k, v), (q, k, v), g)
    assert pta.tiny_linear_attention_backward.launches == before + 1
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("sn", SN_CASES + [144])
def test_ray_head_width_72_kernels_match_plain_on_gpu(rng, cuda_device, sn):
    """The ray head and its NeuS variant at the ablation's width; past 128
    samples the tensor-core layers take two passes over k."""
    y, rparams = _ray_case(rng, rn=37, sn=sn, c=CR_ABLATION)
    rp = _on(cuda_device, _port_params(prh.RayHeadParams, rparams))
    args = [_t(a).to(cuda_device) for a in (y, *_neus_case(rng, 37, sn))]
    before = (prh.ray_head.launches, prh.ray_head_neus.launches)
    got = prh.ray_head(args[0], rp)
    got_neus = prh.ray_head_neus(*args, rp)
    assert (prh.ray_head.launches, prh.ray_head_neus.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, prh.ray_head_reference(args[0], rp), rtol=0, atol=2e-5)
    for name, a, b in zip(("srdf", "weight", "rgb", "depth", "opacity"), got_neus,
                          prh.ray_head_neus_reference(*args, rp)):
        torch.testing.assert_close(a, b, rtol=2e-5 if name == "depth" else 0,
                                   atol=2e-5, msg=name)


@pytest.mark.parametrize("sn", RAY_LENGTHS)
@pytest.mark.parametrize("c", RAY_WIDTHS)
def test_ray_head_kernels_match_plain_at_every_width_and_length_on_gpu(rng, cuda_device,
                                                                      c, sn):
    """The ray head and its NeuS variant (3xTF32) at every width a flag set
    gives and at sample counts from 1 to 512, resident and streamed; at SN
    1 the NeuS weights are empty and its sums 0, as neus_render's."""
    y, rparams = _ray_case(rng, rn=37, sn=sn, c=c)
    rp = _on(cuda_device, _port_params(prh.RayHeadParams, rparams))
    args = [_t(a).to(cuda_device) for a in (y, *_neus_case(rng, 37, sn))]
    before = (prh.ray_head.launches, prh.ray_head_neus.launches)
    with torch.no_grad():
        got = prh.ray_head(args[0], rp)
        got_neus = prh.ray_head_neus(*args, rp)
    assert (prh.ray_head.launches, prh.ray_head_neus.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, prh.ray_head_reference(args[0], rp), rtol=0, atol=2e-5)
    for name, a, b in zip(("srdf", "weight", "rgb", "depth", "opacity"), got_neus,
                          prh.ray_head_neus_reference(*args, rp)):
        torch.testing.assert_close(a, b, rtol=2e-5 if name == "depth" else 0,
                                   atol=2e-5, msg=name)


@pytest.mark.parametrize("sn", RAY_LENGTHS)
@pytest.mark.parametrize("c", RAY_WIDTHS)
@pytest.mark.parametrize("kernel", ["ray_head", "ray_head_neus"])
def test_fast_ray_head_kernels_match_plain_at_every_width_and_length_on_gpu(
        rng, cuda_device, kernel, c, sn):
    """The bf16 ray heads at the same widths and lengths, by the size of
    the bf16 effect (``_fast_close_by_effect``); chip_smoke.py's kernel
    phase holds the configurations' shapes by the element share
    (FAST_SHARE) on 1024 rays."""
    _check_fast_kernel(rng, cuda_device, kernel, c=c, sn=sn, by_effect=True)


def test_head_variants_patch_the_kernel_sources_once():
    """Every patch and constant of the head-kernel variant timer
    (``script/head_variants.py``) names text that its source holds exactly
    once, so each variant changes what it says; unknown options raise."""
    from uforecon_tpu_torch.ops import cuda_build
    from uforecon_tpu_torch.script import head_variants as hv

    def text(name):
        return (cuda_build.CSRC / name).read_text()

    for kernel, consts in hv.CONSTANTS.items():
        for old, _ in consts.values():
            assert text(hv.SOURCE[kernel]).count(old) == 1, old
    for name, subs in hv.PATCHES.items():
        for f, old, new in subs:
            assert text(f).count(old) == 1 and old != new, (name, old)
    kernel, subs = hv.replacements("ph,T=256,nogemm,ph_ln")
    assert kernel == "ph" and len(subs) == 4
    assert subs[0][2] == "constexpr int kPointThreads = 256;"
    kernel, subs = hv.replacements("ph2,S=3,ph2_ln")
    assert kernel == "ph2" and len(subs) == 3 and subs[0][0] == "point_head2.cuh"
    kernel, subs = hv.replacements("ta,I=512,S=3")
    assert kernel == "ta" and [x[2] for x in subs] == ["constexpr int kFwdItems = 512;",
                                                       "constexpr int kFwdStages = 3;"]
    # the backward's stream alone: its three arithmetic phases skipped
    kernel, subs = hv.replacements("tb,I=64,tb_stream")
    assert kernel == "tb" and len(subs) == 4
    assert subs[0][2] == "constexpr int kBwdItems = 64;"
    assert all(" < 0 * " in new for _, _, new in subs[1:])
    kernel, subs = hv.replacements("vf,T=128,vf_direct")
    assert kernel == "vf" and subs[0][2] == "constexpr int kThreads = 128;"
    assert {f for f, _, _ in subs} == {"volume_fusion.cu"}
    for bad in ("xx", "ph,T", "rh,TP=8", "ph,nothing", "ta,nogemm_x", "ph2,I=4", "vf,S=2"):
        with pytest.raises(ValueError):
            hv.replacements(bad)


def _offset(t):
    """A contiguous copy of t that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def test_head_kernels_take_inputs_at_any_offset_on_gpu(rng, cuda_device):
    """The heads load their inputs in 16-byte pieces (cp.async) and the
    tiny attention, forward and backward, by TMA bulk copies; a contiguous
    input that starts off such a boundary gives the same outputs."""
    inputs, params = _point_case(rng, nv=3, n=4096)
    inp = pph.PointHeadInputs(**{k: _t(v).to(cuda_device) for k, v in inputs.items()})
    p = _on(cuda_device, _port_params(pph.PointHeadParams, params))
    shifted = pph.PointHeadInputs(*[_offset(t) for t in inp])
    assert shifted.img_feat.data_ptr() % 16 != 0
    with torch.no_grad():
        for head in (pph.point_head, pph2.point_head2):
            for a, b in zip(head(shifted, p), head(inp, p)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        q, k, v = (_t(a).to(cuda_device) for a in _attention_case(rng, b=1001))
        torch.testing.assert_close(
            pta.tiny_linear_attention(*map(_offset, (q, k, v))),
            pta.tiny_linear_attention(q, k, v), rtol=0, atol=0)
        g = _t(rng.standard_normal((1001, 4, 8, 10))).to(cuda_device)
        before = pta.tiny_linear_attention_backward.launches
        for a, b in zip(pta.tiny_linear_attention_backward(*map(_offset, (q, k, v, g))),
                        pta.tiny_linear_attention_backward(q, k, v, g)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert pta.tiny_linear_attention_backward.launches == before + 2
    y, rparams = _ray_case(rng, rn=37, sn=64)
    rp = _on(cuda_device, _port_params(prh.RayHeadParams, rparams))
    yd = _t(y).to(cuda_device)
    with torch.no_grad():
        torch.testing.assert_close(prh.ray_head(_offset(yd), rp), prh.ray_head(yd, rp),
                                   rtol=0, atol=0)
