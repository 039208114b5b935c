"""The port's kernel wrappers: routing, weight packs, the autograd
backward, and (``*_on_gpu``) the CUDA kernels against their plain
versions; those skip without a GPU.

This file imports no JAX, so the GPU tests run on a GPU machine without
it:

    python -m pytest --noconftest -k on_gpu tests/test_torch_port_kernels.py

Kernel tolerances: atol 2e-5 on token and srdf, 2e-6 on radiance (f32
with another summation order; chip_smoke.py measures ~2e-6 and ~2e-7).
"""
import numpy as np
import pytest
import torch

from uforecon_tpu_torch.ops import fused_point_head as pph
from uforecon_tpu_torch.ops import fused_ray_head as prh

torch.set_num_threads(1)

C = 80   # d_view at the default configuration
CR = 88  # + order PE


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _point_case(rng, nv=3, n=96, c=C):
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    mask = (rng.uniform(size=(nv, n)) > 0.3).astype(np.float32)
    mask[:, :5] = 0.0                      # points masked in every view
    inputs = dict(img_feat=r(nv, n, 32), vol_feat=r(n, 24), sim_feat=r(n, 8),
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


def test_wrappers_take_the_plain_version_on_cpu(rng):
    inputs, params = _point_case(rng, n=20)
    inp = pph.PointHeadInputs(**{k: _t(v) for k, v in inputs.items()})
    p = _port_params(pph.PointHeadParams, params)
    before = pph.point_head.launches
    for a, b in zip(pph.point_head(inp, p), pph.point_head_reference(inp, p)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    y, rparams = _ray_case(rng, rn=3, sn=8)
    rp = _port_params(prh.RayHeadParams, rparams)
    torch.testing.assert_close(prh.ray_head(_t(y), rp),
                               prh.ray_head_reference(_t(y), rp), rtol=0, atol=0)
    assert pph.point_head.launches == before


def test_kernel_launchers_reject_shapes_they_do_not_take(rng):
    inputs, params = _point_case(rng, n=8)
    inputs["img_feat"] = inputs["img_feat"][..., :16]
    with pytest.raises(ValueError, match="point_head kernel takes"):
        pph._launch(pph.PointHeadInputs(**{k: _t(v) for k, v in inputs.items()}),
                    _port_params(pph.PointHeadParams, params), 8)
    y, rparams = _ray_case(rng, rn=2, sn=6)
    with pytest.raises(ValueError, match="SN % 4"):
        prh._launch(_t(y), _port_params(prh.RayHeadParams, rparams), 8)


def test_weight_packs_match_the_kernel_layout(rng):
    """Sizes of the packs equal the N_W constants of csrc/*.cu (derived
    from the same layer widths), and the pack starts as the kernels
    expect."""
    _, params = _point_case(rng, n=4)
    p = _port_params(pph.PointHeadParams, params)
    pack = pph.pack_weights(p)
    c2 = 2 * C
    n_w = C + 4 * C * C + 2 * C + c2 * c2 + c2 * C + 2 * C \
        + (8 * 32 + 32) + (32 * 32 + 32) + (32 * 16 + 16) \
        + ((C + 3) * 16 + 16) + (16 * 8 + 8) + (8 + 1)
    assert pack.numel() == n_w
    torch.testing.assert_close(pack[:C], p.view_token)
    torch.testing.assert_close(pack[C:C + C * C].view(C, C), p.wq.t())
    _, rparams = _ray_case(rng, rn=1, sn=4)
    rp = _port_params(prh.RayHeadParams, rparams)
    c2 = 2 * CR
    assert prh.pack_weights(rp).numel() == 4 * CR * CR + 2 * CR + c2 * c2 + c2 * CR \
        + 2 * CR + (CR * 32 + 32) + (32 * 16 + 16) + (16 + 1)


@pytest.mark.parametrize("head", ["point", "ray"])
def test_autograd_backward_goes_through_the_plain_version(rng, monkeypatch, head):
    """The kernel Functions' backward: launch replaced by the plain
    forward so it runs on the CPU; gradients must equal plain autograd."""
    if head == "point":
        inputs, params = _point_case(rng, n=12)
        monkeypatch.setattr(pph, "_launch", lambda i, p, h: pph.point_head_reference(i, p, h))
        # the mask only selects, it has no gradient
        inp = [_t(v).requires_grad_(k != "mask") for k, v in inputs.items()]
        par = [t.requires_grad_() for t in
               pph._flat_params(_port_params(pph.PointHeadParams, params))]

        def plain():
            return pph.point_head_reference(pph.PointHeadInputs(*inp),
                                            pph._unflat_params(par))

        def fused():
            return pph._PointHeadFn.apply(8, *inp, *par)
    else:
        y, rparams = _ray_case(rng, rn=3, sn=8)
        monkeypatch.setattr(prh, "_launch", lambda y_, p, h: prh.ray_head_reference(y_, p, h))
        inp = [_t(y).requires_grad_()]
        par = [t.requires_grad_() for t in
               prh._flat_params(_port_params(prh.RayHeadParams, rparams))]

        def plain():
            return (prh.ray_head_reference(inp[0], prh._unflat_params(par)),)

        def fused():
            return (prh._RayHeadFn.apply(8, inp[0], *par),)

    leaves = [t for t in inp + par if t.requires_grad]
    g_plain = torch.autograd.grad(sum(o.square().sum() for o in plain()), leaves)
    g_fused = torch.autograd.grad(sum(o.square().sum() for o in fused()), leaves)
    for a, b in zip(g_fused, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("nv", [2, 3, 4, 5])
def test_point_head_kernel_matches_plain_on_gpu(rng, cuda_device, nv):
    inputs, params = _point_case(rng, nv=nv, n=1000)
    inp = pph.PointHeadInputs(**{k: _t(v).to(cuda_device) for k, v in inputs.items()})
    p = pph.PointHeadParams(*[(tuple(x.to(cuda_device) for x in v) if isinstance(v, tuple)
                               else v.to(cuda_device))
                              for v in _port_params(pph.PointHeadParams, params)])
    before = pph.point_head.launches
    tok, rad = pph.point_head(inp, p)
    tok_ref, rad_ref = pph.point_head_reference(inp, p)
    assert pph.point_head.launches == before + 1
    torch.testing.assert_close(tok, tok_ref, rtol=0, atol=2e-5)
    torch.testing.assert_close(rad, rad_ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("sn", [8, 64, 128])
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
