"""The arithmetic of the head kernels' tensor-core layers, on the CPU.

``csrc/point_head.cu``, ``csrc/point_head2.cu`` and ``csrc/ray_head.cu``
run their q/k/v/merge (v2: the split projections), mlp1 and mlp2 layers
on the tensor cores in 3xTF32 (``csrc/tc_gemm.cuh``): every operand x is
split into hi = RNA(x) and lo = RNA(x - hi), TF32 values
rounded to nearest with ties away from zero, and a product a b is taken as
lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b dropped). The weights come
pre-split in the pack, as a hi plane and a lo plane per matrix. Here:

  * the packs' planes reproduce every tensor-core weight to 2^-21 relative,
    and are the RNA split of an emulation written here (bit masking on the
    int32 view, checked against the frexp definition);
  * the heads' plain versions (for the split-weight point head, the
    transcription of its kernel's algebra from the pack) with every
    tensor-core layer replaced by the emulated 3xTF32 product hold the JAX
    package's references to 1e-5 (the
    CPU parity tolerance of the head modules), with weights from a numpy
    seed through ``convert.load_flax_variables``; one TF32 product alone
    does not, so a precision scheme too weak for the kernels fails here,
    before the card;
  * the weight packs are built once per set of weights, and again after an
    in-place update, ``load_state_dict`` or a move.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uforecon_tpu.ops import fused_point_head as jph
from uforecon_tpu.ops import fused_point_head2 as jph2
from uforecon_tpu.ops import fused_ray_head as jrh

from uforecon_tpu_torch.convert import load_flax_variables
from uforecon_tpu_torch.models import ray_transformer as prt
from uforecon_tpu_torch.ops import fused_point_head as pph
from uforecon_tpu_torch.ops import fused_point_head2 as pph2
from uforecon_tpu_torch.ops import fused_ray_head as prh

from test_torch_port_heads import _jax_point
from test_torch_port_kernels import _point_case, _t
from test_torch_port_point_head2 import _split_algebra

torch.set_num_threads(1)

TOL = 1e-5
TC_LAYERS = ("wq", "wk", "wv", "wmerge", "w1", "w2")


def rna(x: torch.Tensor) -> torch.Tensor:
    """TF32 round to nearest, ties away from zero: add half of the 13
    dropped mantissa bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32)


def tc_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.linear(x, w)`` as the kernels' tensor-core layers compute it."""
    wt = w.t()
    xh, wh = rna(x), rna(wt)
    xl, wl = rna(x - xh), rna(wt - wh)
    return (xl @ wh + xh @ wl) + xh @ wh


def tc_planes_mm(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """``x @ (hi + lo)`` as csrc/point_head2.cu's tensor-core layers
    compute it from a pack's planes (2, in, out): the weights pre-split,
    the activations split here."""
    wh, wl = planes[0], planes[1]
    xh = rna(x)
    xl = rna(x - xh)
    return (xl @ wh + xh @ wl) + xh @ wh


def tf32_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One TF32 product: what the tensor cores give without the split."""
    return rna(x) @ rna(w.t())


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_rna_rounds_to_nearest_with_ties_away_from_zero(rng):
    x = rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(-6, 6, 4096)
    # exact ties: 11 significant bits and a twelfth set
    ties = ((rng.integers(1 << 10, 1 << 11, 64) * 2 + 1).astype(np.float64)
            * 2.0 ** rng.integers(-20, 10, 64)).astype(np.float32)
    x = np.concatenate([x, ties, -ties, [0.0, -0.0]]).astype(np.float32)
    m, e = np.frexp(np.abs(x).astype(np.float64))
    ulp = np.ldexp(1.0, e - 11)
    want = np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp
    got = rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert (np.abs(got[4096:4160]) > np.abs(ties)).all()   # ties go away from zero


def _layout(width, tok):
    """(name, offset, (k, n)) of each tensor-core matrix in the pack of a
    head of token width ``width``: [tok] q k v merge (2 planes of C x C)
    norm1 (2C) mlp1 (2 planes of 2C x 2C) mlp2 (2 planes of 2C x C)."""
    c, c2 = width, 2 * width
    off, out = (c if tok else 0), []
    for name in ("wq", "wk", "wv", "wmerge"):
        out.append((name, off, (c, c)))
        off += 2 * c * c
    off += 2 * c
    out.append(("w1", off, (c2, c2)))
    off += 2 * c2 * c2
    out.append(("w2", off, (c2, c)))
    return out


def _ray_transformer(rng, explicit_similarity=True):
    """A port RayTransformer filled from a seeded flax tree through the
    weight bridge; returns it and the tree's ``params``."""
    rt = prt.RayTransformer(sim_feat_fix=16 if explicit_similarity else 0)
    tree = {}
    for key, t in rt.state_dict().items():
        *path, leaf = key.split(".")
        if leaf == "weight" and t.ndim == 2:
            value = rng.standard_normal(t.shape[::-1]) / np.sqrt(t.shape[1])
            leaf = "kernel"
        elif leaf == "weight":          # LayerNorm
            value, leaf = 1 + 0.1 * rng.standard_normal(t.shape), "scale"
        else:
            value = 0.1 * rng.standard_normal(t.shape)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value.astype(np.float32)
    load_flax_variables(rt, {"params": tree})
    return rt, tree


def _jax_point_params(tree):
    lv = tree["density_view_transformer"]["layer_0"]
    sp, rp = tree["pre_sim_mlp"], tree["linear_radianceweight_1_softmax"]
    dense = lambda t, leaf: tuple(t[f"Dense_{i}"][leaf] for i in range(3))
    return dict(view_token=tree["view_token"].reshape(-1),
                wq=lv["q_proj"]["kernel"], wk=lv["k_proj"]["kernel"],
                wv=lv["v_proj"]["kernel"], wmerge=lv["merge"]["kernel"],
                norm1_scale=lv["norm1"]["scale"], norm1_bias=lv["norm1"]["bias"],
                w1=lv["mlp1"]["kernel"], w2=lv["mlp2"]["kernel"],
                norm2_scale=lv["norm2"]["scale"], norm2_bias=lv["norm2"]["bias"],
                sim_w=dense(sp, "kernel"), sim_b=dense(sp, "bias"),
                rad_w=dense(rp, "kernel"), rad_b=dense(rp, "bias"))


def _jax_ray(y, tree):
    lv, dp = tree["density_ray_transformer"]["layer_0"], tree["density_mlp"]
    j = jnp.asarray
    p = jrh.RayHeadParams(
        wq=j(lv["q_proj"]["kernel"]), wk=j(lv["k_proj"]["kernel"]),
        wv=j(lv["v_proj"]["kernel"]), wmerge=j(lv["merge"]["kernel"]),
        norm1_scale=j(lv["norm1"]["scale"]), norm1_bias=j(lv["norm1"]["bias"]),
        w1=j(lv["mlp1"]["kernel"]), w2=j(lv["mlp2"]["kernel"]),
        norm2_scale=j(lv["norm2"]["scale"]), norm2_bias=j(lv["norm2"]["bias"]),
        dens_w=tuple(j(dp[f"Dense_{i}"]["kernel"]) for i in range(3)),
        dens_b=tuple(j(dp[f"Dense_{i}"]["bias"]) for i in range(3)))
    return np.asarray(jrh.ray_head_reference(jnp.asarray(y), p))


def _layout2(p):
    """(name, offset, (k, n), the unsplit matrix) of each tensor-core
    matrix in point_head2's split pack."""
    lay = pph2.layout2(80, 32, 24, 16)
    parts = pph2.split_weights2(p)
    return [(name, lay[name][0], lay[name][1][1:], parts[name]) for name in pph2.TC_MATRICES]


@pytest.mark.parametrize("head", ["point", "point2", "ray88", "ray72"])
def test_packed_planes_split_every_tensor_core_weight(rng, head):
    """(a) hi + lo reproduces each tensor-core weight to 2^-21 relative;
    hi and lo are TF32 values, the RNA split of this file's emulation."""
    rt, _ = _ray_transformer(rng, explicit_similarity=head != "ray72")
    if head == "point2":
        p = rt.point_head_params()
        pack, layout = pph2.pack_weights2(p), _layout2(p)
        assert [name for name, *_ in layout] == ["sh", "v_qkv", "wm", "v_w1", "w2", "v_rad"]
        # the split matrices hold the point head's weights: merge and mlp2 whole
        torch.testing.assert_close(layout[2][3], p.wmerge.detach().t(), rtol=0, atol=0)
        torch.testing.assert_close(layout[4][3], p.w2.detach().t(), rtol=0, atol=0)
    else:
        if head == "point":
            p, pack, width = rt.point_head_params(), pph.pack_weights(rt.point_head_params()), 80
        else:
            p = rt.ray_head_params()
            pack, width = prh.pack_weights(p), p.wq.shape[0]
        assert width == {"point": 80, "ray88": 88, "ray72": 72}[head]
        layout = [(name, off, kn, getattr(p, name).detach().t())
                  for name, off, kn in _layout(width, tok=head == "point")]
        assert [name for name, *_ in layout] == list(TC_LAYERS)
    for name, off, (k, n), w in layout:
        hi = pack[off:off + k * n].view(k, n)
        lo = pack[off + k * n:off + 2 * k * n].view(k, n)
        torch.testing.assert_close(hi, rna(w), rtol=0, atol=0)
        torch.testing.assert_close(lo, rna(w - hi), rtol=0, atol=0)
        assert (rna(lo) == lo).all()
        assert ((hi + lo - w).abs() <= 2.0 ** -21 * w.abs()).all(), name


@pytest.mark.parametrize("nv", [2, 3])
def test_point_head_in_3xtf32_matches_jax(rng, nv):
    """(b) The point head's plain version with its tensor-core layers in
    emulated 3xTF32 against the JAX point_head_reference."""
    rt, tree = _ray_transformer(rng)
    inputs, _ = _point_case(rng, nv=nv)
    tok_ref, rad_ref = _jax_point(inputs, _jax_point_params(tree))
    inp = pph.PointHeadInputs(**{k: _t(v) for k, v in inputs.items()})
    with torch.no_grad():
        tok, rad = pph.point_head_reference(inp, rt.point_head_params(), linear=tc_linear)
    np.testing.assert_allclose(tok.numpy(), tok_ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rad.numpy(), rad_ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rad.numpy()[:5], inputs["rgb"][:, :5].mean(0),
                               rtol=TOL, atol=1e-6)


@pytest.mark.parametrize("nv", [2, 3, 5])
def test_point_head2_in_3xtf32_matches_jax(rng, nv):
    """(b) The split-weight point head's algebra (the transcription of
    csrc/point_head2.cu that reads the pack) with its tensor-core products
    in emulated 3xTF32 from the pack's planes, against the JAX
    point_head2_reference."""
    rt, tree = _ray_transformer(rng)
    inputs, _ = _point_case(rng, nv=nv)
    j = lambda v: tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v)
    tok_ref, rad_ref = jph2.point_head2_reference(
        jph2.PointHeadInputs2(**{k: jnp.asarray(v) for k, v in inputs.items()}),
        jph.PointHeadParams(**{k: j(v) for k, v in _jax_point_params(tree).items()}))
    inp = pph2.PointHeadInputs2(**{k: _t(v) for k, v in inputs.items()})
    with torch.no_grad():
        tok, rad = _split_algebra(inp, pph2.pack_weights2(rt.point_head_params()),
                                  (80, 32, 24, 16, 32), tc_mm=tc_planes_mm)
    np.testing.assert_allclose(tok.numpy(), np.asarray(tok_ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rad.numpy(), np.asarray(rad_ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rad.numpy()[:5], inputs["rgb"][:, :5].mean(0),
                               rtol=TOL, atol=1e-6)


@pytest.mark.parametrize("width,sn", [(88, 8), (88, 20), (88, 64), (72, 36)])
def test_ray_head_in_3xtf32_matches_jax(rng, width, sn):
    """(b) The ray head's plain version with its tensor-core layers in
    emulated 3xTF32 against the JAX ray_head_reference."""
    rt, tree = _ray_transformer(rng, explicit_similarity=width == 88)
    y = rng.standard_normal((5, sn, width)).astype(np.float32)
    with torch.no_grad():
        got = prh.ray_head_reference(_t(y), rt.ray_head_params(), linear=tc_linear)
    np.testing.assert_allclose(got.numpy(), _jax_ray(y, tree), rtol=TOL, atol=TOL)


def test_one_tf32_product_misses_the_tolerance(rng):
    """The control: the same checks with one TF32 product per layer (no
    split) miss 1e-5 by far, so the two tests above can tell a precision
    scheme too weak for the kernels."""
    rt, tree = _ray_transformer(rng)
    inputs, _ = _point_case(rng, nv=3)
    tok_ref, _ = _jax_point(inputs, _jax_point_params(tree))
    inp = pph.PointHeadInputs(**{k: _t(v) for k, v in inputs.items()})
    y = rng.standard_normal((5, 64, 88)).astype(np.float32)
    with torch.no_grad():
        tok, _ = pph.point_head_reference(inp, rt.point_head_params(), linear=tf32_linear)
        srdf = prh.ray_head_reference(_t(y), rt.ray_head_params(), linear=tf32_linear)
    assert np.abs(tok.numpy() - tok_ref).max() > 10 * TOL
    assert np.abs(srdf.numpy() - _jax_ray(y, tree)).max() > 10 * TOL


def _check_pack_cache(cached, fresh, wrapper, params_of, rt, weight):
    """(c) One build over two calls, the cached pack equal to a fresh one,
    a rebuild after an in-place update, after load_state_dict and after a
    move; no rebuild without a change."""
    before = wrapper.pack_builds
    a = cached(params_of(rt))
    b = cached(params_of(rt))
    assert wrapper.pack_builds == before + 1 and a is b
    assert torch.equal(a, fresh(params_of(rt)))
    with torch.no_grad():
        weight().add_(1e-3)                       # an optimiser step
    c = cached(params_of(rt))
    assert wrapper.pack_builds == before + 2 and torch.equal(c, fresh(params_of(rt)))
    assert not torch.equal(c, a)
    rt.load_state_dict({k: v.clone() for k, v in rt.state_dict().items()})
    d = cached(params_of(rt))
    assert wrapper.pack_builds == before + 3 and torch.equal(d, c)
    rt.double().float()                           # .to(): new storage
    e = cached(params_of(rt))
    assert wrapper.pack_builds == before + 4 and torch.equal(e, c)
    assert cached(params_of(rt)) is e and wrapper.pack_builds == before + 4


def test_point_head_pack_is_built_once_per_weights(rng):
    rt, _ = _ray_transformer(rng)
    _check_pack_cache(pph.cached_pack_weights, pph.pack_weights, pph.point_head,
                      lambda m: m.point_head_params(), rt,
                      lambda: rt.density_view_transformer.layer_0.mlp1.weight)


def test_ray_head_pack_is_built_once_per_weights(rng):
    rt, _ = _ray_transformer(rng)
    _check_pack_cache(prh.cached_pack_weights, prh.pack_weights, prh.ray_head,
                      lambda m: m.ray_head_params(), rt,
                      lambda: rt.density_ray_transformer.layer_0.q_proj.weight)


def test_order_pe_is_built_once_per_shape(rng):
    rt, _ = _ray_transformer(rng)
    token = _t(rng.standard_normal((3, 20, 80)))
    a, b = rt._ray_input(token), rt._ray_input(token * 2)
    torch.testing.assert_close(a[..., 80:], b[..., 80:], rtol=0, atol=0)
    assert prt._order_pe(8, 20, token.device) is prt._order_pe(8, 20, token.device)
    pe = torch.as_tensor(prt.order_posenc(8, 20))
    torch.testing.assert_close(a[..., 80:], pe.expand(3, 20, 8), rtol=0, atol=0)
    torch.testing.assert_close(F.pad(token, (0, 8)) + F.pad(a[..., 80:], (80, 0)), a)
