"""The fast split-weight point-head kernel (``csrc/point_head2_fast.cuh``,
kernel 4 in ``fast`` at 2..11 views and tokens of 80 and 72): its weight
pack read back as the kernel reads it, its tiles' shared memory, the
wrapper's dispatch, and (``*_on_gpu``) the kernel against its fast plain
version; those skip without a GPU.

The kernel copies the image at the head of ``fused_point_head2.fast_image2``
into shared memory as it is and takes each matrix's rows at the offsets of
``Img``, transcribed below, and the view token's constants from after the
image; a wrong row slice or stride shows here as a weight that is not the
bf16-rounded one. The expected matrices are sliced from the head's weights
here, by feature group, not through ``split_weights2``. No JAX: the image
is the port's own layout, and the plain version it feeds is held to JAX
elsewhere (``test_torch_port_point_head2.py``, ``test_torch_port_views.py``).

    python -m pytest --noconftest -k on_gpu tests/test_torch_port_point_head2_fast.py
"""
import contextlib

import numpy as np
import pytest
import torch

from uforecon_tpu_torch.ops import cuda_build
from uforecon_tpu_torch.ops import fused_point_head as pph
from uforecon_tpu_torch.ops import fused_point_head2 as pph2

from test_torch_port_kernels import _check_fast_kernel, _point_case, _port_params, _t

SMEM_LIMIT = 232448   # bytes of shared memory an sm_90 block may have


def _params(c_vol, seed=0):
    _, params = _point_case(np.random.default_rng(seed), n=4, c_vol=c_vol)
    return _port_params(pph.PointHeadParams, params)


def _img_layout(c_vol):
    """Img<CV>'s matrices: name -> (bf16 offset, rows, stride, out, in); its
    FP32 part's offsets (floats) and length; the constants' offsets after
    the image (floats) and length."""
    c = 32 + c_vol + 16 + 8
    gs, gv, xk = c_vol + 16, 40, 48
    mats = [("sh", 3 * c + 2 * c + 16, gs), ("v_qkv", 3 * c, gv), ("wm", c, c),
            ("v_w1", 2 * c, gv + c), ("w2", c, 2 * c), ("v_rad", 16, xk + c),
            ("sw0", 32, 8), ("sw1", 32, 32), ("sw2", 16, 32), ("rw1", 8, 16), ("rw2", 1, 8)]
    out, off = {}, 0
    for name, n_out, n_in in mats:
        rows, stride = max(n_out, 8), cuda_build.image_stride(n_in)
        out[name] = (off, rows, stride, n_out, n_in)
        off += rows * stride
    f32 = {"n1s": 0, "n1b": c, "n2s": 2 * c, "n2b": 3 * c, "sb0": 4 * c, "sb1": 4 * c + 32,
           "sb2": 4 * c + 64, "rb1": 4 * c + 80, "rb2": 4 * c + 88}
    consts = {"tok": 0, "tok_q": c, "tok_k": 2 * c, "tok_v": 3 * c, "w1a_tok": 4 * c}
    return out, off, f32, 4 * c + 92, consts, 6 * c


def _pack_bytes(c_vol):
    """Img<CV>::PACK: the image and the view token's constants."""
    _, nbf, _, nf, _, nc = _img_layout(c_vol)
    return 2 * nbf + 4 * nf + 4 * nc


def _expected(p):
    """The image's matrices, (out, in), from the head's weights by feature
    group: the token is [img 32 | vol | sim16 16 | pe 8], the view-shared
    group [vol | sim16], the per-view one [img | pe]."""
    c = p.view_token.numel()
    shared = slice(32, c - 8)
    view = lambda w: torch.cat([w[:, :32], w[:, c - 8:c]], dim=1)
    w1a, r0 = p.w1[:, :c], p.rad_w[0]
    b = p.rad_b[0]
    hi = cuda_build.bf16_round(b)
    mid = cuda_build.bf16_round(b - hi)
    lo = cuda_build.bf16_round(b - hi - mid)
    return {
        "sh": torch.cat([w[:, shared] for w in (p.wq, p.wk, p.wv, w1a, r0[:, :c])]),
        "v_qkv": torch.cat([view(w) for w in (p.wq, p.wk, p.wv)]),
        "wm": p.wmerge,
        "v_w1": torch.cat([view(w1a), p.w1[:, c:]], dim=1),
        "w2": p.w2,
        # [img | pe | dir | 1 1 1 | 0 0 | m2]: the bias as three bf16 columns
        "v_rad": torch.cat([view(r0), r0[:, c:], hi[:, None], mid[:, None], lo[:, None],
                            r0.new_zeros(16, 2), r0[:, :c]], dim=1),
        "sw0": p.sim_w[0], "sw1": p.sim_w[1], "sw2": p.sim_w[2],
        "rw1": p.rad_w[1], "rw2": p.rad_w[2]}


@pytest.mark.parametrize("c_vol", [24, 16])
def test_fast_image2_holds_each_weight_where_the_kernel_reads_it(c_vol):
    p = _params(c_vol, seed=c_vol)
    c = p.view_token.numel()
    mats, nbf, f32, nf, consts, nc = _img_layout(c_vol)
    img = pph2.fast_image2(p)
    assert img.dtype == torch.float32 and img.numel() * 4 == _pack_bytes(c_vol)
    assert (2 * nbf) % 16 == 0 and nf % 4 == 0     # the image in whole bulk-copy units
    bf16 = img[:nbf // 2].view(torch.bfloat16).float()
    want = _expected(p)
    for name, (off, rows, stride, n_out, n_in) in mats.items():
        block = bf16[off:off + rows * stride].view(rows, stride)
        assert want[name].shape == (n_out, n_in), name
        assert torch.equal(block[:n_out, :n_in], cuda_build.bf16_round(want[name])), name
        assert torch.all(block[:, n_in:] == 0) and torch.all(block[n_out:] == 0), name
        # a B fragment's 32 lanes hit 32 banks: the stride is an odd
        # multiple of 4 words, and no shorter than the inputs
        assert stride >= n_in and stride % 2 == 0 and (stride // 2) % 8 == 4, name
    # the radiance bias adds in float32: its three bf16 columns sum to it
    torch.testing.assert_close(want["v_rad"][:, 43:46].double().sum(1), p.rad_b[0].double(),
                               rtol=0, atol=1e-7)
    tail = img[nbf // 2:]
    vectors = {"n1s": p.norm1_scale, "n1b": p.norm1_bias, "n2s": p.norm2_scale,
               "n2b": p.norm2_bias, "sb0": p.sim_b[0], "sb1": p.sim_b[1],
               "sb2": p.sim_b[2], "rb1": p.rad_b[1], "rb2": p.rad_b[2]}
    for name, off in f32.items():
        v = vectors[name].reshape(-1)
        assert torch.equal(tail[off:off + v.numel()], v), name
    assert not tail[f32["rb2"] + 1:nf].any()
    after = tail[nf:]
    assert after.numel() == nc
    tok = p.view_token.reshape(-1).double()
    phi = lambda x: torch.where(x > 0, x + 1, torch.exp(torch.clamp(x, max=0)))
    want_c = {"tok": tok, "tok_q": phi(p.wq.double() @ tok), "tok_k": phi(p.wk.double() @ tok),
              "tok_v": p.wv.double() @ tok, "w1a_tok": p.w1[:, :c].double() @ tok}
    for name, off in consts.items():
        v = want_c[name].float()
        torch.testing.assert_close(after[off:off + v.numel()], v, rtol=1e-6, atol=1e-6,
                                   msg=name)


@pytest.mark.parametrize("c_vol", [24, 16])
def test_fast_kernel2_tiles_fit_shared_memory(c_vol):
    """``smem_bytes`` transcribed: the image, its mbarrier, and each group's
    q, k, v (GR rows of C + 4 floats), the points' shared mlp1 | r0 parts
    (TP rows of 2C + 20) and X and S (GR + 16 rows of 56 bf16), within what
    an sm_90 block may have at every view count the kernel is built for
    (the tightest: 2 views, tokens of 80, 64 bytes to spare)."""
    c = 32 + c_vol + 16 + 8
    _, nbf, _, nf, _, _ = _img_layout(c_vol)
    image = 2 * nbf + 4 * nf
    for nv in range(2, pph2.KERNEL_COMPILED_VIEWS + 1):
        groups = 1 if nv > 5 else 2
        gr = 64 // groups
        tp = gr // (nv + 1)
        floats = 3 * gr * (c + 4) + tp * (2 * c + 20) + (gr + 16) * 56 // 2
        smem = image + 16 + 4 * groups * floats
        assert smem <= SMEM_LIMIT, (nv, smem)
        if c == 80 and nv == 2:
            assert smem == 232384
    if c == 80:
        assert image == 142704


class _Ext:
    """A kernel extension that records what point_head2's wrapper hands it."""

    def __init__(self, params, fail=False):
        self.params, self.fail, self.calls = params, fail, []

    def point_head2_weight_count(self, cv):
        return pph2.pack_weights2(self.params).numel()

    def point_head2_fast_pack_bytes(self, cv):
        return _pack_bytes(cv)

    def point_head2_scratch_floats(self, cv, nv, p):
        return 7

    def point_head2(self, *args):
        if self.fail:
            raise RuntimeError("point_head2 kernel launch failed")
        self.calls.append((args[0].shape[0], args[7].numel(), args[-1]))


@contextlib.contextmanager
def _recording(monkeypatch, ext):
    monkeypatch.setattr(cuda_build, "extension", lambda: ext)
    monkeypatch.setattr(cuda_build, "check_tensors", lambda name, tensors: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    cuda_build.clear_pack_caches()
    try:
        yield ext
    finally:
        cuda_build.clear_pack_caches()


def _inputs(nv, c_vol=24):
    inputs, _ = _point_case(np.random.default_rng(nv), nv=nv, n=8, c_vol=c_vol)
    return pph.PointHeadInputs(**{k: _t(v) for k, v in inputs.items()})


@pytest.mark.parametrize("c_vol", [24, 16])
def test_fast_views_take_the_image_and_the_rest_the_planes(monkeypatch, c_vol):
    """In ``fast`` 2..11 views hand the fast image to the extension, past 11
    views (the streamed kernel) and in 3xTF32 the planes; each pack is built
    once per set of weights, precision and layout (a 3xTF32 pack once for
    both sides of 11 views); fast launches count on ``launches_fast``."""
    p = _params(c_vol)
    planes = pph2.pack_weights2(p).numel()
    image = _pack_bytes(c_vol) // 4
    with _recording(monkeypatch, _Ext(p)) as ext:
        before = (pph2.point_head2.launches, pph2.point_head2.launches_fast,
                  pph2.point_head2.pack_builds)
        for nv, precision in ((3, "fast"), (11, "fast"), (2, "fast"), (12, "fast"),
                              (3, "high"), (12, "high"), (12, "highest")):
            pph2._launch(_inputs(nv, c_vol), p, 8, precision)
        assert ext.calls == [(3, image, True), (11, image, True), (2, image, True),
                             (12, planes, True), (3, planes, False), (12, planes, False),
                             (12, planes, False)]
        after = (pph2.point_head2.launches, pph2.point_head2.launches_fast,
                 pph2.point_head2.pack_builds)
        # packs: the fast image, the fast planes, 'high' (one on both sides
        # of 11 views) and 'highest'
        assert tuple(a - b for a, b in zip(after, before)) == (3, 4, 4)
    assert torch.equal(pph2.cached_pack_weights2(p, "fast"), pph2.fast_image2(p))
    assert torch.equal(pph2.cached_pack_weights2(p, "fast", streamed=True),
                       pph2.pack_weights2(p, precision="fast"))


def test_a_refused_fast_launch_raises_and_counts_nothing(monkeypatch):
    """No fallback: when the extension refuses the launch the wrapper raises
    and counts no launch."""
    p = _params(24)
    with _recording(monkeypatch, _Ext(p, fail=True)) as ext:
        before = (pph2.point_head2.launches, pph2.point_head2.launches_fast)
        with pytest.raises(RuntimeError, match="point_head2 kernel"):
            pph2._launch(_inputs(3), p, 8, "fast")
        assert ext.calls == []
        assert (pph2.point_head2.launches, pph2.point_head2.launches_fast) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def test_fast_kernel2_pack_size_is_the_image_on_gpu(cuda_device):
    ext = cuda_build.extension()
    for c_vol in (24, 16):
        assert ext.point_head2_fast_pack_bytes(c_vol) == _pack_bytes(c_vol)
        assert pph2.fast_image2(_params(c_vol)).numel() * 4 == _pack_bytes(c_vol)
    assert ext.point_head2_fast_pack_bytes(20) == -1


@pytest.mark.parametrize("nv", range(2, 12))
@pytest.mark.parametrize("c_vol", [24, 16])
def test_fast_kernel2_matches_plain_on_gpu(cuda_device, c_vol, nv):
    """At every view count the kernel is built for and both widths, on a
    ragged P (1001 points; the first 5 masked in every view): against
    ``point_head2_fast_reference`` by test_torch_port_kernels.py's fast
    rule, counted on ``launches_fast``, away from the 3xTF32 kernel by
    bf16's size."""
    _check_fast_kernel(np.random.default_rng(100 * nv + c_vol), cuda_device, "point_head2",
                       nv=nv, c_vol=c_vol)


def test_head_variants_time_the_fast_split_head():
    """``script/head_variants.py``: ``ph2f`` builds the fast kernel's two
    units alone, its phase skips and probe patch ``point_head2_fast.cuh``
    (each names text the source holds once:
    ``test_head_variants_patch_the_kernel_sources_once``), and the probe
    names one phase a mark; ``point_head2.cuh`` has no bf16 instance left,
    so ``ph2,fast`` is refused."""
    from uforecon_tpu_torch.script import head_variants as hv

    kernel, subs = hv.replacements("ph2f,ph2f_attn,ph2f_probe")
    assert kernel == "ph2f" and {f for f, _, _ in subs} == {"point_head2_fast.cuh"}
    assert hv.UNITS["ph2f"] == ("point_head2_fast.cu", "point_head2_fast_views.cu")
    assert (cuda_build.CSRC / "point_head2_fast.cuh").read_text().count("PH2F_MARK(") == \
        len(hv.PH2F_PHASES) + 2   # the macro's two definitions
    with pytest.raises(ValueError):
        hv.replacements("ph2,fast")


def test_build_starts_the_slow_sources_first():
    """``cuda_build.sources`` hands the build every kernel source once, the
    binding file and the slowest compiles (``SLOW_SOURCES``, each a file
    of ``csrc/``) first, so that ninja starts them first."""
    names = [f.name for f in cuda_build.sources()]
    on_disk = sorted(f.name for f in cuda_build.CSRC.glob("*.cu"))
    assert sorted(names) == sorted(["bindings.cpp", *on_disk])
    assert tuple(names[:len(cuda_build.SLOW_SOURCES)]) == cuda_build.SLOW_SOURCES
