"""The fast ray-head kernel (``csrc/ray_head_fast.cuh``, kernels 2 and 3 in
``fast`` at token widths 40 .. 112): its weight pack read back as the
kernel reads it, its shared memory, the attention's sum orders, the
wrappers' dispatch, and (``*_on_gpu``) the kernel against its plain
version and against ``csrc/ray_head.cu``'s bf16 instance, bit for bit;
those skip without a GPU.

The kernel copies the image at the head of ``fused_ray_head.fast_image``
into shared memory as it is and takes each matrix's rows at the offsets of
``Img`` (from C 96 on ``ImgW``: mlp1's B fragments and the density MLP's
first two matrices after the copied part, read from global memory),
transcribed below; a wrong row slice, stride or fragment shows here as a
weight that is not the bf16-rounded one. No JAX: the image is the port's
own layout, and the plain version it feeds is held to JAX elsewhere
(``test_torch_port_shipped.py``, ``test_torch_port_ray_widths.py``).

    python -m pytest --noconftest -k on_gpu tests/test_torch_port_ray_head_fast.py
"""
import contextlib

import numpy as np
import pytest
import torch

from uforecon_tpu_torch.ops import cuda_build
from uforecon_tpu_torch.ops import fused_ray_head as prh

from test_torch_port_kernels import _neus_case, _on, _port_params, _ray_case, _t

# Layout<C>::BYTES of csrc/ray_head_fast.cuh (what ufo_ray_head_fast_pack_bytes
# reports): Img's at C 40 .. 88, ImgW's (the copied part, mlp1's fragments
# and the density MLP's first two matrices) from C 96 on
PACK_BYTES = {40: 38672, 48: 57360, 56: 71440, 64: 96272, 72: 114448, 80: 145424,
              88: 167696, 96: 201744, 104: 227856, 112: 270864}
# Smem<C>::BYTES (ufo_ray_head_fast_smem_bytes): the copied image, the
# mbarrier and two groups' buffers, at most the 232,448 bytes an sm_90
# block may have
SMEM_LIMIT = 232448


def _params(c, seed=0):
    _, params = _ray_case(np.random.default_rng(seed), rn=1, sn=1, c=c)
    return _port_params(prh.RayHeadParams, params)


def _rows_layout(mats, off=0):
    """(name, rows, in) matrices as bf16 rows image_stride(in) apart from
    bf16 offset ``off``: name -> (offset, rows, stride, in), and the end."""
    out = {}
    for name, n_out, n_in in mats:
        stride = cuda_build.image_stride(n_in)
        out[name] = (off, n_out, stride, n_in)
        off += n_out * stride
    return out, off


def _img_layout(c):
    """Img<C>'s matrices (ImgW<C>'s copied ones at WIDE_WIDTHS): name ->
    (bf16 offset, rows, stride, in), the copied matrices' bf16 length, and
    its FP32 part's offsets (floats) and length."""
    wide = c in prh.WIDE_WIDTHS
    mats = [("wq", c, c), ("wk", c, c), ("wv", c, c), ("wmerge", c, c),
            *([] if wide else [("w1", 2 * c, 2 * c)]), ("w2", c, 2 * c),
            *([] if wide else [("dw0", 32, c), ("dw1", 16, 32)])]
    out, off = _rows_layout(mats)
    f32 = {"n1s": 0, "n1b": c, "n2s": 2 * c, "n2b": 3 * c, "db0": 4 * c, "db1": 4 * c + 32,
           "dw2": 4 * c + 48, "db2": 4 * c + 64}
    return out, off, f32, 4 * c + 68


def _group_bytes(c):
    """Smem<C>'s buffers of one group: phi(k) and v of a 64-sample chunk
    (bf16, 8 elements of slack each; at C 40 as wide as the density MLP's
    32 + 16 hidden values, which the warps' scratch over these buffers
    holds), the state (FP32 heads x DK x DK) and ksum (FP32)."""
    pk = 64 * max(c, 32 + 16) + 8
    return 2 * 2 * pk + 4 * 8 * (c // 8) ** 2 + 4 * c


def _smem_bytes(c):
    """Smem<C>::BYTES: the copied image, a 16-byte mbarrier slot, two
    groups."""
    _, nb, _, nf = _img_layout(c)
    return 2 * nb + 4 * nf + 16 + 2 * _group_bytes(c)


def _fragment_read(words, c):
    """mlp1 as the wide kernel reads its fragments: for slice c16 and k16
    step s, lane g * 4 + t's 16 bytes {b0, b1} of rows 16 c16 + g and then
    16 c16 + 8 + g, b0 the bf16 pair at columns 16 s + 2t, b1 eight on
    (low half first); returns the (2C, 2C) matrix they hold."""
    ks = 2 * c // 16
    frag = words.view(torch.bfloat16).float().reshape(ks, ks, 32, 2, 2, 2)   # c16 s lane j h e
    w = torch.full((2 * c, 2 * c), float("nan"))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(2):
            for h in range(2):
                for e in range(2):
                    for c16 in range(ks):
                        w[16 * c16 + 8 * j + g, 8 * h + 2 * t + e::16] = frag[c16, :, lane, j, h, e]
    return w


@pytest.mark.parametrize("c", prh.FAST_WIDTHS)
def test_fast_image_holds_each_weight_where_the_kernel_reads_it(c):
    p = _params(c)
    wide = c in prh.WIDE_WIDTHS
    mats, nb, f32, nf = _img_layout(c)
    img = prh.fast_image(p)
    assert img.dtype == torch.float32 and img.numel() * 4 == PACK_BYTES[c]
    assert (2 * nb) % 16 == 0 and nf % 4 == 0     # the image in whole bulk-copy units
    bf16 = img[:nb // 2].view(torch.bfloat16).float()
    weights = {"wq": p.wq, "wk": p.wk, "wv": p.wv, "wmerge": p.wmerge, "w1": p.w1,
               "w2": p.w2, "dw0": p.dens_w[0], "dw1": p.dens_w[1]}

    def check_rows(bf16, mats):
        for name, (off, rows, stride, n_in) in mats.items():
            block = bf16[off:off + rows * stride].view(rows, stride)
            assert torch.equal(block[:, :n_in], cuda_build.bf16_round(weights[name])), name
            assert torch.all(block[:, n_in:] == 0), name
            # a B fragment's 32 lanes hit 32 banks: the stride is an odd
            # multiple of 4 words, and no shorter than the inputs
            assert stride >= n_in and stride % 8 == 0 and (stride // 2) % 8 == 4, name

    check_rows(bf16, mats)
    tail = img[nb // 2:nb // 2 + nf]
    vectors = {"n1s": p.norm1_scale, "n1b": p.norm1_bias, "n2s": p.norm2_scale,
               "n2b": p.norm2_bias, "db0": p.dens_b[0], "db1": p.dens_b[1],
               "dw2": cuda_build.bf16_round(p.dens_w[2]), "db2": p.dens_b[2]}
    for name, off in f32.items():
        v = vectors[name].reshape(-1)
        assert torch.equal(tail[off:off + v.numel()], v), name
    assert tail.numel() == nf and not tail[4 * c + 65:].any()
    rest = img[nb // 2 + nf:]
    if not wide:
        assert rest.numel() == 0
        return
    # the part read from global memory: mlp1's fragments, 16-byte aligned,
    # then the density MLP's first two matrices as Img holds them
    assert (2 * nb + 4 * nf) % 16 == 0
    n_frag = (2 * c // 16) ** 2 * 32 * 4   # words
    assert torch.equal(_fragment_read(rest[:n_frag], c), cuda_build.bf16_round(p.w1))
    dense, n_dense = _rows_layout([("dw0", 32, c), ("dw1", 16, 32)])
    assert rest.numel() == n_frag + n_dense // 2
    check_rows(rest[n_frag:].view(torch.bfloat16).float(), dense)


def test_fast_kernel_fits_shared_memory_at_every_width():
    """Smem<C> at every fast width within the 232,448 bytes of an sm_90
    block: the whole image up to C 88, the wide layout from C 96 on, where
    the whole image and the two groups' buffers would pass it (345,312
    bytes at C 112); 232,416 at C 112."""
    for c in prh.FAST_WIDTHS:
        whole = 2 * _rows_layout([("q", 4 * c, c), ("w1", 2 * c, 2 * c), ("w2", c, 2 * c),
                                  ("dw0", 32, c), ("dw1", 16, 32)])[1] + 4 * (4 * c + 68)
        assert (whole + 16 + 2 * _group_bytes(c) > SMEM_LIMIT) == (c in prh.WIDE_WIDTHS), c
        assert _smem_bytes(c) <= SMEM_LIMIT, c
        if c not in prh.WIDE_WIDTHS:
            assert whole == PACK_BYTES[c]
    assert _smem_bytes(112) == 232416 and _smem_bytes(88) == 221280


def test_fast_pack_is_the_image_at_the_fast_widths_and_the_planes_elsewhere():
    """``pack_weights(p, 'fast')`` is the image at 40 .. 112; at a width
    below (no JAX flag set gives one) ``csrc/ray_head.cu``'s bf16
    instantiation reads the 3xTF32 pack's layout with bf16 values and a
    zero plane where the lo plane was. ``high`` is the planes at every
    width."""
    assert prh.FAST_WIDTHS == tuple(range(40, 113, 8))
    for c in prh.FAST_WIDTHS:
        p = _params(c)
        assert torch.equal(prh.pack_weights(p, "fast"), prh.fast_image(p))
        assert prh.pack_weights(p).numel() != prh.fast_image(p).numel()
    p = _params(32)
    fast, high = prh.pack_weights(p, "fast"), prh.pack_weights(p)
    assert fast.numel() == high.numel() and not torch.equal(fast, high)
    assert torch.equal(fast[:32 * 32], cuda_build.bf16_round(p.wq.t().reshape(-1)))
    assert not fast[32 * 32:2 * 32 * 32].any()


@pytest.mark.parametrize("c, sn", [(88, 64), (72, 130), (112, 256), (64, 17)])
def test_fast_attention_sums_are_the_kernels_ordered_fmas(c, sn):
    """The fast plain version's attention sums on the CPU are the kernel's
    (and ``ray_head.cu`` kFast's) bit for bit: kv = sum_s phi(k_s) v_s^T
    added in sample order, den and num over the head's features in order,
    each product of two bf16 values exact in float32, so an FP32 FMA chain
    is an add chain. (ksum, the layers, the LayerNorms and the density MLP
    sum in other orders on the CPU: the card's checks hold those by the
    bf16 effect; the kernel adds each density layer's bias first, the CPU
    last.)"""
    rng = np.random.default_rng(c)
    rn, nh, dk = 5, 8, c // 8
    r = cuda_build.bf16_round
    kf = torch.exp(_t(rng.standard_normal((rn, sn, nh, dk))))
    vh = _t(rng.standard_normal((rn, sn, nh, dk)))
    qf = r(torch.exp(_t(rng.standard_normal((rn, sn, nh, dk)))))
    # the plain version's sums (ray_head_reference)
    kv = torch.einsum("bshd,bshm->bhmd", r(kf), r(vh))
    ks = r(kf.sum(dim=1))
    den = torch.einsum("blhd,bhd->blh", qf, ks)
    num = torch.einsum("blhd,bhmd->blhm", qf, r(kv))
    # the kernel's: FMA chains in sample, then feature order
    kv_k = torch.zeros(rn, nh, dk, dk)
    for s in range(sn):
        kv_k = kv_k + r(vh)[:, s, :, :, None] * r(kf)[:, s, :, None, :]
    den_k, num_k = torch.zeros(rn, sn, nh), torch.zeros(rn, sn, nh, dk)
    for d in range(dk):
        den_k = den_k + qf[..., d] * ks[:, None, :, d]
        num_k = num_k + qf[..., d, None] * r(kv)[:, None, :, :, d]
    assert torch.equal(kv, kv_k) and torch.equal(den, den_k) and torch.equal(num, num_k)


class _Ext:
    """A kernel extension that records which entry point the wrappers
    call, with the pack's size and the precision flag."""

    def __init__(self, fail=False):
        self.calls, self.fail = [], fail

    def ray_head_weight_count(self, c):
        return prh.pack_weights(_params(c)).numel()

    def ray_head_smem_bytes(self, sn, c, neus, limit):
        return 1

    def ray_head_fast_pack_bytes(self, c):
        return PACK_BYTES.get(c, -1)

    def ray_head_fast_smem_bytes(self, c):
        return _smem_bytes(c) if c in PACK_BYTES else -1

    def _record(self, name, w, fast=None):
        if self.fail:
            raise RuntimeError(f"{name} kernel launch failed")
        self.calls.append((name, w.numel(), fast))

    def ray_head(self, y, w, srdf, fast):
        self._record("ray_head", w, fast)

    def ray_head_neus(self, *args):
        self._record("ray_head_neus", args[1], args[-1])

    def ray_head_fast(self, y, w, srdf):
        self._record("ray_head_fast", w)

    def ray_head_neus_fast(self, *args):
        self._record("ray_head_neus_fast", args[1])


@contextlib.contextmanager
def _recording(monkeypatch, ext):
    monkeypatch.setattr(cuda_build, "extension", lambda: ext)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(prh, "_smem_limit", lambda dev: 232448)
    cuda_build.clear_pack_caches()
    try:
        yield ext
    finally:
        cuda_build.clear_pack_caches()


def _launch_both(c, precision, sn=5):
    p = _params(c)
    rng = np.random.default_rng(1)
    y = _t(rng.standard_normal((3, sn, c)))
    z, rad, inv_s = (_t(a) for a in _neus_case(rng, 3, sn))
    prh._launch(y, p, 8, precision)
    prh._launch_neus(y, z, rad, inv_s, p, 8, precision)


def test_fast_widths_take_the_fast_kernel_and_the_rest_ray_head_cu(monkeypatch):
    """In ``fast`` every width 40 .. 112 reaches ``ray_head_fast`` /
    ``ray_head_neus_fast`` with the image (the wide one from C 96 on);
    ``high`` at those widths, and ``fast`` below them, reach
    ``csrc/ray_head.cu`` (its bf16 instantiation in ``fast``) with the
    planes; every fast launch counts on ``launches_fast``, the rest on
    ``launches``."""
    widths = tuple(range(40, 113, 8))
    cases = [(c, precision) for c in widths for precision in ("fast", "high")]
    cases += [(72, "highest"), (32, "fast"), (8, "fast")]
    with _recording(monkeypatch, _Ext()) as ext:
        before = {w: (w.launches, w.launches_fast) for w in (prh.ray_head, prh.ray_head_neus)}
        for c, precision in cases:
            _launch_both(c, precision)
        want = []
        for c, precision in cases:
            if precision == "fast" and c >= 40:
                want += [("ray_head_fast", PACK_BYTES[c] // 4, None),
                         ("ray_head_neus_fast", PACK_BYTES[c] // 4, None)]
            else:
                n = prh.pack_weights(_params(c)).numel()
                want += [("ray_head", n, precision == "fast"),
                         ("ray_head_neus", n, precision == "fast")]
        assert ext.calls == want
        n_fast = sum(precision == "fast" for _, precision in cases)
        for w in (prh.ray_head, prh.ray_head_neus):
            assert (w.launches - before[w][0], w.launches_fast - before[w][1]) == \
                (len(cases) - n_fast, n_fast)
    for c in widths:
        assert prh.takes_fast_kernel(c, "fast") and not prh.takes_fast_kernel(c, "high")
        assert not prh.takes_fast_kernel(c, "highest")
    assert not prh.takes_fast_kernel(32, "fast")


def test_a_refused_fast_launch_raises_and_runs_nothing_else(monkeypatch):
    """No fallback: when the fast kernel's launch fails the wrapper raises,
    calls no other entry point and counts no launch; so does a card whose
    blocks have less shared memory than the kernel's (C 112's 232,416
    bytes)."""
    with _recording(monkeypatch, _Ext(fail=True)) as ext:
        before = (prh.ray_head.launches, prh.ray_head.launches_fast)
        for c, sn in ((88, 64), (88, 128), (112, 64), (80, 130)):
            with pytest.raises(RuntimeError, match="ray_head_fast kernel"):
                prh._launch(_t(np.ones((2, sn, c))), _params(c), 8, "fast")
        assert ext.calls == [] and (prh.ray_head.launches, prh.ray_head.launches_fast) == before
    with _recording(monkeypatch, _Ext()) as ext:
        monkeypatch.setattr(prh, "_smem_limit", lambda dev: 232415)
        with pytest.raises(ValueError, match="232416 bytes of shared memory at C=112"):
            prh._launch(_t(np.ones((2, 64, 112))), _params(112), 8, "fast")
        prh._launch(_t(np.ones((2, 64, 88))), _params(88), 8, "fast")
        assert ext.calls == [("ray_head_fast", PACK_BYTES[88] // 4, None)]
        assert (prh.ray_head.launches, prh.ray_head.launches_fast) == \
            (before[0], before[1] + 1)


def test_fast_kernel_pack_size_is_the_image_on_gpu(cuda_device):
    ext = cuda_build.extension()
    for c in prh.FAST_WIDTHS:
        assert ext.ray_head_fast_pack_bytes(c) == PACK_BYTES[c]
        assert prh.fast_image(_params(c)).numel() * 4 == PACK_BYTES[c]
        assert ext.ray_head_fast_smem_bytes(c) == _smem_bytes(c) <= SMEM_LIMIT
    for c in (32, 120, 84):
        assert ext.ray_head_fast_pack_bytes(c) == -1 and ext.ray_head_fast_smem_bytes(c) == -1


def test_a_wide_launch_with_a_pack_of_another_size_raises_on_gpu(cuda_device, monkeypatch):
    """C 112 given a pack of the wrong size (the whole Img layout's, or one
    word short): the wrapper raises and launches nothing, neither the fast
    kernel nor ``csrc/ray_head.cu``."""
    y, rparams = _ray_case(np.random.default_rng(5), rn=4, sn=64, c=112)
    rp = _on(cuda_device, _port_params(prh.RayHeadParams, rparams))
    yd = _t(y).to(cuda_device)
    good = prh.fast_image(rp)
    for bad in (torch.zeros(PACK_BYTES[112] // 4 + 4, device=cuda_device), good[:-1]):
        monkeypatch.setattr(prh, "cached_pack_weights", lambda p, precision, b=bad: b)
        before = (prh.ray_head.launches, prh.ray_head.launches_fast)
        with torch.no_grad(), pytest.raises(ValueError, match="weight pack"):
            prh.ray_head(yd, rp, precision="fast")
        torch.cuda.synchronize()
        assert (prh.ray_head.launches, prh.ray_head.launches_fast) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


# chip_smoke.py's rule for a fast render against the CPU (agree_with_cpu,
# and tests/test_torch_port_general_cli.py's): against the bf16 effect (the
# fast plain version against the FP32 one), the median distance at most 0.2
# of the effect's median, the largest at most twice the effect's largest,
# and on at least RAY_SHARE of the rays the ray's largest distance at most
# RAY_EFFECT times its own largest effect, or 2e-4
RAY_SHARE, RAY_EFFECT = 0.97, 2.0


def _hold_by_the_render_rule(got, fast, exact, rn):
    d, gap = (got - fast).abs(), (fast - exact).abs()
    assert d.median().item() <= max(0.2 * gap.median().item(), 2e-4), \
        (d.median().item(), gap.median().item())
    assert d.max().item() <= max(2 * gap.max().item(), 2e-4) and gap.max().item() < 0.5, \
        (d.max().item(), gap.max().item())
    d_r, gap_r = d.reshape(rn, -1).amax(1), gap.reshape(rn, -1).amax(1)
    within = (d_r <= torch.clamp(RAY_EFFECT * gap_r, min=2e-4)).float().mean().item()
    assert within >= RAY_SHARE, within


@pytest.mark.parametrize("sn", [1, 17, 64, 128, 130, 256, 300])
@pytest.mark.parametrize("neus", [False, True])
@pytest.mark.parametrize("c", prh.FAST_WIDTHS)
def test_fast_kernel_matches_plain_at_any_length_on_gpu(cuda_device, c, neus, sn):
    """The fast kernel at lengths from one sample through one chunk of 64
    rows to several (a ragged last tile and chunk), on 37 rays, against the
    fast plain version by chip_smoke.py's rule for a fast render
    (``_hold_by_the_render_rule``; the NeuS per-ray sums by the median and
    to the kernel's own weights), counted on ``launches_fast``, away from
    the 3xTF32 kernel by bf16's size. (On 37 rays a bf16 flip of the state
    moves an element past the largest bf16 effect now and then, for
    ``ray_head.cu``'s bf16 instance as well: 1.14 x at C 72, SN 64 with
    these draws, where both kernels lie as close to the fast function summed
    in float64 as the plain version does.)"""
    rng = np.random.default_rng(sn)
    rn = 37
    y, rparams = _ray_case(rng, rn=rn, sn=sn, c=c)
    rp = _on(cuda_device, _port_params(prh.RayHeadParams, rparams))
    extra = _neus_case(rng, rn, sn) if neus else ()
    args = (*[_t(a).to(cuda_device) for a in (y, *extra)], rp)
    wrapper = prh.ray_head_neus if neus else prh.ray_head
    plain = prh.ray_head_neus_reference if neus else prh.ray_head_reference
    before = (wrapper.launches, wrapper.launches_fast)
    with torch.no_grad():
        got = wrapper(*args, precision="fast")
        assert (wrapper.launches, wrapper.launches_fast) == (before[0], before[1] + 1)
        tf32 = wrapper(*args, precision="high")
        fast, exact = plain(*args, precision="fast"), plain(*args)
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
    for i, (g, f, e) in enumerate(zip(*map(as_tuple, (got, fast, exact)))):
        assert g.shape == f.shape and torch.isfinite(g).all()
        if not g.numel():   # the NeuS weights of a one-sample ray are empty
            continue
        if i < 2:
            _hold_by_the_render_rule(g, f, e, rn)
        else:
            d, gap = (g - f).abs(), (f - e).abs()
            assert d.median().item() <= max(0.2 * gap.median().item(), 2e-5)
    if neus:
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


@pytest.mark.parametrize("sn", [1, 17, 64, 128, 130, 256, 300])
@pytest.mark.parametrize("c", prh.FAST_WIDTHS)
def test_fast_kernel_is_ray_head_cu_bit_for_bit_on_gpu(cuda_device, monkeypatch, c, sn):
    """The new design keeps what the kernel computes: on the same inputs
    both fast ray heads and their NeuS variant give ``csrc/ray_head.cu``'s
    bf16 instance's outputs bit for bit (the same products, sums and
    roundings in the same orders), reached by taking the width out of
    ``FAST_WIDTHS``."""
    rng = np.random.default_rng(sn + c)
    y, rparams = _ray_case(rng, rn=37, sn=sn, c=c)
    rp = _on(cuda_device, _port_params(prh.RayHeadParams, rparams))
    args = [_t(a).to(cuda_device) for a in (y, *_neus_case(rng, 37, sn))]
    outs = []
    for widths in (prh.FAST_WIDTHS, ()):
        monkeypatch.setattr(prh, "FAST_WIDTHS", widths)
        cuda_build.clear_pack_caches()
        before = (prh.ray_head.launches_fast, prh.ray_head_neus.launches_fast)
        with torch.no_grad():
            outs.append((prh.ray_head(args[0], rp, precision="fast"),
                         *prh.ray_head_neus(*args, rp, precision="fast")))
        assert (prh.ray_head.launches_fast, prh.ray_head_neus.launches_fast) == \
            (before[0] + 1, before[1] + 1)
    cuda_build.clear_pack_caches()
    for name, a, b in zip(("srdf", "srdf (NeuS)", "weight", "rgb", "depth", "opacity"), *outs):
        assert torch.equal(a, b), name


def test_fast_kernel_takes_inputs_at_any_offset_on_gpu(cuda_device):
    """The kernel reads its tokens by 8-byte loads; a contiguous input that
    starts off a 16-byte boundary is copied to one, with the same outputs."""
    y, rparams = _ray_case(np.random.default_rng(3), rn=37, sn=64)
    rp = _on(cuda_device, _port_params(prh.RayHeadParams, rparams))
    yd = _t(y).to(cuda_device)
    buf = torch.empty(yd.numel() + 1, device=cuda_device)
    shifted = buf[1:].view(yd.shape)
    shifted.copy_(yd)
    with torch.no_grad():
        torch.testing.assert_close(prh.ray_head(shifted, rp, precision="fast"),
                                   prh.ray_head(yd, rp, precision="fast"), rtol=0, atol=0)


def test_head_variants_time_both_fast_ray_heads():
    """``script/head_variants.py``: ``rh,fast`` is ``ray_head.cu``'s bf16
    instantiation (the flag changes no source), ``rhf`` the fast kernel
    with its own phase skips and probe, each text once in its source;
    ``fast`` on another kernel raises."""
    from uforecon_tpu_torch.script import head_variants as hv

    kernel, subs = hv.replacements("rh,fast,rh_ln")
    assert kernel == "rh" and subs == hv.PATCHES["rh_ln"]
    kernel, subs = hv.replacements("rhf,rhf_probe,rhf_mlp")
    assert kernel == "rhf" and {f for f, _, _ in subs} == {"ray_head_fast.cuh"}
    assert "#define UFO_RHF_PROBE" in subs[0][2] and " < 0 * KS2;" in subs[1][2]
    text = (cuda_build.CSRC / "ray_head_fast.cuh").read_text()
    for name in [n for n in hv.PATCHES if n.startswith("rhf_")]:
        for f, old, new in hv.PATCHES[name]:
            assert f == "ray_head_fast.cuh" and text.count(old) == 1 and old != new, name
    # a variant builds the entry points, the timed width's unit and stubs
    # for the others; every width has its unit
    assert hv.rhf_units(112) == ("ray_head_fast.cu", "ray_head_fast_112.cu", "rhf_stubs.cu")
    assert hv.rhf_units(88) == ("ray_head_fast.cu", "rhf_stubs.cu")
    units = {u for c in prh.FAST_WIDTHS for u in hv.rhf_units(c)} - {"rhf_stubs.cu"}
    assert {u.name for u in cuda_build.CSRC.glob("ray_head_fast*.cu")} == units
    assert len(units) == len(prh.FAST_WIDTHS) == 10
    assert len(hv.RHF_PHASES) == 11
    kernel, subs = hv.replacements("rhf,G=1,A=1")
    assert subs == [("ray_head_fast.cuh", "constexpr int kGroups = 2;", "constexpr int kGroups = 1;"),
                    ("ray_head_fast.cuh", "constexpr int kW1Ahead = 2;",
                     "constexpr int kW1Ahead = 1;")]
    assert all(text.count(old) == 1 for _, old, _ in subs)
    for bad in ("rhf,fast", "ph,fast", "rhf,S=2"):
        with pytest.raises(ValueError):
            hv.replacements(bad)
