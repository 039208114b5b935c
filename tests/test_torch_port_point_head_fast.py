"""The fast point-head kernel's weight pack (``csrc/point_head_fast.cuh``
``Img``), read back on the CPU as the kernel reads it.

The kernel copies the image at the head of ``fused_point_head.fast_image``
into shared memory as it is and takes each matrix's rows at the offsets of
``Img``, and the view token from after the image; a wrong row slice or
stride shows here as a weight that is not the bf16-rounded one.
The offsets below are ``Img``'s, transcribed. No JAX: the image is the
port's own layout, and the plain version it feeds is held to JAX
elsewhere (``test_torch_port_views.py``, ``test_torch_port_shipped.py``).
"""
import numpy as np
import pytest
import torch

from uforecon_tpu_torch.ops import cuda_build
from uforecon_tpu_torch.ops import fused_point_head as pph

from test_torch_port_kernels import _point_case, _port_params


def _img_layout(c):
    """Img<CV>'s matrices: name -> (bf16 offset, rows, stride, out, in),
    and its FP32 part's offsets (floats) and length; the view token follows
    the FP32 part."""
    c2, cr = 2 * c, c + 3
    mats = [("wq", c, c), ("wk", c, c), ("wv", c, c), ("wmerge", c, c), ("w1", c2, c2),
            ("w2", c, c2), ("sw0", 32, 8), ("sw1", 32, 32), ("sw2", 16, 32),
            ("rw0", 16, cr), ("rw1", 8, 16), ("rw2", 1, 8)]
    out, off = {}, 0
    for name, n_out, n_in in mats:
        rows, stride = max(n_out, 8), cuda_build.image_stride(n_in)
        out[name] = (off, rows, stride, n_out, n_in)
        off += rows * stride
    f32 = {"n1s": 0, "n1b": c, "n2s": 2 * c, "n2b": 3 * c, "sb0": 4 * c,
           "sb1": 4 * c + 32, "sb2": 4 * c + 64, "rb0": 4 * c + 80, "rb1": 4 * c + 96,
           "rb2": 4 * c + 104}
    return out, off, f32, 4 * c + 108


@pytest.mark.parametrize("c_vol", [24, 16])
def test_fast_image_holds_each_weight_where_the_kernel_reads_it(c_vol):
    _, params = _point_case(np.random.default_rng(c_vol), n=4, c_vol=c_vol)
    p = _port_params(pph.PointHeadParams, params)
    c = p.view_token.numel()
    mats, nb, f32, nf = _img_layout(c)
    img = pph.fast_image(p)
    assert img.dtype == torch.float32 and img.numel() * 4 == 2 * nb + 4 * nf + 4 * c
    assert (2 * nb) % 16 == 0 and nf % 4 == 0     # the image in whole bulk-copy units
    bf16 = img[:nb // 2].view(torch.bfloat16).float()
    weights = {"wq": p.wq, "wk": p.wk, "wv": p.wv, "wmerge": p.wmerge, "w1": p.w1,
               "w2": p.w2, "sw0": p.sim_w[0], "sw1": p.sim_w[1], "sw2": p.sim_w[2],
               "rw0": p.rad_w[0], "rw1": p.rad_w[1], "rw2": p.rad_w[2]}
    for name, (off, rows, stride, n_out, n_in) in mats.items():
        block = bf16[off:off + rows * stride].view(rows, stride)
        assert torch.equal(block[:n_out, :n_in], cuda_build.bf16_round(weights[name])), name
        assert torch.all(block[:, n_in:] == 0) and torch.all(block[n_out:] == 0), name
        # a B fragment's 32 lanes hit 32 banks: the stride is an odd
        # multiple of 4 words, and no shorter than the inputs
        assert stride >= n_in and stride % 2 == 0 and (stride // 2) % 8 == 4, name
    tail = img[nb // 2:]
    vectors = {"n1s": p.norm1_scale, "n1b": p.norm1_bias, "n2s": p.norm2_scale,
               "n2b": p.norm2_bias, "sb0": p.sim_b[0], "sb1": p.sim_b[1],
               "sb2": p.sim_b[2], "rb0": p.rad_b[0], "rb1": p.rad_b[1], "rb2": p.rad_b[2]}
    for name, off in f32.items():
        v = vectors[name].reshape(-1)
        assert torch.equal(tail[off:off + v.numel()], v), name
    assert torch.equal(tail[nf:], p.view_token.reshape(-1))


def test_fast_pack_is_the_image_and_the_streamed_pack_the_planes():
    """``pack_weights(p, 'fast')`` is the image alone; past 11 views
    (``streamed``) the streamed kernel reads the 3xTF32 pack's layout with
    bf16 values and a zero plane where the lo plane was."""
    _, params = _point_case(np.random.default_rng(5), n=4)
    p = _port_params(pph.PointHeadParams, params)
    high = pph.pack_weights(p)
    streamed = pph.pack_weights(p, "fast", streamed=True)
    assert torch.equal(pph.pack_weights(p, "fast"), pph.fast_image(p))
    assert torch.equal(pph.pack_weights(p, streamed=True), high)
    assert streamed.numel() == high.numel() and not torch.equal(streamed, high)
    c = p.view_token.numel()
    wq = streamed[c:c + 2 * c * c]
    assert torch.equal(wq[:c * c], cuda_build.bf16_round(p.wq.t().reshape(-1)))
    assert not wq[c * c:].any()
