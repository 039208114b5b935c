"""The ray head and its NeuS variant at every token width and sample count
a JAX flag set gives, against the JAX package's Pallas kernels.

The port's kernels 2 and 3 (``csrc/ray_head.cu``) take any width C (a
multiple of 8 up to 112) and any SN, as JAX's ``ray_head_fused`` and
``ray_head_neus_fused`` do; on the card they are held to their plain
versions (``test_torch_port_kernels.py``, ``chip_smoke.py``). Here the
plain versions, which the CPU runs, are held to the JAX kernels in
interpret mode at C in {40, 64, 80, 112} and SN in {50, 128, 256}, in two
processes (the JAX package keeps one kernel-precision mode per process):
  * ``highest``: within 1e-5 (one layer of attention and MLPs in f32,
    another summation order);
  * ``fast``: by the size of JAX's own bf16 effect on each output (its
    fast run against its highest run), by medians, as
    ``test_torch_port_general_cli.py`` holds the fast path: the median
    distance at most 0.2 of the effect's median, and every element within
    the effect's max (each at least 1e-5, for an output bf16 hardly moves:
    a saturated opacity). A key-value sum of a ray, summed in another order,
    lands now and then on the other side of its bf16 rounding and moves
    every sample of its ray by a bf16 step of that sum (here up to 0.68 of
    the effect's max, one ray in four at C 64 and 80, with the sums in the
    kernel's order or in einsum's), which a mean or share rule over four
    rays takes for a fault; medians measured 0.004 of the effect at most,
    while the plain version without the attention's operand rounding
    gives 0.69-8.5.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_ray_widths.py -q
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uforecon_tpu_torch.ops import fused_ray_head as prh

from test_torch_port_kernels import _neus_case, _port_params, _ray_case, _t

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = (40, 64, 80, 112)
LENGTHS = (50, 128, 256)
RN = 4
TOL = dict(rtol=1e-5, atol=1e-5)
NEUS = ("srdf", "weight", "rgb", "depth", "opacity")

_JAX_HEADS = """
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from uforecon_tpu.ops import kernel_precision
path, mode = sys.argv[1], sys.argv[2]
kernel_precision.set_mode(mode)
from uforecon_tpu.ops import fused_ray_head as frh
with open(path, "rb") as f:
    cases = pickle.load(f)
J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
out = {}
for key, (y, z, rad, inv_s, p) in cases.items():
    p = frh.RayHeadParams(**J(p))
    out[key] = (np.asarray(frh.ray_head_fused(J(y), p)),
                tuple(map(np.asarray, frh.ray_head_neus_fused(
                    J(y), J(z), J(rad), jnp.float32(inv_s), p))))
with open(path, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    rng = np.random.default_rng(12)
    cases = {}
    for c in WIDTHS:
        for sn in LENGTHS:
            y, params = _ray_case(rng, RN, sn, c)
            cases[c, sn] = (y, *_neus_case(rng, RN, sn), params)
    tmp = tmp_path_factory.mktemp("jax_ray_widths")
    procs = {}
    for mode in ("highest", "fast"):
        with open(tmp / mode, "wb") as f:
            pickle.dump(cases, f)
        procs[mode] = subprocess.Popen(
            [sys.executable, "-c", _JAX_HEADS, str(tmp / mode), mode],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
            env={**os.environ, "JAX_PLATFORMS": "cpu", "UFO_PLATFORM": "cpu",
                 "PYTHONPATH": os.pathsep.join([str(ROOT),
                                                os.environ.get("PYTHONPATH", "")])})
    runs = {}
    for mode, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        with open(tmp / mode, "rb") as f:
            runs[mode] = pickle.load(f)
    return cases, runs


def _port(case, precision):
    y, z, rad, inv_s, params = case
    p = _port_params(prh.RayHeadParams, params)
    with torch.no_grad():
        srdf = prh.ray_head(_t(y), p, precision=precision).numpy()
        neus = prh.ray_head_neus(_t(y), _t(z), _t(rad), _t(inv_s), p,
                                 precision=precision)
    return srdf, tuple(t.numpy() for t in neus)


@pytest.mark.parametrize("sn", LENGTHS)
@pytest.mark.parametrize("c", WIDTHS)
def test_plain_ray_heads_match_the_jax_kernels(jax_runs, c, sn):
    cases, runs = jax_runs
    srdf, neus = _port(cases[c, sn], "highest")
    want_srdf, want_neus = runs["highest"][c, sn]
    np.testing.assert_allclose(srdf, want_srdf, **TOL)
    for name, a, b in zip(NEUS, neus, want_neus):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("sn", LENGTHS)
@pytest.mark.parametrize("c", WIDTHS)
def test_fast_plain_ray_heads_match_the_jax_fast_kernels(jax_runs, c, sn):
    cases, runs = jax_runs
    srdf, neus = _port(cases[c, sn], "fast")
    got = (srdf, *neus)
    fast = (runs["fast"][c, sn][0], *runs["fast"][c, sn][1])
    highest = (runs["highest"][c, sn][0], *runs["highest"][c, sn][1])
    for name, g, f, h in zip(("ray_head srdf", *NEUS), got, fast, highest):
        assert g.shape == f.shape, name
        d, gap = np.abs(g - f), np.abs(f - h)
        # (an output bf16 hardly moves, a saturated opacity, within 1e-5)
        assert np.median(d) <= max(0.2 * np.median(gap), TOL["atol"]), \
            (name, np.median(d), np.median(gap))
        assert d.max() <= max(gap.max(), TOL["atol"]), (name, d.max(), gap.max())
    # the two JAX modes really differ: fast is not the FP32 function
    assert max(np.abs(f - h).max() for f, h in zip(fast, highest)) > 1e-4
