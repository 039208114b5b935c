"""The port's block-local row gather and its microbenchmark script against
the JAX package.

``block_row_gather_reference`` is what the CUDA kernel
(``csrc/row_gather.cu``) is held to, bit for bit, on the card; here it is
held bit for bit to the computation of the JAX probe's Pallas body,
``jnp.take_along_axis`` of the broadcast index per block in bf16 (with
int32 and with uint32 indices, the probe's two forms), run by JAX on the
CPU. The script ``uforecon_tpu_torch/script/bench_tile_gather.py`` runs
its two modes on the CPU at tiny sizes, and it and the gather module
import neither JAX nor the JAX package.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_gather.py -q
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu_torch.ops import row_gather as prg
from uforecon_tpu_torch.script import bench_tile_gather as bench

ROOT = Path(__file__).resolve().parent.parent


def _case(rng, n_blocks=3, rows=256):
    src = torch.as_tensor(rng.standard_normal((n_blocks * rows, 128)).astype(np.float32))
    idx = rng.integers(0, rows, n_blocks * rows).astype(np.int32)
    return src.to(torch.bfloat16), idx


@pytest.mark.parametrize("form", ["int32", "uint32"])
def test_block_row_gather_reference_matches_jax_take_along_axis(rng, form):
    n_blocks, rows = 3, 256
    src, idx = _case(rng, n_blocks, rows)
    bits = src.view(torch.int16).numpy().view(np.uint16)
    # the same bf16 bits on both sides
    jsrc = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    jsrc = jsrc.reshape(n_blocks, rows, 128)
    jidx = jnp.asarray(idx.astype(form)).reshape(n_blocks, rows, 1)
    want = jax.vmap(lambda s, i: jnp.take_along_axis(
        s, jnp.broadcast_to(i, s.shape), axis=0))(jsrc, jidx)
    got = prg.block_row_gather_reference(src, torch.as_tensor(idx), block_rows=rows)
    assert got.shape == (n_blocks * rows, 128) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(want).reshape(-1, 128).view(np.uint16))
    # on the CPU the wrapper is the plain version, and launches nothing
    before = prg.block_row_gather.launches
    assert torch.equal(prg.block_row_gather(src, torch.as_tensor(idx), rows), got)
    assert prg.block_row_gather.launches == before


def test_bytes_moved_counts_distinct_source_rows():
    idx = torch.tensor([0, 0, 1, 3, 2, 2, 2, 2], dtype=torch.int32)   # 2 blocks of 4
    # 8 output rows + 8 indices; distinct rows 3 (block 0) + 1 (block 1)
    assert prg.bytes_moved(idx, block_rows=4, row_bytes=256) == 8 * (256 + 4) + 4 * 256


@pytest.mark.parametrize("mode,extra", [
    ("probe", ["--blocks", "2"]),
    ("sweep", ["--rows", "1000", "--max-src-mb", "4"]),
])
def test_script_modes_print_json_lines_on_cpu(mode, extra):
    res = subprocess.run(
        [sys.executable, "-m", "uforecon_tpu_torch.script.bench_tile_gather",
         "--mode", mode, "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(l) for l in res.stdout.splitlines() if l.strip()]
    assert len(lines) == (1 if mode == "probe" else 2)
    for r in lines:
        assert r["mode"] == mode and r["device"] == "cpu"
        assert all(np.isfinite(r[k]) and r[k] > 0 for k in ("ns_per_row", "mrows_per_s"))
    if mode == "probe":
        r = lines[0]
        assert r["rows"] == 2 * 4096 and r["bit_equal_block0"] is True
        assert np.isfinite(r["bound_ms"]) and r["bound_ms"] > 0
    else:
        assert [r["src_mb"] for r in lines] == [1, 4]


def test_script_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        bench.main(["--mode", "probe", "--blocks", "1"])


def test_gather_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['uforecon_tpu'] = None; "
            "import uforecon_tpu_torch.script.bench_tile_gather, "
            "uforecon_tpu_torch.ops.row_gather, "
            "uforecon_tpu_torch.ops.fused_point_head2, "
            "uforecon_tpu_torch.pipeline.trainer, uforecon_tpu_torch.pipeline.fit, "
            "uforecon_tpu_torch.pipeline.checkpoint, uforecon_tpu_torch.data.dtu_train, "
            "uforecon_tpu_torch.utils.metrics, uforecon_tpu_torch.utils.logging, "
            "uforecon_tpu_torch.script.learn_sanity, uforecon_tpu_torch.cli.run, "
            "uforecon_tpu_torch.data.image, uforecon_tpu_torch.data.general_fit, "
            "uforecon_tpu_torch.data.colmap, uforecon_tpu_torch.cli.colmap2mvsnet, "
            "uforecon_tpu_torch.pipeline.extract, "
            "uforecon_tpu_torch.script.make_general_fixture; "
            # and every other module of the port
            "import importlib, pkgutil, uforecon_tpu_torch; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "uforecon_tpu_torch.__path__, 'uforecon_tpu_torch.')]")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
