"""Row-gather microbenchmark on one GPU: gather rate against source size,
and the block-local row-gather kernel.

Counterpart of the JAX package's ``script/bench_tile_gather.py``, with
flags in place of its environment variables:

    python -m uforecon_tpu_torch.script.bench_tile_gather --mode sweep
    python -m uforecon_tpu_torch.script.bench_tile_gather --mode probe

Modes:
  sweep  row gather (``torch.index_select``) of ``--rows`` random rows of
         72 bf16 values (a corner-packed feature||weight row) from sources
         of 1 to 2048 MB (cut with ``--max-src-mb``): the gather rate
         against source size. One JSON line per source size.
  probe  the block-local row-gather kernel (``ops/row_gather.py``, the JAX
         ``pallas_gather_probe``): ``--blocks`` blocks of 4096 rows of 128
         bf16 values, each block gathering its own rows by random indices.
         One JSON line: rows, ns_per_row, mrows_per_s, bit_equal_block0 (the
         first block against plain indexing), bound_ms (the bytes the gather
         must move over an H100 SXM's 3.35 TB/s).

The JAX script's ``tiled`` mode (brick gathers on scene geometry) is not
here: it belongs with ``ops/brick_gather.py``, which the port leaves out.
Runs on the CUDA card unless ``--device cpu`` is passed (the plain
versions, for tests); without a card ``--device cuda`` raises. Data is
made from ``--seed`` on the device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..device import resolve_device
from ..ops.row_gather import BLOCK_ROWS, ROW_WIDTH, block_row_gather, bytes_moved

C8 = 72                                   # corner-packed feat||weight channels
SWEEP_SRC_MB = (1, 4, 16, 64, 256, 1024, 2048)
PEAK_BYTES = 3.35e12                      # H100 SXM HBM3, data sheet


def _time(fn, dev: torch.device, n: int = 3) -> float:
    """Least of n timed calls in seconds, after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(n):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            dt = a.elapsed_time(b) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
        best = min(best, dt)
    return best


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def sweep(dev: torch.device, rows: int, max_src_mb: int, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    report = []
    for src_mb in (s for s in SWEEP_SRC_MB if s <= max_src_mb):
        n_src = src_mb * 2 ** 20 // (C8 * 2)
        src = torch.zeros(n_src, C8, dtype=torch.bfloat16, device=dev)
        idx = torch.randint(0, n_src, (rows,), generator=gen, device=dev)
        dt = _time(lambda: torch.index_select(src, 0, idx), dev)
        r = {"mode": "sweep", "device": _device_name(dev), "src_mb": src_mb,
             "rows": rows, "ns_per_row": dt / rows * 1e9,
             "mrows_per_s": rows / dt / 1e6}
        report.append(r)
        print(json.dumps(r), flush=True)
    return report


def probe(dev: torch.device, n_blocks: int, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = p = BLOCK_ROWS
    src = torch.randn(n_blocks * v, ROW_WIDTH, generator=gen, device=dev).to(torch.bfloat16)
    idx = torch.randint(0, v, (n_blocks * p,), generator=gen, device=dev, dtype=torch.int32)
    out = block_row_gather(src, idx)
    ok = bool(torch.equal(out[:p], src[:v][idx[:p].long()]))
    dt = _time(lambda: block_row_gather(src, idx), dev)
    rows = n_blocks * p
    r = {"mode": "probe", "form": "block_row_gather", "device": _device_name(dev),
         "blocks": n_blocks, "rows": rows, "ms": dt * 1e3,
         "ns_per_row": dt / rows * 1e9, "mrows_per_s": rows / dt / 1e6,
         "bit_equal_block0": ok,
         "bound_ms": bytes_moved(idx, BLOCK_ROWS, ROW_WIDTH * src.element_size())
         / PEAK_BYTES * 1e3}
    print(json.dumps(r), flush=True)
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("sweep", "probe"), default="sweep")
    ap.add_argument("--rows", type=int, default=16 * 2 ** 20,
                    help="gathered rows per source size (sweep)")
    ap.add_argument("--max-src-mb", type=int, default=max(SWEEP_SRC_MB),
                    help="largest source size of the sweep, MB")
    ap.add_argument("--blocks", type=int, default=2048,
                    help="blocks of 4096 rows (probe)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.mode == "sweep":
        return sweep(dev, args.rows, args.max_src_mb, args.seed)
    return probe(dev, args.blocks, args.seed)


if __name__ == "__main__":
    main(sys.argv[1:])
