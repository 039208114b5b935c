"""Time the point-head kernels (``point_head``, ``point_head2``) on one GPU
at several view counts and precisions, on the package under ``--root``, so
that two trees (a commit and its parent, unpacked with ``git archive``) can
be timed in turns in one run on one card.

    python uforecon_tpu_torch/script/point_head_times.py [--root DIR] \\
        [--views 2 3 5 11 12 49] [--points 65536] [--precisions fast high] \\
        [--heads point_head point_head2] [--c_vol 24]

Inputs as chip_smoke.py's kernel phase draws them (~30 % of the (view,
point) pairs masked, the first 256 points masked in every view), from a
generator seeded per view count; the weights of ``UFORecon(Config())``
(tokens of 80), or with ``--c_vol 16`` of the guided feature grid's
``UFORecon(Config(volume_type='featuregrid'))`` (tokens of 72),
initialised from ``--seed``. Per case: the kernel's device time (the mean
of the port's own kernels over 10 calls, torch.profiler), the call's
CUDA-event time (median of 10), and the max abs error against the plain
version at the same precision (in ``fast`` a bf16-sized number: the two
sum in other orders), and a digest of the kernel's outputs (sha256 of the
token and radiance bytes), so that two trees' kernels can be held to each
other bit for bit in one run. One line per case, the card's name and power limit
first, then one JSON line. Run as a file (not with ``-m``), so that
``--root`` decides which package is imported.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path


def _device_ms(fn, reps=10):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and "ufo::" in e.name]
    return sum(us) / len(us) / 1e3 if us else float("nan")


def _call_ms(fn, reps=10):
    import numpy as np
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the directory that holds the uforecon_tpu_torch package to time")
    ap.add_argument("--views", type=int, nargs="+", default=[3])
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--precisions", nargs="+", default=["fast", "high"])
    ap.add_argument("--heads", nargs="+", default=["point_head"])
    ap.add_argument("--c_vol", type=int, choices=(24, 16), default=24,
                    help="volume features: 24 (tokens of 80) or 16 (the feature grid, 72)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from uforecon_tpu_torch.config import Config
    from uforecon_tpu_torch.convert import init_weights
    from uforecon_tpu_torch.models.uforecon import UFORecon
    from uforecon_tpu_torch.ops import fused_point_head as fph
    from uforecon_tpu_torch.ops import fused_point_head2 as fph2

    if not torch.cuda.is_available():
        raise SystemExit("point_head_times needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    model = UFORecon(Config(volume_type="featuregrid") if args.c_vol == 16 else Config())
    init_weights(model, args.seed)
    params = model.ray_transformer.to(dev).point_head_params()
    heads = {"point_head": (fph.point_head, fph.point_head_reference),
             "point_head2": (fph2.point_head2, fph2.point_head2_reference)}
    out = {"card": card, "root": args.root, "points": args.points, "c_vol": args.c_vol,
           "cases": {}}
    for nv in args.views:
        g = torch.Generator(device=dev).manual_seed(args.seed + 100 + nv)
        n = args.points
        mask = (torch.rand(nv, n, generator=g, device=dev) > 0.3).float()
        mask[:, :256] = 0.0
        randn = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale
        inp = fph.PointHeadInputs(
            img_feat=randn(nv, n, 32), vol_feat=randn(n, args.c_vol),
            sim_feat=torch.rand(n, 8, generator=g, device=dev) * 2 - 1,
            depth_dist=randn(nv, n, scale=0.3), dir_rel=randn(nv, n, 3, scale=0.1),
            rgb=torch.rand(nv, n, 3, generator=g, device=dev), mask=mask)
        for head in args.heads:
            wrapper, plain = heads[head]
            for prec in args.precisions:
                with torch.no_grad():
                    tok, rad = wrapper(inp, params, precision=prec)
                    ref = plain(inp, params, precision=prec)
                    torch.cuda.synchronize()
                    err = max((tok - ref[0]).abs().max().item(),
                              (rad - ref[1]).abs().max().item())
                    digest = hashlib.sha256(tok.cpu().numpy().tobytes()
                                            + rad.cpu().numpy().tobytes()).hexdigest()[:16]
                    k_ms = _device_ms(lambda: wrapper(inp, params, precision=prec))
                    c_ms = _call_ms(lambda: wrapper(inp, params, precision=prec))
                name = f"{head} {prec} NV={nv}" + (" C=72" if args.c_vol == 16 else "")
                out["cases"][name] = {"ms": k_ms, "call_ms": c_ms, "max_abs_err": err,
                                      "digest": digest}
                print(f"{name} P={n}: kernel {k_ms:.4f} ms, call {c_ms:.4f} ms, max abs err "
                      f"vs plain {err:.3e}, outputs {digest} [{card}]", flush=True)
        del inp
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
