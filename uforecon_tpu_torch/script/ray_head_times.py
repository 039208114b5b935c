"""Time the ray-head kernels (``ray_head``, ``ray_head_neus``) on one GPU at
several widths, sample counts and precisions, on the package under
``--root``, so that two trees (a commit and its parent, unpacked with ``git
archive``) can be timed in turns in one run on one card.

    python uforecon_tpu_torch/script/ray_head_times.py [--root DIR] \\
        [--widths 88 72] [--lengths 64 128] [--rays 1024] \\
        [--precisions fast high] [--heads ray_head ray_head_neus]

Inputs as chip_smoke.py's kernel phase draws them: random weights of each
width (each matrix N(0, 1 / fan_in), the LayerNorms 1 +- 0.1), tokens
N(0, 1), the NeuS variant's sorted z over the scene's near..far range,
radiance U(0, 1) and inv_s exp(3), from a generator seeded per width.
Per case: the kernel's device time (the mean of the port's own kernels
over 10 calls, torch.profiler), the call's CUDA-event time (median of 10),
and the max abs error against the plain version at the same precision (in
``fast`` a bf16-sized number: the two sum in other orders). One line per
case, the card's name and power limit first, then one JSON line. Run as a
file (not with ``-m``), so that ``--root`` decides which package is
imported.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from point_head_times import _call_ms, _device_ms  # noqa: E402  (the same timers)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the directory that holds the uforecon_tpu_torch package to time")
    ap.add_argument("--widths", type=int, nargs="+", default=[88, 72])
    ap.add_argument("--lengths", type=int, nargs="+", default=[64, 128])
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--precisions", nargs="+", default=["fast", "high"])
    ap.add_argument("--heads", nargs="+", default=["ray_head", "ray_head_neus"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from uforecon_tpu_torch.ops import fused_ray_head as frh

    if not torch.cuda.is_available():
        raise SystemExit("ray_head_times needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    heads = {"ray_head": (frh.ray_head, frh.ray_head_reference),
             "ray_head_neus": (frh.ray_head_neus, frh.ray_head_neus_reference)}
    near, far = 425.0 / 300.0, 900.0 / 300.0
    out = {"card": card, "root": args.root, "rays": args.rays, "cases": {}}
    for c in args.widths:
        g = torch.Generator(device=dev).manual_seed(args.seed + c)
        randn = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale
        w = lambda o, i: randn(o, i, scale=i ** -0.5)
        params = frh.RayHeadParams(
            wq=w(c, c), wk=w(c, c), wv=w(c, c), wmerge=w(c, c),
            norm1_scale=1 + randn(c, scale=0.1), norm1_bias=randn(c, scale=0.1),
            w1=w(2 * c, 2 * c), w2=w(c, 2 * c), norm2_scale=1 + randn(c, scale=0.1),
            norm2_bias=randn(c, scale=0.1), dens_w=(w(32, c), w(16, 32), w(1, 16)),
            dens_b=(randn(32, scale=0.1), randn(16, scale=0.1), randn(1, scale=0.1)))
        for sn in args.lengths:
            rn = args.rays
            y = randn(rn, sn, c)
            z = near + (far - near) * torch.sort(torch.rand(rn, sn, generator=g, device=dev),
                                                 dim=1).values
            neus_in = (z, torch.rand(rn, sn, 3, generator=g, device=dev),
                       torch.exp(torch.tensor(3.0, device=dev)))
            for head in args.heads:
                wrapper, plain = heads[head]
                inputs = (y, *neus_in) if head == "ray_head_neus" else (y,)
                for prec in args.precisions:
                    def call():
                        return wrapper(*inputs, params, precision=prec)
                    with torch.no_grad():
                        got = call()
                        want = plain(*inputs, params, precision=prec)
                        got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
                        torch.cuda.synchronize()
                        err = max((a - b).abs().max().item() for a, b in zip(got, want)
                                  if a.numel())
                        k_ms, c_ms = _device_ms(call), _call_ms(call)
                    name = f"{head} {prec} C={c} SN={sn}"
                    out["cases"][name] = {"ms": k_ms, "call_ms": c_ms, "max_abs_err": err}
                    print(f"{name} RN={rn}: kernel {k_ms:.4f} ms, call {c_ms:.4f} ms, max abs "
                          f"err vs plain {err:.3e} [{card}]", flush=True)
            del y, z, neus_in
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
