"""Time the shipped route's 1024-ray render chunks (the JAX extraction
defaults: merged bf16 volume, fast heads) on one GPU, on the package under
``--root``, so that two trees (a commit and its parent, unpacked with
``git archive``) can be timed in turns in one run on one card.

    python uforecon_tpu_torch/script/chunk_times.py [--root DIR] [--reps 5]

The scene is chip_smoke.py's slice view (``data.synthetic.dtu_scale_sample``:
800x640, 3 views, 192 hypotheses, 64 + 64 samples), the weights
``UFORecon(Config(**EXACT))`` initialised from ``--seed``, the chunks
chip_smoke.py's profile phase renders (8 of 1024 rays spread over the
view). Per round, after a warm-up round: the wall ms a chunk (host clock,
unprofiled, the 8 chunks and one synchronize); then, under
torch.profiler, the device ms a chunk and the share of the wall time the
device was busy. The card's name and power limit first, then one line per
round, then one JSON line with the medians. Run as a file (not with
``-m``), so that ``--root`` decides which package is imported.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the directory that holds the uforecon_tpu_torch package to time")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from uforecon_tpu_torch.config import EXACT, Config
    from uforecon_tpu_torch.convert import init_weights
    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.data.synthetic import dtu_scale_sample
    from uforecon_tpu_torch.models.uforecon import UFORecon

    if not torch.cuda.is_available():
        raise SystemExit("chunk_times needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    model = UFORecon(Config(**EXACT))
    init_weights(model, args.seed)
    model.to("cuda")
    shipped = model.with_knobs(extract_geometry=True,
                               **{k: getattr(Config(), k) for k in EXACT})
    scene, extras = scene_inputs_from_sample(dtu_scale_sample(), "cuda")
    rn = args.rays
    n_chunks = extras["ray_d"].shape[0] // rn
    chunks = []
    for i in range(args.chunks):   # chip_smoke.py's profile phase's chunks
        start = ((i * 97 + 50) % n_chunks) * rn
        cam_z = torch.as_tensor(extras["cam_ray_d"][start:start + rn, 2], device="cuda")
        ray_d = torch.as_tensor(extras["ray_d"][start:start + rn], device="cuda")
        chunks.append((ray_d, float(scene.near) / cam_z, float(scene.far) / cam_z))
    with torch.no_grad():
        enc = shipped.encode(scene)

    @torch.no_grad()
    def run():
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        for ray_d, near, far in chunks:
            shipped.render_chunk(scene, enc, ray_d, gen, near_per_ray=near, far_per_ray=far)
        torch.cuda.synchronize()

    run()
    rounds = []
    for r in range(args.reps):
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        rounds.append({"wall_ms": wall_ms / len(chunks), "device_ms": busy_ms / len(chunks),
                       "device_ops": len(dev) / len(chunks)})
        print(f"round {r}: wall {rounds[-1]['wall_ms']:.3f} ms a chunk, device "
              f"{rounds[-1]['device_ms']:.3f} ms, {rounds[-1]['device_ops']:.1f} device ops "
              f"[{card}]", flush=True)
    med = {k: float(np.median([x[k] for x in rounds])) for k in rounds[0]}
    med["busy_share"] = med["device_ms"] / med["wall_ms"]
    print(json.dumps({"card": card, "root": args.root, "rays": rn, "chunks": len(chunks),
                      "median": med, "rounds": rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
