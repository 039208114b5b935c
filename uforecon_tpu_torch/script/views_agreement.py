"""The per-ray rule of chip_smoke.py's views phase (``agree_with_cpu``: a
fast render chunk on the card against the same chunk on the CPU, ray by
ray against the bf16 effect) over several draws of rays, with the point
head, or both heads, swapped for their plain versions on the card, so that
what a kernel moves can be told from what the card's render moves without
it.

    python uforecon_tpu_torch/script/views_agreement.py [--views 12 11] \\
        [--rays 256] [--seeds 0 1 2 3] \\
        [--variants kernels plain_point plain_heads]

Run from the root of a checkout (it imports ``chip_smoke.py`` from there);
needs one GPU. The fixture is the views phase's (DTU's evaluation set 1
and view 16 at 800x640; 11 views are set 1's, 12 add view 16), the
weights chip_smoke's (``UFORecon(Config(**EXACT))`` from its SEED), the
route the JAX extraction defaults (fast kernels 1 and 2). Variants:
``kernels`` as shipped; ``plain_point`` the point head's plain version on
the card in place of its kernel; ``plain_heads`` both heads' plain
versions on the card. Per (views, seed, variant): the share of rays within
RAY_EFFECT times their bf16 effect per output, the rays beyond it, and
whether the rules held; the card's name and power limit first, then one
line per case, then one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
from pathlib import Path

VARIANTS = ("kernels", "plain_point", "plain_heads")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, nargs="+", default=[12, 11])
    ap.add_argument("--rays", type=int, default=256)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=VARIANTS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from uforecon_tpu_torch.config import EXACT, Config
    from uforecon_tpu_torch.convert import init_weights
    from uforecon_tpu_torch.data.dtu_test import SET1_VIEW_LIST, DtuFitSparse
    from uforecon_tpu_torch.models import ray_transformer
    from uforecon_tpu_torch.models.uforecon import UFORecon
    from uforecon_tpu_torch.ops import fused_point_head as fph
    from uforecon_tpu_torch.ops import fused_ray_head as frh
    from uforecon_tpu_torch.script import make_dtu_fixture as fixture

    card = cs.smi("name,power.limit")
    print(card, flush=True)
    model = UFORecon(Config(**EXACT))
    init_weights(model, cs.SEED)
    model.to("cuda")
    shipped = model.with_knobs(extract_geometry=True,
                               **{k: getattr(Config(), k) for k in EXACT})
    heads = {"point": ray_transformer.point_head_v1, "ray": ray_transformer.ray_head}
    plain = {"kernels": {}, "plain_point": {"point": fph.point_head_reference},
             "plain_heads": {"point": fph.point_head_reference, "ray": frh.ray_head_reference}}
    w, h = cs.PIPELINE_WH
    extra = cs.VIEWS_CHUNK[2]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "fixture")
        with contextlib.redirect_stdout(io.StringIO()):
            fixture.main([root, "--views", *map(str, SET1_VIEW_LIST), str(extra), "--wh",
                          str(w), str(h)])
        for nv in args.views:
            if nv <= len(SET1_VIEW_LIST):
                data = DtuFitSparse(root, "scan24", n_views=nv, set=1, img_wh=(w, h))
            else:
                data = DtuFitSparse(root, "scan24", n_views=nv, set=0,
                                    test_view_pair=[*SET1_VIEW_LIST, extra], img_wh=(w, h))
            sample = data[0]
            for seed in args.seeds:
                for variant in args.variants:
                    swap = plain[variant]
                    ray_transformer.point_head_v1 = swap.get("point", heads["point"])
                    ray_transformer.ray_head = swap.get("ray", heads["ray"])
                    try:
                        with contextlib.redirect_stdout(io.StringIO()):
                            r = cs.agree_with_cpu(shipped, sample, variant, rn=args.rays,
                                                  tag="views_agreement", seed=seed,
                                                  check=False)
                    finally:
                        ray_transformer.point_head_v1 = heads["point"]
                        ray_transformer.ray_head = heads["ray"]
                    within = {k: v["rays_within_k_effect"][cs.RAY_EFFECT]["fast"]
                              for k, v in r["fast_vs_effect"].items()}
                    case = {"views": nv, "rays": args.rays, "seed": seed, "variant": variant,
                            "ok": r["ok"], "rays_beyond": r["rays_beyond"],
                            "within_effect": within,
                            "launches": {k: v for k, v in r["launches"].items() if v}}
                    results.append(case)
                    print(f"[views_agreement] NV {nv} seed {seed} {variant}: "
                          f"{len(r['rays_beyond'])} of {args.rays} rays beyond "
                          f"{cs.RAY_EFFECT} x their bf16 effect in some output; the rules "
                          f"held: {r['ok']}; share within per output (at least "
                          f"{cs.RAY_SHARE}) {within}; rays {r['rays_beyond']}; launches "
                          f"{case['launches']} [{card}]", flush=True)
    print(json.dumps({"card": card, "ray_share": cs.RAY_SHARE, "ray_effect": cs.RAY_EFFECT,
                      "cases": results}), flush=True)


if __name__ == "__main__":
    main()
