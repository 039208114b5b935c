"""The per-ray rule of chip_smoke.py's views phase (``agree_with_cpu``: a
fast render chunk on the card against the same chunk on the CPU, ray by
ray against the bf16 effect) over several draws of rays, with the heads
swapped for their plain versions on the card, and stage by stage: one
stage of ``render_chunk`` on the card, every other stage on the CPU, so
that what each stage of the card's render moves can be told apart. It
reports without raising, so a tree that misses the rule can be read.

    python uforecon_tpu_torch/script/views_agreement.py [--views 6 8 11 12] \\
        [--draws 256:0,1,2,3 1024:0,1,2] [--point_head v1] [--scene views] \\
        [--variants kernels plain_point plain_heads] [--stages all]

Run from the root of a checkout (it imports that checkout's
``chip_smoke.py`` and package, so an unpacked parent is checked by running
it from there); needs one GPU. ``--scene views`` is the views phase's
fixture (DTU's evaluation set 1 and view 16 at 800x640; 11 views are set
1's, 12 add view 16); ``--scene slice`` is the slice phase's scene
(``dtu_scale_sample``, 3 views; ``--views`` is not read). The weights are
chip_smoke's (``UFORecon(Config(**EXACT))`` from its SEED), the route the
JAX extraction defaults (fast heads), with ``--point_head v2`` the split
point head (fast kernel 4 in place of fast kernel 1). A draw ``RN:S,..``
is RN rays and their uniform draws from each seed S, as
``agree_with_cpu`` draws them (its chunk is 1024:0). The card encodes each
view set once; the CPU renders on the card's encoding.

Variants, each a whole render on the card: ``kernels`` as shipped;
``plain_point`` the point head's plain version in place of its kernel;
``plain_heads`` both heads' plain versions; ``fine_pass`` chip_smoke's
staged check (``agree_with_cpu(staged=True)``): the card's render with the
CPU render's fine samples in place of its own. Stages (``--stages``), each
run on the card on the CPU render's inputs, its outputs taken back into
the CPU's render, which recomputes what follows it (a stage whose inputs
equal the reference render's takes that render's outputs):
``coarse_sampling`` (``ops/sampling.sample_coarse``), ``coarse_features``
(``UFORecon._point_features`` of the coarse points) and, inside it,
``coarse_similarity`` (``query_similarity``), ``coarse_correlation``
(``query_correlation_volume``), ``coarse_gathers`` (every
``grid_sample_2d`` / ``grid_sample_3d`` of the coarse features, the bf16
sources' float32 copies included), ``coarse_point_head`` (the point head's
kernel), ``coarse_sequence`` (``_render_sequence``: the ray head and
``neus_render``), ``importance`` (``sample_importance``: its cumsum and
searchsorted), ``fine_features`` and ``fine_sequence``.

Per (views, draw, variant or stage): per output (coarse and fine depth
and rgb) the share of rays within RAY_EFFECT times their bf16 effect (the
CPU's fast render against its FP32 one) or 2e-4, the rays beyond it,
whether the view's rules held (``chip_smoke.effect_figures``) and whether
the fine depth and rgb held the per-ray rule (the staged check's), the rays
whose outputs differ from the CPU's at all, and the rays whose fine
samples moved (any, and by more than a tenth of a coarse interval). The
card's name and power limit first, then one line per case, then a table
of the stages summed over the draws, then one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import sys
import tempfile
from pathlib import Path

VARIANTS = ("kernels", "plain_point", "plain_heads", "fine_pass")
STAGES = ("coarse_sampling", "coarse_features", "coarse_similarity", "coarse_correlation",
          "coarse_gathers", "coarse_point_head", "coarse_sequence", "importance",
          "fine_features", "fine_sequence")
# the stages inside the coarse point features
SUBSTAGES = ("coarse_similarity", "coarse_correlation", "coarse_gathers", "coarse_point_head")
OUTPUTS = (("coarse", "depth"), ("coarse", "rgb"), ("fine", "depth"), ("fine", "rgb"))


def move(x, device, known=None):
    """Tensors, dicts, tuples and named tuples of them on ``device``; a CPU
    tensor in ``known`` (id -> tensor) becomes that tensor."""
    import torch

    if isinstance(x, torch.Tensor):
        if known is not None and id(x) in known:
            return known[id(x)]
        return x.to(device)
    if isinstance(x, dict):
        return {k: move(v, device, known) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[move(v, device, known) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(move(v, device, known) for v in x)
    return x


def same(a, b) -> bool:
    """a and b hold the same values, bit for bit."""
    import torch

    if a is b:
        return True
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype
                and bool(torch.equal(a, b)))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(same(u, v) for u, v in zip(a, b)))
    return a == b


class StagedRender:
    """The CPU's render of one chunk (``model_cpu.render_chunk``) with one
    stage run on the card (``model_card``, the CPU's inputs moved there).
    ``known`` maps the CPU's scene and encoding tensors to the card's, so a
    card stage reads the card's own copies. The first run (no stage) is
    the reference: it records every top-level stage's inputs and outputs,
    which a later run takes where its inputs are the same. ``device`` is
    the card's (the tests run this class with a CPU model as the card)."""

    def __init__(self, model_cpu, model_card, scene_card, enc_card, point_name, known,
                 device="cuda"):
        self.cpu, self.card, self.device = model_cpu, model_card, device
        self.scene_card, self.enc_card = scene_card, enc_card
        self.point_name, self.known = point_name, known
        self.memo = None
        self.fine = None     # the last run's fine samples (points, z)

    def _on_card(self, fn, args, kw):
        out = fn(*move(args, self.device, self.known), **move(kw, self.device, self.known))
        return move(out, "cpu")

    def run(self, scene, enc, ray_d, draws, stage=None):
        from uforecon_tpu_torch.models import ray_transformer as rt
        from uforecon_tpu_torch.models import uforecon as uf
        from uforecon_tpu_torch.ops import volume_merge as vm

        record = self.memo is None
        memo = {} if record else self.memo
        calls = {}
        active = {"sub": None}

        def top(name, fn_cpu, fn_card, stages):
            # stages: the stage of this call by its index (coarse, fine)
            def wrapped(*args, **kw):
                i = calls[name] = calls.get(name, -1) + 1
                here = stages[i]
                if here == stage:
                    out = self._on_card(fn_card, args, kw)
                elif here == "coarse_features" and stage in SUBSTAGES:
                    active["sub"] = stage
                    try:
                        out = fn_cpu(*args, **kw)
                    finally:
                        active["sub"] = None
                elif (name, i) in memo and same((args, kw), memo[(name, i)][0]):
                    out = memo[(name, i)][1]
                else:
                    out = fn_cpu(*args, **kw)
                if record:
                    memo[(name, i)] = ((args, kw), out)
                if name == "sample_importance":
                    self.fine = out
                return dict(out) if isinstance(out, dict) else out
            return wrapped

        def sub(name, fn):
            def wrapped(*args, **kw):
                if active["sub"] == name:
                    return self._on_card(fn, args, kw)
                return fn(*args, **kw)
            return wrapped

        card_feats = lambda s_, e_, pts: self.card._point_features(self.scene_card,
                                                                   self.enc_card, pts)
        patches = [
            (uf, "sample_coarse", top("sample_coarse", uf.sample_coarse, uf.sample_coarse,
                                      ("coarse_sampling",))),
            (uf, "sample_importance", top("sample_importance", uf.sample_importance,
                                          uf.sample_importance, ("importance",))),
            (self.cpu, "_point_features", top("features", self.cpu._point_features, card_feats,
                                              ("coarse_features", "fine_features"))),
            (self.cpu, "_render_sequence", top("sequence", self.cpu._render_sequence,
                                               self.card._render_sequence,
                                               ("coarse_sequence", "fine_sequence"))),
            (uf, "query_similarity", sub("coarse_similarity", uf.query_similarity)),
            (uf, "query_correlation_volume", sub("coarse_correlation",
                                                 uf.query_correlation_volume)),
            (rt, "grid_sample_2d", sub("coarse_gathers", rt.grid_sample_2d)),
            (rt, "grid_sample_3d", sub("coarse_gathers", rt.grid_sample_3d)),
            (vm, "grid_sample_3d", sub("coarse_gathers", vm.grid_sample_3d)),
            (rt, self.point_name, sub("coarse_point_head", getattr(rt, self.point_name))),
        ]
        saved = [(obj, name, obj.__dict__.get(name)) for obj, name, _ in patches]
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        try:
            out = self.cpu.render_chunk(scene, enc, ray_d, **draws)
        finally:
            for obj, name, old in saved:
                if old is None:
                    delattr(obj, name)
                else:
                    setattr(obj, name, old)
        if record:
            self.memo = memo
        return out


def compare(cs, out, out_cpu, out_fp32, z_ref, z, span):
    """A render against the CPU's (``chip_smoke.effect_figures`` per
    output), with the rays that differ at all and those whose fine samples
    moved."""
    import numpy as np

    rn = out_cpu["fine"]["depth"].shape[0]
    within, beyond, ok, differ = {}, {}, True, np.zeros(rn, dtype=bool)
    for phase, key in OUTPUTS:
        a = out[phase][key].cpu().numpy()
        b = out_cpu[phase][key].numpy()
        _, ok_out, beyond_out = cs.effect_figures(a, b, out_fp32[phase][key].numpy())
        within[f"{phase}_{key}"] = float(1.0 - beyond_out.mean())
        beyond[f"{phase}_{key}"] = np.flatnonzero(beyond_out).tolist()
        ok &= ok_out
        differ |= (a != b).reshape(rn, -1).any(axis=1)
    moved = np.abs(z.cpu().numpy() - z_ref.numpy()).max(axis=1)
    fine_rule = all(within[f"fine_{k}"] >= cs.RAY_SHARE for k in ("depth", "rgb"))
    return {"within_effect": within, "rays_beyond": beyond, "ok": ok, "fine_rule": fine_rule,
            "rays_differ": int(differ.sum()), "fine_z_moved": int((moved > 0).sum()),
            "fine_z_moved_tenth_interval": int((moved > 0.1 * span).sum())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, nargs="+", default=[6, 8, 11, 12])
    ap.add_argument("--draws", nargs="+", default=["256:0,1,2,3", "1024:0,1,2"],
                    help="RN:SEEDS, e.g. 256:0,1,2,3")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS), choices=VARIANTS)
    ap.add_argument("--stages", nargs="*", default=list(STAGES), choices=STAGES)
    ap.add_argument("--point_head", default="v1", choices=("v1", "v2"))
    ap.add_argument("--scene", default="views", choices=("views", "slice"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path.cwd()))
    import numpy as np
    import torch

    import chip_smoke as cs
    from uforecon_tpu_torch.config import EXACT, Config
    from uforecon_tpu_torch.convert import init_weights
    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.data.dtu_test import SET1_VIEW_LIST, DtuFitSparse
    from uforecon_tpu_torch.data.synthetic import dtu_scale_sample
    from uforecon_tpu_torch.models import ray_transformer
    from uforecon_tpu_torch.models.uforecon import UFORecon
    from uforecon_tpu_torch.ops import fused_point_head as fph
    from uforecon_tpu_torch.ops import fused_point_head2 as fph2
    from uforecon_tpu_torch.ops import fused_ray_head as frh
    from uforecon_tpu_torch.script import make_dtu_fixture as fixture

    draws = [(int(rn), [int(s) for s in seeds.split(",")])
             for rn, seeds in (d.split(":") for d in args.draws)]
    card = cs.smi("name,power.limit")
    print(card, flush=True)
    model = UFORecon(Config(**EXACT))
    init_weights(model, cs.SEED)
    model.to("cuda")
    model.requires_grad_(False)
    shipped = model.with_knobs(extract_geometry=True, point_head=args.point_head,
                               **{k: getattr(Config(), k) for k in EXACT})
    model_cpu = copy.deepcopy(shipped).cpu()
    # the module attribute render_chunk's point head is looked up by
    point_name = "point_head2" if args.point_head == "v2" else "point_head_v1"
    point_plain = (fph2.point_head2_reference if args.point_head == "v2"
                   else fph.point_head_reference)
    heads = {"point": getattr(ray_transformer, point_name), "ray": ray_transformer.ray_head}
    plain = {"kernels": {}, "plain_point": {"point": point_plain},
             "plain_heads": {"point": point_plain, "ray": frh.ray_head_reference}}
    wrappers = cs.launch_counts()
    w, h = cs.PIPELINE_WH
    extra = cs.VIEWS_CHUNK[2]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "fixture")
        if args.scene == "views":
            with contextlib.redirect_stdout(io.StringIO()):
                fixture.main([root, "--views", *map(str, SET1_VIEW_LIST), str(extra), "--wh",
                              str(w), str(h)])
        for nv in args.views if args.scene == "views" else [3]:
            if args.scene == "slice":
                sample = dtu_scale_sample()
            elif nv <= len(SET1_VIEW_LIST):
                sample = DtuFitSparse(root, "scan24", n_views=nv, set=1, img_wh=(w, h))[0]
            else:
                sample = DtuFitSparse(root, "scan24", n_views=nv, set=0,
                                      test_view_pair=[*SET1_VIEW_LIST, extra],
                                      img_wh=(w, h))[0]
            scene, extras = scene_inputs_from_sample(sample, "cuda")
            with torch.no_grad():
                enc = shipped.encode(scene)
            scene_cpu, enc_cpu = cs.to_cpu(scene), cs.to_cpu(enc)
            known = {}
            for a, b in ((scene_cpu, scene), (enc_cpu, enc)):
                for u, v in zip(a, b):
                    for uu, vv in (zip(u.values(), v.values()) if isinstance(u, dict)
                                   else [(u, v)]):
                        if isinstance(uu, torch.Tensor):
                            known[id(uu)] = vv
            span = float(scene.far - scene.near) / (shipped.cfg.samples[0] - 1)
            for rn, seeds in draws:
                for seed in seeds:
                    # agree_with_cpu's draws
                    idx = np.random.default_rng(seed).choice(len(extras["ray_d"]), rn,
                                                             replace=False)
                    ray_d = torch.as_tensor(extras["ray_d"][idx], device="cuda")
                    gen = torch.Generator(device="cuda").manual_seed(seed)
                    n_coarse, n_fine = shipped.cfg.samples
                    u_c = torch.rand((rn, n_coarse), generator=gen, device="cuda")
                    u_f = torch.rand((rn, n_fine), generator=gen, device="cuda")
                    card_draws = dict(u_coarse=u_c, u_fine=u_f)
                    cpu_draws = dict(u_coarse=u_c.cpu(), u_fine=u_f.cpu())
                    staged = StagedRender(model_cpu, shipped, scene, enc, point_name, known)
                    with torch.no_grad():
                        out_cpu = staged.run(scene_cpu, enc_cpu, ray_d.cpu(), cpu_draws)
                        fine_ref = staged.fine
                        out_fp32 = model_cpu.with_knobs(kernel_precision="highest").render_chunk(
                            scene_cpu, enc_cpu, ray_d.cpu(), **cpu_draws)
                    cases = [(v, None) for v in args.variants] + [(None, s) for s in args.stages]
                    for variant, stage in cases:
                        for wr in wrappers.values():
                            wr.launches = 0
                        with torch.no_grad():
                            if variant == "fine_pass":
                                # chip_smoke's staged check: the card's render on
                                # the CPU's fine samples
                                with cs.fine_samples(replay=fine_ref):
                                    out = shipped.render_chunk(scene, enc, ray_d, **card_draws)
                                z = fine_ref[1]
                            elif variant is not None:
                                swap = plain[variant]
                                setattr(ray_transformer, point_name,
                                        swap.get("point", heads["point"]))
                                ray_transformer.ray_head = swap.get("ray", heads["ray"])
                                try:
                                    with cs.fine_samples() as rec:
                                        out = shipped.render_chunk(scene, enc, ray_d,
                                                                   **card_draws)
                                    z = rec["out"][1]
                                finally:
                                    setattr(ray_transformer, point_name, heads["point"])
                                    ray_transformer.ray_head = heads["ray"]
                            else:
                                out = staged.run(scene_cpu, enc_cpu, ray_d.cpu(), cpu_draws,
                                                 stage)
                                z = staged.fine[1]
                        torch.cuda.synchronize()
                        fig = compare(cs, out, out_cpu, out_fp32, fine_ref[1], z, span)
                        case = {"scene": args.scene, "point_head": args.point_head,
                                "views": nv, "rays": rn, "seed": seed,
                                "variant": variant or "stage", "stage": stage, **fig,
                                "launches": {k: v for k, v in
                                             ((k, wr.launches) for k, wr in wrappers.items())
                                             if v}}
                        results.append(case)
                        fine = {k: len(fig["rays_beyond"][k]) for k in ("fine_depth", "fine_rgb")}
                        print(f"[views_agreement] {args.scene} point_head={args.point_head} "
                              f"NV {nv} {rn} rays seed {seed} "
                              f"{variant or 'stage ' + stage}: rays beyond {cs.RAY_EFFECT} x "
                              f"their bf16 effect (fine depth, rgb) {fine}; share within "
                              f"(at least {cs.RAY_SHARE}) {fig['within_effect']}; the rules "
                              f"held: {fig['ok']}; rays differing {fig['rays_differ']}, fine "
                              f"samples moved {fig['fine_z_moved']} (by > 0.1 interval "
                              f"{fig['fine_z_moved_tenth_interval']}); launches "
                              f"{case['launches']} [{card}]", flush=True)
            del sample, scene, enc, scene_cpu, enc_cpu, known
    print(summary(cs, results, card), flush=True)
    print(json.dumps({"card": card, "ray_share": cs.RAY_SHARE, "ray_effect": cs.RAY_EFFECT,
                      "cases": results}), flush=True)


def summary(cs, results, card):
    """The cases summed per (point head, views, variant or stage) over the
    draws: draws that held the rules, draws whose fine depth and rgb held
    the per-ray rule alone (the staged check's rule), rays beyond on the
    fine depth and rgb, rays differing, fine samples moved, as a markdown
    table."""
    rows = {}
    for c in results:
        key = (c["point_head"], c["views"], c["stage"] or c["variant"])
        r = rows.setdefault(key, [0] * 9)
        for i, n in enumerate((1, int(c["ok"]), int(c["fine_rule"]), c["rays"],
                               len(c["rays_beyond"]["fine_depth"]),
                               len(c["rays_beyond"]["fine_rgb"]), c["rays_differ"],
                               c["fine_z_moved"], c["fine_z_moved_tenth_interval"])):
            r[i] += n
    lines = [f"[views_agreement] summed over the draws [{card}]",
             "| head | NV | run | draws held / all | fine per-ray rule held | rays | beyond: "
             "fine depth | fine rgb | differing | fine z moved | by > 0.1 interval |",
             "|---" * 11 + "|"]
    for (head, nv, run), r in rows.items():
        lines.append(f"| {head} | {nv} | {run} | {r[1]} / {r[0]} | "
                     + " | ".join(map(str, r[2:])) + " |")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
