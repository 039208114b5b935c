"""Where learn_sanity's render training starts, in both packages, on the CPU.

    JAX_PLATFORMS=cpu python tests/learn_sanity_start.py [--mvs_steps 120] [--json FILE]

The learning check (``script/learn_sanity.py`` and its port) pretrains the
cascade matcher, renders the held-out reference view (sample 0), trains the
render side and renders again. This script takes the first render, the one
before render training, at the check's own size and settings (160x128, 6
views, 3 sources, 64 hypotheses, 32 + 32 samples, 1024-ray chunks), in
these cases:

  * ``jax_init`` / ``jax_pretrained``: JAX's script: its model's ``init``
    (seed 0), then its MVS pretraining (``pipeline/fit.pretrain_mvs``), each
    rendered by the script's renderer with ``PRNGKey(0)``;
  * ``port_on_jax_init`` / ``port_on_jax_pretrained``: the port rendering
    those same weights (``convert.load_flax_variables``), with JAX's draws
    (``SceneRenderer.render_rays(draws=)``): equal to the JAX figures, or
    the render path differs;
  * ``port_pretrained_from_jax_init``: the port's own MVS pretraining from
    JAX's init weights, rendered with JAX's draws;
  * ``port_own_init`` / ``port_pretrained_from_own_init``: the port's
    ``convert.init_weights`` (seed 0; flax's initialisers), before and
    after the port's MVS pretraining, rendered with JAX's draws.

Each case reports the depth L1 over the sphere's rays in units of the depth
span (the check's statistic) and the mean opacity over the same rays. Prints
one JSON object (and writes it to ``--json``).
"""
import argparse
import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_learn_sanity",
                                                  ROOT / "script" / "learn_sanity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stats(out, sample, far_minus_near):
    gt = sample["depths_h"][0].reshape(-1)
    m = gt > 0
    return {"depth_l1": float(np.abs(out["depth"][m] - gt[m]).mean() / far_minus_near),
            "opacity": float(np.mean(out["opacity"][m]))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mvs_steps", type=int, default=120)
    ap.add_argument("--h", type=int, default=128)
    ap.add_argument("--w", type=int, default=160)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from uforecon_tpu.config import Config as JaxConfig
    from uforecon_tpu.data.convert import scene_inputs_from_sample as jax_scene
    from uforecon_tpu.pipeline.fit import init_model
    from uforecon_tpu.pipeline.fit import pretrain_mvs as jax_pretrain

    from uforecon_tpu_torch.config import Config
    from uforecon_tpu_torch.convert import init_weights, load_flax_variables
    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.models.uforecon import UFORecon
    from uforecon_tpu_torch.pipeline.fit import pretrain_mvs
    from uforecon_tpu_torch.script import learn_sanity as port_ls

    jls = _jax_script()
    logdir = tempfile.mkdtemp()
    settings = dict(ndepths=(24, 16, 8), numdepth=64, coarse_sample=32, fine_sample=32,
                    test_sample_coarse=32, test_sample_fine=32, train_ray_num=512,
                    train_n_view=4, uforecon_lr=5e-4, logdir=logdir, exp_name="sanity",
                    max_epochs=1)
    jcfg = JaxConfig(volume_type="correlation", **settings)
    pcfg = Config(**settings)
    span = jls.FAR - jls.NEAR
    jds = jls.SphereDataset(jls.build_scene_views(6, args.h, args.w), 3, 64, args.h, args.w)
    pds = port_ls.SphereDataset(port_ls.build_scene_views(6, args.h, args.w), 3, 64)
    sample = jds[0]
    n = args.h * args.w

    # JAX's draws for sample 0's render (pipeline/renderer.py's schedule)
    chunk = 1024
    draws = []
    for k in jax.random.split(jax.random.PRNGKey(0), -(-n // chunk)):
        kc, kf = jax.random.split(k)
        draws.append((np.asarray(jax.random.uniform(kc, (chunk, 32), jnp.float32)),
                      np.asarray(jax.random.uniform(kf, (chunk, 32), jnp.float32))))

    def jax_render(variables):
        renderer = jls.make_renderer(jcfg, variables)
        scene, extras = jax_scene(sample)
        out = renderer.render_rays(scene, renderer.encode(scene), extras["ray_d"],
                                   np.full(n, jls.NEAR, np.float32),
                                   np.full(n, jls.FAR, np.float32), jax.random.PRNGKey(0))
        return _stats(out, sample, span)

    def port_render(model):
        renderer = port_ls.make_renderer(model, "cpu", model.kernel_precision)
        scene, extras = scene_inputs_from_sample(pds[0], "cpu")
        with torch.no_grad():
            enc = renderer.model.encode(scene)
        out = renderer.render_rays(scene, enc, extras["ray_d"],
                                   np.full(n, port_ls.NEAR, np.float32),
                                   np.full(n, port_ls.FAR, np.float32), draws=draws)
        return _stats(out, sample, span)

    def np_tree(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    def port_on(variables):
        model = UFORecon(pcfg)
        load_flax_variables(model, np_tree(variables))
        return model

    res = {"mvs_steps": args.mvs_steps, "size": [args.w, args.h]}
    _, v0 = init_model(jcfg, sample, jcfg.seed)
    res["jax_init"] = jax_render(v0)
    res["port_on_jax_init"] = port_render(port_on(v0))
    state = jax_pretrain(jcfg, train_ds=jds, variables=v0, max_steps=args.mvs_steps,
                         log_every=20, n_workers=2)
    v1 = {"params": state.params, "batch_stats": state.batch_stats}
    res["jax_pretrained"] = jax_render(v1)
    res["port_on_jax_pretrained"] = port_render(port_on(v1))
    print(json.dumps(res), flush=True)

    st = pretrain_mvs(pcfg, train_ds=pds, model=port_on(v0), max_steps=args.mvs_steps,
                      log_every=20, n_workers=2, device="cpu")
    res["port_pretrained_from_jax_init"] = port_render(st.model)
    own = UFORecon(pcfg)
    init_weights(own, pcfg.seed)
    res["port_own_init"] = port_render(own)
    st = pretrain_mvs(pcfg, train_ds=pds, max_steps=args.mvs_steps, log_every=20,
                      n_workers=2, device="cpu")
    res["port_pretrained_from_own_init"] = port_render(st.model)
    print(json.dumps(res), flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
