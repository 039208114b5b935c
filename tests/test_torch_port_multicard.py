"""The port on two ranks (``parallel/sharding.py``: two CPU processes over
gloo) against the port on one and against the JAX package's two-device
mesh (``tests/conftest.py`` gives JAX 8 host devices).

One tiny scene (the learn_sanity sphere: 3 views at 32x32, 16 hypotheses),
a tiny model (cascade depths 8/8/8, one FMT self/cross pair, 4 + 4
samples) initialised by the JAX package and bridged into the port, on the
exact path. The two ranks run once per module (``torch_multicard_workers.
rank_checks``) and render the reference view's 1024 rays in chunks of 96
(11 chunks on one rank, 12 on two: the rays pad to chunk x ranks).

  * the 2-rank render with the generator equals the 1-rank render bit for
    bit: the chunk boundaries and each chunk's draws are the same. On the
    CPU the sums of the GEMMs depend on the number of torch threads, so the
    1-rank render runs at one thread, as each rank does (``spawn`` splits
    the parent's threads over the ranks);
  * the 2-rank render fed JAX's per-device key schedule (device ``d``'s
    chunk ``j`` from ``jax.random.split(key, 6)[j]``) against
    ``SceneRenderer(mesh=make_mesh(2))``, by the per-ray rule of the port's
    render tests: every output of a ray within 2e-4 (rtol and atol) for
    99 % of the rays (a ray through a flipped winner-take-all pixel sees
    another depth PE);
  * one gradient step on 64 rays, each rank its 32 rows, all-reduced,
    against the port's 1-rank step on the same rays and draws and against
    JAX's ``grad_step`` on rays sharded over ``make_mesh(2)``
    (``tests/test_pipeline.py``'s rule as a ceiling: loss rtol 1e-3, the
    gradient tree's relative L2 2e-2; the measured values are printed);
  * a weight pack built before ``broadcast_module_`` or a
    ``load_state_dict`` is not reused after it, on every rank.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uforecon_tpu.config import Config as JaxConfig
from uforecon_tpu.data.convert import scene_inputs_from_sample as jax_scene_inputs
from uforecon_tpu.parallel.sharding import make_mesh, replicate, shard_rays
from uforecon_tpu.pipeline import trainer as jax_trainer
from uforecon_tpu.pipeline.fit import init_model as jax_init_model
from uforecon_tpu.pipeline.renderer import SceneRenderer as JaxSceneRenderer

from uforecon_tpu_torch.convert import flax_to_state_dict
from uforecon_tpu_torch.parallel import sharding
from uforecon_tpu_torch.pipeline.fit import _gather_ray_batch

import torch_multicard_workers as workers

torch.set_num_threads(2)

RN, SEED, WORLD = 64, 0, 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@contextlib.contextmanager
def _threads(n):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs():
    """The JAX side (mesh of 2), the port on one rank and on two."""
    sample = workers.sample()
    jcfg = JaxConfig(**workers.SMALL, volume_type="correlation", volume_merge="never",
                     volume_dtype="float32", image_gather_dtype="float32")
    model, variables = jax_init_model(jcfg, sample, SEED)
    scene, extras = jax_scene_inputs(sample)
    mesh = make_mesh(WORLD)

    # the render over the mesh, and its per-device key schedule as draws
    renderer = JaxSceneRenderer(jcfg, variables, mesh=mesh, chunk=workers.CHUNK)
    n = extras["ray_d"].shape[0]
    near = np.full(n, float(scene.near), np.float32)
    far = np.full(n, float(scene.far), np.float32)
    key = jax.random.PRNGKey(5)
    jax_render = renderer.render_rays(scene, renderer.encode(scene), extras["ray_d"],
                                      near, far, key)
    per_dev = -(-n // (workers.CHUNK * WORLD))
    jax_draws = []
    for _ in range(WORLD):       # every device splits the replicated key alike
        for k in jax.random.split(key, per_dev):
            kc, kf = jax.random.split(k)
            jax_draws.append(tuple(np.asarray(jax.random.uniform(
                kk, (workers.CHUNK, workers.SAMPLES), jnp.float32)) for kk in (kc, kf)))

    # one gradient step on RN rays sharded over the mesh
    idx = np.random.default_rng(SEED).permutation(n)[:RN]
    rays = _gather_ray_batch(extras, idx)
    step_key = jax.random.PRNGKey(1)
    k_c, k_f = jax.random.split(step_key)
    step_draws = tuple(np.asarray(jax.random.uniform(k, (RN, workers.SAMPLES), jnp.float32))
                       for k in (k_c, k_f))
    state = replicate(mesh, jax_trainer.create_train_state(jcfg, variables))
    grads, logs = jax_trainer.make_grad_step(jcfg, model)(
        state, replicate(mesh, scene), *(shard_rays(mesh, jnp.asarray(a)) for a in rays),
        step_key)

    state_dict = {k: torch.tensor(v) for k, v in flax_to_state_dict(_np(variables)).items()}
    with _threads(1):
        port = workers.port_model(state_dict)
        one = {"render_gen": workers.render(port),
               "step": workers.grad_step(workers.port_model(state_dict), "cpu", rays,
                                         step_draws)}
    two = sharding.spawn(workers.rank_checks, WORLD,
                         (state_dict, jax_draws, rays, step_draws), device="cpu")
    return dict(jax_render=jax_render, jax_grads=flax_to_state_dict({"params": _np(grads)}),
                jax_logs={k: float(v) for k, v in logs.items()}, one=one, two=two)


def test_the_ranks_ran_as_one_process_group(runs):
    assert runs["two"][0]["world"] == WORLD
    assert runs["two"][1].keys() == {"packs"}       # only rank 0 returns outputs


def test_two_rank_render_equals_one_rank_bit_for_bit(runs):
    got, want = runs["two"][0]["render_gen"], runs["one"]["render_gen"]
    for k in ("rgb", "depth", "opacity"):
        assert got[k].shape == want[k].shape and got[k].shape[0] == 32 * 32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_two_rank_render_matches_the_jax_mesh(runs):
    got, want = runs["two"][0]["render_jax"], runs["jax_render"]
    ok = np.ones(32 * 32, bool)
    for k in ("rgb", "depth", "opacity"):
        assert np.all(np.isfinite(got[k]))
        ok &= np.isclose(got[k], want[k], rtol=2e-4, atol=2e-4).reshape(32 * 32, -1).all(1)
    assert ok.mean() >= 0.99, ok.mean()


def _rel_l2(got, want, names):
    num = sum(float(np.sum((got[n] - want[n]) ** 2)) for n in names)
    den = sum(float(np.sum(want[n] ** 2)) for n in names)
    return (num / max(den, 1e-30)) ** 0.5


@pytest.mark.parametrize("reference", ["port_one_rank", "jax_mesh"])
def test_two_rank_grad_step(runs, reference):
    logs, grads = runs["two"][0]["step"]
    if reference == "port_one_rank":
        want_logs, want = runs["one"]["step"]
    else:
        want_logs, want = runs["jax_logs"], {n: runs["jax_grads"][n] for n in grads}
    assert set(grads) == set(want) and grads
    for k in ("train/loss_all", "train/rgb_coarse", "train/depth_ray_coarse"):
        assert abs(logs[k] - want_logs[k]) <= 1e-3 * abs(want_logs[k]), (k, logs[k],
                                                                         want_logs[k])
    rel = _rel_l2(grads, want, sorted(grads))
    loss_rel = abs(logs["train/loss_all"] - want_logs["train/loss_all"]) / abs(
        want_logs["train/loss_all"])
    print(f"2-rank step against {reference}: loss rel {loss_rel:.3e}, "
          f"gradient tree rel-L2 {rel:.3e}")
    assert rel < 2e-2, rel


def test_weight_packs_are_built_anew_after_a_broadcast_or_load(runs):
    for rank, res in enumerate(runs["two"]):
        assert res["packs"] == {"reused": True, "broadcast": True,
                                "load_state_dict": True}, rank
