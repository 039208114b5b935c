"""``script/views_agreement.py``'s stage swap on the CPU: a render with one
stage run by a second model (on the card in the script; here a CPU copy)
takes that stage's outputs into the first model's render and recomputes
only what follows it. With an identical second model every stage gives the
reference render bit for bit; with its NeuS variance moved, only the
stages that run the compositing move the outputs."""
import copy

import numpy as np
import pytest
import torch

from uforecon_tpu_torch.config import EXACT, Config
from uforecon_tpu_torch.convert import init_weights
from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
from uforecon_tpu_torch.data.synthetic import dtu_scale_sample
from uforecon_tpu_torch.models import ray_transformer as rt
from uforecon_tpu_torch.models.uforecon import UFORecon
from uforecon_tpu_torch.script import views_agreement as va

NV, RN = 6, 16


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    base = UFORecon(Config(**EXACT, ndepths=(8, 8, 8), fmt_layer_names=("self", "cross"),
                           test_sample_coarse=8, test_sample_fine=8))
    init_weights(base, 0)
    base.requires_grad_(False)
    # the views phase's route: the JAX extraction defaults (fast heads,
    # bf16 sources), on the point head
    model = base.with_knobs(extract_geometry=True, **{k: getattr(Config(), k) for k in EXACT})
    sample = dtu_scale_sample(w=64, h=64, n_views=NV, n_depth=16)
    scene, extras = scene_inputs_from_sample(sample, "cpu")
    with torch.no_grad():
        enc = model.encode(scene)
    idx = np.random.default_rng(0).choice(len(extras["ray_d"]), RN, replace=False)
    ray_d = torch.as_tensor(extras["ray_d"][idx])
    gen = torch.Generator().manual_seed(0)
    draws = dict(u_coarse=torch.rand((RN, 8), generator=gen),
                 u_fine=torch.rand((RN, 8), generator=gen))
    return model, scene, enc, ray_d, draws


def _staged(model, card, scene, enc):
    return va.StagedRender(model, card, scene, enc, "point_head_v1", {}, device="cpu")


def _outputs(out):
    return {(p, k): out[p][k] for p, k in va.OUTPUTS}


def test_every_stage_on_an_identical_model_is_the_reference(setup):
    model, scene, enc, ray_d, draws = setup
    card = copy.deepcopy(model)
    staged = _staged(model, card, scene, enc)
    with torch.no_grad():
        ref = _outputs(staged.run(scene, enc, ray_d, draws))
        direct = _outputs(model.render_chunk(scene, enc, ray_d, **draws))
        for key in ref:
            assert torch.equal(ref[key], direct[key]), key
        assert model.kernel_precision == "fast"
        for stage in va.STAGES:
            got = _outputs(staged.run(scene, enc, ray_d, draws, stage))
            for key in ref:
                assert torch.equal(got[key], ref[key]), (stage, key)


def test_a_stage_takes_the_second_models_outputs_and_recomputes_what_follows(setup,
                                                                              monkeypatch):
    model, scene, enc, ray_d, draws = setup
    card = copy.deepcopy(model)
    card.variance.add_(0.05)     # moves the NeuS compositing only
    staged = _staged(model, card, scene, enc)
    heads = []
    inner = rt.point_head_v1
    monkeypatch.setattr(rt, "point_head_v1", lambda *a, **k: heads.append(1) or inner(*a, **k))
    with torch.no_grad():
        ref = _outputs(staged.run(scene, enc, ray_d, draws))
        assert len(heads) == 2          # the coarse and the fine points
        moved = {}
        for stage in va.STAGES:
            heads.clear()
            got = _outputs(staged.run(scene, enc, ray_d, draws, stage))
            moved[stage] = {key for key in ref if not torch.equal(got[key], ref[key])}
            # the point features of a pass whose inputs are the reference's
            # are taken from the reference render, not recomputed: the fine
            # stages run no point head but the second model's own
            if stage in ("fine_features", "fine_sequence"):
                assert len(heads) == int(stage == "fine_features"), stage
    assert moved["coarse_sequence"] == set(ref)
    assert moved["fine_sequence"] == {("fine", "depth"), ("fine", "rgb")}
    for stage in ("coarse_sampling", "coarse_features", *va.SUBSTAGES, "importance",
                  "fine_features"):
        assert moved[stage] == set(), stage


def test_chip_smokes_fine_samples_replay_the_recorded_fine_samples(setup):
    """chip_smoke.py's staged check renders the card's fine pass on the
    CPU's fine samples (``fine_samples``): a replay puts the recorded
    samples in place of the importance sampler's, whatever the fine draws."""
    import chip_smoke as cs

    model, scene, enc, ray_d, draws = setup
    other = dict(draws, u_fine=torch.rand(draws["u_fine"].shape,
                                          generator=torch.Generator().manual_seed(1)))
    with torch.no_grad():
        with cs.fine_samples() as rec:
            ref = _outputs(model.render_chunk(scene, enc, ray_d, **draws))
        moved = _outputs(model.render_chunk(scene, enc, ray_d, **other))
        with cs.fine_samples(replay=rec["out"]):
            got = _outputs(model.render_chunk(scene, enc, ray_d, **other))
    assert rec["out"][1].shape == (RN, 8)
    assert not torch.equal(moved[("fine", "depth")], ref[("fine", "depth")])
    for key in ref:
        assert torch.equal(got[key], ref[key]), key
