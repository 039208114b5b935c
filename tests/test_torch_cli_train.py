"""The training CLI on one rank: ``cli.run --debug --device cpu`` on the
fixture's DTU training layout (``make_dtu_fixture.write_train_layout``,
640x512, 3 views) with the tiny model's flags and the default source
dtypes (bf16 volumes) trains 3 steps, validates once and writes one
checkpoint, which holds the weights it returns.

The layout's 640x512 is the dataset's fixed crop, so the four encodes at
that size (about 35 s each on two CPU threads) and the validation's
whole-view render are the test's time: it renders 2 + 2 samples and
validates with reference views 23 and 24 (3 views; the training takes 3).
(The extraction from a training checkpoint: ``test_torch_port_fit.py``;
on two ranks: ``test_torch_port_multicard_fit.py``.)
"""
import json

import numpy as np
import pytest
import torch

from uforecon_tpu_torch.cli import run
from uforecon_tpu_torch.convert import load_weights
from uforecon_tpu_torch.models.uforecon import UFORecon
from uforecon_tpu_torch.script import make_dtu_fixture

torch.set_num_threads(2)

SMALL_MODEL = ["--depth_pos_encoding", "--explicit_similarity", "--ndepths", "8,8,8"]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixture")
    return root, make_dtu_fixture.write_train_layout(str(root), views=(23, 24, 33))


def test_cli_debug_trains_validates_and_checkpoints(fixture_root, tmp_path):
    root, paths = fixture_root
    logdir = tmp_path / "logs"
    state = run.main(SMALL_MODEL + [
        "--debug", "--root_dir", str(root), "--train_list", paths["train"],
        "--val_list", paths["val"], "--pair_file", paths["pair"], "--logdir", str(logdir),
        "--train_n_view", "3", "--test_ref_view", "23", "24", "--coarse_sample", "2",
        "--fine_sample", "2", "--train_ray_num", "2048", "--device", "cpu"])
    assert state.step == 3
    assert state.model.cfg.volume_dtype == "bfloat16"
    with open(logdir / "uforecon_tpu" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "train/loss_all" in r] == [1, 2, 3]
    val = [r for r in recs if "val/loss_depth_fine" in r]
    assert len(val) == 1 and val[0]["step"] == 3
    assert all(np.isfinite(v) for v in val[0].values())
    ckpt = logdir / "uforecon_tpu" / "ckpt" / "step_3.pt"
    assert ckpt.exists()
    # the checkpoint holds the trained weights
    trained = UFORecon(state.model.cfg)
    load_weights(trained, str(ckpt))
    for k, v in state.model.state_dict().items():
        assert torch.equal(trained.state_dict()[k], v.cpu()), k
