"""Data-parallel training through the CLI's rank path on two CPU ranks
(gloo): ``cli.run --debug --mesh_shape 2 --device cpu``'s per-rank work
(``run.run``, which ``run.main`` runs on each rank it starts; the start
itself is held by ``test_torch_port_sharding.py``'s extraction runs) on the
learn_sanity sphere (4 views at 32x32, 16 hypotheses, 4 + 4 samples) in
place of the DTU training layout, whose 640x512 encodes take minutes on
the CPU (``test_torch_cli_train.py`` runs the layout on one rank).

Rank 0 alone logs, validates and checkpoints: one ``metrics.jsonl`` with
steps 1-3 and one validation, one checkpoint, which holds the weights the
run returns, and every rank sees only those files. The two ranks' logged
losses equal one rank's within 1e-3 relative at every step (the JAX
sharding test's loss rule; the gradients are summed in another order).
"""
import json

import numpy as np
import torch

from uforecon_tpu_torch.config import config_from_args
from uforecon_tpu_torch.convert import load_weights
from uforecon_tpu_torch.models.uforecon import UFORecon
from uforecon_tpu_torch.parallel import sharding

import torch_multicard_workers as workers

FLAGS = ["--debug", "--depth_pos_encoding", "--explicit_similarity", "--ndepths", "8,8,8",
         "--numdepth", "16", "--train_n_view", "3", "--coarse_sample", "4",
         "--fine_sample", "4", "--train_ray_num", "64", "--device", "cpu"]


def _losses(logdir):
    with open(logdir / "uforecon_tpu" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return recs, [r for r in recs if "train/loss_all" in r]


def test_cli_debug_on_two_ranks_logs_and_checkpoints_once(tmp_path):
    runs = {}
    for world in (1, 2):
        logdir = tmp_path / f"ranks{world}"
        argv = FLAGS + ["--mesh_shape", str(world), "--logdir", str(logdir)]
        runs[world] = (logdir, sharding.spawn(workers.cli_debug_rank, world,
                                              (argv, str(logdir)), device="cpu"))
    logdir, ranks = runs[2]
    want = ["uforecon_tpu/ckpt/index.json", "uforecon_tpu/ckpt/step_3.pt",
            "uforecon_tpu/metrics.jsonl"]
    assert [r["step"] for r in ranks] == [3, 3]
    assert [r["files"] for r in ranks] == [want, want]
    recs, train = _losses(logdir)
    assert [r["step"] for r in train] == [1, 2, 3]
    val = [r for r in recs if "val/loss_depth_fine" in r]
    assert len(val) == 1 and val[0]["step"] == 3
    assert all(np.isfinite(v) for r in recs for v in r.values())
    trained = UFORecon(config_from_args(FLAGS)[0])
    load_weights(trained, str(logdir / "uforecon_tpu" / "ckpt" / "step_3.pt"))
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(trained.state_dict()[k], v), k
    # the same run on one rank
    _, one = _losses(runs[1][0])
    assert [r["step"] for r in one] == [1, 2, 3]
    for g, w in zip(train, one):
        for k in ("train/loss_all", "train/rgb_coarse", "train/depth_ray_coarse"):
            rel = abs(g[k] - w[k]) / abs(w[k])
            print(f"step {g['step']} {k}: 2 ranks {g[k]:.7g}, 1 rank {w[k]:.7g}, rel {rel:.2e}")
            assert rel <= 1e-3, (g["step"], k, g[k], w[k])
