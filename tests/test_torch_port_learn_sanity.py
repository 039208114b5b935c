"""The kernel precision of ``learn_sanity``'s evaluation, in both packages.

The JAX package pins one kernel-precision mode per process: a kernel body
that traces reads it (``ops/kernel_precision.get_mode``) and a later
``auto`` keeps it (``models/uforecon.py:79-90``). A process that trains and
then evaluates, as ``script/learn_sanity.py`` does, therefore renders its
depth maps and mesh at the training mode ``high``, where a fresh extract
model's ``auto`` gives ``fast``. On the CPU the JAX heads take their flax
path and no kernel body traces, so the JAX side here makes the one
trace-time read that the training step's kernels make on the accelerator,
then runs the JAX script's ``make_renderer`` and ``mesh_eval``
(``script/learn_sanity.py:295-360``) with a ``Config`` built here, at a
tiny size; before that read, its renderer resolves ``fast``. The port's
``learn_sanity`` passes its trainer's resolved precision to the
evaluation: ``high`` after training, ``fast`` on ``--resume``.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_learn_sanity.py -q
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

from uforecon_tpu_torch.script import learn_sanity

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--h", "32", "--w", "32", "--views", "4", "--n_src", "2", "--ndepth", "16",
        "--mvs_steps", "2", "--render_steps", "2", "--device", "cpu"]

_JAX_EVAL = """
import importlib.util, json
import jax
jax.config.update("jax_platforms", "cpu")
from uforecon_tpu.config import Config
from uforecon_tpu.data.convert import scene_inputs_from_sample
from uforecon_tpu.ops import kernel_precision
from uforecon_tpu.pipeline.fit import init_model
spec = importlib.util.spec_from_file_location("learn_sanity", "script/learn_sanity.py")
ls = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ls)
# the script's training config at a tiny size
cfg = Config(ndepths=(8, 8, 8), numdepth=16, coarse_sample=8, fine_sample=8,
             test_sample_coarse=8, test_sample_fine=8, train_ray_num=512,
             train_n_view=3, volume_type="correlation", exp_name="sanity",
             max_epochs=1)
ds = ls.SphereDataset(ls.build_scene_views(4, 32, 32), 2, 16, 32, 32)
_, variables = init_model(cfg, ds[0], 0)       # the training model: mode 'high'
out = {"after_init": kernel_precision.current_mode()}
# a fresh process's evaluation, before any kernel traced
fresh = ls.make_renderer(cfg, variables)
fresh.encode(scene_inputs_from_sample(ds[0])[0])
out["fresh_eval"] = kernel_precision.current_mode()
# training: its model sets 'high' and its kernel bodies read it as they trace
kernel_precision.set_mode("high")
kernel_precision.get_mode()
renderer = ls.make_renderer(cfg, variables)
out.update(ls.mesh_eval(renderer, ds))
out["trained_eval"] = kernel_precision.current_mode()
print(json.dumps(out))
"""


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        learn_sanity.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_evaluation_after_training_resolves_high_in_both_packages(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", _JAX_EVAL], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu", "UFO_PLATFORM": "cpu",
                       "PYTHONPATH": os.pathsep.join([str(ROOT),
                                                      os.environ.get("PYTHONPATH", "")])})
    assert res.returncode == 0, res.stderr[-3000:]
    jax_out = json.loads(res.stdout.strip().splitlines()[-1])
    assert jax_out["after_init"] == "high"
    assert jax_out["fresh_eval"] == "fast"
    assert jax_out["trained_eval"] == "high" and jax_out["mesh_verts"] >= 0

    trained = _main(TINY + ["--mesh_eval", "--logdir", str(tmp_path)])
    assert trained["kernel_precision"] == jax_out["trained_eval"] == "high"
    assert "mesh_verts" in trained
    # no training in the process: the extract default, as JAX's --resume
    resumed = _main(TINY + ["--resume", "--logdir", str(tmp_path)])
    assert resumed["kernel_precision"] == jax_out["fresh_eval"] == "fast"
