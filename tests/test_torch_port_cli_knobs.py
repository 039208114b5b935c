"""The port's CLI flags for the JAX package's route overrides:
``--point_head`` for ``UFO_POINT_HEAD`` (the split-weight point head,
kernel 4) and ``--fused_neus_epilogue`` for ``UFO_NEUS_EPILOGUE`` (the ray
head with the NeuS epilogue, kernel 3). Each flag sets the field that the
JAX package's ``config_from_args`` sets with the variable in its
environment (``uforecon_tpu/config.py`` ``perf_env_overrides``), and
without either both take the same default. No render: the parsers only.
"""
import pytest

from uforecon_tpu_torch.config import config_from_args

ARGV = ["--extract_geometry", "--depth_pos_encoding", "--explicit_similarity"]
KNOBS = {"point_head": ("--point_head", "UFO_POINT_HEAD", ("v1", "v2")),
         "fused_neus_epilogue": ("--fused_neus_epilogue", "UFO_NEUS_EPILOGUE",
                                 ("auto", "never"))}


@pytest.mark.parametrize("field, value", [(f, v) for f, (_, _, vs) in KNOBS.items()
                                          for v in (None, *vs)])
def test_flag_sets_the_field_the_jax_variable_sets(monkeypatch, field, value):
    from uforecon_tpu.config import config_from_args as jax_config_from_args

    flag, env, _ = KNOBS[field]
    for _, name, _ in KNOBS.values():
        monkeypatch.delenv(name, raising=False)
    if value is not None:
        monkeypatch.setenv(env, value)
    cfg, _ = config_from_args(ARGV + ([flag, value] if value is not None else []))
    want = getattr(jax_config_from_args(ARGV), field)
    assert getattr(cfg, field) == want
    if value is not None:
        assert want == value
    # the other knob stays at its default
    other = next(f for f in KNOBS if f != field)
    assert getattr(cfg, other) == getattr(jax_config_from_args(ARGV), other)
