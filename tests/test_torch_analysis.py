"""The port's analytic model math (``repro_torch.launch.analysis``)
against the reference's (``repro.launch.analysis``): `count_params`,
`_attn_layers` and the train, prefill and decode model FLOPs are equal,
exactly, for all ten full configs and every ``SHAPES`` cell.  The
reference counts from ``jax.eval_shape``; the port builds the model on
the ``meta`` device, which draws no weight and allocates no storage."""
import pytest
import torch

from repro.configs import ARCH_NAMES, SHAPES as JSHAPES, get_config as jget
from repro.launch import analysis as ja
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import analysis
from repro_torch.models import build_model


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_counts_and_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert analysis.count_params(cfg) == ja.count_params(jcfg)
    assert analysis._attn_layers(cfg) == ja._attn_layers(jcfg)
    for name, shape in SHAPES.items():
        assert analysis.model_flops_for(cfg, shape) == ja.model_flops_for(
            jcfg, JSHAPES[name]), name
    for batch, seq in ((8, 128), (1, 1), (3, 4096)):
        assert analysis.train_model_flops(cfg, batch, seq) == \
            ja.train_model_flops(jcfg, batch, seq)
        assert analysis.prefill_model_flops(cfg, batch, seq) == \
            ja.prefill_model_flops(jcfg, batch, seq)
        assert analysis.decode_model_flops(cfg, batch, seq) == \
            ja.decode_model_flops(jcfg, batch, seq)


def test_shape_only_build_allocates_nothing(monkeypatch):
    def no_draws(*a, **k):
        raise AssertionError("a weight was drawn")

    monkeypatch.setattr(torch, "randn", no_draws)
    model = build_model(get_config("deepseek-67b"), device="meta")
    params = list(model.parameters())
    assert params and all(p.is_meta for p in params)
    assert sum(p.numel() for p in params) == 67_425_001_472
    assert analysis.count_params(get_config("deepseek-67b"))["total"] == \
        67_425_001_472
