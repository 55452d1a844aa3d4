"""The port's roofline model terms (``repro_torch.launch.roofline``)
against the reference's (``repro.launch.roofline``): ``active_params``
and ``model_flops`` equal exactly for every arch of ``ALL_ARCHS`` at
full width and every entry of ``SHAPES``, counted from the port's
parameter definitions without allocating a model; ``roofline_terms`` on
the card's peaks against a hand computation."""

import math

import pytest

from repro.configs import ALL_ARCHS, SHAPES
from repro.configs import get_config as jget_config
from repro.launch import roofline as jroof
from repro.models import build
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import roofline as roof


def _reference_model(cfg):
    if cfg.family == "graph":
        from repro.core.graph_model import build_graph_model
        return build_graph_model(cfg)
    return build(cfg)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_active_params_and_model_flops_equal_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    model = _reference_model(jcfg)
    assert roof.active_params(cfg) == jroof.active_params(jcfg, model)
    # every parameter of the definitions, as the reference counts them
    assert sum(math.prod(shape) * n
               for _, shape, n in roof.param_shapes(cfg)) \
        == model.n_params()
    for shape in SHAPES.values():
        mine = ShapeConfig(shape.name, shape.kind, shape.seq_len,
                           shape.global_batch)
        assert roof.model_flops(cfg, mine) == \
            jroof.model_flops(jcfg, model, shape), shape.name


def test_moe_counts_top_k_of_the_experts():
    """Kimi-K2: only ``moe_top_k / moe_experts`` of the expert stacks
    count, the router and the shared expert in full."""
    cfg = get_config("kimi_k2_1t_a32b")
    total = sum(math.prod(s) * n for _, s, n in roof.param_shapes(cfg))
    assert roof.active_params(cfg) < total / 10
    dense = cfg.replace(moe_top_k=cfg.moe_experts)
    tok = cfg.vocab_padded * cfg.d_model
    assert roof.active_params(dense) == total - tok


def test_roofline_terms_by_hand():
    """989 TFLOP over 989 TFLOP/s is 1 s; 6.7 TB over 3.35 TB/s 2 s; an
    all-reduce of 450 GB goes twice over 450 GB/s (2 s) and an
    all-gather of 900 GB once (2 s)."""
    t = roof.roofline_terms(989e12, 6.7e12, {"all-reduce": 450e9,
                                             "all-gather": 900e9})
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(4.0)
    assert t["dominant"] == "collective_s"
    assert t["step_lower_bound_s"] == pytest.approx(4.0)
    assert t["roofline_frac"] == pytest.approx(0.25)
    assert roof.roofline_terms(0.0, 0.0, {})["roofline_frac"] == 0.0
    assert roof.roofline_terms(1e12, 0.0, {})["dominant"] == "compute_s"


def test_no_definitions_for_an_unknown_family():
    with pytest.raises(ValueError, match="family"):
        roof.param_shapes(get_config("gt").replace(family="audio"))
