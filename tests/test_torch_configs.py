"""The port's `repro_torch.configs` == the reference's `repro.configs`.

Every architecture id, every variant and every SMOKE config: the same
fields (`dataclasses.asdict`), the same analytic parameter counts (the
reference's formula, odd terms included), the same shape registry and
cells. Pure Python on both sides: exact equality.
"""
import dataclasses

import pytest

import repro.configs as J
import repro_torch.configs as T

IDS = list(J.ARCH_IDS) + sorted(J._VARIANTS)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", IDS)
def test_config_fields_and_counts_match(name, smoke):
    want, got = J.get_config(name, smoke=smoke), T.get_config(name, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == want.head_dim
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    for i in range(got.n_layers):
        assert got._layer_is_attention(i) == want._layer_is_attention(i)
        assert got._layer_is_moe(i) == want._layer_is_moe(i)
        assert got._layer_is_global_attn(i) == want._layer_is_global_attn(i)


def test_registry_matches():
    assert T.ARCH_IDS == J.ARCH_IDS
    assert T.list_configs() == J.list_configs()
    assert T._VARIANTS == J._VARIANTS
    assert {k: dataclasses.asdict(v) for k, v in T.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J.SHAPES.items()}
    assert T.cells() == J.cells()
    assert T.cells(include_skipped=True) == J.cells(include_skipped=True)


def test_field_defaults_match():
    fields = {f.name: f.default for f in dataclasses.fields(J.ArchConfig)}
    assert {f.name: f.default for f in dataclasses.fields(T.ArchConfig)} == fields


def test_unknown_name_raises_like_the_reference():
    with pytest.raises(ModuleNotFoundError):
        J.get_config("no_such_arch")
    with pytest.raises(ModuleNotFoundError):
        T.get_config("no_such_arch")
