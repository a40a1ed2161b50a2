"""The arguments of the dry run's train cells at full size (the rank's
chunks of the state under `state_shardings` and of the batch), from shapes
only, against the reference's shard arithmetic from its specs."""
import pytest

from _torch_dryrun_cases import cells, reference_argument_bytes
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, make_production_mesh


@pytest.mark.parametrize("arch,shape_name,mesh_kind", cells(("train",)))
def test_train_argument_bytes_equal_reference_shards(monkeypatch, arch, shape_name,
                                                     mesh_kind):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    got = dryrun.argument_bytes(get_config(arch), SHAPES[shape_name], mesh)
    assert got == reference_argument_bytes(monkeypatch, arch, shape_name, mesh_kind)
