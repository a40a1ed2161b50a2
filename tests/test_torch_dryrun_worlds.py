"""The dry run's fake world against a real one, and its CLI.

A cell's per-rank counts from rank 0 of a fake world
(`repro_torch.parallel.fake_world`, fake tensors) equal, exactly, those the
census reads around the same cell run by rank 0 of a threaded world of
the same shape (`parallel.local_world`, real tensors): dot FLOPs,
transcendentals, collective counts, result bytes and bytes sent. The
census's argument bytes equal `dryrun.argument_bytes` (shapes only). The
fake world is torn down after each cell. Smoke configs.
"""
import json
import os

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.parallel import Mesh, local_world
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.fake_world import fake_world

CPU = torch.device("cpu")
CASES = {
    "train_mistral_2x2": ("mistral_nemo_12b", ShapeSpec("t", "train", 16, 8),
                          (2, 2), ("data", "model")),
    "train_granite_hash_2x2x2": ("granite_moe_hash", ShapeSpec("t", "train", 16, 8),
                                 (2, 2, 2), ("pod", "data", "model")),
    "decode_granite_hash_2x2": ("granite_moe_hash", ShapeSpec("d", "decode", 32, 4),
                                (2, 2), ("data", "model")),
}


def _same(a: dict, b: dict) -> None:
    for key in ("dot_flops_per_device", "transcendentals_per_device"):
        assert a["corrected"][key] == b["corrected"][key], key
    assert a["collectives"] == b["collectives"]
    assert a["memory"]["argument_bytes"] == b["memory"]["argument_bytes"]


@pytest.mark.parametrize("case", list(CASES))
def test_fake_world_counts_equal_a_real_world(case):
    arch, shape, dims, names = CASES[case]
    cfg = get_config(arch, smoke=True)
    mesh = Mesh((CPU,) * (dims[0] * dims[1] * (dims[2] if len(dims) > 2 else 1)),
                names, dims)
    fake = dryrun.run_cell(arch, shape.name, "w", mesh=mesh, shape=shape, cfg=cfg,
                           device="cpu")
    assert not dist.is_initialized()  # the fake world is torn down
    assert getattr(sh._STATE, "device_meshes", {}) == {}
    assert fake["collectives"]["total_count"] > 0
    assert fake["memory"]["argument_bytes"] == dryrun.argument_bytes(cfg, shape, mesh)
    real = local_world.run(lambda r: dryrun.run_cell(
        arch, shape.name, "w", mesh=mesh, shape=shape, cfg=cfg, fake=False), mesh)
    _same(fake, real[0])
    assert fake["cost"]["flops"] == fake["corrected"]["dot_flops_per_device"]


def test_fake_world_refuses_a_live_group_and_cleans_up():
    mesh = Mesh((CPU,) * 4, ("data", "model"), (2, 2))
    with fake_world(mesh) as dm:
        assert dist.get_world_size() == 4 and dm.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError, match="live"):
            with fake_world(mesh):
                pass
    assert not dist.is_initialized()


def test_cli_writes_records_skips_and_fails(tmp_path):
    out = str(tmp_path)
    argv = ["--arch", "rwkv6_1_6b", "--shape", "long_500k", "--mesh", "single",
            "--out", out, "--device", "cpu"]
    assert dryrun.main(argv) == 0
    rec = json.loads((tmp_path / "rwkv6_1_6b__long_500k__single.json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    # what benchmarks/roofline.py reads
    assert rec["corrected"]["dot_flops_per_device"] == rec["cost"]["flops"] > 0
    assert rec["corrected"]["collective_bytes_per_device"] >= 0
    assert rec["memory"]["temp_bytes"] > 0 and rec["memory"]["argument_bytes"] > 0
    assert set(rec["collectives"]) >= {"all-gather", "all-reduce", "reduce-scatter",
                                       "all-to-all", "collective-permute",
                                       "total_bytes", "total_count", "traffic"}
    mtime = os.path.getmtime(tmp_path / "rwkv6_1_6b__long_500k__single.json")
    assert dryrun.main(argv) == 0  # an existing file is skipped
    assert os.path.getmtime(tmp_path / "rwkv6_1_6b__long_500k__single.json") == mtime
    assert dryrun.main(["--arch", "mistral_nemo_12b", "--shape", "long_500k",
                        "--mesh", "single", "--out", out, "--device", "cpu"]) == 0
    skip = json.loads((tmp_path / "mistral_nemo_12b__long_500k__single.json").read_text())
    assert skip["status"] == "skipped" and skip["reason"]
    assert dryrun.main(["--arch", "no_such_arch", "--shape", "decode_32k", "--mesh",
                        "single", "--out", out, "--device", "cpu"]) == 1
    err = json.loads((tmp_path / "no_such_arch__decode_32k__single.json").read_text())
    assert err["status"] == "error" and err["error"]
