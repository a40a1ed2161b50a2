"""The partitioned train step (`repro_torch.parallel.partition`) as the dry
run counts it on fake worlds of CPU ranks (`launch.dryrun.run_cell`):
mistral's SMOKE config, whose heads, FFN and vocabulary the model ranks
divide.

- the model ranks split the work: one rank's dot FLOPs on a (data 2,
  model 2) world are at most 0.6 of a (data 2, model 1) world's;
- no rank holds the whole model: at 8 layers (remat on, as the published
  configs train) on a (data 4, model 4) world the rank's peak live bytes,
  its chunks of the state and their gradients included, stay under the
  whole model's f32 parameters, which a gather of every parameter would
  hold alone (on a (2, 2) world a rank's AdamW state and gradients are
  already that much);
- on a world of one rank the step is the single-device step: its dot
  FLOPs and transcendentals equal the census of `make_train_step`'s.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import Census
from repro_torch.models import build
from repro_torch.parallel import Mesh
from repro_torch.train import Schedule, init_state, make_optimizer, make_train_step

B, T = 8, 32
SPECS = {"tokens": ((B, T), torch.int32), "labels": ((B, T), torch.int32)}


def _cfg(n_layers: int = 2):
    return dataclasses.replace(get_config("mistral_nemo_12b", smoke=True), n_layers=n_layers,
                               remat=True)


def _cell(cfg, dims) -> dict:
    """The cell's record as rank 0 of a fake (data, model) world of CPU ranks."""
    mesh = Mesh((torch.device("cpu"),) * int(np.prod(dims)), ("data", "model"), dims)
    return dryrun.run_cell("mistral_nemo_12b", "t", "x".join(map(str, dims)), mesh=mesh,
                           shape=ShapeSpec("t", "train", T, B), cfg=cfg,
                           batch_specs=SPECS, device="cpu")


def test_model_ranks_split_the_dot_flops():
    cfg = _cfg()
    whole = _cell(cfg, (2, 1))["cost"]["flops"]
    split = _cell(cfg, (2, 2))["cost"]["flops"]
    assert 0 < split <= 0.6 * whole, (split, whole)


def test_no_rank_holds_the_whole_model():
    cfg = _cfg(8)
    n_params = sum(p.numel() for p in build(cfg).init(torch.Generator(),
                                                      train=True).parameters())
    rec = _cell(cfg, (4, 4))
    assert rec["memory"]["peak_bytes"] < 4 * n_params, (rec["memory"], 4 * n_params)


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "granite_moe_hash"])
def test_one_rank_world_counts_the_single_device_step(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=True)
    api = build(cfg)
    opt = make_optimizer(cfg.optimizer, Schedule())
    state = init_state(api, opt, torch.Generator().manual_seed(0))
    g = np.random.default_rng(5)
    batch = {k: torch.from_numpy(g.integers(0, cfg.vocab_size, s).astype(np.int32))
             for k, (s, _) in SPECS.items()}
    with Census((state, batch)) as c:
        make_train_step(api, opt)(state, batch)
    real = c.totals()
    mesh = Mesh((torch.device("cpu"),), ("data", "model"), (1, 1))
    dry = dryrun.run_cell(arch, "t", "1x1", mesh=mesh, shape=ShapeSpec("t", "train", T, B),
                          cfg=cfg, batch_specs=SPECS, device="cpu")["corrected"]
    for key in ("dot_flops_per_device", "transcendentals_per_device"):
        assert dry[key] == real[key] > 0, key
