#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path -- keys -> `Hasher` -> fused K-hash CUDA kernels
-> Bloom/dedup admission -- and the single-hash path -- `multilinear_hash`
/ `gf_hash` -> single-hash CUDA kernels, and the streaming fingerprints on
top of them -- at a deployment's scale and checks every result:

1. device: the card's name and power limit; nvcc builds the four kernels
   from the sources in this checkout (timed, with ptxas' registers and
   spills -- a spill in an engine kernel or the carry-less single-hash
   kernel fails the run -- and each engine launch's dynamic shared
   memory); the b1 mma rate that the carry-less single-hash design floor
   uses, measured by a loop of the instruction alone;
2. kernels vs plain versions: every engine family, fixed and ragged rows
   (L = 0, odd L, L just before, at and after the 32-column tile and the
   column-split edges), N in {300, 1,100} (one column split; four, with the
   second pass), K in {1, 3, 9, 20}, mod_m in {none, 1, 2^20, 4097,
   2^32-1}: `torch.equal` with the plain PyTorch version on the card, and
   equality with the numpy host twin on a row subsample (an oracle that
   needs neither the kernels nor JAX);
3. pure path at full width: B = 65,536 x N = 1,024 u32 tokens on the card,
   `Hasher(K=9, out_bits=64)`: `__call__`, `probe_indices(m)` for the m of
   the Bloom filter below, `shard_ids(64)`, for multilinear and
   gf_multilinear, one kernel launch per call;
4. admission: `BloomFilter(n_items=10**8, fp_rate=1e-3)` (m ~ 1.44e9 bits,
   k = 9) for multilinear and gf_multilinear, `ExactDedup` and
   `HashPipeline.admit_batch`, over 32 batches of 8,192 documents of 64-2,048
   tokens (vocabulary 50,000) with 10 % planted exact repeats: one launch per
   batch, every planted repeat rejected, the admitted count plausible;
6. single-hash path, every family through `multilinear_hash`/`gf_hash`,
   each result equal to the entry point's plain version on the card
   (`torch.equal`) and to the numpy twins on a row subsample:
   a. many strings: B = 65,536 x N = 1,024, keys from one key buffer of
      N + 1 u64 (256-row subsample);
   b. long strings: B = 64 x N = 1,048,576 (4 MiB per row, an 8 MiB key
      buffer), plus both HM families at odd N = 1,048,575 (16-row
      subsample: the numpy carry-less twin takes seconds per million
      tokens);
   c. streaming: `Hasher(multilinear)` with chunk_words 1,024 and
      max_chunks 4,096 absorbs a 4,194,304-token stream on the card in 64
      updates of 65,536 tokens and again in uneven blocks (1, 1,023, 1,025,
      rest); both digests equal each other, `stream_digest_host` (numpy)
      and the digest of the same stream on the CPU, and each update that
      completes chunks makes exactly one kernel launch;
5. measurements: phase 3's Hasher outputs against the plain version and
   each surface's time; each kernel's time (`ms`: CUDA events around 20
   warm wrapper calls launched from Python, so a short kernel's time
   includes the host's launch gap; `graph_ms`: the same 20 calls captured
   in a CUDA graph and replayed, device time without that gap) beside its
   bound and its plain version's time, at the shapes of phases 3, 4 (the
   integer engine at K 9, and at K 1 and 3 as ExactDedup and HashPipeline
   launch it), 6a and 6b (the carry-less single-hash kernel in both its
   modes: the raw accumulator, and the finished hash with m1 and Barrett
   that `gf_hash` launches), and the single-hash entry points' times at
   6a, with the device operations of one `gf_hash` call (torch.profiler;
   more than 8 fails the run). The carry-less rows also give their
   design's own floor. The rows with per-row lengths (the admission batch,
   and a docs batch of B 65,536 x W 2,050 with Dolma-like lengths) run as
   the Hasher runs them, in length order (csrc/engine_tile.cuh's ordering
   kernel, then the tile kernel), and the docs batch again unordered; each
   gives the engine's lane-per-row work over the live work (each warp
   hashes to its longest row), the call's device operations and the
   ordering and tile kernels' device times (torch.profiler), and these are
   in the `kernels` line.

7. tree fingerprints and checkpoints (`hash.tree`, `checkpoint`), a path of
   its own after phase 5, on the engine kernels at the tree-leaf shape (K 1,
   64-bit surface, fixed length, 256-word leaves):
   a. a seeded 1 GiB int32 tensor on the card (2^20 leaves), `TreeSpec()`:
      `fingerprint_array` of the card tensor == `fingerprint_bytes` of the
      same bytes staged from the host; `fingerprint` == `digest_tokens`
      (0-d `n_tokens` on the card) == a `TreeStream` fed the host words in
      97 uneven updates (the token count is their tag, the byte count that
      of the byte surfaces); the leaf launch == its plain version at full
      size; a 64 MiB prefix's root == the numpy twin `digest_host`. Again
      at 256 MiB for `gf_multilinear` (kernel 2; 16 MiB prefix) and
      `multilinear_hm`. Times: the card-resident and the host-staged
      fingerprint, the stream, the leaf kernel (`ms`, `graph_ms`, bound,
      plain) and the fold (`ms`, `graph_ms`, device operations);
   b. `Checkpointer` (keep=2) over a ~512 MiB state on the card (f32, bf16,
      int32, an OrderedDict state_dict, an odd-length uint8 leaf): 3 saves,
      `verify` uncached, `latest_valid` cached, `restore` (== the state);
      a flipped byte of arrays.npz fails `verify` and `restore` raises
      `CorruptCheckpointError`; an array rewritten in a clean zip fails its
      fingerprint. MB/s of each;
   c. `ExactDedup.add_documents` over 256 documents of 64-2,048 words and
      8 of 2^20 words (tree route) with repeats at both lengths: the mask
      equals the same routing on host fingerprints.

8. sharded admission (`hash.distributed`, `hash.service`, `hash.faults`),
   a path of its own after phase 7, on D logical shards of the card
   (`parallel.data_mesh(device=, n_shards=D)`, D in {1, 4}):
   a. `ShardedHasher` at phase 3's pure shape: `__call__`,
      `probe_indices(m)` and `shard_ids(64)` == phase 3's single-device
      outputs, for multilinear and gf_multilinear;
   b. `DeviceShardedBloom(n_items=10**8, fp_rate=1e-3)` (1.44 GB of bit
      bytes, k 9) over the first 8 of phase 4's batches: D in {1, 4} x the
      routed, all_gather and host transports (multilinear), gf_multilinear
      routed at D 4, and a routed D 4 filter that overflows its buckets
      (capacity_factor 0.5, slack 0; it must fall back), one at a time:
      each `check_and_add_batch` verdict == the negation of a host
      `BloomFilter`'s pre-batch `contains_batch`, every planted repeat of
      an earlier batch rejected, the final words (packed on the card) ==
      the host filter's bits. The launch part of a routed add and
      contains runs under `torch.cuda.set_sync_debug_mode("error")`.
      docs/s and bytes moved a call for each; then, for routed D 4, the
      staging time, the launch part's time and the card's busy share
      (torch.profiler);
   c. `AdmissionService.over_bloom_shards(4, 10**8, mesh=<4 logical
      shards>)` over 4 batches: fault-free twice, and twice under one
      seeded `FaultPlan` (shard 1 down for its calls 1-3, timeouts,
      corrupt replies; fail_open); after `reconcile_all()` every shard
      filter's words == the fault-free run's, and the two faulty runs
      give identical events and stats;
   d. `TreeHasher(mesh=)` over phase 7a's 256 MiB carry-less words ==
      phase 7a's root; `ExactDedup(mesh=, approx_items=10**7)` == the
      unsharded fingerprints and a host filter over the same 2-word keys;
      `HashPipeline(mesh=, admission=8c's service)` == the unsharded
      pipeline over the fault-free twin.

The launch counts are set to 0 before phase 3 and read after phase 6: that
run is the main path (99 engine launches of multihash, 35 of gf_multihash;
printed per phase). Launches made to compare or to time come after. They
are set to 0 again before phase 7, whose every call is checked for its
exact engine launches: one per `fingerprint*`/`digest_tokens` call and
per `TreeStream` flush, one per checkpoint leaf array plus one per path
and one per root, one for the short documents' batch and one per long
document; and again before phase 8, whose every call is checked for its
exact engine launches too: D per sharded call (2D for a routed call that
falls back), one per unsharded call, and for a service call one for the
router, one for the L1 check, one L1 add a shard group and D per shard
filter call; and again before phase 9, whose probe-path calls are each
checked for their exact engine launches (one per `probe_indices` call, D
per sharded call) and whose battery must make exactly its probe path's
launches (the adapters and metrics are PyTorch operations); and again
before phase 10 and before phase 11, whose serving runs must make exactly
their predicted `multihash` launches and no other kernel's (the models are
PyTorch operations). Any failed
check exits non-zero. The last line is the JSON device record.

9. the quality battery (`quality`, `core.baselines`, `core.gf`), a path of
   its own after phase 8, at the committed report's sizes (seed 0x5AC1,
   N 4, 2^21 keys, 2^16 avalanche keys):
   a. every battery family and control on 4,096 rows of keygen's Threefry
      streams: streams and adapter outputs on the card == on the CPU;
      `core.baselines` (rabin_karp, sax, fnv1a, nh, Zobrist) and the
      whole-string `core.gf` hashes on the card == Python-int oracles on a
      64-row subsample;
   b. the battery's probe path (`Hasher.probe_indices`, K 2, 64-bit,
      fixed length, B 2^21 x N 4, m in {3, 4097, 2^32-1}) for multilinear
      and gf_multilinear: each call == its plain version, one launch a
      call; the `ShardedHasher` twin == it, D launches a call;
   c. `run_battery` on the card: `compare_reports(QUALITY.json, report,
      verdicts_only=False) == []`, both controls flagged, every shipped
      family passing; seconds per family and in all, beside the card's name
      and power limit (the report is written beside chip_smoke.json).

10. serving the dense-attention models (`configs`, `models`, `serve`), a
    path of its own after phase 9 (counts set to 0 again; every
    `submit_all` checked for its exact engine launches):
    a. parity at full width: `mistral_nemo_12b` with n_layers cut to 2
       (d_model 5,120, d_ff 14,336, vocab 131,072), float32 with TF32 off,
       one seeded set of weights on the card and its copy on the CPU:
       prefill logits of a (2, 33) batch, the next decode step's logits and
       `lm_loss` on the card == on the CPU, and prefill(32) + decode(1) ==
       the full forward's last logits on the card, each within rtol = atol =
       2e-3;
    b. `mistral_nemo_12b` as published (40 layers, bf16, 12.25e9 parameters
       drawn on the card) served by `ServeEngine(n_slots=8, max_seq=2048,
       tree_prompt_words=512)` over 32 requests (28 prompts of 64-1,500
       tokens, 4 exact repeats, 32 new tokens each), without admission and
       with `admission_items=10**6`: every admitted request done with its 32
       tokens, 4 prefix hits without admission and 4 rejections with it,
       prompts of >= 512 tokens on the tree route, every prompt key the
       engine computed == its host twin (the tree's `digest_host`; the
       prefix hasher's numpy path for the short prompts' launch), with
       admission the verdicts and both filters' final words == host
       `BloomFilter`s (hashing on the CPU) given the same waves, the engine
       launches equal to the prediction (`serve_launches`), and the first
       wave's greedy tokens == a manual prefill + decode_step loop. Times: prefill
       by prompt length (64, 512, 1,500), a decode tick at batch 8 beside
       the bytes of weights it must read (as in 11b), tokens/s and
       requests/s of each run, peak memory, the device idle share of a
       decode tick and of each prefill (torch.profiler), and kernel 1 at the
       prefix-key shape beside its bound and its plain version. 10b and each
       of 11b's LMs run through one function, `serve_family`.

11. serving the MoE, state-space and encoder-decoder models (`models/moe.py`
    with the hash router, `models/ssm.py`, `models/encdec.py`), a path of
    its own after phase 10 (counts set to 0 again; every `submit_all`
    checked for its exact engine launches, 104 in all):
    a. parity in float32 with TF32 off, one seeded set of weights on the
       card and its copy on the CPU, within rtol = atol = 2e-3: prefill
       logits of a (2, 33) batch, the next decode step and the loss card ==
       CPU, and on the card prefill(32) + decode(1) == the full forward's
       last logits (MoE at the reference's own capacity_factor 8 for that
       check, so no token drops in either). Cuts, so that the CPU twin
       fits: `granite_moe_hash` and `granite_moe_1b_a400m` n_layers 24 -> 2,
       `rwkv6_1_6b` 24 -> 2, `whisper_large_v3` 32 + 32 -> 2 + 2 layers over
       (2, 1,500, 1,280) frames, each at full width; jamba's Mamba
       sublayer alone at its published width (d_model 4,096, d_inner 8,192,
       d_state 16; output, conv tail, state, and 32 + 1 tokens == 33); and
       `jamba_smoke` and `llama4_smoke` whole (a CPU twin of jamba or llama4
       at full width would need 53 GB and 74 GB of f32);
    b. serving in bf16 at published widths, weights drawn on the card, each
       model freed before the next: `ServeEngine(n_slots=8, max_seq=2048,
       tree_prompt_words=512)` over 16 requests (14 prompts of 64-1,500
       tokens, 2 exact repeats of first-wave prompts, 16 new tokens each)
       for `granite_moe_hash` as published (24 layers, 32 experts top-8,
       the hash router; without and with `admission_items=10**6`),
       `granite_moe_1b_a400m` (the learned router) and `rwkv6_1_6b` as
       published, `jamba_v0_1_52b` at full width with n_layers 32 -> 8 (one
       block period: 7 Mamba, 1 attention, 4 MoE layers; 104 GB as
       published does not fit one card) and `llama4_maverick_400b_a17b` at
       full width with n_layers 48 -> 2 (one dense and one MoE layer of 128
       experts with the shared expert), each with phase 10b's checks
       (`serve_runs`, `manual_wave`); `whisper_large_v3` as published
       through its model API (the engine needs `init_caches`, which an
       enc-dec refuses, as the reference's does): encode (8, 1,500, 1,280)
       frames, prefill 4 tokens, 32 greedy decode steps. Times: prefill by
       length (64, 512, 1,500), a decode tick at batch 8 beside the bytes
       of weights it must read over 3.35 TB/s (an untied embedding: 8 rows;
       an MoE layer: the min(E, 8 k) experts 8 tokens can reach), tokens/s,
       peak memory above what earlier phases hold (10b's model is freed
       first), a tick's device operations and idle share
       (torch.profiler), whisper's encoder.

12. training (`train/`, the backward passes of `models/`), a path of its
    own after phase 11 (counts set to 0 again; every kernel-1 launch, the
    trainer checkpoints' leaf fingerprints, predicted and checked):
    a. parity in float32 with TF32 off: one train step on the card == the
       same step on the CPU from the same state and batch, for
       `granite_moe_hash` at full width with n_layers 24 -> 2 (AdamW) and
       `llama4_smoke` whole (adafactor): the loss, the largest gradient
       error of every leaf (relative to its largest magnitude) and the
       parameters after the step, each printed beside its bound; every
       parameter element that moved apart past 1e-5 must have its cause
       (gradients of opposite signs, or a clipped gradient within AdamW's
       eps of 0: `moved_apart`);
    b. `granite_moe_hash` as published (24 layers, 1.335e9 parameters,
       bf16 compute, f32 masters, AdamW, remat as the config sets it) on
       batches of 8 x 1,024 tokens packed by `HashPipeline` from
       `data.synthetic.corpus` (vocabulary 49,155): `make_train_step`, 2
       warm-up and 5 timed steps; ms a step, tokens/s, peak memory, a
       step's device operations and idle share (torch.profiler), the first
       and last loss (finite; the first near ln 49,155), and a step's bound
       (the larger of its FLOPs over 989 TFLOP/s and its bytes over
       3.35 TB/s), and beside it the bound of the least work (no
       recompute, the routed expert rows only, the causal half);
    c. the `Trainer` at full width with n_layers 24 -> 2: 12 steps,
       `checkpoint_every=4`, a `SimulatedFault` at step 6 (it resumes from
       step 4 and completes), the last checkpoint restored equal to the
       final state, the kernel-1 launches of its saves, verifies and
       restores equal to the prediction, every fingerprint of the final
       checkpoint recomputed without the kernel (each leaf's by the
       engine's plain version on the card, the paths' and the root by
       `digest_host`), then `ServeEngine` serves 4 requests from the
       trained parameters.
13. sharding (`parallel/sharding.py`, `launch/mesh.py`, the sharded step
    and restore), a path of its own after phase 12 (counts set to 0
    again; every kernel-1 launch predicted and checked):
    a. the rules at full size: every architecture at (16, 16) and
       (2, 16, 16), training and serving, from shapes only (fake
       tensors): the leaves sharded and the bytes a rank holds;
    b. `jit_train_step` (the partitioned program: tensor parallelism over
       "model", one block gathered at a time) on a world of 8 threaded
       ranks on the card (`parallel.local_world`), shaped (pod 2, data 2,
       model 2): `granite_moe_hash` at full width with n_layers 24 -> 2 in
       f32 (TF32 off) on 3 HashPipeline batches of 8 x 1,024 tokens, with
       `fsdp_pods` on and off, 2 steps of it with `grad_accum` 2 (two
       microbatches of the global batch), and 1 step of `llama4_smoke`
       under adafactor (fsdp_pods on): after every step every rank's
       chunks, the loss and the gradient norm against the single-device
       step (`moe_groups` 4, the same `grad_accum`) within 12a's bounds; ms
       a step of the world and the bytes each collective sent;
    c. `Checkpointer.restore(mesh=)` of 12c's last checkpoint onto the
       world: every rank's chunks == its slices of the single-device
       restore, kernel-1 launches == the prediction;
    d. `hierarchical_psum` of integer-valued f32 on the world == the plain
       sum, exactly.
14. the dry run (`launch/dryrun.py`, `launch/op_analysis.py`,
    `parallel/fake_world.py`, `serve/sharded.py`), a path of its own after
    phase 13 (counts set to 0 again; it launches no kernel):
    a. 12b's cell under the op census around one real step on the card,
       then through the dry run on a fake world of one rank: dot FLOPs
       and transcendentals equal exactly, the dry run's peak within 10 %
       of the card's `max_memory_allocated` over the step;
    b. 13b's cell on a fake (2, 2, 2) world: the bytes rank 0 sends
       (printed), and its collectives equal the census of one real step
       of the same cell on 8 threaded ranks on the card;
    c. sharded serving (each rank's chunks of the weights at the serving
       rules and of the caches at `cache_shardings`, the models' prefill
       and decode on its `ServingPartition`) on a threaded (data 2, model
       2) world on the card: a 512-token prefill and 8 ticks of
       mistral_nemo_12b and granite_moe_hash (2 layers) and gemma3_27b (6
       layers, B 1: the long-context layout) == the single-device port
       within 2e-3 in f32; the census of a prefill and a decode cell on
       that world == the dry run's on a fake world of its shape;
    d. `python -m repro_torch.launch.dryrun` in subprocesses on production
       cells of each shape kind, both meshes, and a skipped cell: no
       `error` record;
    e. sequence-parallel prefill at length: mistral_nemo_12b at its
       published width (2 layers, f32), B 2 x 32,768 tokens on a threaded
       (data 1, model 4) world == the single-device port's prefill within
       2e-3; each rank's share of the card's `max_memory_allocated` over
       the world's prefill == the dry run's peak a rank of the same cell
       within 10 %.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0x5EED
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit):
# memory 3.35 TB/s; 32-bit integer instructions 64 lanes/SM x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
# Rows the engine's row order sorts on their own (csrc/engine_tile.cuh EO_SEG).
ORDER_SEG = 65536
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# shared memory: 128 bytes a clock on each SM (32 banks of 4 bytes).
SMEM_BYTES_PER_S = 128 * 132 * 1.98e9
# The carry-less engine's window-table product (csrc/gf_multihash.cu), for
# its design floor: 7 Horner steps of a 64-bit shift (2 operations) and a
# 64-bit xor (2), and the xor into the sum (2): 30 integer operations and 8
# table reads of 8 bytes a product; a token's 8 nibble offsets (2 operations
# each) serve its K products.
GF_TABLE_OPS, GF_NIBBLE_OPS, GF_TABLE_BYTES = 30, 16, 64
# The carry-less single-hash kernel's HM pair product (csrc/gf_single.cuh::
# bmul_acc), for its design floor: 2 xors of key and token, 8 ands that
# split the factors into bit classes, 16 32x32 -> 64-bit multiplies and 16
# three-input xors of the 64-bit products into the 4 class sums.
BMUL_PAIR_OPS = 42
# The b1 mma rate of an A100 (4,992 dense INT1 TOPS: one m16n8k256 product,
# 65,536 operations, every 2 clocks an SM) carried to 132 SMs at 1.98 GHz:
# printed beside the rate that phase 1 measures, which the floor uses.
B1_MMA_PER_S_A100_LIKE = 132 * 1.98e9 / 2
FAMILIES = ("multilinear", "multilinear_2x2", "multilinear_hm",
            "gf_multilinear", "gf_multilinear_hm")
KERNELS = {
    "multihash": ("src/repro_torch/kernels/csrc/multihash.cu",
                  "src/repro/kernels/multihash.py:69"),
    "gf_multihash": ("src/repro_torch/kernels/csrc/gf_multihash.cu",
                     "src/repro/kernels/gf_multihash.py:84"),
    "multilinear": ("src/repro_torch/kernels/csrc/multilinear.cu",
                    "src/repro/kernels/multilinear.py:72"),
    "gf_multilinear": ("src/repro_torch/kernels/csrc/gf_multilinear.cu",
                       "src/repro/kernels/gf_multilinear.py:40"),
}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase(name: str):
    """Context manager printing a phase's wall time."""
    class _Phase:
        def __enter__(self):
            print(f"== {name}", flush=True)
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"== {name}: {time.perf_counter() - self.t0:.3f} s wall",
                      flush=True)
    return _Phase()


class Port:
    """The port's modules, imported once the card is known to exist."""

    def __init__(self):
        sys.path.insert(0, str(ROOT / "src"))
        import torch

        from repro_torch.checkpoint import Checkpointer, CorruptCheckpointError
        from repro_torch.core import gf, hostref, keys, limbs
        from repro_torch.core.pytree import flatten_with_paths
        from repro_torch.data import BloomFilter, ExactDedup, HashPipeline, PipelineConfig
        from repro_torch.hash import (AdmissionService, DeviceShardedBloom,
                                      FaultEvent, FaultPlan, FaultyTransport,
                                      Hasher, HashSpec, ProbeTransport,
                                      TreeHasher, TreeSpec, streaming)
        from repro_torch.kernels import _build, autotune, ops, ref
        from repro_torch.kernels import gf_multihash as gfmh
        from repro_torch.kernels import gf_multilinear as gfk
        from repro_torch.kernels import multihash as mhk
        from repro_torch.kernels import multilinear as mlk
        from repro_torch.parallel import data_mesh
        from repro_torch import quality, tracing
        from repro_torch.configs import get_config
        from repro_torch.core import baselines
        from repro_torch.models import build, encdec, ssm, transformer
        from repro_torch.serve import Request, ServeEngine
        from repro_torch import train
        from repro_torch.data.synthetic import corpus
        import torch.distributed as dist
        from repro_torch.configs import list_configs
        from repro_torch.launch import make_production_mesh
        from repro_torch.models.convert import nested
        from repro_torch.parallel import Mesh, collectives, local_world
        from repro_torch.parallel import sharding
        from repro_torch.configs import ShapeSpec
        from repro_torch.launch import dryrun, op_analysis
        from repro_torch.serve import sharded as serve_sharded

        self.torch, self.hostref, self.limbs = torch, hostref, limbs
        self.gf, self.keys, self.streaming = gf, keys, streaming
        self.flatten = flatten_with_paths
        self.BloomFilter, self.ExactDedup = BloomFilter, ExactDedup
        self.HashPipeline, self.PipelineConfig = HashPipeline, PipelineConfig
        self.Hasher, self.HashSpec = Hasher, HashSpec
        self.TreeHasher, self.TreeSpec = TreeHasher, TreeSpec
        self.Checkpointer, self.CorruptCheckpointError = (Checkpointer,
                                                          CorruptCheckpointError)
        self.build, self.ops, self.ref = _build, ops, ref
        self.autotune = autotune
        self.data_mesh, self.DeviceShardedBloom = data_mesh, DeviceShardedBloom
        self.ProbeTransport, self.AdmissionService = ProbeTransport, AdmissionService
        self.FaultEvent, self.FaultPlan = FaultEvent, FaultPlan
        self.FaultyTransport = FaultyTransport
        self.quality, self.baselines = quality, baselines
        self.tracing = tracing
        self.get_config, self.build_model = get_config, build
        self.transformer, self.Request, self.ServeEngine = (transformer, Request,
                                                            ServeEngine)
        self.encdec, self.ssm = encdec, ssm
        self.train, self.corpus = train, corpus
        self.dist, self.list_configs, self.nested = dist, list_configs, nested
        self.make_production_mesh, self.Mesh = make_production_mesh, Mesh
        self.collectives, self.local_world, self.sharding = (collectives, local_world,
                                                             sharding)
        self.ShapeSpec, self.dryrun, self.op_analysis = ShapeSpec, dryrun, op_analysis
        self.serve_sharded = serve_sharded
        self.tally = 0  # engine launches `launched` has checked
        self.wrappers = {"multihash": mhk, "gf_multihash": gfmh,
                         "multilinear": mlk, "gf_multilinear": gfk}
        self.single = {"multilinear": mlk.hash_blocks,
                       "gf_multilinear": gfk.gf_hash_blocks}

    def kernel_of(self, family: str) -> str:
        return "gf_multihash" if family.startswith("gf_") else "multihash"

    def single_of(self, family: str) -> str:
        return "gf_multilinear" if family.startswith("gf_") else "multilinear"

    def counts(self) -> dict:
        return {k: m.launch_count() for k, m in self.wrappers.items()}

    def reset_counts(self) -> None:
        for m in self.wrappers.values():
            m.reset_count()

    def plain(self, family, *args, **kw):
        fn = (self.ref.gf_multihash_ref if family.startswith("gf_")
              else self.ref.multihash_ref)
        return fn(*args, family=family, **kw)

    def plain_single(self, family, toks, keys):
        """Single-hash kernel's plain version; keys (N,) int64 u64 bits
        (the carry-less families take their low 32 bits)."""
        if family.startswith("gf_"):
            return self.ref.gf_accumulate_ref(toks, keys.to(self.torch.int32),
                                              family=family)
        return self.ref.multilinear_accumulate_ref(toks, keys, family=family)

    def plain_hash(self, family, toks, keys):
        """Plain version of multilinear_hash / gf_hash (and of the
        carry-less kernel's finish mode): keys (N+1,) int64 u64 bits, key 0
        is m1."""
        if family.startswith("gf_"):
            k32 = keys.to(self.torch.int32)
            return self.ref.gf_hash_ref(toks, k32[1:], k32[0], family=family)
        acc = self.plain_single(family, toks, keys[1:])
        return self.limbs.hi32(((acc[:, 0] << 32) | acc[:, 1]) + keys[0])


def one_launch(port: Port, family: str, fn, kernel: str | None = None):
    """Run fn(); require exactly one launch on the card of `kernel` -- by
    default the family's engine kernel, which also makes one engine
    dispatch -- and none of any other kernel."""
    engine = kernel is None
    kernel = port.kernel_of(family) if engine else kernel
    c0, d0 = port.counts(), port.ops.launch_count()
    out = fn()
    c1 = port.counts()
    want = dict(c0)
    if port.torch.cuda.is_available():
        want[kernel] += 1
    check(c1 == want and port.ops.launch_count() == d0 + engine,
          f"{family}: expected one {kernel} launch, counts {c0} -> {c1}")
    return out


def timed(port: Port, fn, repeats: int) -> float:
    """Mean milliseconds of fn() over warm repeats (CUDA events)."""
    torch = port.torch
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def timed_graph(port: Port, fn, repeats: int) -> float:
    """Mean device milliseconds of fn() over `repeats` calls captured in one
    CUDA graph and replayed (so a short kernel is not timed by the host's
    launch rate)."""
    torch = port.torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def live_work(lens, N: int) -> tuple[int, int]:
    """(tokens the kernel loads, columns it hashes), summed over the rows.
    A row of code L >= 0 loads its L tokens and hashes L + 1 columns (the
    sentinel is made, not loaded); a row of code < 0 loads and hashes
    lm = -code - 1. No row loads past the N columns it has."""
    lens = np.asarray(lens, np.int64)
    lm = np.where(lens >= 0, lens, -lens - 1)
    return int(np.minimum(lm, N).sum()), int((lm + (lens >= 0)).sum())


def lane_work(lens, W: int, ordered: bool = False) -> float:
    """Columns the engine hashes with one row per lane (each warp of 32 rows
    runs to its longest row's kend) over the live ones. A warp's rows are 32
    consecutive rows, or in a call whose rows run in length order
    (`ordered`), 32 consecutive places of each segment of ORDER_SEG rows
    sorted by kend, longest first."""
    lens = np.asarray(lens, np.int64)
    lm = np.where(lens >= 0, lens, -lens - 1)
    end = lm + (lens >= 0)
    kend = np.minimum(end + (end & 1), W)
    if ordered:
        kend = np.concatenate([-np.sort(-kend[i:i + ORDER_SEG])
                               for i in range(0, len(kend), ORDER_SEG)])
    pad = -len(kend) % 32
    warps = np.concatenate([kend, np.zeros(pad, np.int64)]).reshape(-1, 32)
    return float(32 * warps.max(axis=1).sum() / max(1, int(end.sum())))


def bound(kernel: str, B: int, N: int, W: int, K: int,
          lens) -> tuple[float, str]:
    """Least time (ms) for the work on the card, whatever the kernel's
    design: the larger of the bytes the call must move (the live tokens of
    `live_work`, keys and codes read once; slots written once) over the
    memory rate, and, for the integer kernel, its operations: 2 32-bit
    operations per hashed column and function (one 64x32-bit multiply-add)
    over the instruction rate (its tensor-core path moves the products to u8
    MACs; at the main path's shapes the bytes bound is the larger either
    way). A carry-less product has no instruction on the card and no
    operation count that holds for every way of computing it, so the
    carry-less kernel's bound is its bytes; `design_floor` gives the floor
    of its own design."""
    loaded, hashed = live_work(lens, N)
    nbytes = loaded * 4 + K * (W + 1) * 8 + B * 4 + B * K * 2 * 8
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 0.0 if kernel == "gf_multihash" else 2 * hashed * K / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def probe_bound(kernel: str, B: int, N: int, K: int, lens) -> tuple[float, str]:
    """Least time (ms) of a fixed-length `Hasher.probe_indices` call: the
    bytes the probe function needs -- the live tokens of `live_work` and the
    K (N+1) keys (8 bytes, 4 for the carry-less families) read once, and K
    u32 residues a row (each < m <= 2^32 - 1) written once; no length codes
    at fixed length -- over the memory rate, and for the integer kernel the
    operations of `bound`."""
    loaded, hashed = live_work(lens, N)
    gf = kernel == "gf_multihash"
    nbytes = loaded * 4 + K * (N + 1) * (4 if gf else 8) + B * K * 4
    return _least_ms(nbytes, 0 if gf else 2 * hashed * K)


def design_floor(B: int, N: int, W: int, K: int, lens,
                 bytes_ms: float | None = None) -> tuple[float, str]:
    """Least time (ms) of the carry-less engine's plain families in their
    own design, the 4-bit window table (csrc/gf_multihash.cu): the largest
    of the bytes bound (`bound`'s, or `bytes_ms` where given), its integer
    operations (GF_TABLE_OPS a product, GF_NIBBLE_OPS a column) over the
    instruction rate ("operations") and its table reads (GF_TABLE_BYTES a
    product) over the shared-memory rate ("shared memory"). Not a bound on
    the function: another product form could go below it."""
    hashed = live_work(lens, N)[1]
    if bytes_ms is None:
        bytes_ms = bound("gf_multihash", B, N, W, K, lens)[0]
    t = {"bytes": bytes_ms / 1e3,
         "operations": (GF_TABLE_OPS * K + GF_NIBBLE_OPS) * hashed / INT32_OPS_PER_S,
         "shared memory": GF_TABLE_BYTES * K * hashed / SMEM_BYTES_PER_S}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def single_bound(family: str, B: int, N: int, port: Port,
                 finish: bool = False) -> tuple[float, str]:
    """Least time (ms) of a single-hash kernel call, whatever its design:
    the tokens it hashes (B x cols, cols = N, or 2 floor(N / 2) for HM) and
    as many keys (8 bytes, 4 for the carry-less families; one more, m1, in
    the finish mode) read once, the output ((B, 2) int64, or (B,) in the
    finish mode) written once, over the memory rate; for the integer
    kernel also 2 operations a token (one 64x32-bit multiply-add) over the
    instruction rate. A carry-less product has no instruction on the card
    and no operation count that holds for every way to compute it, so the
    carry-less bound is its bytes; `single_design_floor` gives the floor of
    the design that ships."""
    cols = port.ref.hashed_cols(N, family)
    gf = family.startswith("gf_")
    nbytes = (B * cols * 4 + (cols + finish) * (4 if gf else 8)
              + B * (8 if finish else 16))
    return _least_ms(nbytes, 0 if gf else 2 * B * cols)


def _least_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def single_design_floor(family: str, B: int, N: int, port: Port, device,
                        b1_rate: float, finish: bool = False) -> tuple[float, str]:
    """Least time (ms) of the carry-less single-hash kernel in its own
    design (csrc/gf_single.cuh), never below the bytes bound: the plain
    family's m16n8k256 b1 mma products -- 8 for every 8 columns of every
    16-row tile, counted over this launch's column splits -- at `b1_rate`
    (measured in phase 1); the HM family's BMUL_PAIR_OPS integer operations a
    pair over the instruction rate. Not a bound on the function: another
    design could go below it."""
    b_ms = single_bound(family, B, N, port, finish)[0]
    cols = port.ref.hashed_cols(N, family)
    if family in port.ref.PAIRWISE:
        t_ms, by = BMUL_PAIR_OPS * B * (cols // 2) / INT32_OPS_PER_S * 1e3, "operations"
    else:
        split = port.wrappers["gf_multilinear"].split_of(B, N, family, device)
        steps = sum(-(-min(split, cols - c) // 32) for c in range(0, max(cols, 1), split))
        mmas = -(-B // 16) * steps * 32  # 4 k-steps x 8 n-tiles a step
        t_ms, by = mmas / b1_rate * 1e3, "b1 mma"
    return (t_ms, by) if t_ms > b_ms else (b_ms, "bytes")


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------

def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_kernels(port: Port) -> dict:
    t0 = time.perf_counter()
    log = port.build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s wall "
          f"(nvcc per kernel: "
          + ", ".join(f"{k} {v['seconds']:.3f} s" for k, v in log.items())
          + ")")
    for name, entry in log.items():
        for line in entry["ptxas"].splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                print(f"  {name}: {line.strip()}")
        if name in ("multihash", "gf_multihash", "gf_multilinear"):
            spills = [ln for ln in entry["ptxas"].splitlines() if "spill" in ln]
            check(all("0 bytes spill stores, 0 bytes spill loads" in ln
                      for ln in spills), f"{name}: ptxas reports spills")
    for name in port.build.KERNELS:
        port.build.load(name)
    for name in ("multihash", "gf_multihash"):
        print(f"  {name}: dynamic shared memory per block (bytes): " + ", ".join(
            f"K={k}{' HM' if hm else ''} {port.build.engine_smem(name, k, hm)}"
            for k in (1, 3, 9, 20) for hm in (False, True)))
    return log


def b1_rate(port: Port, device) -> float:
    """The b1 mma rate the carry-less single-hash design floor uses:
    measured on this card by a loop of the instruction alone."""
    rate = port.wrappers["gf_multilinear"].b1_mma_rate(device)
    print(f"b1 mma rate (m16n8k256 and/popc products a second): {rate} "
          f"measured on this card by gf_multilinear.b1_mma_rate "
          f"(csrc/gf_single.cuh::gf_b1_rate); an A100's per-SM rate at 132 "
          f"SMs x 1.98 GHz would give {B1_MMA_PER_S_A100_LIKE}")
    check(rate > 0, "b1 mma rate probe")
    return rate


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------

def kernel_vs_plain(port: Port, device, B=256, widths=(300, 1100)) -> dict:
    """Every family x fixed/ragged x K x mod_m, at N = 300 (one column
    split) and N = 1,100 (four splits and the second pass): kernel == plain
    == host twin. Ragged rows end just before, at and after the 32-column
    tile and the split edges. Returns {kernel: max |kernel - plain|}."""
    torch = port.torch
    g = np.random.default_rng(SEED)
    errs = {"multihash": 0, "gf_multihash": 0}
    for N, K in ((N, K) for N in widths for K in (1, 3, 9, 20)):
        splits = {port.wrappers["multihash"].split_of(k, B, N + 2, device)
                  for k in errs}
        edge = sorted(x for x in {0, 1, 2, 3, 31, 32, 33, 63, 64, 65, 127, 128,
                                  129, N - 1, N} | {s + d for s in splits
                                                    for d in (-2, -1, 0, 1)}
                      if x <= N)
        W = N + 2  # even, and room for the sentinel of a full row
        toks = g.integers(0, 2**32, (B, N), dtype=np.uint64).astype(np.uint32)
        keys_u64 = g.integers(0, 2**64, (K, W + 1), dtype=np.uint64)
        ragged = np.array(edge + list(g.integers(0, N + 1, B - len(edge))), np.int32)
        ragged[-2:] = (-1, 0)  # the two padding codes
        t_toks = torch.from_numpy(toks.view(np.int32)).to(device)
        t_keys = torch.from_numpy(keys_u64.view(np.int64)).to(device)
        sub = np.arange(0, B, 7)
        toks_w = np.zeros((len(sub), W), np.uint32)
        toks_w[:, :N] = toks[sub]
        for lens in (np.full(B, -(N + 1), np.int32), ragged):
            t_lens = torch.from_numpy(lens).to(device)
            for family in FAMILIES:
                gf = family.startswith("gf_")
                if gf:
                    surf = port.hostref.gf_multilinear_multi_np(
                        toks_w, lens[sub],
                        (keys_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                        family=family)
                else:
                    surf = port.hostref.multilinear_multi_np(
                        toks_w, lens[sub], keys_u64, family=family)
                for mod_m in (None, 1, 2**20, 4097, 2**32 - 1):
                    got = one_launch(port, family, lambda: port.ops.multihash(
                        t_toks, t_keys, t_lens, family=family, mod_m=mod_m,
                        width=W))
                    want = port.plain(family, t_toks, t_keys, t_lens,
                                      mod_m=mod_m, width=W)
                    torch.cuda.synchronize()
                    what = f"{family} N={N} K={K} mod_m={mod_m}"
                    check(torch.equal(got, want), f"kernel != plain: {what}")
                    name = port.kernel_of(family)
                    errs[name] = max(errs[name],
                                     int((got - want).abs().max().item()))
                    s = got[torch.from_numpy(sub).to(device)].cpu().numpy()
                    hi = (surf >> np.uint64(32)).astype(np.int64)
                    if mod_m is None:
                        host0 = hi
                        host1 = (surf & np.uint64(0xFFFFFFFF)).astype(np.int64)
                    else:
                        host0 = (surf % np.uint64(mod_m)).astype(np.int64)
                        host1 = hi
                    check(np.array_equal(s[..., 0], host0)
                          and np.array_equal(s[..., 1], host1),
                          f"kernel != host twin: {what}")
    print(f"kernel == plain == host twin in "
          f"{len(widths) * 2 * 4 * len(FAMILIES) * 5} cases; "
          f"max |kernel - plain| {errs}")
    return errs


# --------------------------------------------------------------------------
# phases 3-4: the main path
# --------------------------------------------------------------------------

def bloom_m(n_items=10**8, fp_rate=1e-3) -> int:
    return max(64, int(-n_items * math.log(fp_rate) / (math.log(2) ** 2)))


def pure_path(port: Port, device, B: int, N: int, K: int) -> dict:
    """Hasher surfaces at full width; returns the inputs and outputs."""
    torch = port.torch
    gen = torch.Generator(device=device).manual_seed(SEED)
    toks = torch.randint(-2**31, 2**31, (B, N), generator=gen,
                         dtype=torch.int32, device=device)
    m = bloom_m()
    res = {"tokens": toks, "m": m}
    for family in ("multilinear", "gf_multilinear"):
        h = port.Hasher.from_spec(port.HashSpec(
            family=family, n_hashes=K, out_bits=64, seed=SEED), max_len=N,
            device=device)
        slots = one_launch(port, family, lambda: h(toks))
        probes = one_launch(port, family, lambda: h.probe_indices(toks, m))
        shards = one_launch(port, family, lambda: h.shard_ids(toks, 64))
        torch.cuda.synchronize()
        check(tuple(slots.shape) == (B, K, 2) and tuple(probes.shape) == (B, K)
              and tuple(shards.shape) == (B,), f"{family}: shapes")
        check(bool(((probes >= 0) & (probes < m)).all())
              and bool(((shards >= 0) & (shards < 64)).all())
              and bool(((slots >= 0) & (slots < 2**32)).all()),
              f"{family}: values out of range")
        res[family] = {"hasher": h, "slots": slots, "probes": probes,
                       "shards": shards}
        print(f"{family}: __call__ {tuple(slots.shape)}, probe_indices(m={m}) "
              f"{tuple(probes.shape)}, shard_ids(64) {tuple(shards.shape)}; "
              f"shard loads min/max {int(torch.bincount(shards.long(), minlength=64).min())}"
              f"/{int(torch.bincount(shards.long(), minlength=64).max())}")
    return res


def make_batches(n_batches: int, batch: int, lo: int, hi: int, vocab: int,
                 dup_rate: float):
    """Documents (vectorized seeded numpy) with planted exact repeats of
    documents offered earlier (half from the batch before, half from
    earlier in the same batch). Returns [(docs, planted mask)]."""
    g = np.random.default_rng(SEED)
    out, prev = [], None
    for _ in range(n_batches):
        lens = g.integers(lo, hi + 1, batch)
        flat = g.integers(0, vocab, int(lens.sum()), dtype=np.uint32)
        docs = np.split(flat, np.cumsum(lens)[:-1])
        planted = g.random(batch) < dup_rate
        planted[0] = planted[0] and prev is not None
        from_prev = g.random(batch) < 0.5
        for i in np.flatnonzero(planted):
            if prev is not None and (from_prev[i] or i == 0):
                docs[i] = prev[g.integers(batch)]
            else:
                docs[i] = docs[g.integers(i)]
        out.append((docs, planted))
        prev = docs
    return out


def admission(port: Port, device, batches, card: str) -> dict:
    """Bloom (both families), ExactDedup and HashPipeline over the batches."""
    n_docs = sum(len(d) for d, _ in batches)
    n_tokens = sum(int(sum(len(x) for x in d)) for d, _ in batches)
    n_planted = int(sum(p.sum() for _, p in batches))
    report = {}

    def drive(label, family, admit_batch, rejected):
        admitted, c0, t0 = 0, port.counts(), time.perf_counter()
        for docs, planted in batches:
            verdict = one_launch(port, family, lambda: admit_batch(docs))
            rej = rejected(verdict)
            check(bool(rej[planted].all()),
                  f"{label}: a planted repeat was admitted")
            admitted += int((~rej).sum())
        dt = time.perf_counter() - t0
        launched = {k: v - c0[k] for k, v in port.counts().items() if v > c0[k]}
        report[label] = {"docs_per_s": n_docs / dt, "tokens_per_s": n_tokens / dt,
                         "seconds": dt, "admitted": admitted,
                         "launches": launched}
        print(f"{label}: {n_docs} docs, {n_tokens} tokens in {dt:.3f} s: "
              f"{n_docs / dt} docs/s, {n_tokens / dt} tokens/s ({card}); "
              f"admitted {admitted} of {n_docs - n_planted} unique; "
              f"launches {launched}")
        return admitted

    for family in ("multilinear", "gf_multilinear"):
        bf = port.BloomFilter(n_items=10**8, fp_rate=1e-3, family=family,
                              device=device)
        check(bf.k == 9 and bf.m == bloom_m(), "Bloom sizing")
        admitted = drive(f"bloom/{family}", family, bf.check_and_add_batch,
                         lambda v: ~v)
        fill = 1 - math.exp(-bf.k * n_docs / bf.m)
        fp_bound = max(5, 10 * n_docs * fill ** bf.k)
        check(n_docs - n_planted - fp_bound <= admitted <= n_docs - n_planted,
              f"bloom/{family}: implausible admitted count {admitted}")
    ed = port.ExactDedup(device=device)
    admitted = drive("exact_dedup/multilinear", "multilinear",
                     ed.check_and_add_batch, lambda v: ~v)
    check(admitted == n_docs - n_planted, "exact dedup: admitted count")
    pipe = port.HashPipeline(port.PipelineConfig(
        seq_len=2048, batch_size=8, n_shards=4, shard_id=0), device=device)
    drive("pipeline/multilinear", "multilinear", pipe.admit_batch,
          lambda routes: np.array([r == "dup" for r in routes]))
    check(pipe.stats["docs"] == n_docs, "pipeline stats")
    print(f"pipeline routes: {pipe.stats}")
    return report


# --------------------------------------------------------------------------
# phase 6: the single-hash path (also on the main path)
# --------------------------------------------------------------------------

def single_host(port: Port, family: str, s: np.ndarray, ku: np.ndarray):
    """The numpy twins of multilinear_hash / gf_hash on rows s (uint32)."""
    hr = port.hostref
    N = s.shape[1]
    c = port.ref.hashed_cols(N, family)
    if family == "multilinear_hm":
        return hr.multilinear_hm_np(s[:, :c], ku[:c + 1])
    if not family.startswith("gf_"):
        return hr.multilinear_np(s, ku)
    k = ku & np.uint64(0xFFFFFFFF)
    if family == "gf_multilinear_hm":
        prod = hr._clmul32_np(k[1:c + 1:2] ^ s[:, 0:c:2], k[2:c + 1:2] ^ s[:, 1:c:2])
    else:
        prod = hr._clmul32_np(k[1:N + 1], s)
    return hr._gf_barrett_np(np.bitwise_xor.reduce(prod, axis=-1) ^ k[0])


def single_path(port: Port, device, B: int, N: int, n_sub: int,
                families=FAMILIES) -> dict:
    """`multilinear_hash`/`gf_hash` of B rows of N tokens for each family:
    one launch each, equal to the plain version and to the numpy twins on
    n_sub rows. Returns the inputs for phase 5."""
    torch = port.torch
    gen = torch.Generator(device=device).manual_seed(SEED + N)
    toks = torch.randint(-2**31, 2**31, (B, N), generator=gen,
                         dtype=torch.int32, device=device)
    ku = port.keys.KeyBuffer(seed=SEED).u64(N + 1)
    keys = torch.from_numpy(ku.view(np.int64)).to(device)
    hi, lo = (torch.from_numpy(x.view(np.int32)).to(device)
              for x in port.keys.split_hi_lo(ku))
    sub = np.linspace(0, B - 1, min(n_sub, B)).astype(np.int64)
    s = toks[torch.from_numpy(sub).to(device)].cpu().numpy().view(np.uint32)
    for family in families:
        if family.startswith("gf_"):
            fn = lambda: port.ops.gf_hash(toks, lo, family=family)  # noqa: E731
        else:
            fn = lambda: port.ops.multilinear_hash(toks, hi, lo, family=family)  # noqa: E731
        out = one_launch(port, family, fn, kernel=port.single_of(family))
        want = port.plain_hash(family, toks, keys)
        torch.cuda.synchronize()
        what = f"{family} B={B} N={N}"
        check(tuple(out.shape) == (B,) and torch.equal(out, want),
              f"{what}: entry point != plain version")
        check(np.array_equal(out[torch.from_numpy(sub).to(device)].cpu().numpy(),
                             single_host(port, family, s, ku).astype(np.int64)),
              f"{what}: entry point != numpy twin")
        print(f"{what}: (B,) hashes == plain version == numpy twin "
              f"({len(sub)} rows)")
    return {"tokens": toks, "keys": keys, "hi": hi, "lo": lo,
            "families": families}


def streaming(port: Port, device, n_tokens=4_194_304, chunk_words=1024,
              max_chunks=4096, block=65_536) -> dict:
    """Stream fingerprints on the card: even and uneven updates, one kernel
    launch per update that completes chunks; digests equal each other, the
    numpy reference and the CPU digest."""
    torch = port.torch
    spec = port.HashSpec(family="multilinear", seed=SEED)
    h = port.Hasher.from_spec(spec, max_len=chunk_words, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    toks = torch.randint(-2**31, 2**31, (n_tokens,), generator=gen,
                         dtype=torch.int32, device=device)

    def absorb(bounds):
        st = h.stream(chunk_words=chunk_words, max_chunks=max_chunks)
        for a, b in zip(bounds[:-1], bounds[1:]):
            before = port.counts()["multilinear"]
            fill = st.fill
            st = h.update(st, toks[a:b])
            want = int(torch.cuda.is_available()
                       and (fill + b - a) // chunk_words > 0)
            check(port.counts()["multilinear"] == before + want,
                  f"stream update [{a}, {b}): expected {want} launch(es)")
        return st

    t0 = time.perf_counter()
    st = absorb(list(range(0, n_tokens + 1, block)))
    even = h.digest_int(st)
    wall = time.perf_counter() - t0
    uneven = h.digest_int(absorb([0, 1, 1024, 2049, n_tokens]))
    host = port.streaming.stream_digest_host(
        h, toks.cpu().numpy().view(np.uint32), chunk_words, max_chunks)
    hc = port.Hasher.from_spec(spec, max_len=chunk_words, device="cpu")
    cpu = hc.digest_int(hc.update(hc.stream(chunk_words, max_chunks), toks.cpu()))
    check(even == uneven == host == cpu,
          f"stream digests differ: {even:#x} {uneven:#x} {host:#x} {cpu:#x}")
    print(f"stream of {n_tokens} tokens ({n_tokens // block} updates of {block}): "
          f"digest {even:#018x} == uneven blocks == stream_digest_host == CPU; "
          f"{1e3 * wall:.3f} ms wall for the updates and the digest")
    return {"tokens": n_tokens, "updates": n_tokens // block, "ms": 1e3 * wall,
            "digest": f"{even:#018x}"}


# --------------------------------------------------------------------------
# phase 5: measurements
# --------------------------------------------------------------------------

def measure(port: Port, device, pure: dict, batch, K: int, launches: dict,
            card: str, docs_rows: int = 65536):
    """Kernel vs plain version at the main path's shapes: equality, times
    and bounds. Returns the `kernels` records and a table of rows."""
    torch = port.torch
    toks = pure["tokens"]
    B, N = toks.shape
    rows, records = [], {}
    docs, _ = batch
    from repro_torch.hash.hasher import _stack_ragged

    dense, lens_b = _stack_ragged(docs)
    t_dense = torch.from_numpy(dense.view(np.int32)).to(device)
    t_lens_b = torch.from_numpy(lens_b.astype(np.int32)).to(device)
    W_b = dense.shape[1] + 2 + (dense.shape[1] & 1)  # hash_batch's width
    # a docs batch: exponential lengths of mean 635 cut at 2,048 (Dolma's
    # sources, as the benchmark's docs traffic), shuffled
    g = np.random.default_rng(SEED + 28)
    N_docs = 2048
    lens_docs = np.minimum(N_docs, 1 + g.exponential(635, docs_rows).astype(np.int64))
    t_lens_docs = torch.from_numpy(lens_docs.astype(np.int32)).to(device)
    t_docs = torch.randint(0, 50000, (docs_rows, N_docs), dtype=torch.int32,
                           generator=torch.Generator(device=device).manual_seed(SEED + 28),
                           device=device)
    W_docs = N_docs + 2
    for family in ("multilinear", "gf_multilinear"):
        name = port.kernel_of(family)
        h = pure[family]["hasher"]
        keys = h._keys_for_width(W_b)
        W = N + 2 if N % 2 == 0 else N + 1
        code = torch.full((B,), N, dtype=torch.int32, device=device)
        # phase 3's Hasher surfaces against the plain version, then timed
        res, m = pure[family], pure["m"]
        plain = port.plain(family, toks, h.keys, code, width=W)
        check(torch.equal(res["slots"], plain)
              and torch.equal(res["shards"], port.limbs.mulhi32(
                  plain[:, 0, 0], 64).to(torch.int32)),
              f"{family}: __call__/shard_ids != plain version")
        plain = port.plain(family, toks, h.keys, code, mod_m=m, width=W)
        check(torch.equal(res["probes"], plain[..., 0]),
              f"{family}: probe_indices != plain version")
        del plain
        for surface, fn in (("__call__", lambda: h(toks)),
                            ("probe_indices", lambda: h.probe_indices(toks, m)),
                            ("shard_ids", lambda: h.shard_ids(toks, 64))):
            row = {"surface": surface, "family": family, "B": B, "N": N,
                   "K": K, "ms": timed(port, fn, 20), "card": card}
            rows.append(row)
            print(json.dumps(row))
        # the admission batch and a docs batch (B 65,536 x W 2,050, Dolma-like
        # lengths) with the lengths given, as the Hasher's ragged calls run
        # them (rows in length order), and the docs batch without
        shapes = [("pure", toks, h.keys, code, W, pure["m"], False),
                  ("pure-nomod", toks, h.keys, code, W, None, False),
                  ("admit-batch", t_dense, keys, t_lens_b, W_b, None, True),
                  ("docs", t_docs, h._keys_for_width(W_docs), t_lens_docs, W_docs,
                   pure["m"], True),
                  ("docs-unordered", t_docs, h._keys_for_width(W_docs), t_lens_docs,
                   W_docs, pure["m"], False)]
        if family == "multilinear":  # the ExactDedup and HashPipeline launches
            shapes += [(f"admit-batch-K{k}", t_dense, port.Hasher.from_spec(
                port.HashSpec(family=family, n_hashes=k, out_bits=64, seed=SEED),
                device=device)._keys_for_width(W_b), t_lens_b, W_b, None, True)
                for k in (1, 3)]
        for label, t, kt, ln, width, mod_m, ragged in shapes:
            run = lambda: port.ops.multihash(t, kt, ln, family=family,  # noqa: E731
                                             mod_m=mod_m, width=width, ragged=ragged)
            got = run()
            want = plain_in_rows(port, family, t, kt, ln, mod_m, width)
            check(torch.equal(got, want), f"{family} {label}: kernel != plain")
            err = int((got - want).abs().max().item())
            del got, want
            ms, graph_ms = timed(port, run, 20), timed_graph(port, run, 20)
            plain_ms = timed(port, lambda: plain_in_rows(
                port, family, t, kt, ln, mod_m, width), 2)
            k, lens_np = kt.shape[0], ln.cpu().numpy()
            B_ = t.shape[0]
            b_ms, b_by = bound(name, B_, t.shape[1], width, k, lens_np)
            ordered = port.autotune.engine_orders(
                B_, width, port.autotune.engine_rows(name), ragged)
            extra = {}
            if name == "gf_multihash":
                extra["design_floor_ms"], extra["design_floor_by"] = design_floor(
                    B_, t.shape[1], width, k, lens_np)
            if label.startswith(("admit-batch", "docs")):
                extra["lane_per_row_work"] = lane_work(lens_np, width, ordered)
                # the call's device operations: the ordering kernel beside the
                # tile kernel (and the finish pass where split)
                extra.update(engine_ops(port, run, name))
                del extra["names"]
                # the program's own count of its ordered calls decides; the
                # profiler's count beside it can miss a record
                port.tracing.enable()
                run()
                port.tracing.disable()
                n_ord = port.tracing.snapshot()["counters"]["engine.ordered_calls"]
                want = int(ordered and t.is_cuda)  # a CPU tensor runs the plain version
                check(n_ord == want, f"{family} {label}: {n_ord} ordered calls "
                      f"of one, expected {want}")
            row = {"kernel": name, "family": family, "shape": label,
                   "B": B_, "W": width, "K": k, "mod_m": mod_m,
                   "ragged": ragged, "ordered": ordered,
                   "splits": port.autotune.engine_splits(
                       width, port.wrappers["multihash"].split_of(
                           name, B_, width, device, ordered)),
                   "ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, **extra,
                   "max_abs_err": err}
            rows.append(row)
            print(json.dumps(row))
            if label == "pure":
                records[name] = {
                    "name": name, "route": "cuda", "source": KERNELS[name][0],
                    "replaces": KERNELS[name][1], "launches": launches[name],
                    "matches_plain": err == 0,
                    "max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    **{key: v for key, v in extra.items()
                       if key.startswith("design_floor")},
                    "library_ms": None}
            if label in ("admit-batch", "docs", "docs-unordered"):
                records[name][label] = {key: row[key] for key in (
                    "B", "W", "ordered", "splits", "ms", "graph_ms", "plain_ms",
                    "bound_ms", "lane_per_row_work", "ops", "order_launches",
                    "order_ms", "tile_ms", "finish_ms", "max_abs_err")}
        # the host part of one admission batch beside its launch
        bf_h = port.Hasher.from_spec(port.HashSpec(
            family=family, n_hashes=K, out_bits=64, seed=SEED), device=device)
        t0 = time.perf_counter()
        bf_h.hash_batch(docs)
        print(f"{family}: hash_batch of one admission batch (stack, upload, "
              f"launch, download) {1e3 * (time.perf_counter() - t0):.3f} ms wall")
    return records, rows


def plain_in_rows(port: Port, family: str, t, keys, lens, mod_m, width: int,
                  step: int = 16384):
    """The plain version a slab of `step` rows at a time (its (B, W)
    temporaries stay small at the docs shape)."""
    return port.torch.cat([port.plain(family, t[r:r + step], keys, lens[r:r + step],
                                      mod_m=mod_m, width=width)
                           for r in range(0, t.shape[0], step)])


def engine_ops(port: Port, fn, kernel: str, calls: int = 5) -> dict:
    """The device operations of an engine call fn of `kernel` under
    torch.profiler (the card's activity alone), over `calls` warm calls:
    {ops, order_launches} a call, {order_ms, tile_ms, finish_ms}: the
    device ms of one launch of the ordering kernel, the tile kernel and the
    finish pass (the mean over the records seen: the profiler can miss
    one, as it missed one of five of the carry-less library's first
    kernel in a window), and the names of the operations seen; None where
    the profiler sees nothing here."""
    torch = port.torch
    from torch.profiler import ProfilerActivity, profile

    none = {"ops": None, "order_launches": None, "order_ms": None,
            "tile_ms": None, "finish_ms": None, "names": []}
    fn()
    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:  # the profiler itself, not the code under test
        print(f"torch.profiler failed on the card: {exc!r}")
        return none
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    try:
        prof.stop()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as exc:  # the profiler itself, not the code under test
        print(f"torch.profiler failed on the card: {exc!r}")
        return none
    if not dev:
        return none
    tag = "GfEngine" if kernel == "gf_multihash" else "IntEngine"

    def of(what):
        us = [e.time_range.elapsed_us() for e in dev if what in e.name and tag in e.name]
        return len(us) / calls, sum(us) / len(us) / 1e3 if us else 0.0

    n_order, order_ms = of("engine_order_kernel")
    return {"ops": len(dev) / calls, "order_launches": n_order,
            "order_ms": order_ms, "tile_ms": of("engine_tile_kernel")[1],
            "finish_ms": of("engine_finish")[1],
            "names": sorted({e.name[:60] for e in dev})}


def device_busy(port: Port, fn, warm: bool = False, top: int = 8):
    """fn() once (after one warm call when `warm`) under torch.profiler:
    {wall_ms (profiler on), ops and names (the card's operations), kernel_ms
    and copy_ms (device times summed: one stream, so they do not overlap),
    idle_share of the wall, top_ms (the `top` names by device ms)}; None
    when the profiler sees nothing here. Only the profiler's own start and
    stop are guarded: a failure of fn() fails the run."""
    torch = port.torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as exc:  # the profiler itself, not the code under test
        print(f"torch.profiler failed on the card: {exc!r}")
        return None
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    try:
        prof.stop()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as exc:  # the profiler itself, not the code under test
        print(f"torch.profiler failed on the card: {exc!r}")
        return None
    if not dev:
        return None
    by_name: dict = {}
    for e in dev:
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + e.time_range.elapsed_us() / 1e3
    copies = sum(v for k, v in by_name.items() if k.startswith(("Memcpy", "Memset")))
    busy = sum(by_name.values())
    return {"wall_ms": wall, "ops": len(dev), "names": [e.name for e in dev],
            "kernel_ms": busy - copies, "copy_ms": copies,
            "idle_share": 1 - busy / wall,
            "top_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}


def ops_of(prof) -> tuple:
    """(operations, names) of a `device_busy` record; (None, []) without one."""
    return (prof["ops"], prof["names"]) if prof else (None, [])


def measure_single(port: Port, device, shapes: dict, launches: dict,
                   card: str, rate: float):
    """Single-hash kernels vs their plain versions at phase 6's shapes:
    equality, times, bounds (and the carry-less kernel's design floor), the
    carry-less kernel in both modes (raw accumulator; finished hashes with
    m1 and Barrett); then the entry points' times at 6a, and the device
    operations of one `gf_hash` call (at most 8)."""
    torch = port.torch
    gfk = port.wrappers["gf_multilinear"]
    rows, records, finish_ms = [], {}, {}
    for label, res in shapes.items():
        toks, keys = res["tokens"], res["keys"]
        k32 = keys.to(torch.int32)
        B, N = toks.shape
        for family in res["families"]:
            name = port.single_of(family)
            modes = ("raw", "finish") if name == "gf_multilinear" else ("raw",)
            for mode in modes:
                if mode == "finish":
                    run = lambda: gfk.gf_hash_rows(toks, k32, family=family)  # noqa: E731
                    plain = lambda: port.plain_hash(family, toks, keys)  # noqa: E731
                else:
                    k = keys[1:] if name == "multilinear" else k32[1:]
                    run = lambda: port.single[name](toks, k, family=family)  # noqa: E731
                    plain = lambda: port.plain_single(family, toks, keys[1:])  # noqa: E731
                got, want = run(), plain()
                check(torch.equal(got, want),
                      f"{family} {label} {mode}: kernel != plain")
                err = int((got - want).abs().max().item())
                del got, want
                ms, graph_ms = timed(port, run, 20), timed_graph(port, run, 20)
                plain_ms = timed(port, plain, 2)
                b_ms, b_by = single_bound(family, B, N, port, mode == "finish")
                extra = {}
                if name == "gf_multilinear":
                    extra["design_floor_ms"], extra["design_floor_by"] = \
                        single_design_floor(family, B, N, port, device, rate,
                                            mode == "finish")
                    extra["splits"] = max(1, -(-port.ref.hashed_cols(N, family)
                                               // gfk.split_of(B, N, family, device)))
                row = {"kernel": name, "family": family, "shape": label,
                       "mode": mode, "B": B, "N": N, "ms": ms,
                       "graph_ms": graph_ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by, **extra,
                       "max_abs_err": err, "card": card}
                rows.append(row)
                print(json.dumps(row))
                if mode == "finish" and label == "6a":
                    finish_ms[family] = ms
                # the main path launches the carry-less kernel in its finish mode
                if (label == "6a" and family == name
                        and mode == ("finish" if name == "gf_multilinear" else "raw")):
                    records[name] = {
                        "name": name, "route": "cuda", "source": KERNELS[name][0],
                        "replaces": KERNELS[name][1], "launches": launches[name],
                        "matches_plain": err == 0, "max_abs_err": err, "ms": ms,
                        "graph_ms": graph_ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        **{key: v for key, v in extra.items()
                           if key.startswith("design_floor")},
                        "library_ms": None}
    res = shapes["6a"]
    toks, hi, lo = res["tokens"], res["hi"], res["lo"]
    for family in FAMILIES:
        row = {"surface": "gf_hash" if family.startswith("gf_") else
               "multilinear_hash", "family": family, "B": toks.shape[0],
               "N": toks.shape[1]}
        if family.startswith("gf_"):
            fn = lambda: port.ops.gf_hash(toks, lo, family=family)  # noqa: E731
            n_ops, names = ops_of(device_busy(port, fn, warm=True))
            check(n_ops is None or n_ops <= 8,
                  f"gf_hash {family}: {n_ops} device operations a call > 8: {names}")
            row.update(kernel_finish_ms=finish_ms[family],
                       device_ops_per_call=n_ops, device_ops=sorted(set(names)))
        else:
            fn = lambda: port.ops.multilinear_hash(toks, hi, lo, family=family)  # noqa: E731
        row.update(ms=timed(port, fn, 10), card=card)
        rows.append(row)
        print(json.dumps(row))
    return records, rows


# --------------------------------------------------------------------------
# phase 7: tree fingerprints and checkpoints
# --------------------------------------------------------------------------

def launched(port: Port, n, fn, what: str):
    """Run fn(); require exactly n engine launches on the card (kernels 1-2,
    counted by their wrappers) and n engine dispatches, and no launch of
    another kernel. `n` may be a function, read after fn() (a count that
    depends on what fn did, such as overflow replays). Returns fn()'s
    result; `port.tally` adds n."""
    c0, d0 = port.counts(), port.ops.launch_count()
    out = fn()
    n = n() if callable(n) else n
    port.tally += n
    c1 = port.counts()
    engine = sum(c1[k] - c0[k] for k in ("multihash", "gf_multihash"))
    other = {k: c1[k] - c0[k] for k in ("multilinear", "gf_multilinear")}
    on_card = port.torch.cuda.is_available()  # wrappers count CUDA launches
    check((engine == n or not on_card) and port.ops.launch_count() - d0 == n
          and not any(other.values()),
          f"{what}: expected {n} engine launch(es), counts {c0} -> {c1}")
    return out


def stream_flushes(bounds, lw: int, leaf_batch: int) -> int:
    """Flushes (engine launches) of a TreeStream fed updates at `bounds`,
    digest included: `TreeStream.update`'s rule, on the block lengths."""
    nbuf, total, flushes = 0, 0, 0
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b == a:
            continue
        nbuf, total = nbuf + b - a, total + b - a
        if nbuf >= leaf_batch * lw:
            flushes, nbuf = flushes + 1, nbuf % lw
    return flushes + int(nbuf > 0 or total == 0)


def tree_fingerprints(port: Port, device, family: str, n_words: int,
                      prefix_words: int, card: str) -> dict:
    """7a: one seeded int32 tensor of n_words on the card under
    `TreeSpec(family=family)`: device-resident fingerprint_array == the
    same bytes staged from the host == fingerprint of the tokens == a
    TreeStream fed the host words in 97 uneven updates; the leaf launch ==
    its plain version at full size; the root of a prefix == the numpy
    twin. Times and device operations for the record."""
    torch = port.torch
    spec = port.TreeSpec(family=family)
    th = port.TreeHasher(spec, device=device)
    lw = spec.leaf_words
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    x = torch.randint(-2**31, 2**31, (n_words,), generator=gen,
                      dtype=torch.int32, device=device)
    n_bytes = 4 * n_words
    fp_dev = launched(port, 1, lambda: th.fingerprint_array(x),
                      f"{family}: fingerprint_array")
    host = x.cpu().numpy()
    t0 = time.perf_counter()
    fp_host = launched(port, 1, lambda: th.fingerprint_bytes(host.view(np.uint8)),
                       f"{family}: fingerprint_bytes")
    host_ms = 1e3 * (time.perf_counter() - t0)
    check(fp_dev == fp_host, f"{family}: device-resident {fp_dev:#x} != "
          f"host-staged {fp_host:#x}")
    fp_tok = launched(port, 1, lambda: th.fingerprint(x), f"{family}: fingerprint")
    hi, lo = launched(port, 1, lambda: th.digest_tokens(
        x, n_tokens=torch.tensor(n_words, device=device)), "digest_tokens").tolist()
    check((hi << 32) | lo == fp_tok, f"{family}: digest_tokens != fingerprint")
    # 97 uneven updates of the host words (tag: the token count)
    g = np.random.default_rng(SEED + 97)
    bounds = [0] + sorted(g.integers(0, n_words, 96).tolist()) + [n_words]
    leaf_batch = 1024
    flushes = stream_flushes(bounds, lw, leaf_batch)

    def run_stream():
        st = th.stream(leaf_batch=leaf_batch)
        for a, b in zip(bounds[:-1], bounds[1:]):
            st.update(host[a:b])
        return st.digest_int()

    t0 = time.perf_counter()
    fp_stream = launched(port, flushes, run_stream, f"{family}: stream")
    stream_ms = 1e3 * (time.perf_counter() - t0)
    check(fp_stream == fp_tok, f"{family}: stream {fp_stream:#x} != "
          f"fingerprint {fp_tok:#x}")
    # the leaf launch against its plain version, at full size
    name = port.kernel_of(family)
    rows = x.view(-1, lw)
    B = rows.shape[0]
    keys = th.hasher.keys
    lens = torch.full((B,), -(lw + 1), dtype=torch.int32, device=device)
    run = lambda: port.ops.multihash(rows, keys, lens, family=family, width=lw)  # noqa: E731
    got = launched(port, 1, run, f"{family}: leaf launch")
    want = port.plain(family, rows, keys, lens, width=lw)
    check(torch.equal(got, want), f"{family}: tree leaf launch != plain version")
    err = int((got - want).abs().max().item())
    del got, want
    # the root of a prefix against the numpy twin
    t0 = time.perf_counter()
    twin = th.digest_host(host[:prefix_words].view(np.uint32))
    twin_s = time.perf_counter() - t0
    fp_prefix = launched(port, 1, lambda: th.fingerprint(x[:prefix_words]),
                         f"{family}: prefix fingerprint")
    check(fp_prefix == twin, f"{family}: prefix root {fp_prefix:#x} != "
          f"digest_host {twin:#x}")
    print(f"{family}: {n_bytes} bytes, {B} leaves of {lw} words: "
          f"fingerprint_array (card) == fingerprint_bytes (host-staged) "
          f"{fp_dev:#018x}; fingerprint == digest_tokens == stream of "
          f"{len(bounds) - 1} updates ({flushes} flushes) {fp_tok:#018x}; "
          f"leaf launch == plain version; {4 * prefix_words}-byte prefix "
          f"== digest_host ({twin_s:.3f} s numpy)")
    rec = {"family": family, "bytes": n_bytes, "leaves": B, "leaf_words": lw,
           "root": f"{fp_dev:#018x}", "stream_updates": len(bounds) - 1,
           "stream_flushes": flushes, "prefix_bytes": 4 * prefix_words,
           "digest_host_s": twin_s, "launches": 6 + flushes,
           "fingerprint_bytes_host_ms": host_ms, "stream_ms": stream_ms,
           "card": card}

    def measure_tree() -> dict:
        """Times and device operations, once the path's launches are read."""
        nodes = th._leaf_digests(rows)
        fold = lambda: th._fold_impl(nodes, B, n_bytes)  # noqa: E731
        fold_ops, fold_names = ops_of(device_busy(port, fold, warm=True))
        fp_ops, _ = ops_of(device_busy(port, lambda: th.fingerprint_array(x),
                                       warm=True))
        lens_np = lens.cpu().numpy()
        b_ms, b_by = bound(name, B, lw, lw, 1, lens_np)
        floor = (dict(zip(("design_floor_ms", "design_floor_by"),
                          design_floor(B, lw, lw, 1, lens_np)))
                 if name == "gf_multihash" else {})
        rec.update({
            "fingerprint_array_ms": timed(port, lambda: th.fingerprint_array(x), 10),
            "device_ops_per_fingerprint": fp_ops,
            "fold_ms": timed(port, fold, 20),
            "fold_graph_ms": timed_graph(port, fold, 20),
            "fold_device_ops": fold_ops, "fold_op_names": sorted(set(fold_names)),
            "fold_levels": max(0, (B - 1).bit_length()),
            "leaf": {"kernel": name, "B": B, "N": lw, "K": 1,
                     "ms": timed(port, run, 20),
                     "graph_ms": timed_graph(port, run, 20),
                     "plain_ms": timed(port, lambda: port.plain(
                         family, rows, keys, lens, width=lw), 2),
                     "bound_ms": b_ms, "bound_by": b_by, **floor,
                     "max_abs_err": err}})
        print(json.dumps(rec))
        return rec

    return rec, measure_tree


def _state(port: Port, device, rows: int) -> dict:
    """A training-like state on the card, ~512 MiB at rows = 8,192: nested
    dicts of f32, bf16 and int32 leaves, an OrderedDict state_dict and a
    uint8 leaf of odd byte length, from a seeded generator."""
    torch = port.torch
    from collections import OrderedDict

    gen = torch.Generator(device=device).manual_seed(SEED + 8)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    return {"params": {"w": randn(rows, rows),
                       "b16": randn(rows, rows // 2, dtype=torch.bfloat16)},
            "opt": OrderedDict([("exp_avg", randn(rows // 2, rows)),
                                ("step", torch.tensor(1234, dtype=torch.int32,
                                                      device=device))]),
            "data": {"ids": torch.randint(0, 50000, (rows * rows // 4,),
                                          generator=gen, dtype=torch.int32,
                                          device=device),
                     "blob": torch.randint(0, 256, (rows * 122 + 3,), generator=gen,
                                           dtype=torch.uint8, device=device)}}


def _flip_in(npz: Path, member: str) -> None:
    """Flip one byte in the middle of `member`'s stored data in the zip."""
    import zipfile

    with zipfile.ZipFile(npz) as z:
        info = z.getinfo(member)
    off = info.header_offset + 30 + len(info.filename) + info.compress_size // 2
    with open(npz, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def checkpoints(port: Port, device, card: str, rows: int = 8192) -> dict:
    """7b: Checkpointer.save x 3 (keep=2), verify (uncached), latest_valid
    (cached), restore on the card; a flipped byte of arrays.npz fails
    verify and raises CorruptCheckpointError on restore; an array
    rewritten in a clean zip fails its fingerprint."""
    import tempfile

    torch = port.torch
    state = _state(port, device, rows)
    flat = [v for _, v in port.flatten(state)]
    n = len(flat)
    stored = sum(x.numel() * (4 if x.dtype == torch.bfloat16 else x.element_size())
                 for x in flat)
    rec = {"leaves": n, "state_bytes": sum(x.numel() * x.element_size() for x in flat),
           "stored_bytes": stored, "card": card}

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        ck = port.Checkpointer(d, keep=2, device=device)
        saves = []
        for step in (1, 2, 3):
            _, dt = wall(lambda: launched(port, 2 * n + 1,
                                          lambda: ck.save(step, state), "save"))
            saves.append(dt)
        check(ck.steps() == [2, 3], f"keep=2: steps {ck.steps()}")
        ok, verify_s = wall(lambda: launched(port, 2 * n + 1,
                                             lambda: ck.verify(3), "verify"))
        check(ok, "verify of a fresh checkpoint")
        latest, latest_s = wall(lambda: launched(port, 0, ck.latest_valid,
                                                 "latest_valid (cached)"))
        check(latest == 3, f"latest_valid {latest}")
        out, restore_s = wall(lambda: launched(port, n, lambda: ck.restore(
            3, state), "restore"))
        check(all(torch.equal(a, b) and a.dtype == b.dtype and a.device == b.device
                  for a, b in zip(flat, (v for _, v in port.flatten(out)))),
              "restore != the saved state")
        del out
        # one flipped byte in the last leaf's data: the zip CRC or the
        # fingerprint must catch it, in verify and in restore
        npz = Path(d) / "step_3" / "arrays.npz"
        _flip_in(npz, f"a{n - 1}.npy")
        ok = launched(port, n - 1, lambda: ck.verify(3), "verify (corrupt)")
        check(not ok, "verify passed a flipped byte")
        try:
            launched(port, n - 1, lambda: ck.restore(3, state), "restore (corrupt)")
            raise SmokeFailure("restore of a flipped byte did not raise")
        except port.CorruptCheckpointError as exc:
            rec["corrupt_restore_error"] = str(exc)[:200]
        # step 3's verdict is cached; step 2 is verified for the first time
        check(launched(port, 2 * n + 1, ck.latest_valid, "latest_valid") == 2,
              "latest_valid did not skip the corrupt step")
        # a clean zip with one wrong element: only the fingerprint sees it
        small = port.Checkpointer(str(Path(d) / "small"), device=device)
        tiny = {"a": state["data"]["blob"][:4096].clone(),
                "b": state["data"]["ids"][:1000].clone()}
        launched(port, 5, lambda: small.save(1, tiny), "save (small)")
        spath = Path(d) / "small" / "step_1" / "arrays.npz"
        arrays = dict(np.load(spath))
        arrays["a0"][0] ^= 1
        np.savez(spath, **arrays)
        check(not launched(port, 1, lambda: small.verify(1), "verify (rewritten)"),
              "verify passed a rewritten array")
        try:
            launched(port, 1, lambda: small.restore(1, tiny), "restore (rewritten)")
            raise SmokeFailure("restore of a rewritten array did not raise")
        except port.CorruptCheckpointError as exc:
            check("fingerprint mismatch" in str(exc), f"rewritten: {exc}")
    mb = stored / 1e6
    rec.update({"launches": 5 * (2 * n + 1) + n + 2 * (n - 1) + 7,
                "save_s": saves, "verify_uncached_s": verify_s,
                "latest_valid_cached_s": latest_s, "restore_s": restore_s,
                "save_MBps": [mb / t for t in saves], "verify_MBps": mb / verify_s,
                "restore_MBps": mb / restore_s})
    print(f"checkpoints: {n} leaves, {stored} stored bytes; save "
          f"{[round(mb / t, 1) for t in saves]} MB/s, verify {mb / verify_s:.1f}, "
          f"restore {mb / restore_s:.1f} MB/s, latest_valid (cached) "
          f"{1e3 * latest_s:.3f} ms; a flipped byte failed verify and restore "
          f"({rec['corrupt_restore_error'][:80]}...), a rewritten array failed "
          f"its fingerprint ({card})")
    print(json.dumps(rec))
    return rec


def long_dedup(port: Port, device, card: str, long_len: int = 1 << 20) -> dict:
    """7c: ExactDedup.add_documents over 256 documents of 64-2,048 words
    and 8 of 2^20 words, with repeats at both lengths: the mask equals
    the same routing on host fingerprints (hash_batch's numpy twin for
    the short ones, the tree's numpy twin for the long ones)."""
    g = np.random.default_rng(SEED + 9)
    short = [g.integers(0, 50000, int(n), dtype=np.uint32)
             for n in g.integers(64, 2049, 256)]
    for i in g.choice(np.arange(1, 256), 24, replace=False):
        short[i] = short[g.integers(i)]
    longs = [g.integers(0, 2**32, long_len, dtype=np.uint64).astype(np.uint32)
             for _ in range(5)]
    longs += [longs[0], longs[3], longs[0]]
    docs = list(short)
    for k, pos in enumerate(sorted(g.choice(257, 8, replace=False)), start=0):
        docs.insert(int(pos) + k, longs[k])
    ed = port.ExactDedup(device=device)
    t0 = time.perf_counter()
    mask = launched(port, 1 + len(longs), lambda: ed.add_documents(docs),
                    "add_documents")
    wall_s = time.perf_counter() - t0
    # the same routing on host fingerprints
    th = port.TreeHasher(port.TreeSpec(seed=ed._seed), device=device)
    is_long = [len(d) >= 1 << 12 for d in docs]
    fps = np.zeros(len(docs), np.uint64)
    idx = [i for i, lng in enumerate(is_long) if not lng]
    fps[idx] = ed.hasher.hash_batch([docs[i] for i in idx], backend="host")[:, 0]
    for i, lng in enumerate(is_long):
        if lng:
            fps[i] = th.digest_host(docs[i])
    seen, want = set(), np.zeros(len(docs), bool)
    for i, fp in enumerate(map(int, fps)):
        if fp not in seen:
            seen.add(fp)
            want[i] = True
    check(np.array_equal(mask, want), "add_documents != host-fingerprint routing")
    check(int((~mask[np.array(is_long)]).sum()) == 3, "long repeats not rejected")
    rec = {"docs": len(docs), "long_docs": len(longs), "admitted": int(mask.sum()),
           "launches": 1 + len(longs), "seconds": wall_s,
           "tokens": int(sum(len(d) for d in docs)), "card": card}
    print(f"add_documents: {len(docs)} docs ({len(longs)} of 2^20 words), "
          f"{rec['tokens']} tokens in {wall_s:.3f} s; admitted {rec['admitted']}; "
          f"mask == host-fingerprint routing ({card})")
    return rec


# --------------------------------------------------------------------------
# phase 8: sharded admission
# --------------------------------------------------------------------------

SHARDS = (1, 4)


def logical(port: Port, device, D: int):
    """A mesh of D logical shards of the card."""
    return port.data_mesh(device=device, n_shards=D)


def sharded_pure(port: Port, device, pure: dict):
    """8a: `ShardedHasher` over D logical shards at phase 3's pure shape
    (B 65,536 x N 1,024, K 9): `__call__`, `probe_indices(m)` and
    `shard_ids(64)` == phase 3's single-device outputs, D launches a call.
    Returns the record and a closure that times `__call__` (run once the
    phase's launches are read)."""
    torch = port.torch
    toks, m = pure["tokens"], pure["m"]
    rec, hashers = {}, {}
    for D in SHARDS:
        mesh = logical(port, device, D)
        for family in ("multilinear", "gf_multilinear"):
            ref = pure[family]
            sh = ref["hasher"].sharded(mesh)
            for name, fn, want in (
                    ("__call__", lambda: sh(toks), ref["slots"]),
                    ("probe_indices", lambda: sh.probe_indices(toks, m),
                     ref["probes"]),
                    ("shard_ids", lambda: sh.shard_ids(toks, 64), ref["shards"])):
                got = launched(port, D, fn, f"8a {family} D={D} {name}")
                check(torch.equal(got, want), f"8a {family} D={D}: {name} "
                      "!= phase 3's single-device output")
            hashers[f"{family}/D{D}"] = sh
            rec[f"{family}/D{D}"] = {"launches_per_call": D}
    print(f"8a: __call__, probe_indices(m={m}), shard_ids(64) over 1 and 4 "
          "logical shards == phase 3's outputs, D launches a call")

    def measure():
        for label, sh in hashers.items():
            rec[label]["call_ms"] = timed(port, lambda: sh(toks), 5)
        print("8a __call__ ms: " + json.dumps(
            {k: v["call_ms"] for k, v in rec.items()}))
    return rec, measure


def earlier_repeats(batches) -> list:
    """Per batch: the planted repeats of a document offered in an EARLIER
    batch (a repeat of one earlier in the same batch admits under the
    sharded filter's pre-batch contract, as under the host filter's
    pre-batch `contains_batch`)."""
    seen, out = set(), []
    for docs, planted in batches:
        keys = [d.tobytes() for d in docs]
        out.append(np.array([bool(p) and k in seen for p, k in zip(planted, keys)]))
        seen.update(keys)
    return out


def sharded_bloom(port: Port, device, batches, card: str,
                  n_items: int = 10**8) -> dict:
    """8b: `DeviceShardedBloom(n_items, fp_rate=1e-3)` over D in {1, 4}
    logical shards x the routed, all_gather and host transports (family
    multilinear), the carry-less family at routed D 4, and a routed D 4
    filter whose buckets overflow (capacity_factor 0.5, slack 0), one at a
    time over the batches: each `check_and_add_batch` verdict == the
    negation of a host `BloomFilter`'s pre-batch `contains_batch`, every
    planted repeat of an earlier batch rejected, the final words == the
    host filter's bits; D launches a call (2D when it falls back). The
    launch part of a routed add and contains runs under
    `torch.cuda.set_sync_debug_mode("error")`: no host sync."""
    torch = port.torch
    docs = [d for d, _ in batches]
    earlier = earlier_repeats(batches)
    n_docs = sum(len(d) for d in docs)
    host = {}
    for family in ("multilinear", "gf_multilinear"):
        bf = port.BloomFilter(n_items=n_items, fp_rate=1e-3, family=family,
                              device=device)
        want, t0 = [], time.perf_counter()
        for i, d in enumerate(docs):
            want.append(~launched(port, 1, lambda: bf.contains_batch(d),
                                  f"8b host {family} contains {i}"))
            launched(port, 1, lambda: bf.add_batch(d), f"8b host {family} add {i}")
        dt = time.perf_counter() - t0
        host[family] = (want, torch.from_numpy(bf.bits.view(np.int64)).to(device))
        print(f"8b host BloomFilter/{family}: contains + add, {n_docs} docs in "
              f"{dt:.3f} s: {n_docs / dt} docs/s ({card})")
        del bf
    # the launch part reads nothing back
    f = port.DeviceShardedBloom(n_items=n_items, fp_rate=1e-3,
                                mesh=logical(port, device, 4))
    st = f._stage(docs[0])
    torch.cuda.synchronize()

    def guarded():
        torch.cuda.set_sync_debug_mode("error")
        try:
            f._add_staged(st)
            return f._verdict_staged(st, insert=False)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    out = launched(port, 8, guarded, "8b guarded launch part").cpu().numpy()
    check(bool(out[:st.B].all()) and not out[st.Bp:].any(),
          "8b: a routed add's documents are not all present")
    print("8b: routed add + contains launch parts (D 4) ran under "
          "sync_debug_mode('error'): no host sync")
    del f, st, out
    tiny = port.ProbeTransport("routed", capacity_factor=0.5, capacity_slack=0)
    runs = ([("multilinear", kind, D) for kind in ("routed", "all_gather", "host")
             for D in SHARDS]
            + [("gf_multilinear", "routed", 4), ("multilinear", tiny, 4)])
    rec = {}
    for family, kind, D in runs:
        label = (f"{family}/{getattr(kind, 'kind', kind)}/D{D}"
                 + ("/overflow" if kind is tiny else ""))
        f = port.DeviceShardedBloom(n_items=n_items, fp_rate=1e-3,
                                    mesh=logical(port, device, D),
                                    probe_transport=kind, family=family)
        check(f.m == bloom_m(n_items) and f.k == 9, f"8b {label}: sizing")
        want, words = host[family]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, d in enumerate(docs):
            fb = f.stats["overflow_fallbacks"]
            v = launched(port, lambda: D * (1 + f.stats["overflow_fallbacks"] - fb),
                         lambda: f.check_and_add_batch(d), f"8b {label} batch {i}")
            check(np.array_equal(v, want[i]), f"8b {label} batch {i}: verdict "
                  "!= the host filter's pre-batch contains_batch")
            check(not v[earlier[i]].any(),
                  f"8b {label} batch {i}: a planted repeat was admitted")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(torch.equal(f.words(), words),
              f"8b {label}: final words != the host filter's bits")
        falls = f.stats["overflow_fallbacks"]
        check((falls > 0) == (kind is tiny),
              f"8b {label}: overflow_fallbacks {falls}")
        rec[label] = {"docs": n_docs, "seconds": dt, "docs_per_s": n_docs / dt,
                      "bytes_moved_per_call": f.bytes_moved / len(docs),
                      "overflow_fallbacks": falls, "m": f.m, "k": f.k,
                      "m_local": f.m_local, "card": card}
        print(f"8b {label}: {n_docs} docs in {dt:.3f} s: {n_docs / dt} docs/s, "
              f"{f.bytes_moved / len(docs)} bytes moved a call, "
              f"overflow_fallbacks {falls} ({card})")
        del f
        torch.cuda.empty_cache()
    for D in SHARDS:
        r, a = rec[f"multilinear/routed/D{D}"], rec[f"multilinear/all_gather/D{D}"]
        print(f"8b D{D}: routed / all_gather bytes a call = "
              f"{r['bytes_moved_per_call'] / a['bytes_moved_per_call']}")

    def measure():
        """Where a routed D 4 call's time goes: host staging alone, the
        launch part (events around a read-only verdict launch), and the
        card's busy time over the 8 calls (torch.profiler)."""
        f = port.DeviceShardedBloom(n_items=n_items, fp_rate=1e-3,
                                    mesh=logical(port, device, 4))
        t0 = time.perf_counter()
        staged = [f._stage(d) for d in docs]
        torch.cuda.synchronize()
        stage_ms = 1e3 * (time.perf_counter() - t0) / len(docs)
        launch_ms = timed(port, lambda: f._verdict_staged(staged[0], insert=False), 10)
        del staged
        busy = device_busy(port, lambda: [f.check_and_add_batch(d) for d in docs])
        out = {"stage_ms_per_batch": stage_ms, "launch_part_ms": launch_ms}
        if busy is not None:
            out.update({"profiled_wall_ms_per_batch": busy["wall_ms"] / len(docs),
                        "device_kernel_ms_per_batch": busy["kernel_ms"] / len(docs),
                        "device_copy_ms_per_batch": busy["copy_ms"] / len(docs),
                        "device_idle_share": busy["idle_share"]})
        rec["multilinear/routed/D4"]["breakdown"] = out
        print("8b routed D4 breakdown: " + json.dumps(out) + f" ({card})")
        del f
        torch.cuda.empty_cache()
    return rec, measure


def service_launches(svc, backends, D: int, calls: bool):
    """A function of the engine launches an `AdmissionService` call makes,
    from its counters read before it and after: per `admit_batch` the
    router and the L1 `contains_batch` (one each) and one L1 `add_batch` a
    shard group; D per executed shard-filter call and per overflow replay."""
    def snap():
        return (svc.stats["l2_calls"],
                sum(b.calls[op] for b in backends
                    for op in ("admit", "contains", "add")),
                sum(b.filt.stats["overflow_fallbacks"] for b in backends))
    before = snap()

    def n():
        after = snap()
        return (2 * calls + (after[0] - before[0]) * calls
                + D * (after[1] - before[1] + after[2] - before[2]))
    return n


def sharded_service(port: Port, device, batches, card: str,
                    n_items: int = 10**8) -> tuple:
    """8c: `AdmissionService.over_bloom_shards(4, n_items, mesh=<4 logical
    shards>)` (L1 2^20 items) over the batches: two fault-free services, and
    twice the same seeded `FaultPlan` (shard 1 down for its calls 1-3,
    20 % timeouts and 10 % corrupt replies) with `fail_open`. After
    `reconcile_all()` every shard filter's words == the fault-free run's,
    and the two faulty runs give identical `events` and `stats`. Returns
    the record and the two fault-free services (for 8d)."""
    torch = port.torch
    mesh, D = logical(port, device, 4), 4
    docs = [d for d, _ in batches]
    n_docs = sum(len(d) for d in docs)

    def run(plan):
        svc = port.AdmissionService.over_bloom_shards(
            4, n_items, mesh=mesh, l1_items=1 << 20, policy="fail_open")
        backends = svc.transport.backends
        if plan is not None:
            svc.transport = port.FaultyTransport(svc.transport, plan, svc.clock)
        t0 = time.perf_counter()
        admitted = 0
        for i, d in enumerate(docs):
            admitted += int(launched(
                port, service_launches(svc, backends, D, True),
                lambda: svc.admit_batch(d), f"8c batch {i}").sum())
        ok = launched(port, service_launches(svc, backends, D, False),
                      svc.reconcile_all, "8c reconcile_all")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(ok and not svc.degraded, "8c: the service did not recover")
        return svc, backends, [b.filt.words() for b in backends], admitted, dt

    healthy, twin = run(None), run(None)
    check(all(torch.equal(a, b) for a, b in zip(healthy[2], twin[2])),
          "8c: two fault-free services differ")
    faulty = []
    for _ in range(2):
        plan = port.FaultPlan(SEED, events=[port.FaultEvent(
            "crash", shard=1, at=1, until=4)], p_timeout=0.2, p_corrupt=0.1)
        svc, _, words, admitted, dt = run(plan)
        check(all(torch.equal(a, b) for a, b in zip(words, healthy[2])),
              "8c: reconciled shard words != the fault-free run's")
        faulty.append((list(svc.events), dict(svc.stats), admitted, dt))
        del svc, words
        torch.cuda.empty_cache()
    check(faulty[0][0] == faulty[1][0] and faulty[0][1] == faulty[1][1],
          "8c: the same fault plan gave different events or stats")
    stats = faulty[0][1]
    check(stats["breaker_opens"] > 0 and stats["reconciled_items"] > 0
          and stats["timeouts"] > 0 and stats["corrupt_replies"] > 0,
          f"8c: the plan injected too little: {stats}")
    rec = {"docs": n_docs, "healthy_seconds": healthy[4],
           "healthy_docs_per_s": n_docs / healthy[4],
           "healthy_admitted": healthy[3], "healthy_stats": dict(healthy[0].stats),
           "faulty_seconds": faulty[0][3], "faulty_docs_per_s": n_docs / faulty[0][3],
           "faulty_admitted": faulty[0][2], "faulty_stats": stats,
           "events": len(faulty[0][0]), "card": card}
    print(f"8c: {n_docs} docs through 4 service shards x 4 logical shards: "
          f"fault-free {n_docs / healthy[4]} docs/s, under the plan "
          f"{n_docs / faulty[0][3]} docs/s ({card}); {len(faulty[0][0])} "
          f"events, identical in two runs; stats {stats}; reconciled words "
          "== the fault-free run's")
    return rec, healthy[0], twin[0]


def lifted_routes(port: Port, device, batches, tree_root: int, svc_a, svc_b,
                  card: str, n_words: int = 1 << 26,
                  approx_items: int = 10**7) -> dict:
    """8d: the routes this slice lifted, once each, over 4 logical shards:
    `TreeHasher(mesh=)` over phase 7a's carry-less words == phase 7a's
    root; `ExactDedup(mesh=, approx_items=)` over two batches: fingerprints
    == the unsharded ones and verdicts == a host `BloomFilter` over the
    same 2-word keys; `HashPipeline(mesh=, admission=8c's service)` ==
    `HashPipeline(admission=its fault-free twin)` without a mesh."""
    torch = port.torch
    mesh, D = logical(port, device, 4), 4
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    x = torch.randint(-2**31, 2**31, (n_words,), generator=gen,
                      dtype=torch.int32, device=device)
    th = port.TreeHasher(port.TreeSpec(family="gf_multilinear"), mesh=mesh)
    fp = launched(port, D, lambda: th.fingerprint_array(x), "8d TreeHasher(mesh=)")
    check(fp == tree_root, f"8d: sharded tree root {fp:#x} != phase 7a's "
          f"{tree_root:#x}")
    del x
    ed = port.ExactDedup(mesh=mesh, approx_items=approx_items)
    plain = port.ExactDedup(device=device)
    bf = port.BloomFilter(n_items=approx_items, fp_rate=1e-3,
                          seed=ed._seed ^ 0xB100, device=device)
    earlier = earlier_repeats(batches[:2])
    for i in (0, 1):
        d = batches[i][0]
        fps = launched(port, 1, lambda: plain._fingerprints(d), "8d fingerprints")
        rows = [np.array([fp & 0xFFFFFFFF, fp >> 32], np.uint32)
                for fp in map(int, fps)]
        want = ~launched(port, 1, lambda: bf.contains_batch(rows), "8d host contains")
        launched(port, 1, lambda: bf.add_batch(rows), "8d host add")
        got = launched(port, 2 * D, lambda: ed.check_and_add_batch(d),
                       "8d ExactDedup(mesh=, approx_items=)")
        check(np.array_equal(got, want), "8d: approximate dedup verdicts != "
              "the host filter's over the same keys")
        check(not got[earlier[i]].any(), "8d: a planted repeat was admitted")
    d = batches[2][0]
    check(np.array_equal(
        launched(port, D, lambda: ed._fingerprints(d), "8d sharded fingerprints"),
        launched(port, 1, lambda: plain._fingerprints(d), "8d fingerprints")),
          "8d: sharded fingerprints != unsharded")
    cfg = port.PipelineConfig(seq_len=2048, batch_size=8, n_shards=4, shard_id=0)
    pa = port.HashPipeline(cfg, mesh=mesh, admission=svc_a)
    pb = port.HashPipeline(cfg, admission=svc_b, device=device)
    d = batches[4][0]
    backends = svc_a.transport.backends, svc_b.transport.backends
    na, nb = (service_launches(s, b, D, True) for s, b in zip((svc_a, svc_b), backends))
    ra = launched(port, lambda: D + na(), lambda: pa.admit_batch(d),
                  "8d HashPipeline(mesh=, admission=)")
    rb = launched(port, lambda: 1 + nb(), lambda: pb.admit_batch(d),
                  "8d HashPipeline(admission=)")
    check(ra == rb and pa.stats == pb.stats and svc_a.stats == svc_b.stats,
          "8d: sharded pipeline routes != unsharded")
    rec = {"tree_root": f"{fp:#018x}", "approx_dedup_docs": 2 * len(batches[0][0]),
           "pipeline": pa.stats, "card": card}
    print(f"8d: TreeHasher(mesh=4) root {fp:#018x} == phase 7a; ExactDedup("
          f"mesh=, approx_items={approx_items}) == host filter over 2-word "
          f"keys; HashPipeline(mesh=, admission=) routes {pa.stats} == "
          "unsharded")
    return rec


# --------------------------------------------------------------------------
# phase 9: the quality battery
# --------------------------------------------------------------------------

def _rk_ref(row) -> int:
    h = 0
    for t in row:
        h = (h * 31 + int(t)) & 0xFFFFFFFF
    return h


def _sax_ref(row) -> int:
    h = 0
    for t in row:
        h ^= ((h << 5) + (h >> 2) + int(t)) & 0xFFFFFFFF
        h &= 0xFFFFFFFF
    return h


def _fnv_ref(row) -> int:
    h = 2166136261
    for t in row:
        for shift in (0, 8, 16, 24):
            h = ((h ^ ((int(t) >> shift) & 0xFF)) * 16777619) & 0xFFFFFFFF
    return h


def _nh_ref(row, keys) -> int:
    acc = 0
    for i in range(0, len(row), 2):
        acc += (((int(keys[i]) + int(row[i])) & 0xFFFFFFFF)
                * ((int(keys[i + 1]) + int(row[i + 1])) & 0xFFFFFFFF))
    return acc & ((1 << 64) - 1)


def battery_adapters(port: Port, device, rows: int = 4096, n_sub: int = 64):
    """9a: every battery family and control on `rows` rows of keygen's
    streams, the card's result `torch.equal` the CPU's (the streams too);
    then `core.baselines` and the whole-string `core.gf` hashes on the card
    against Python-int oracles on an `n_sub`-row subsample."""
    torch, q = port.torch, port.quality
    keygen, runner = q.keygen, q.runner
    N = runner.N_TOKENS
    for fam in q.families.battery_families():
        key = keygen.battery_key(keygen.QUALITY_SEED, zlib.crc32(fam.name.encode()))
        kw = fam.key_words(N)
        ins = {dev: (keygen.token_batch(key, rows, N, dev),
                     *keygen.key_planes(key, rows, kw, dev))
               for dev in (device, "cpu")}
        check(all(torch.equal(a.cpu(), b) for a, b in zip(ins[device], ins["cpu"])),
              f"9a {fam.name}: keygen streams on the card != the CPU's")
        got, want = fam.fn(*ins[device]), fam.fn(*ins["cpu"])
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              f"9a {fam.name}: adapter on the card != on the CPU")
    g = np.random.Generator(np.random.Philox(key=np.uint64(SEED)))
    toks = g.integers(0, 2**32, (rows, 16), dtype=np.uint64).astype(np.uint32)
    keys = g.integers(0, 2**32, 17, dtype=np.uint64).astype(np.uint32)
    t = torch.from_numpy(toks.astype(np.int64)).to(device)
    b = port.baselines
    sub = toks[:n_sub]
    for name, fn, ref in (("rabin_karp", b.rabin_karp, _rk_ref),
                          ("sax", b.sax, _sax_ref), ("fnv1a", b.fnv1a, _fnv_ref)):
        out = fn(t)
        check(out.device == t.device and out[:n_sub].tolist() == [ref(r) for r in sub],
              f"9a baselines.{name} on the card != its Python-int oracle")
    hi, lo = b.nh(t, keys[:16])
    nh = [_nh_ref(r, keys) for r in sub]
    check(hi[:n_sub].tolist() == [v >> 32 for v in nh]
          and lo[:n_sub].tolist() == [v & 0xFFFFFFFF for v in nh],
          "9a baselines.nh on the card != its Python-int oracle")
    z = b.Zobrist(16, 256, device=device)
    ztoks = toks & 0xFF
    table = z.table.cpu().numpy()
    zref = np.bitwise_xor.reduce(table[np.arange(16), ztoks[:n_sub]], axis=1)
    check(z(torch.from_numpy(ztoks.astype(np.int64)).to(device))[:n_sub].tolist()
          == zref.tolist(), "9a baselines.Zobrist on the card != numpy gather")
    gfm = port.gf
    for name, fn, ref in (("gf_multilinear", gfm.gf_multilinear, gfm.gf_multilinear_ref),
                          ("gf_multilinear_hm", gfm.gf_multilinear_hm,
                           gfm.gf_multilinear_hm_ref)):
        out = fn(t, keys)
        check(out[:n_sub].tolist() == [ref(r, keys) for r in sub],
              f"9a core.gf.{name} on the card != its Python-int oracle")
    print(f"9a: {len(q.families.battery_families())} battery adapters on "
          f"{rows} rows (card == CPU, keygen streams too); rabin_karp, sax, "
          f"fnv1a, nh, Zobrist and core.gf's whole-string hashes on {rows} x 16 "
          f"== Python-int oracles on {n_sub} rows")


def probe_path_launches(port: Port, device, card: str):
    """9b: the battery's probe path at the committed report's size (B 2^21 x
    N 4, K 2, 64-bit surface, fixed length): each `probe_indices` call ==
    its plain version, one launch a call, and D launches a call of its
    `ShardedHasher` twins (== the unsharded output): the default mesh the
    battery's own probe path uses (every visible card) and 4 logical shards
    of the card, so rows really split. Returns the rows and a closure that
    times them (run once the phase's launches are read)."""
    torch, q = port.torch, port.quality
    keygen, runner = q.keygen, q.runner
    B, N = runner.FULL_KEYS, runner.N_TOKENS
    toks = keygen.token_batch(keygen.battery_key(keygen.QUALITY_SEED, 7), B, N,
                              device).to(torch.int32)
    code = torch.full((B,), -(N + 1), dtype=torch.int32, device=device)
    rows, calls = [], []
    for family in runner.probe_path_families():
        h = port.Hasher.from_spec(port.HashSpec(
            family=family, n_hashes=2, out_bits=64, variable_length=False,
            seed=keygen.QUALITY_SEED), max_len=N, device=device)
        sh, sh4 = h.sharded(), h.sharded(mesh=logical(port, device, 4))
        D, W = sh.n_shards, h._required_width(N)
        for m in (*runner.MODULI_SMALL, runner.MODULUS_HUGE):
            plan = port.limbs.ModPlan.for_modulus(m)
            idx = launched(port, 1, lambda: h.probe_indices(toks, plan),
                           f"9b {family} probe_indices(m={m})")
            want = port.plain(family, toks, h.keys, code, mod_m=plan, width=W)[..., 0]
            check(torch.equal(idx, want), f"9b {family} m={m}: probe_indices "
                  "!= plain version")
            err = int((idx - want).abs().max().item())
            del want
            idx_sh = launched(port, D, lambda: sh.probe_indices(toks, plan),
                              f"9b {family} sharded probe_indices(m={m})")
            check(torch.equal(idx_sh, idx), f"9b {family} m={m}: sharded "
                  "probe_indices != unsharded")
            del idx_sh
            idx_sh = launched(port, 4, lambda: sh4.probe_indices(toks, plan),
                              f"9b {family} 4-shard probe_indices(m={m})")
            check(torch.equal(idx_sh, idx), f"9b {family} m={m}: probe_indices "
                  "on 4 logical shards != unsharded")
            del idx_sh
            name, lens = port.kernel_of(family), np.full(B, -(N + 1))
            b_ms, b_by = probe_bound(name, B, N, 2, lens)
            row = {"kernel": name, "family": family,
                   "shape": "battery-probe", "B": B, "N": N, "W": W, "K": 2,
                   "mod_m": m, "shards": D, "mesh4_shards": 4,
                   "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                   "engine_bytes_bound_ms": bound(name, B, N, W, 2, lens)[0],
                   "card": card}
            if name == "gf_multihash":
                row["design_floor_ms"], row["design_floor_by"] = design_floor(
                    B, N, W, 2, lens, bytes_ms=b_ms)
            rows.append(row)
            calls.append((row, lambda h=h, plan=plan: h.probe_indices(toks, plan),
                          lambda f=family, h=h, plan=plan, W=W: port.plain(
                              f, toks, h.keys, code, mod_m=plan, width=W)))
    print(f"9b: probe_indices at B {B} x N {N} (K 2, m in "
          f"{[*runner.MODULI_SMALL, runner.MODULUS_HUGE]}) == plain versions, "
          f"one launch a call; the sharded twins (D = {D} and 4 logical "
          f"shards) == it, D launches a call")

    def measure():
        for row, fn, plain in calls:
            row["ms"] = timed(port, fn, 20)
            row["graph_ms"] = timed_graph(port, fn, 20)
            row["plain_ms"] = timed(port, plain, 2)
            print(json.dumps(row))
    return rows, measure


def full_battery(port: Port, device, card: str) -> tuple[dict, dict]:
    """9c: `run_battery` at the committed report's sizes on the card; the
    report must reproduce QUALITY.json (every verdict, every statistic
    within compare_reports' rtol), with both controls flagged and every
    shipped family passing. Times each family."""
    torch, runner = port.torch, port.quality.runner
    committed = json.loads((ROOT / "QUALITY.json").read_text())
    marks = [time.perf_counter()]

    def progress(line: str) -> None:
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        print(f"  {marks[-1] - marks[-2]:.3f} s {line}", flush=True)

    report = runner.run_battery(committed["n_keys"], committed["avalanche_keys"],
                                committed["seed"], progress=progress,
                                device=device)
    seconds = marks[-1] - marks[0]
    names = [*report["families"], "probe_path"]
    per = {n: marks[i + 1] - marks[i] for i, n in enumerate(names)}
    problems = runner.compare_reports(committed, report, verdicts_only=False)
    for p in problems:
        print(f"  DRIFT: {p}")
    check(problems == [], f"9c: the battery drifted from QUALITY.json "
          f"({len(problems)} problem(s))")
    check(report["self_validated"] and report["all_shipped_pass"],
          "9c: a control passed or a shipped family failed")
    bic = {n: (next(m["value"] for m in f["metrics"] if m["name"] == "bic_max_corr"),
               next(m["value"] for m in committed["families"][n]["metrics"]
                    if m["name"] == "bic_max_corr"))
           for n, f in report["families"].items()}
    exact = sum(m == c for n, f in report["families"].items()
                for m, c in zip(f["metrics"], committed["families"][n]["metrics"]))
    n_metrics = sum(len(f["metrics"]) for f in report["families"].values())
    print(f"9c: run_battery(n_keys={committed['n_keys']}, avalanche_keys="
          f"{committed['avalanche_keys']}, seed={committed['seed']:#x}) on the "
          f"card reproduces QUALITY.json (compare_reports == []); "
          f"{exact}/{n_metrics} family metrics identical to the committed "
          f"records; {seconds:.3f} s; card {card}")
    return {"seconds": seconds, "seconds_per_family": per,
            "metrics_identical": exact, "metrics": n_metrics,
            "bic_max_corr_vs_committed": bic, "card": card}, report


# --------------------------------------------------------------------------
# phase 10: serving the dense-attention models
# --------------------------------------------------------------------------

SERVE_ARCH = "mistral_nemo_12b"
# rtol = atol of the reference's own test_decode_matches_forward
PARITY_TOL = 2e-3
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_TREE_WORDS, SERVE_NEW = 8, 2048, 512, 32
SERVE_ADMISSION_ITEMS = 10**6
# prompt lengths: the three measured ones first, then 25 drawn in [64, 1500]
SERVE_LENS = (1500, 64, 512)
SERVE_REPEATS = (2, 9, 0, 17)  # requests 28-31 repeat these (the 4th wave)
# 11b: 16 requests a model: the 3 measured lengths, 11 drawn, 2 repeats of
# first-wave prompts (the second wave's last two)
NEW_11, DRAWN_11, REPEATS_11 = 16, 11, (2, 0)


@contextlib.contextmanager
def f32_products(torch):
    """Full-f32 products on the card (TF32 off for matmuls and cuDNN)."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


def agree(port, got, want, what: str) -> float:
    """Max abs difference of two float tensors; fails the run past
    rtol = atol = PARITY_TOL."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    check(bool(port.torch.isfinite(got).all()), f"{what}: non-finite values")
    check(port.torch.allclose(got, want, rtol=PARITY_TOL, atol=PARITY_TOL),
          f"{what}: max abs err {float((got - want).abs().max()):.3e} past "
          f"rtol = atol = {PARITY_TOL}")
    return float((got - want).abs().max())


def model_parity(port: Port, device, card: str, name: str = SERVE_ARCH,
                 n_layers: int | None = 2, tag: str = "10a") -> dict:
    """10a: `mistral_nemo_12b` at its published width with n_layers cut to 2,
    float32 with TF32 off; one seeded set of weights, drawn on the card,
    and its copy on the CPU. Prefill logits of a (2, 33) batch, the next token's
    decode logits and the loss on the card == on the CPU; on the card,
    prefill(32) + decode(1) == the full forward's last logits. Phase 11a
    runs the same for its models (`name`; n_layers None: a SMOKE config,
    whole). An encoder-decoder model has its encoder cut to n_layers too and
    takes (2, encoder_positions, d_model) frames with every call; its full
    forward is `encode` then `decoder_forward`. An MoE model's prefill(32) +
    decode(1) check runs at the capacity_factor 8 of the reference's own
    decode test, so no token drops in either (drops differ between 33 and
    32 tokens by design)."""
    import copy
    import dataclasses

    torch = port.torch
    if n_layers is None:
        cfg = dataclasses.replace(port.get_config(name, smoke=True), dtype="float32")
        print(f"{tag}: {cfg.name} (the SMOKE config of {name}), whole, float32")
    else:
        full = port.get_config(name)
        cuts = {"n_layers": n_layers}
        if full.n_encoder_layers:
            cuts["n_encoder_layers"] = n_layers
        cfg = dataclasses.replace(full, **cuts, dtype="float32")
        print(f"{tag} reduced: {name} " + ", ".join(
            f"{k} {getattr(full, k)} -> {v}" for k, v in cuts.items())
            + f" (full width: d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}), float32")
    api = port.build_model(cfg)
    t0 = time.perf_counter()
    on_card = api.init(torch.Generator(device).manual_seed(SEED))
    cpu = copy.deepcopy(on_card).to("cpu")  # Module.to moves in place
    init_s = time.perf_counter() - t0
    g = np.random.default_rng(SEED)
    extra = {}  # what every call of an encoder-decoder model also takes
    if cfg.n_encoder_layers:
        extra["frames"] = g.normal(
            size=(2, cfg.encoder_positions, cfg.d_model)).astype(np.float32)
    toks = g.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    n_loss = 33 - 33 % min(cfg.ce_chunk, 33)  # a multiple of the CE chunk
    batch = {**extra, "tokens": toks[:, :n_loss],
             "labels": g.integers(0, cfg.vocab_size, (2, n_loss)).astype(np.int32)}

    def forward(params, t, ex):
        if "frames" in ex:
            return port.encdec.decoder_forward(
                params, cfg, t, mode="train",
                enc_out=port.encdec.encode(params, cfg, ex["frames"]))[0]
        return port.transformer.forward(params, cfg, t, mode="train")[0]

    err = {}
    with f32_products(torch):
        (lc, cc), (lg, cg) = (api.prefill(p, {**extra, "tokens": toks}, cache_len=64)
                              for p in (cpu, on_card))
        err["prefill"] = agree(port, lg, lc, f"{tag} prefill logits")
        nxt = lc.argmax(-1, keepdim=True).int().numpy()
        (dc, _), (dg, _) = (api.decode_step(p, c, nxt, 33)
                            for p, c in ((cpu, cc), (on_card, cg)))
        err["decode"] = agree(port, dg, dc, f"{tag} decode logits")
        (Lc, _), (Lg, _) = (api.loss(p, batch) for p in (cpu, on_card))
        err["loss"] = agree(port, Lg, Lc, f"{tag} loss")
        if cfg.moe:
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
            api = port.build_model(cfg)
        t = torch.from_numpy(toks).to(device)
        ex = {k: torch.from_numpy(v).to(device) for k, v in extra.items()}
        hidden = forward(on_card, t, ex)
        full = (hidden[:, -1] @ port.transformer.unembed_matrix(
            on_card, cfg, hidden.dtype)).float()
        _, caches = api.prefill(on_card, {**ex, "tokens": t[:, :32]}, cache_len=33)
        last, _ = api.decode_step(on_card, caches, t[:, 32:], 32)
        err["decode_vs_forward"] = agree(port, last, full,
                                         f"{tag} prefill(32) + decode != forward")
    del on_card, caches, cg, ex
    torch.cuda.empty_cache()
    n = sum(p.numel() for p in cpu.parameters())
    rec = {"config": (cfg.name if n_layers is None else f"{name}, " + ", ".join(
                          f"{k} {v}" for k, v in cuts.items()))
                     + ", float32, TF32 off",
           "params": n, "batch": [2, 33], "tolerance": PARITY_TOL,
           "max_abs_err": err, "init_and_copy_s": init_s, "loss": float(Lg),
           "card": card}
    if extra:
        rec["frames"] = list(extra["frames"].shape)
    print(f"{tag}: {n} parameters; card == CPU within {PARITY_TOL}: "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))
    return rec


def serve_prompts(vocab: int, n_drawn: int = 25, repeats=SERVE_REPEATS) -> list:
    """The measured lengths (SERVE_LENS) and `n_drawn` drawn in [64, 1500],
    then exact repeats of the prompts at `repeats`."""
    g = np.random.default_rng(SEED + 10)
    lens = list(SERVE_LENS) + [int(n) for n in g.integers(64, 1501, n_drawn)]
    prompts = [g.integers(0, vocab, n).astype(np.int32) for n in lens]
    return prompts + [prompts[i].copy() for i in repeats]


def serve_launches(prompts, admission: bool) -> int:
    """The engine launches (kernel 1) a `submit_all` of `prompts` makes,
    predicted from the request schedule: one for the short prompts' keys,
    one tree leaf launch per long prompt (repeats included: each request is
    fingerprinted), and with admission one call per wave of 8 requests (8
    slots; the first before the first wave, each later one at its wave's
    first tick; the repeats are the last wave's last ones) of 4 launches
    each: the router's hash, the L1 check, the one L2 shard's filter call
    (D = 1 shard: one card) and the L1 add."""
    n_long = sum(len(p) >= SERVE_TREE_WORDS for p in prompts)
    n_short = len(prompts) - n_long
    waves = -(-len(prompts) // SERVE_SLOTS)
    return (n_short > 0) + n_long + (4 * waves if admission else 0)


def host_key(eng, prompt) -> int:
    """A prompt's key from its host twin: the tree's `digest_host` at or
    past `tree_prompt_words`, else the prefix hasher's numpy path."""
    toks = prompt.astype(np.uint32)
    if len(toks) >= eng.tree_prompt_words:
        return eng._tree_hasher().digest_host(toks)
    return int(eng._prefix_hasher.hash_batch([toks], backend="host")[0, 0])


def admission_vs_host(port: Port, device, svc, prompts, reqs, tag: str = "10b"):
    """The engine's admission verdicts and its filters' final words == host
    `BloomFilter`s (hashing on the CPU, the kernel's plain version) given
    the same waves of SERVE_SLOTS requests: a wave's L1 hits are rejected,
    its other rows take the L2 filter's pre-batch verdict and are added to
    both filters (the service's rule, `AdmissionService._decide_batch`)."""
    torch = port.torch
    l2 = svc.transport.backends[0].filt
    l1h = port.BloomFilter(n_items=4096, fp_rate=1e-3, seed=svc.seed ^ 0x11F1,
                           device="cpu")
    l2h = port.BloomFilter(n_items=SERVE_ADMISSION_ITEMS, fp_rate=1e-3,
                           seed=0xB100, device="cpu")
    check((l1h.m, l1h.k, l2h.m, l2h.k) == (svc.l1.m, svc.l1.k, l2.m, l2.k),
          f"{tag} admission: filter sizing")
    want = []
    for w in range(0, len(prompts), SERVE_SLOTS):
        rows = [p.astype(np.uint32) for p in prompts[w:w + SERVE_SLOTS]]
        v = ~l1h.contains_batch(rows)
        miss = [r for r, ok in zip(rows, v) if ok]
        if miss:
            v[v] = ~l2h.contains_batch(miss)
            l2h.add_batch(miss)
            l1h.add_batch(miss)
        want += v.tolist()
    check([r.admitted for r in reqs] == want,
          f"{tag} admission: verdicts != the host filters' given the same waves")
    check(torch.equal(l2.words(), torch.from_numpy(l2h.bits.view(np.int64)).to(device))
          and np.array_equal(svc.l1.bits, l1h.bits),
          f"{tag} admission: final words != the host filters' bits")


def serve_runs(port: Port, device, tag: str, api, params, prompts, n_repeats: int,
               n_new: int, admissions=(False, True)):
    """`ServeEngine(n_slots=8, max_seq=2048, tree_prompt_words=512)` over
    `prompts` (the last `n_repeats` exact repeats of first-wave prompts),
    `n_new` new tokens each, for each admission setting: every admitted
    request done with its tokens, the repeats prefix hits (plain) or
    rejections (admission), the engine launches == `serve_launches`, every
    prompt key == its host twin, with admission the verdicts and filter
    words == the host filters'. Returns the runs' records and the plain
    run's first-wave tokens."""
    vocab = api.cfg.vocab_size
    runs, first = {}, None
    for admission in admissions:
        label = "admission" if admission else "plain"
        eng = port.ServeEngine(api, params, n_slots=SERVE_SLOTS,
                               max_seq=SERVE_MAX_SEQ,
                               tree_prompt_words=SERVE_TREE_WORDS,
                               admission_items=SERVE_ADMISSION_ITEMS if admission else None,
                               device=device)
        reqs = [port.Request(i, p.copy(), max_new_tokens=n_new)
                for i, p in enumerate(prompts)]
        want = serve_launches(prompts, admission)
        t0 = time.perf_counter()
        launched(port, want, lambda: eng.submit_all(reqs), f"{tag} {label} submit_all")
        wall = time.perf_counter() - t0
        served = [r for r in reqs if r.admitted is not False]
        check(all(r.done for r in reqs)
              and all(len(r.out_tokens) == n_new for r in served)
              and all(0 <= t < vocab for r in served for t in r.out_tokens),
              f"{tag} {label}: a request not done or with a wrong token count")
        st = eng.stats
        if admission:
            check(st["admission_rejects"] == n_repeats
                  and st["admission_errors"] == 0 and st["prefix_hits"] == 0
                  and [r.req_id for r in reqs if r.admitted is False]
                  == list(range(len(prompts) - n_repeats, len(prompts))),
                  f"{tag} admission: stats {st}")
        else:
            check(st["prefix_hits"] == n_repeats
                  and st["prefills"] == len(prompts), f"{tag} plain: stats {st}")
        # every key the engine computed at the served shapes (the short
        # prompts' batched launch, each long prompt's tree leaf launch) ==
        # its host twin: the prefix hasher's numpy path, the tree's
        # `digest_host`
        tree = eng._tree_hasher()
        check(tree.spec == port.TreeSpec(seed=0x1E53),
              f"{tag} {label}: the tree route's spec {tree.spec}")
        want_keys = {host_key(eng, p) for p, r in zip(prompts, reqs)
                     if r.admitted is not False}
        check(len(want_keys) == len(prompts) - n_repeats
              and set(eng._prefix_logit_cache) == want_keys,
              f"{tag} {label}: the engine's prompt keys != their host twins")
        long_p = next(p for p in prompts if len(p) >= SERVE_TREE_WORDS)
        key = launched(port, 1, lambda: eng._prompt_key(long_p),
                       f"{tag} {label} tree route")
        check(key == host_key(eng, long_p),
              f"{tag}: a prompt of >= 512 tokens did not take the tree route")
        if admission:
            admission_vs_host(port, device, eng.admission, prompts, reqs, tag)
        n_tok = sum(len(r.out_tokens) for r in served)
        runs[label] = {"wall_s": wall, "launches": want, "stats": dict(st),
                       "generated_tokens": n_tok, "tokens_per_s": n_tok / wall,
                       "requests_per_s": len(reqs) / wall,
                       "ticks": st["ticks"]}
        print(f"{tag} {label}: {len(reqs)} requests in {wall:.3f} s, "
              f"{n_tok / wall:.1f} generated tokens/s, {len(reqs) / wall:.2f} "
              f"requests/s, {st['ticks']} ticks, {want} engine launches "
              f"(predicted and counted); stats {st}")
        if not admission:
            first = [r.out_tokens for r in reqs[:SERVE_SLOTS]]
        del eng
    return runs, first


def manual_wave(port: Port, device, tag: str, api, params, prompts, n_new: int,
                first):
    """The first wave's greedy tokens == a manual prefill + decode_step loop:
    each prompt prefilled alone, the 8 caches stacked on the slot axis,
    n_new - 1 lockstep steps at the engine's position (the wave's longest
    prompt). Returns the stacked caches and that position."""
    torch = port.torch
    wave = prompts[:SERVE_SLOTS]
    outs = [api.prefill(params, {"tokens": p[None]}, cache_len=SERVE_MAX_SEQ)
            for p in wave]
    toks = [[int(lg[0].argmax())] for lg, _ in outs]
    caches = {"blocks": {s: {k: torch.cat([c["blocks"][s][k] for _, c in outs], 1)
                             for k in outs[0][1]["blocks"][s]}
                         for s in outs[0][1]["blocks"]}}
    del outs
    pos = max(len(p) for p in wave)
    for step in range(n_new - 1):
        tok = torch.tensor([[t[-1]] for t in toks], dtype=torch.int32, device=device)
        lg, caches = api.decode_step(params, caches, tok, pos + step)
        for t, n in zip(toks, lg.argmax(-1).tolist()):
            t.append(n)
    check(toks == first, f"{tag}: the first wave's greedy tokens != a manual "
          "prefill + decode_step loop")
    return caches, pos


def serve_measure(port: Port, device, card: str, tag: str, rec: dict, api, params,
                  prompts, caches, at: int, profile_prefill: bool = True):
    """Prefill ms at 64, 512 and 1,500 tokens and a decode tick at batch 8
    (position `at`, free in `caches`), each warm (CUDA events), and
    torch.profiler's record of a decode tick (and of each prefill when
    `profile_prefill`), into `rec`."""
    torch = port.torch
    prefill_ms, profiles = {}, {}
    for T in (64, 512, 1500):
        t = next(torch.from_numpy(p[None]).to(device) for p in prompts
                 if len(p) == T)
        fn = lambda t=t: api.prefill(  # noqa: E731
            params, {"tokens": t}, cache_len=SERVE_MAX_SEQ)
        prefill_ms[T] = timed(port, fn, 3)
        if profile_prefill:
            profiles[f"prefill {T}"] = device_busy(port, fn, warm=True)
    tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32, device=device)
    step = lambda: api.decode_step(params, caches, tok, at)  # noqa: E731
    decode_ms = timed(port, step, 10)
    profiles["decode tick"] = device_busy(port, step, warm=True)
    rec["prefill_ms"] = prefill_ms
    rec["decode_tick_ms"] = decode_ms
    rec["decode_batch"] = SERVE_SLOTS
    rec["decode_position"] = at
    rec["profiles"] = profiles
    print(f"{tag}: prefill ms {prefill_ms}; decode tick {decode_ms:.3f} ms "
          f"(B {SERVE_SLOTS}, position {at}); card {card}")
    for name, prof in profiles.items():
        if prof is not None:
            del prof["names"]
        print(f"{tag} profile of one {name}: {json.dumps(prof)}")


def tick_read_bytes(cfg, params, B: int) -> int:
    """Bytes of weights a decode tick at batch B must read: every weight
    once, but of an untied embedding table the B rows gathered, and in an
    MoE layer only the experts B tokens can reach (min(E, B*k) of E)."""
    keep = (min(cfg.n_experts, B * cfg.experts_per_token) / cfg.n_experts
            if cfg.moe else 1.0)
    tied = "lm_head" not in params
    n = 0.0
    for name, p in params.named_parameters():
        b = p.numel() * p.element_size()
        if name == "embed.tok.w" and not tied:
            b = B * p.shape[1] * p.element_size()
        elif ".moe.w_" in name:
            b *= keep
        n += b
    return int(n)


def serve_family(port: Port, device, card: str, name: str, n_layers=None,
                 admissions=(False, True), *, tag: str | None = None,
                 n_drawn: int = DRAWN_11, repeats=REPEATS_11, n_new: int = NEW_11,
                 count_params: bool = False, profile_prefill: bool = False) -> dict:
    """One LM in bf16, weights drawn on the card (as published, or at full
    width with n_layers cut), served by `serve_runs` for each admission
    setting over the measured lengths, `n_drawn` prompts drawn in
    [64, 1500] and exact repeats of the first-wave prompts at `repeats`,
    `n_new` new tokens each; the first wave == a manual loop; then prefill
    and decode times, peak memory and a decode tick's profile (and each
    prefill's with `profile_prefill`). 11b serves each of its LMs so (16
    requests, 16 new tokens); 10b serves mistral_nemo_12b as published
    over 32 requests (28 drawn, 4 repeats, 32 new tokens), with
    `count_params` checking the drawn parameters against `param_count()`.
    The weights are freed before it returns."""
    import dataclasses

    torch = port.torch
    full = port.get_config(name)
    cfg = full if n_layers is None else dataclasses.replace(full, n_layers=n_layers)
    tag = tag or f"11b {name}"
    api = port.build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    if count_params:
        check(n_params == cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model,
              f"{tag}: {n_params} parameters != param_count() + the norm scales")
    prompts = serve_prompts(cfg.vocab_size, n_drawn, repeats)
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    rec = {"config": (f"{name} as published" if n_layers is None else
                      f"{name} at full width, n_layers {full.n_layers} -> {n_layers}")
                     + f": {cfg.n_layers} layers, d_model {cfg.d_model}, bfloat16",
           "params": n_params, "weights_gb": weights / 1e9, "init_s": init_s,
           "requests": len(prompts),
           "long_prompts": sum(len(p) >= SERVE_TREE_WORDS for p in prompts),
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "n_slots": SERVE_SLOTS, "max_seq": SERVE_MAX_SEQ, "card": card}
    print(f"{tag}: {rec['config']}, {n_params} parameters "
          f"({rec['weights_gb']:.3f} GB) drawn in {init_s:.3f} s")
    runs, first = serve_runs(port, device, tag, api, params, prompts,
                             len(repeats), n_new, admissions)
    caches, pos = manual_wave(port, device, tag, api, params, prompts, n_new, first)
    rec["runs"] = runs
    rec["first_wave_equals_manual_loop"] = True
    serve_measure(port, device, card, tag, rec, api, params, prompts, caches,
                  pos + n_new, profile_prefill=profile_prefill)
    rec["peak_memory_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    rec["held_before_gb"] = base / 1e9
    read = tick_read_bytes(cfg, params, SERVE_SLOTS)
    rec["decode_read_gb"] = read / 1e9
    rec["decode_bound_ms"] = read / HBM_BYTES_PER_S * 1e3
    rec["decode_all_weights_ms"] = weights / HBM_BYTES_PER_S * 1e3
    print(f"{tag}: first wave == manual loop; decode tick "
          f"{rec['decode_tick_ms']:.3f} ms against a weights-read bound of "
          f"{rec['decode_bound_ms']:.3f} ms ({rec['decode_read_gb']:.3f} GB; all "
          f"weights {rec['decode_all_weights_ms']:.3f} ms); peak memory "
          f"{rec['peak_memory_gb']:.3f} GB above the {base / 1e9:.3f} GB that "
          f"earlier phases hold; card {card}")
    del params, caches
    torch.cuda.empty_cache()
    return rec


def prefix_key_row(port: Port, device, card: str) -> dict:
    """Kernel 1 at the serving prefix-key shape of 10b's short prompts (one
    launch of K 1, 64-bit surface, variable length, rows and width
    pow2-bucketed as the engine buckets them) == its plain version, timed."""
    torch = port.torch
    prompts = [p for p in serve_prompts(port.get_config(SERVE_ARCH).vocab_size)
               if len(p) < SERVE_TREE_WORDS]
    N = port.autotune.pow2_at_least(max(len(p) for p in prompts))
    B = port.autotune.pow2_at_least(len(prompts))
    toks = np.zeros((B, N), np.uint32)
    lens = np.zeros(B, np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)], lens[i] = p, len(p)
    h = port.Hasher.from_spec(port.HashSpec(
        family="multilinear", n_hashes=1, out_bits=64, variable_length=True,
        seed=0x1E53), max_len=N, device=device)
    t = torch.from_numpy(toks.view(np.int32)).to(device)
    code = torch.from_numpy(lens).to(device)
    W = h._required_width(N)
    got = h(t, code)
    want = port.plain("multilinear", t, h.keys, code, width=W)
    check(torch.equal(got, want), "10: prefix keys != the plain version")
    b_ms, b_by = bound("multihash", B, N, W, 1, lens)
    row = {"kernel": "multihash", "family": "multilinear", "shape": "serve-prefix",
           "B": B, "N": N, "W": W, "K": 1, "max_abs_err": 0,
           "ms": timed(port, lambda: h(t, code), 20),
           "graph_ms": timed_graph(port, lambda: h(t, code), 20),
           "plain_ms": timed(port, lambda: port.plain(
               "multilinear", t, h.keys, code, width=W), 3),
           "bound_ms": b_ms, "bound_by": b_by, "card": card}
    print(json.dumps(row))
    return row


# --------------------------------------------------------------------------
# phase 11: serving the MoE, state-space and encoder-decoder models
# --------------------------------------------------------------------------

# 11a: (arch, n_layers cut to; None runs its SMOKE config whole)
PARITY_11 = (("granite_moe_hash", 2), ("granite_moe_1b_a400m", 2),
             ("rwkv6_1_6b", 2), ("jamba_v0_1_52b", None),
             ("llama4_maverick_400b_a17b", None), ("whisper_large_v3", 2))
# 11b: (arch, n_layers cut to or None as published, admission settings)
SERVE_11 = (("granite_moe_hash", None, (False, True)),
            ("granite_moe_1b_a400m", None, (False,)),
            ("rwkv6_1_6b", None, (False,)),
            ("jamba_v0_1_52b", 8, (False,)),
            ("llama4_maverick_400b_a17b", 2, (False,)))
WHISPER = "whisper_large_v3"
WHISPER_B, WHISPER_PROMPT, WHISPER_STEPS = 8, 4, 32


def to_cpu(tree):
    """A copy on the CPU of a dict tree of card tensors."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def mamba_parity(port: Port, device, card: str) -> dict:
    """11a: jamba's Mamba sublayer alone at the published width (d_model
    4,096, d_inner 8,192, d_state 16, chunk 64), float32 with TF32 off, over
    (2, 33, 4,096): output, conv tail and state on the card == on the CPU;
    on the card a 32-token call then a one-token step from its states ==
    the whole call."""
    torch = port.torch
    cfg = port.get_config("jamba_v0_1_52b")
    tag = "11a jamba mamba sublayer"
    p = port.ssm.mamba_init(torch.Generator(device).manual_seed(SEED), cfg.d_model,
                            d_state=cfg.d_state, expand=cfg.ssm_expand)
    cpu = to_cpu(p)
    x = torch.randn((2, 33, cfg.d_model), generator=torch.Generator(device).manual_seed(
        SEED + 1), device=device)
    kw = dict(d_state=cfg.d_state, chunk=cfg.ssm_chunk, dtype=torch.float32,
              return_state=True)
    err = {}
    with f32_products(torch):
        yc, (cc, hc) = port.ssm.mamba_forward(cpu, x.cpu(), **kw)
        yg, (cg, hg) = port.ssm.mamba_forward(p, x, **kw)
        err["out"] = agree(port, yg, yc, f"{tag} output")
        err["conv"] = agree(port, cg, cc, f"{tag} conv tail")
        err["ssm"] = agree(port, hg, hc, f"{tag} state")
        y1, (c1, h1) = port.ssm.mamba_forward(p, x[:, :32], **kw)
        y2, (_, h2) = port.ssm.mamba_forward(p, x[:, 32:], conv_state=c1,
                                             ssm_state=h1, **kw)
        err["split_vs_whole"] = agree(port, torch.cat([y1, y2], 1), yg,
                                      f"{tag} 32 + 1 != whole")
        err["split_state"] = agree(port, h2, hg, f"{tag} 32 + 1 state != whole")
    rec = {"config": f"jamba_v0_1_52b Mamba sublayer: d_model {cfg.d_model}, "
                     f"d_inner {cfg.ssm_expand * cfg.d_model}, d_state {cfg.d_state}",
           "input": [2, 33, cfg.d_model], "tolerance": PARITY_TOL,
           "max_abs_err": err, "card": card}
    print(f"{tag}: card == CPU within {PARITY_TOL}: "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))
    return rec


def whisper_serve(port: Port, device, card: str) -> dict:
    """11b: `whisper_large_v3` as published (32 + 32 layers, bf16) through
    its model API (the engine needs `init_caches`, which an enc-dec refuses,
    as the reference's does): encode (8, 1,500, 1,280) frames, prefill 4
    tokens, 32 greedy decode steps at batch 8 (finite logits, tokens in the
    vocabulary, the caches' layout); the encoder's, a prefill's and a
    decode tick's times, a tick's profile, peak memory."""
    torch = port.torch
    cfg = port.get_config(WHISPER)
    tag = f"11b {WHISPER}"
    api = port.build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    gen = torch.Generator(device).manual_seed(SEED)
    params = api.init(gen)
    frames = torch.randn((WHISPER_B, cfg.encoder_positions, cfg.d_model),
                         generator=gen, device=device)
    prompt = torch.randint(0, cfg.vocab_size, (WHISPER_B, WHISPER_PROMPT),
                           generator=gen, device=device, dtype=torch.int32)
    S = WHISPER_PROMPT + WHISPER_STEPS + 1
    t0 = time.perf_counter()
    logits, caches = api.prefill(params, {"frames": frames, "tokens": prompt},
                                 cache_len=S)
    c = caches["blocks"]["s0"]
    L, H, dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    check(tuple(c["cross_k"].shape) == (L, WHISPER_B, cfg.encoder_positions, H, dh)
          and tuple(c["k"].shape) == (L, WHISPER_B, S, cfg.n_kv_heads, dh)
          and c["cross_v"].dtype == torch.bfloat16,
          f"{tag}: cache layout {[(k, tuple(v.shape)) for k, v in c.items()]}")
    toks, finite = [logits.argmax(-1)], [torch.isfinite(logits).all()]
    for step in range(WHISPER_STEPS):
        lg, caches = api.decode_step(params, caches, toks[-1][:, None].int(),
                                     WHISPER_PROMPT + step)
        toks.append(lg.argmax(-1))
        finite.append(torch.isfinite(lg).all())
    out = torch.stack(toks, 1)
    check(bool(torch.stack(finite).all()) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size,
          f"{tag}: non-finite logits or a token out of the vocabulary")
    wall = time.perf_counter() - t0
    enc_ms = timed(port, lambda: port.encdec.encode(params, cfg, frames), 3)
    prefill_ms = timed(port, lambda: api.prefill(
        params, {"frames": frames, "tokens": prompt}, cache_len=S), 3)
    tok = out[:, -1:].int()
    step = lambda: api.decode_step(params, caches, tok, S - 1)  # noqa: E731
    decode_ms = timed(port, step, 10)
    prof = device_busy(port, step, warm=True)
    if prof is not None:
        del prof["names"]
    decoder = sum(p.numel() * p.element_size() for n, p in params.named_parameters()
                  if not n.startswith(("enc_", "pos_dec")))
    cross = sum(c[k].numel() * c[k].element_size() for k in ("cross_k", "cross_v"))
    rec = {"config": f"{WHISPER} as published: {cfg.n_encoder_layers} + "
                     f"{cfg.n_layers} layers, d_model {cfg.d_model}, bfloat16",
           "params": sum(p.numel() for p in params.parameters()),
           "frames": [WHISPER_B, cfg.encoder_positions, cfg.d_model],
           "prompt": [WHISPER_B, WHISPER_PROMPT], "decode_steps": WHISPER_STEPS,
           "wall_s": wall, "tokens_per_s": WHISPER_B * (WHISPER_STEPS + 1) / wall,
           "encoder_ms": enc_ms, "prefill_ms": prefill_ms, "decode_tick_ms": decode_ms,
           "decode_read_gb": (decoder + cross) / 1e9,
           "decode_bound_ms": (decoder + cross) / HBM_BYTES_PER_S * 1e3,
           "profiles": {"decode tick": prof},
           "peak_memory_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "held_before_gb": base / 1e9, "card": card}
    print(f"{tag}: {rec['params']} parameters; encode + prefill + "
          f"{WHISPER_STEPS} steps in {wall:.3f} s ({rec['tokens_per_s']:.1f} "
          f"tokens/s); encoder {enc_ms:.3f} ms, prefill {prefill_ms:.3f} ms, "
          f"decode tick {decode_ms:.3f} ms against a weights-and-cross-K/V "
          f"read bound of {rec['decode_bound_ms']:.3f} ms; peak memory "
          f"{rec['peak_memory_gb']:.3f} GB above the {base / 1e9:.3f} GB that "
          f"earlier phases hold; card {card}")
    print(f"{tag} profile of one decode tick: {json.dumps(prof)}")
    del params, caches, frames
    torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------------------
# phase 12: training
# --------------------------------------------------------------------------

TRAIN_ARCH = "granite_moe_hash"
# 12a: (arch, n_layers cut to; None runs its SMOKE config whole)
PARITY_12 = (("granite_moe_hash", 2), ("llama4_maverick_400b_a17b", None))
PARITY_12_LR = 1e-3
# 12a bounds: loss rel; a gradient leaf's max abs err over its largest
# magnitude (+1e-7 for gradients that are 0 in exact arithmetic); the
# parameters after a step (an element whose gradient is within rounding
# of 0 may take AdamW's +-lr step the other way: 2 lr). An element that
# differs past MOVED_12 must have a cause (`train_parity`); as a backstop,
# at most one in FLIPS_12 of the parameters (at least 64) may.
LOSS_TOL_12, GRAD_TOL_12, MOVED_12, FLIPS_12 = 1e-5, 1e-4, 1e-5, 10**5
# 12b/12c: batches of B x T tokens from the synthetic corpus
TRAIN_B, TRAIN_T, TRAIN_WARM, TRAIN_TIMED = 8, 1024, 2, 5
TRAIN_SCHEDULE = dict(peak_lr=3e-4, warmup_steps=2, decay_steps=100)
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W)
BF16_FLOPS_PER_S = 989e12
# 12c: the trainer's run
SYSTEM_STEPS, SYSTEM_EVERY, SYSTEM_FAULT, SYSTEM_REQUESTS = 12, 4, 6, 4


def train_batches(port, device, cfg, n: int, B: int = TRAIN_B, T: int = TRAIN_T):
    """n batches of B x T tokens packed by `HashPipeline` (on the card) from
    `data.synthetic.corpus` over the config's vocabulary. The pipeline's
    own engine launches (its split hash of each document) are counted
    into `port.tally`."""
    c0 = port.counts()["multihash"]
    pipe = port.HashPipeline(port.PipelineConfig(seq_len=T, batch_size=B, eval_pct=0,
                                                 dedup=False), device=device)
    out = []
    for b in pipe.pack(port.corpus(seed=SEED, n_docs=50 * n * B, vocab=cfg.vocab_size,
                                   dup_rate=0.0)):
        out.append(b)
        if len(out) == n:
            port.tally += port.counts()["multihash"] - c0
            return out
    raise SmokeFailure(f"the corpus packed {len(out)} of {n} batches")


def moved_apart(port, cfg, a: dict, b: dict, m_a: dict, m_b: dict) -> dict:
    """The parameter elements of two states after one step from one state
    (a the yardstick, b the state under test; reference paths -> tensors,
    b's moved to a's device) that differ
    past MOVED_12, and whether each has its cause. AdamW's first update
    of an element is lr g/(|g| + eps) of its clipped gradient g, which the
    first moment holds as m = (1 - b1) g. For two gradients of one sign
    the updates differ by less than lr eps/(min |g| + eps), so past
    MOVED_12 only if the smaller |g| is under eps (lr/MOVED_12 - 1):
    within rounding of 0. Otherwise the signs differ. Adafactor's update
    is continuous in g, and no element of it has a cause."""
    torch = port.torch
    hyper = inspect.signature(port.train.adamw).parameters
    eps, b1 = hyper["eps"].default, hyper["b1"].default
    g_limit = eps * (PARITY_12_LR / MOVED_12 - 1)
    out = {"moved": 0, "sign_flips": 0, "unexplained": 0, "max_abs": 0.0,
           "largest_g": 0.0, "g_limit": g_limit, "largest_g_over_leaf_max": 0.0}
    for path, x in a.items():
        d = (b[path].to(x.device) - x).abs()
        out["max_abs"] = max(out["max_abs"], float(d.max()))
        moved = d > MOVED_12
        n = int(moved.sum())
        if not n:
            continue
        out["moved"] += n
        if cfg.optimizer != "adamw":
            out["unexplained"] += n
            continue
        ga, gb = m_a[path] / (1 - b1), m_b[path].to(m_a[path].device) / (1 - b1)
        ga_m, gb_m = ga[moved], gb[moved]
        flip = torch.sign(ga_m) != torch.sign(gb_m)
        small = torch.minimum(ga_m.abs(), gb_m.abs())
        out["sign_flips"] += int(flip.sum())
        out["unexplained"] += int((~flip & (small >= g_limit)).sum())
        if not flip.all():
            out["largest_g"] = max(out["largest_g"], float(small[~flip].max()))
        out["largest_g_over_leaf_max"] = max(
            out["largest_g_over_leaf_max"], float(ga_m.abs().max() / ga.abs().max()))
    return out


def train_parity(port: Port, device, card: str, name: str, n_layers) -> dict:
    """12a: one train step on the card == the same step on the CPU, float32
    with TF32 off, from one seeded state drawn on the card and its copy:
    the loss, every gradient leaf and the parameters after the step, each
    error beside its bound; every element that moved apart has its cause
    (`moved_apart`)."""
    import dataclasses

    torch = port.torch
    if n_layers is None:
        cfg = dataclasses.replace(port.get_config(name, smoke=True), dtype="float32")
        tag, T = f"12a {cfg.name} (the SMOKE config of {name}, whole)", 16
    else:
        full = port.get_config(name)
        cfg = dataclasses.replace(full, n_layers=n_layers, dtype="float32")
        tag, T = (f"12a {name} at full width, n_layers {full.n_layers} -> "
                  f"{n_layers}"), 64
    api = port.build_model(cfg)
    opt = port.train.make_optimizer(cfg.optimizer, port.train.Schedule(
        peak_lr=PARITY_12_LR, warmup_steps=0))
    on_card = port.train.init_state(api, opt, torch.Generator(device).manual_seed(SEED))
    cpu = port.train.train_state.copy_to(on_card, "cpu")
    g = np.random.default_rng(SEED + 12)
    batch = {"tokens": g.integers(0, cfg.vocab_size, (2, T)).astype(np.int32),
             "labels": g.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)}
    step = port.train.make_train_step(api, opt)
    with f32_products(torch):
        (lc, gc), (lg, gg) = (port.train.step.reference_grads(api, s.params, batch)
                              for s in (cpu, on_card))
        loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
        grad_err, worst = 0.0, ""
        for path, a in gc.items():
            err = float((gg[path].cpu() - a).abs().max())
            rel = err / (float(a.abs().max()) + 1e-7 / GRAD_TOL_12)
            if rel > grad_err:
                grad_err, worst = rel, path
        del gc, gg
        cpu, mc = step(cpu, batch)
        on_card, mg = step(on_card, batch)
        torch.cuda.synchronize()
    after = [port.train.train_state.to_reference(s) for s in (cpu, on_card)]
    params = [dict(port.flatten(s.params)) for s in after]
    floats = [{p: x for p, x in ps.items() if x.is_floating_point()} for ps in params]
    keys_equal = all(torch.equal(x, params[1][p].cpu())
                     for p, x in params[0].items() if not x.is_floating_point())
    m = [dict(port.flatten(s.opt_state["m"])) if "m" in s.opt_state else {}
         for s in after]
    moved = moved_apart(port, cfg, *floats, *m)
    n_params = sum(p.numel() for p in cpu.params.parameters())
    bounds = {"loss_rel": LOSS_TOL_12, "grad_rel": GRAD_TOL_12,
              "param_abs": 2 * PARITY_12_LR + 1e-6, "unexplained": 0,
              "flips": max(64, n_params // FLIPS_12)}
    errs = {"loss_rel": loss_err, "grad_rel": grad_err, "param_abs": moved["max_abs"],
            "unexplained": moved["unexplained"], "flips": moved["moved"]}
    print(f"{tag}: " + ", ".join(f"{k} {errs[k]:.3e} (bound {bounds[k]:.3e})"
                                 for k in errs)
          + f"; worst gradient leaf {worst}; key planes equal: {keys_equal}; "
          f"{moved['moved']} elements past {MOVED_12}: {moved['sign_flips']} of "
          f"them with gradients of opposite signs, the others' smaller clipped "
          f"|g| at most {moved['largest_g']:.3e} (limit {moved['g_limit']:.3e}); "
          f"their largest |g| over their leaf's largest "
          f"{moved['largest_g_over_leaf_max']:.3e}")
    check(all(errs[k] <= bounds[k] for k in errs) and keys_equal,
          f"{tag}: past a bound: {errs} against {bounds}")
    rec = {"config": tag, "optimizer": cfg.optimizer, "batch": [2, T],
           "loss_card": float(mg["loss"]), "loss_cpu": float(mc["loss"]),
           "errors": errs, "bounds": bounds, "moved_apart": moved,
           "worst_grad_leaf": worst, "params": n_params, "card": card}
    del on_card, cpu, after, params, floats, m
    torch.cuda.empty_cache()
    return rec


def step_work(cfg, n_params: int, tokens: int, B: int, T: int) -> tuple:
    """(FLOPs, bytes, least FLOPs) of one remat train step of an MoE LM
    whose blocks are attention + a routed FFN: 8 FLOPs a multiply-add (2
    forward, 2 recomputed, 4 backward) on the projections and the tied
    unembedding for every token, on the experts for the E x C rows the
    reference's dispatch computes, and on the dense (B, T, T) attention
    scores and values the flash loop computes; bytes: AdamW's 28 a
    parameter (read p, g, m, v; write p, m, v in f32) and the f32 masters
    read 3 times (forward, recompute, backward). The least FLOPs count what
    the step's function needs: 6 a multiply-add (no recompute), the
    tokens x top-k routed rows, the causal half of the scores."""
    C = max(cfg.experts_per_token, int(math.ceil(  # one dispatch group
        tokens * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor)))
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = D * (2 * H * dh + 2 * Hkv * dh)
    expert = 3 * D * cfg.d_ff

    def macs(rows, scores):
        return cfg.n_layers * (tokens * attn + rows * expert + scores) \
            + tokens * D * cfg.vocab_size

    full = 2 * B * T * T * H * dh
    return (8 * macs(cfg.n_experts * C, full), (28 + 12) * n_params,
            6 * macs(tokens * cfg.experts_per_token, full // 2))


def train_full(port: Port, device, card: str) -> dict:
    """12b: `granite_moe_hash` as published, trained by `make_train_step`
    on HashPipeline batches: 2 warm-up and 5 timed steps; ms a step,
    tokens/s, peak memory, a step's profile, the losses, the bound."""
    torch = port.torch
    cfg = port.get_config(TRAIN_ARCH)
    tag = f"12b {TRAIN_ARCH}"
    api = port.build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    opt = port.train.make_optimizer(cfg.optimizer, port.train.Schedule(**TRAIN_SCHEDULE))
    t0 = time.perf_counter()
    box = [port.train.init_state(api, opt, torch.Generator(device).manual_seed(SEED))]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in box[0].params.parameters())
    state_gb = (torch.cuda.memory_allocated() - base) / 1e9
    batches = train_batches(port, device, cfg, TRAIN_WARM + TRAIN_TIMED + 1)
    step = port.train.make_train_step(api, opt)
    losses = []

    def one(b):
        box[0], m = step(box[0], b)
        losses.append(m["loss"])

    for b in batches[:TRAIN_WARM]:
        one(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[TRAIN_WARM:TRAIN_WARM + TRAIN_TIMED]:
        one(b)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / TRAIN_TIMED
    prof = device_busy(port, lambda: one(batches[-1]))
    loss = [float(v) for v in losses]
    tokens = TRAIN_B * TRAIN_T
    check(all(math.isfinite(v) for v in loss), f"{tag}: non-finite loss {loss}")
    check(abs(loss[0] - math.log(cfg.vocab_size)) < 1.0,
          f"{tag}: first loss {loss[0]:.4f} far from ln V = "
          f"{math.log(cfg.vocab_size):.4f}")
    flops, nbytes, least = step_work(cfg, n_params, tokens, TRAIN_B, TRAIN_T)
    f_ms, b_ms = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    least_ms = max(least / BF16_FLOPS_PER_S * 1e3, b_ms)
    if prof is not None:
        del prof["names"]
    rec = {"config": f"{TRAIN_ARCH} as published: {cfg.n_layers} layers, d_model "
                     f"{cfg.d_model}, {cfg.n_experts} experts top-"
                     f"{cfg.experts_per_token}, bf16 compute, f32 masters, "
                     f"{cfg.optimizer}, remat {cfg.remat}",
           "params": n_params, "param_count": cfg.param_count(),
           "state_gb": state_gb, "init_s": init_s, "batch": [TRAIN_B, TRAIN_T],
           "step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
           "peak_memory_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "held_before_gb": base / 1e9, "losses": loss,
           "flops": flops, "bytes": nbytes, "flops_ms": f_ms, "bytes_ms": b_ms,
           "bound_ms": max(f_ms, b_ms),
           "bound_by": "operations" if f_ms >= b_ms else "bytes",
           "least_flops": least, "least_bound_ms": least_ms,
           "profile": prof, "card": card}
    print(f"{tag}: {rec['config']}; {n_params} parameters ({state_gb:.3f} GB of "
          f"params + AdamW state) drawn in {init_s:.3f} s; {ms:.3f} ms a step of "
          f"{tokens} tokens ({rec['tokens_per_s']:.1f} tokens/s) against a bound "
          f"of {rec['bound_ms']:.3f} ms ({flops / 1e12:.3f} TFLOP over 989 "
          f"TFLOP/s: {f_ms:.3f} ms; {nbytes / 1e9:.3f} GB over 3.35 TB/s: "
          f"{b_ms:.3f} ms; without the recompute, the unfilled expert rows and "
          f"the causal upper half: {least / 1e12:.3f} TFLOP, a bound of "
          f"{least_ms:.3f} ms); peak memory {rec['peak_memory_gb']:.3f} GB above the "
          f"{base / 1e9:.3f} GB that earlier phases hold; losses {loss}; card {card}")
    if prof is not None:
        print(f"{tag}: one step's device operations {prof['ops']}, busy "
              f"{prof['kernel_ms'] + prof['copy_ms']:.3f} of {prof['wall_ms']:.3f} ms "
              f"(idle share {prof['idle_share']:.4f}); top {json.dumps(prof['top_ms'])}")
    del box, batches
    torch.cuda.empty_cache()
    return rec


def plain_checkpoint_check(port, th, step_dir: str, device) -> dict:
    """Every fingerprint in a checkpoint's manifest recomputed from the
    bytes on disk without the kernel: each leaf's leaf digests by the
    engine's plain version on the card (then the tree's fold), the path
    fingerprints and the root by the tree's numpy twin `digest_host`."""
    torch = port.torch
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    lw, family = th.spec.leaf_words, th.hasher.spec.family
    check(not th.hasher.spec.variable_length, f"{th}: a variable-length leaf spec")
    pairs, leaves, n_bytes = [], 0, 0
    t0 = time.perf_counter()
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        for path, meta in manifest["leaves"].items():
            u8 = torch.from_numpy(np.ascontiguousarray(data[meta["key"]]).reshape(-1)
                                  .view(np.uint8)).to(device)
            n = u8.shape[0]
            L = max(1, -(-n // (4 * lw)))
            rows = torch.cat([u8, u8.new_zeros(4 * L * lw - n)]).view(torch.int32) \
                .view(L, lw)
            lens = torch.full((L,), -(lw + 1), dtype=torch.int32, device=device)
            out = port.plain(family, rows, th.hasher.keys, lens, width=lw)
            nodes = (out[:, 0, 0] << 32) | out[:, 0, 1]
            fp = th._int(th._fold_impl(nodes, L, n))
            check(f"{fp:016x}" == meta["fingerprint"],
                  f"{step_dir}: leaf {path} fingerprint {meta['fingerprint']} != "
                  f"{fp:016x} from the plain version")
            pairs.append((path, fp))
            leaves, n_bytes = leaves + 1, n_bytes + n
            del u8, rows, out, nodes
    words = np.zeros(4 * len(pairs), np.uint32)
    for i, (path, fp) in enumerate(pairs):
        raw = path.encode()
        buf = np.zeros(-(-len(raw) // 4) * 4, np.uint8)
        buf[:len(raw)] = np.frombuffer(raw, np.uint8)
        pfp = th.digest_host(buf.view(np.uint32), tag=len(raw))
        words[4 * i:4 * i + 4] = (pfp & 0xFFFFFFFF, pfp >> 32, fp & 0xFFFFFFFF, fp >> 32)
    root = th.digest_host(words)
    check(f"{root:016x}" == manifest["root"],
          f"{step_dir}: root {manifest['root']} != digest_host {root:016x}")
    return {"leaves": leaves, "bytes": n_bytes, "root": manifest["root"],
            "seconds": time.perf_counter() - t0}


def train_system(port: Port, device, card: str, d: str) -> dict:
    """12c: the `Trainer` on `granite_moe_hash` at full width with 2 layers:
    12 steps, checkpoints every 4, a fault at step 6 (resumed from step 4),
    the last checkpoint restored equal to the final state, kernel-1
    launches as predicted, the final checkpoint's fingerprints ==
    `plain_checkpoint_check`'s; then `ServeEngine` serves 4 requests from
    the trained parameters. Its checkpoints go to `d` (13c restores the
    last)."""
    import dataclasses

    torch = port.torch
    full = port.get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=2)
    tag = f"12c {TRAIN_ARCH} at full width, n_layers {full.n_layers} -> 2"
    api = port.build_model(cfg)
    # the faulted step draws a batch and the replay redraws steps 4 and 5
    batches = train_batches(port, device, cfg,
                            SYSTEM_STEPS + 1 + SYSTEM_FAULT - SYSTEM_EVERY)
    t0 = time.perf_counter()
    tc = port.train.TrainerConfig(total_steps=SYSTEM_STEPS,
                                  checkpoint_every=SYSTEM_EVERY, keep_checkpoints=2,
                                  checkpoint_dir=d, log_every=1, peak_lr=1e-3,
                                  warmup_steps=2)
    tr = port.train.Trainer(api, tc, device=device)
    fired = []

    def injector(step):
        if step == SYSTEM_FAULT and not fired:
            fired.append(step)
            raise port.train.SimulatedFault("preempted")

    # leaves of the checkpointed state: its reference layout
    skel = port.train.train_state.skeleton(
        port.train.init_state(api, tr.optimizer,
                              torch.Generator(device).manual_seed(0)))
    n = len(port.flatten(skel))
    del skel
    torch.cuda.empty_cache()
    saves = SYSTEM_STEPS // SYSTEM_EVERY + 1  # steps 4, 8, 12 and the end's 12
    want = (saves * (2 * n + 1)   # a save: n leaves, n paths and the root
            + (2 * n + 1) + n     # the fault: verify step 4, restore it
            + (2 * n + 1) + n     # below: latest_valid (uncached), restore
            + 1)                  # the 4 short prompts' keys
    c0 = port.counts()["multihash"]
    state = tr.train(iter(batches), fault_injector=injector)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check(fired == [SYSTEM_FAULT] and tr.restarts == 1
          and int(state.step) == SYSTEM_STEPS,
          f"{tag}: fault {fired}, restarts {tr.restarts}, step {int(state.step)}")
    replayed = [m["step"] for m in tr.metrics_log]
    check(replayed == list(range(SYSTEM_FAULT)) + list(range(SYSTEM_EVERY,
                                                             SYSTEM_STEPS)),
          f"{tag}: logged steps {replayed}")
    check(tr.ckpt.latest_valid() == SYSTEM_STEPS, f"{tag}: latest valid checkpoint")
    restored = tr.ckpt.restore(SYSTEM_STEPS, port.train.train_state.skeleton(state))
    saved = port.train.train_state.to_reference(state)
    got = dict(port.flatten(restored))
    check(all(torch.equal(got[p].cpu(), x.cpu()) for p, x in port.flatten(saved)),
          f"{tag}: the restored state != the saved one")
    ckpt_gb = sum(x.numel() * x.element_size() for _, x in port.flatten(saved)) / 1e9
    del restored, saved, got
    torch.cuda.empty_cache()
    # the launches above fingerprinted with the kernel at save, verify
    # and restore; the final checkpoint's fingerprints again without it
    plain = plain_checkpoint_check(port, tr.ckpt.tree,
                                   os.path.join(d, f"step_{SYSTEM_STEPS}"), device)
    losses = [m["loss"] for m in tr.metrics_log]
    check(all(math.isfinite(v) for v in losses), f"{tag}: non-finite loss")
    eng = port.ServeEngine(api, state.params, n_slots=4, max_seq=256, device=device)
    g = np.random.default_rng(SEED + 13)
    reqs = [port.Request(i, g.integers(0, cfg.vocab_size, 24 + 8 * i).astype(np.int32),
                         max_new_tokens=8) for i in range(SYSTEM_REQUESTS)]
    eng.submit_all(reqs)
    check(all(r.done and len(r.out_tokens) == 8 for r in reqs),
          f"{tag}: a request was not served")
    launches = port.counts()["multihash"] - c0
    port.tally += want
    print(f"{tag}: {SYSTEM_STEPS} steps with a fault at step {SYSTEM_FAULT} "
          f"(resumed from step {SYSTEM_EVERY}) in {train_s:.3f} s; checkpoint of "
          f"{n} leaves, {ckpt_gb:.3f} GB; restored == saved; multihash launches "
          f"{launches} (predicted {want}); the step-{SYSTEM_STEPS} manifest's "
          f"{plain['leaves']} leaf fingerprints ({plain['bytes']} bytes) == the "
          f"plain version on the card, its paths and root {plain['root']} == "
          f"digest_host ({plain['seconds']:.3f} s); {SYSTEM_REQUESTS} requests served; "
          f"losses {[round(v, 4) for v in losses]}; card {card}")
    check(launches == want, f"{tag}: {launches} multihash launches != {want} predicted")
    rec = {"config": tag, "steps": SYSTEM_STEPS, "checkpoint_every": SYSTEM_EVERY,
           "fault_at": SYSTEM_FAULT, "leaves": n, "checkpoint_gb": ckpt_gb,
           "train_s": train_s, "losses": losses, "launches": launches,
           "predicted_launches": want, "plain_checkpoint_check": plain, "card": card}
    del state, eng, tr
    torch.cuda.empty_cache()
    return rec



# --------------------------------------------------------------------------
# phase 13: sharding rules, the sharded train step, restore onto a mesh
# --------------------------------------------------------------------------

# 13b/13c/13d: a world of 8 threaded ranks on the card, (pod 2, data 2,
# model 2); the single-device step runs with one MoE group a batch rank
WORLD_13 = ((2, 2, 2), ("pod", "data", "model"))
STEPS_13 = 3
# 13b bounds (12a's): the loss within LOSS_TOL_12 and the gradient norm
# within GRAD_TOL_12 (rel); a parameter within 12a's 2 lr a step, summed
# over the steps. After step 1 every element past MOVED_12 must have its
# cause (`moved_apart`, as 12a) and the optimizer state (a moment of the
# gradient, or of its square: twice its relative error) is within
# 2 GRAD_TOL_12 of its leaf's largest magnitude. After later steps the
# causes no longer separate (an element moved apart changes the next
# gradient): at most 12a's backstop of elements past MOVED_12 a step,
# summed over the steps, and the optimizer state within OPT_TOL_13, the
# train tests' bound on the state after three steps against the reference
# (+1e-9: the moments of gradients that are 0 in exact arithmetic are noise)
OPT_TOL_13 = 1e-3
# 13d: integer-valued f32, (pod, data) shards of PSUM_ROWS_13 x 1,024 rows each
PSUM_ROWS_13 = 1024


def rules_at_full_size(port: Port, card: str) -> dict:
    """13a: every architecture at (16, 16) and (2, 16, 16), training (f32
    masters and the optimizer's state) and serving (the compute dtype):
    the count of leaves the rules shard, and the bytes a rank holds, from
    shapes only (fake tensors: no weights drawn)."""
    torch = port.torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    sh, tstate = port.sharding, port.train.train_state
    out = {}
    for name in port.list_configs():
        cfg = port.get_config(name)
        api = port.build_model(cfg)
        opt = port.train.make_optimizer(cfg.optimizer, port.train.Schedule())
        with FakeTensorMode():
            train_p = api.init(torch.Generator(), train=True)
            state = port.train.TrainState(torch.zeros((), dtype=torch.int32), train_p,
                                          opt.init(train_p))
            serve_p = api.init(torch.Generator())
        rec = {"params": sum(x.numel() for x in train_p.parameters())}
        for multi in (False, True):
            mesh = port.make_production_mesh(multi_pod=multi)
            label = "x".join(map(str, mesh.dims))
            places = port.flatten(tstate.state_shardings(tstate.skeleton(state), mesh,
                                                         cfg.fsdp_pods))
            leaves = dict(port.flatten(tstate.skeleton(state)))
            per_rank, sharded = 0, 0
            for path, s in places:
                x = leaves[path]
                blocks = x if isinstance(s, list) else [x]
                specs = s if isinstance(s, list) else [s]
                sharded += any(e is not None for e in specs[0].spec)
                per_rank += sum(math.prod(sp.local_shape(tuple(b.shape))) * b.element_size()
                                for sp, b in zip(specs, blocks))
            with sh.use_mesh(mesh):
                serve_specs = port.flatten(sh.param_specs(serve_p, cfg.fsdp_pods,
                                                          serving=True))
            serve_leaves = dict(port.flatten(port.nested(serve_p)))
            s_rank, s_sharded = 0, 0
            for path, spec in serve_specs:
                x = serve_leaves[path]
                blocks = x if isinstance(spec, list) else [x]
                specs = spec if isinstance(spec, list) else [spec]
                s_sharded += any(e is not None for e in specs[0])
                s_rank += sum(math.prod(sh.NamedSharding(mesh, sp).local_shape(
                    tuple(b.shape))) * b.element_size() for sp, b in zip(specs, blocks))
            rec[label] = {"train_leaves": len(places), "train_sharded": sharded,
                          "train_bytes_per_rank": per_rank,
                          "serve_leaves": len(serve_specs), "serve_sharded": s_sharded,
                          "serve_bytes_per_rank": s_rank}
            check(sharded > 0 and s_sharded > 0 and 0 < per_rank and 0 < s_rank,
                  f"13a {name} at {label}: nothing sharded")
        out[name] = rec
        print(f"13a {name} ({rec['params']} parameters, {cfg.optimizer}, fsdp_pods "
              f"{cfg.fsdp_pods}): " + "; ".join(
                  f"{m}: train {r['train_sharded']}/{r['train_leaves']} leaves sharded, "
                  f"{r['train_bytes_per_rank'] / 1e9:.3f} GB a rank (params + "
                  f"{cfg.optimizer} state, f32); serve {r['serve_sharded']}/"
                  f"{r['serve_leaves']} sharded, {r['serve_bytes_per_rank'] / 1e9:.3f} GB "
                  f"a rank" for m, r in rec.items() if m != "params"))
    return out


def world_mesh(port: Port, device):
    dims, names = WORLD_13
    return port.Mesh((device,) * math.prod(dims), names, dims)


def state_errors(port: Port, got, want, cfg=None) -> dict:
    """A rank's chunks of a state against the single-device state's same
    chunks: parameters' largest error and count past MOVED_12, the
    optimizer state's largest error over its leaf's largest magnitude,
    whether every integer leaf is equal; with `cfg` (after the first
    step) also the count of elements past MOVED_12 without a cause
    (`moved_apart`)."""
    torch = port.torch
    tstate = port.train.train_state
    ref_got, ref_want = tstate.to_reference(got), tstate.to_reference(want)
    a = dict(port.flatten(ref_got))
    out = {"param_abs": 0.0, "moved": 0, "opt_rel": 0.0, "ints_equal": True,
           "leaves": len(a)}
    if cfg is not None:
        params = [{p: x for p, x in port.flatten(s.params) if x.is_floating_point()}
                  for s in (ref_want, ref_got)]
        m = [dict(port.flatten(s.opt_state["m"])) if "m" in s.opt_state else {}
             for s in (ref_want, ref_got)]
        out["unexplained"] = moved_apart(port, cfg, *params, *m)["unexplained"]
    for path, x in port.flatten(ref_want):
        y = a[path]
        if not x.is_floating_point():
            out["ints_equal"] &= bool(torch.equal(y, x))
            continue
        d = (y.float() - x.float()).abs()
        if path.startswith(".params"):
            out["param_abs"] = max(out["param_abs"], float(d.max()))
            out["moved"] += int((d > MOVED_12).sum())
        else:
            out["opt_rel"] = max(out["opt_rel"], float(d.max())
                                 / (float(x.abs().max()) + 1e-9 / OPT_TOL_13))
    return out


def sharded_train(port: Port, device, card: str, name: str, n_layers, n_steps: int,
                  batches, fsdp_settings, grad_accum: int = 1) -> dict:
    """13b: `jit_train_step` on the 8-rank world against the single-device
    step (`moe_groups` = the 4 batch ranks, `grad_accum` microbatches of
    the global batch) from one state on the card, in f32 with TF32 off:
    every rank's chunks, the loss and the gradient norm after every step
    within 12a's bounds; ms a step of the world and the bytes each
    collective moved."""
    torch = port.torch
    dist = port.dist
    tstate = port.train.train_state
    if n_layers is None:
        cfg = dataclasses.replace(port.get_config(name, smoke=True), dtype="float32")
        tag = f"13b {cfg.name} (the SMOKE config of {name}, whole)"
    else:
        full = port.get_config(name)
        cfg = dataclasses.replace(full, n_layers=n_layers, dtype="float32")
        tag = f"13b {name} at full width, n_layers {full.n_layers} -> {n_layers}"
    if grad_accum > 1:
        tag += f", grad_accum {grad_accum}"
    api = port.build_model(cfg)
    opt = port.train.make_optimizer(cfg.optimizer, port.train.Schedule(
        peak_lr=PARITY_12_LR, warmup_steps=0))
    mesh = world_mesh(port, device)
    n_batch = mesh.shape["pod"] * mesh.shape["data"]
    step = port.train.make_train_step(api, opt, moe_groups=n_batch, grad_accum=grad_accum)
    rec = {"config": tag, "optimizer": cfg.optimizer, "mesh": mesh.shape,
           "batch": list(batches[0]["tokens"].shape), "steps": n_steps, "card": card}
    with f32_products(torch):
        state = port.train.init_state(api, opt, torch.Generator(device).manual_seed(SEED))
        single, wants, metrics = tstate.copy_to(state, device), [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[:n_steps]:
            single, m = step(single, b)
            wants.append(tstate.copy_to(single, device))
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        rec["single_ms"] = 1e3 * (time.perf_counter() - t0) / n_steps
        del single
        n_params = sum(p.numel() for p in state.params.parameters())
        lrs = list(itertools.accumulate(m["lr"] for m in metrics))
        bounds = {"loss_rel": LOSS_TOL_12, "grad_norm_rel": GRAD_TOL_12,
                  "param_abs": [2 * v + 1e-6 for v in lrs],
                  "moved": [(i + 1) * max(64, n_params // FLIPS_12) for i in range(n_steps)],
                  "unexplained": 0,
                  "opt_rel": [2 * GRAD_TOL_12] + [OPT_TOL_13] * (n_steps - 1)}
        rec["bounds"] = bounds
        for fsdp in fsdp_settings:
            sharded = port.train.jit_train_step(
                step, mesh, state, {k: v.ndim for k, v in batches[0].items()},
                fsdp_pods=fsdp)

            def rank(r, fsdp=fsdp, sharded=sharded):
                sync = torch.zeros(1, device=device)
                local = tstate.shard(state, mesh, r, fsdp)
                res = []
                for i, b in enumerate(batches[:n_steps]):
                    lb = {k: port.sharding.batch_sharding(mesh, v.ndim).local(v, r)
                          for k, v in b.items()}
                    torch.cuda.synchronize()
                    dist.all_reduce(sync)  # every rank starts the step together
                    t0 = time.perf_counter()
                    local, m = sharded(local, lb)
                    torch.cuda.synchronize()
                    dist.all_reduce(sync)
                    ms = 1e3 * (time.perf_counter() - t0)
                    err = state_errors(port, local, tstate.shard(wants[i], mesh, r, fsdp),
                                       cfg if i == 0 else None)
                    res.append({"ms": ms, "loss": float(m["loss"]),
                                "grad_norm": float(m["grad_norm"]),
                                "traffic": m["traffic"], **err})
                return res

            per_rank = port.local_world.run(rank, mesh)
            steps = []
            for i in range(n_steps):
                rs = [per_rank[r][i] for r in range(mesh.size)]
                want = metrics[i]
                errs = {"loss_rel": max(abs(x["loss"] - want["loss"]) / abs(want["loss"])
                                        for x in rs),
                        "grad_norm_rel": max(abs(x["grad_norm"] - want["grad_norm"])
                                             / want["grad_norm"] for x in rs),
                        "param_abs": max(x["param_abs"] for x in rs),
                        "moved": max(x["moved"] for x in rs),
                        "opt_rel": max(x["opt_rel"] for x in rs)}
                if i == 0:
                    errs["unexplained"] = sum(x["unexplained"] for x in rs)
                ok = (errs["loss_rel"] <= bounds["loss_rel"]
                      and errs["grad_norm_rel"] <= bounds["grad_norm_rel"]
                      and errs["param_abs"] <= bounds["param_abs"][i]
                      and errs["moved"] <= bounds["moved"][i]
                      and errs.get("unexplained", 0) <= bounds["unexplained"]
                      and errs["opt_rel"] <= bounds["opt_rel"][i]
                      and all(x["ints_equal"] for x in rs))
                steps.append({"step": i + 1, "ms": rs[0]["ms"], "loss": rs[0]["loss"],
                              "single_loss": want["loss"], "errors": errs,
                              "traffic_rank0": rs[0]["traffic"],
                              "traffic_total": {k: sum(x["traffic"].get(k, 0) for x in rs)
                                                for k in rs[0]["traffic"]}})
                print(f"{tag}, fsdp_pods {fsdp}, step {i + 1}: {rs[0]['ms']:.3f} ms for the "
                      f"8-rank world (single-device step {rec['single_ms']:.3f} ms); loss "
                      f"{rs[0]['loss']:.6f} (single {want['loss']:.6f}); "
                      + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                                  for k, v in errs.items())
                      + f" (bounds loss {bounds['loss_rel']:.1e}, grad_norm "
                      f"{bounds['grad_norm_rel']:.1e}, param {bounds['param_abs'][i]:.3e}, "
                      f"moved {bounds['moved'][i]}"
                      + (f", unexplained {bounds['unexplained']}" if i == 0 else "")
                      + f", opt {bounds['opt_rel'][i]:.1e}); bytes rank 0 "
                      f"sent {json.dumps(rs[0]['traffic'])}")
                check(ok, f"{tag}, fsdp_pods {fsdp}, step {i + 1}: past a bound: {errs}")
            rec[f"fsdp_pods_{fsdp}"] = steps
            del per_rank
    del state, wants
    torch.cuda.empty_cache()
    return rec


def restore_onto_mesh(port: Port, device, card: str, directory: str, step: int) -> dict:
    """13c: `Checkpointer.restore(mesh=)` of a 12c checkpoint onto the
    8-rank world: every rank's chunks == its slices of the single-device
    restore; kernel-1 launches == the prediction (each leaf fingerprinted
    once by the world's rank 0, and once by the single-device restore)."""
    torch = port.torch
    full = port.get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=2)
    api = port.build_model(cfg)
    opt = port.train.make_optimizer(cfg.optimizer, port.train.Schedule())
    tstate = port.train.train_state
    like = tstate.skeleton(port.train.init_state(api, opt,
                                                 torch.Generator(device).manual_seed(0)))
    mesh = world_mesh(port, device)
    n = len(port.flatten(like))
    want = 2 * n
    ck = port.Checkpointer(directory, device=device)
    c0 = port.counts()["multihash"]
    t0 = time.perf_counter()
    whole = dict(port.flatten(ck.restore(step, like)))
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    where = {}
    for p, s in port.flatten(tstate.state_shardings(like, mesh, cfg.fsdp_pods)):
        where[p] = (port.sharding.NamedSharding(mesh, port.sharding.P(None, *s[0].spec))
                    if isinstance(s, list) else s)

    def rank(r):
        t0 = time.perf_counter()
        got = dict(port.flatten(ck.restore(step, like, mesh=mesh, fsdp_pods=cfg.fsdp_pods)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        equal = all(torch.equal(got[p], where[p].local(x, r)) for p, x in whole.items())
        return equal, secs, sum(x.numel() * x.element_size() for x in got.values())

    out = port.local_world.run(rank, mesh)
    launches = port.counts()["multihash"] - c0
    port.tally += want
    gb = sum(x.numel() * x.element_size() for x in whole.values()) / 1e9
    print(f"13c restore(mesh=) of the step-{step} checkpoint of 12c ({n} leaves, {gb:.3f} GB) "
          f"onto the 8-rank world: every rank's chunks == its slices of the single-device "
          f"restore: {all(o[0] for o in out)}; {max(o[1] for o in out):.3f} s (single-device "
          f"{whole_s:.3f} s); a rank holds {out[0][2] / 1e9:.3f} GB; multihash launches "
          f"{launches} (predicted {want}: {n} leaves once by rank 0, once by the single-"
          f"device restore); card {card}")
    check(all(o[0] for o in out), "13c: a rank's restored chunks != the slices of the whole")
    check(launches == want, f"13c: {launches} multihash launches != {want} predicted")
    rec = {"leaves": n, "gb": gb, "launches": launches, "predicted_launches": want,
           "seconds": max(o[1] for o in out), "single_seconds": whole_s,
           "bytes_per_rank": out[0][2], "card": card}
    del whole
    torch.cuda.empty_cache()
    return rec


def psum_on_card(port: Port, device, card: str) -> dict:
    """13d: `hierarchical_psum` on the 8-rank world, integer-valued f32 (so
    the order of the sum cannot matter): every rank's result == the plain
    sum of the 4 (pod, data) shards, exactly; the bytes each collective
    moved."""
    torch = port.torch
    mesh = world_mesh(port, device)
    g = torch.Generator(device).manual_seed(SEED + 13)
    x = torch.randint(0, 1000, (4 * PSUM_ROWS_13, 1024), generator=g, device=device).float()
    plain = x.view(4, PSUM_ROWS_13, 1024).sum(0)
    s = port.sharding.NamedSharding(mesh, port.sharding.P(("pod", "data")))

    def rank(r):
        traffic = {}
        y = port.collectives.hierarchical_psum(s.local(x, r), mesh, traffic=traffic)
        return bool(torch.equal(y, plain)), traffic

    out = port.local_world.run(rank, mesh)
    print(f"13d hierarchical_psum of ({4 * PSUM_ROWS_13}, 1024) integer-valued f32 over "
          f"(pod 2, data 2): every rank == the plain sum: {all(o[0] for o in out)}; bytes "
          f"rank 0 sent {json.dumps(out[0][1])}; card {card}")
    check(all(o[0] for o in out), "13d: hierarchical_psum != the plain sum")
    return {"exact": True, "shape": [4 * PSUM_ROWS_13, 1024], "traffic_rank0": out[0][1],
            "card": card}


# --------------------------------------------------------------------------
# phase 14: the dry run (fake worlds, the op census, sharded serving)
# --------------------------------------------------------------------------

# 14a: phase 12b's cell on a world of one rank
PEAK_TOL_14 = 0.10
# 14c: sharded serving on a threaded (data 2, model 2) world on the card
WORLD_14 = ((2, 2), ("data", "model"))
# (arch, n_layers cut to, batch; B 1 is the long-context layout): gemma3
# keeps one block of 5 sliding-window (ring cache) layers and 1 global one
SERVE_14 = (("mistral_nemo_12b", 2, 4), ("granite_moe_hash", 2, 4),
            ("gemma3_27b", 6, 1))
PREFILL_14, TICKS_14 = 512, 8
# 14d: the CLI on production cells, one of each shape kind, both meshes,
# and a skipped cell
CLI_14 = (("granite_moe_1b_a400m", "train_4k"), ("granite_moe_1b_a400m", "prefill_32k"),
          ("granite_moe_1b_a400m", "decode_32k"), ("rwkv6_1_6b", "long_500k"),
          ("mistral_nemo_12b", "long_500k"))
CLI_TIMEOUT_14 = 120  # seconds for all of them (one process a cell, at once)
# 14e: a long prefill on a threaded (data 1, model 4) world
WORLD_14E = ((1, 4), ("data", "model"))
PREFILL_14E, B_14E = 32768, 2


def train_specs(port, B: int, T: int) -> dict:
    """A packed HashPipeline batch's entries (tokens, labels, a mask)."""
    torch = port.torch
    return {"tokens": ((B, T), torch.int32), "labels": ((B, T), torch.int32),
            "mask": ((B, T), torch.float32)}


def census_vs_card(port: Port, device, card: str) -> dict:
    """14a: phase 12b's cell (granite_moe_hash as published, B 8 x T 1,024)
    under the census around one real step on the card (after a warm-up
    step), then through the dry run on a fake world of one rank: dot
    FLOPs and transcendentals equal exactly; the dry run's peak within
    PEAK_TOL_14 of `max_memory_allocated` over the real step (less what
    earlier phases still hold)."""
    import gc

    torch = port.torch
    cfg = port.get_config(TRAIN_ARCH)
    shape = port.ShapeSpec("train_8x1024", "train", TRAIN_T, TRAIN_B)
    mesh = port.Mesh((device,), ("data", "model"), (1, 1))
    api = port.build_model(cfg)
    opt = port.train.make_optimizer(cfg.optimizer, port.train.Schedule(**TRAIN_SCHEDULE))
    gc.collect()  # what earlier phases left is not freed inside the step
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = port.train.init_state(api, opt, torch.Generator(device).manual_seed(SEED))
    batches = train_batches(port, device, cfg, 2)
    step = port.train.make_train_step(api, opt)
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with port.op_analysis.Census((state, batches[1])) as c:
        state, _ = step(state, batches[1])
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    real = c.totals()
    del state, batches, step
    torch.cuda.empty_cache()
    dry = port.dryrun.run_cell(TRAIN_ARCH, shape.name, "1x1", mesh=mesh, shape=shape,
                               cfg=cfg, batch_specs=train_specs(port, TRAIN_B, TRAIN_T))
    d = dry["corrected"]
    rec = {"dry": {k: d[k] for k in ("dot_flops_per_device", "transcendentals_per_device",
                                     "peak_bytes", "argument_bytes", "n_ops")},
           "real": {k: real[k] for k in ("dot_flops_per_device",
                                         "transcendentals_per_device", "peak_bytes",
                                         "argument_bytes", "n_ops")},
           "max_memory_allocated": peak, "trace_s": dry["trace_s"], "card": card}
    rec["peak_rel"] = (d["peak_bytes"] - peak) / peak
    print(f"14a {TRAIN_ARCH} B {TRAIN_B} x T {TRAIN_T}: dry run {d['dot_flops_per_device']:.6e} "
          f"dot FLOPs, {d['transcendentals_per_device']:.6e} transcendentals, peak "
          f"{d['peak_bytes'] / 1e9:.3f} GB ({d['argument_bytes'] / 1e9:.3f} GB arguments), "
          f"{d['n_ops']} ops, trace {dry['trace_s']} s; census of the real step "
          f"{real['dot_flops_per_device']:.6e}, {real['transcendentals_per_device']:.6e}, "
          f"peak {real['peak_bytes'] / 1e9:.3f} GB, {real['n_ops']} ops; the card's "
          f"max_memory_allocated over the step {peak / 1e9:.3f} GB (dry run / card - 1 = "
          f"{rec['peak_rel']:+.4f}, bound {PEAK_TOL_14})")
    check(d["dot_flops_per_device"] == real["dot_flops_per_device"]
          and d["transcendentals_per_device"] == real["transcendentals_per_device"],
          "14a: the dry run's FLOPs or transcendentals != the real step's census")
    check(abs(rec["peak_rel"]) <= PEAK_TOL_14,
          f"14a: the dry run's peak is {rec['peak_rel']:+.4f} off the card's")
    return rec


def _counts(coll: dict) -> dict:
    return {k: v["count"] for k, v in coll.items() if isinstance(v, dict)}


def census_vs_13b(port: Port, device, card: str) -> dict:
    """14b: 13b's cell -- granite_moe_hash at full width cut to 2 layers,
    f32, fsdp_pods, 8 x 1,024 tokens a step -- on a fake (2, 2, 2) world:
    the bytes rank 0 sends, and its collective counts and bytes equal the
    census's around one real step of the same cell on 8 threaded ranks on
    the card."""
    torch = port.torch
    cfg = dataclasses.replace(port.get_config(TRAIN_ARCH), n_layers=2, dtype="float32",
                              fsdp_pods=True)
    shape = port.ShapeSpec("train_8x1024", "train", TRAIN_T, TRAIN_B)
    mesh = world_mesh(port, device)
    specs = train_specs(port, TRAIN_B, TRAIN_T)
    dry = port.dryrun.run_cell(TRAIN_ARCH, shape.name, "2x2x2", mesh=mesh, shape=shape,
                               cfg=cfg, batch_specs=specs)

    def rank(r):
        return port.dryrun.run_cell(TRAIN_ARCH, shape.name, "2x2x2", mesh=mesh,
                                    shape=shape, cfg=cfg, batch_specs=specs, fake=False)

    with f32_products(torch):
        real = port.local_world.run(rank, mesh)
    torch.cuda.empty_cache()
    dc, rc = dry["collectives"], real[0]["collectives"]
    rec = {"dry": dc, "real_rank0": rc, "trace_s": dry["trace_s"], "card": card,
           "dry_flops": dry["cost"]["flops"], "real_flops": real[0]["cost"]["flops"]}
    print(f"14b {cfg.name} (2 layers, f32, fsdp_pods) on (2, 2, 2): the fake world's "
          f"rank 0 sends {dc['traffic']} bytes; collectives "
          f"{json.dumps(_counts(dc))}, result bytes {dc['total_bytes']}; the real world's "
          f"rank 0 census: {rc['traffic']} bytes sent, {json.dumps(_counts(rc))}, result "
          f"bytes {rc['total_bytes']}; trace {dry['trace_s']} s")
    check(_counts(dc) == _counts(rc) and dc["total_bytes"] == rc["total_bytes"]
          and dc["traffic"] == rc["traffic"],
          "14b: the fake world's collectives != the real world's census")
    check(dry["cost"]["flops"] == real[0]["cost"]["flops"],
          "14b: the fake world's FLOPs != the real world's")
    return rec


def sharded_serving(port: Port, device, card: str, name: str, n_layers: int,
                    B: int) -> dict:
    """14c: prefill of PREFILL_14 tokens and TICKS_14 decode ticks on a
    threaded (data 2, model 2) world on the card, each rank its chunks of
    the weights at the serving rules and its batch rows (`ss.Layout`),
    f32 with TF32 off: every rank's logits (its rows, every column) ==
    the single-device port's within PARITY_TOL. Then the census of a
    prefill cell and a decode cell on the real world == the same cells'
    dry run on a fake world of that shape (mesh on the card)."""
    import gc

    torch = port.torch
    ss = port.serve_sharded
    full = port.get_config(name)
    cfg = dataclasses.replace(full, n_layers=n_layers, dtype="float32")
    api = port.build_model(cfg)
    dims, names = WORLD_14
    mesh = port.Mesh((device,) * math.prod(dims), names, dims)
    long_ctx = B == 1
    groups = math.gcd(B, dims[0])
    tag = (f"14c {name} (n_layers {full.n_layers} -> {n_layers}, f32), B {B}"
           + (" (long_ctx: S over data + model)" if long_ctx else ""))
    g = np.random.default_rng(SEED + 140)
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (B, PREFILL_14))
                            .astype(np.int32)).to(device)
    ticks = [torch.from_numpy(g.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32))
             .to(device) for _ in range(TICKS_14)]
    S = PREFILL_14 + TICKS_14
    with f32_products(torch):
        params = api.init(torch.Generator(device).manual_seed(SEED))
        t0 = time.perf_counter()
        logits, caches = api.prefill(params, {"tokens": toks}, cache_len=S,
                                     moe_groups=groups)
        wants = [logits]
        for i, t in enumerate(ticks):
            logits, caches = api.decode_step(params, caches, t, PREFILL_14 + i,
                                             moe_groups=groups)
            wants.append(logits)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        del caches

        layout = ss.Layout(mesh, B, S)

        def rank(r):
            p = ss.shard_params(params, mesh, r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, c = ss.prefill(api, p, {"tokens": layout.rows(toks, r)}, layout,
                               moe_groups=groups)
            out = [lg]
            for i, t in enumerate(ticks):
                lg, c = ss.decode_step(api, p, c, layout.rows(t, r), PREFILL_14 + i,
                                       layout, moe_groups=groups)
                out.append(lg)
            torch.cuda.synchronize()
            return layout.rows(torch.arange(B, device=device), r), out, time.perf_counter() - t0

        res = port.local_world.run(rank, mesh)
        err = max(agree(port, got, want[rows], f"{tag}: rank {r} step {i}")
                  for r, (rows, outs, _) in enumerate(res) for i, (got, want)
                  in enumerate(zip(outs, wants)))
        world_s = max(s for _, _, s in res)
        del res, params, wants
        gc.collect()  # the ranks' frames hold their chunks in cycles
        torch.cuda.empty_cache()
        # the census of the real world against the dry run of the same cells
        cells = {"prefill": port.ShapeSpec("prefill_14", "prefill", PREFILL_14, B),
                 "decode": port.ShapeSpec("decode_14", "decode", S, B)}
        census = {}
        for kind, shape in cells.items():
            dry = port.dryrun.run_cell(name, shape.name, "2x2", mesh=mesh, shape=shape,
                                       cfg=cfg)
            real = port.local_world.run(
                lambda r, shape=shape: port.dryrun.run_cell(
                    name, shape.name, "2x2", mesh=mesh, shape=shape, cfg=cfg, fake=False),
                mesh)
            d, w = dry["collectives"], real[0]["collectives"]
            same = (_counts(d) == _counts(w) and d["total_bytes"] == w["total_bytes"]
                    and dry["cost"]["flops"] == real[0]["cost"]["flops"])
            census[kind] = {"dry": {"flops": dry["cost"]["flops"], "collectives": d,
                                    "trace_s": dry["trace_s"]},
                            "real_rank0": {"flops": real[0]["cost"]["flops"],
                                           "collectives": w}, "equal": same}
            print(f"{tag}: {kind} cell census, fake world {dry['cost']['flops']:.6e} FLOPs, "
                  f"{json.dumps(_counts(d))}, {d['total_bytes']} result bytes; real world "
                  f"rank 0 {real[0]['cost']['flops']:.6e}, {json.dumps(_counts(w))}, "
                  f"{w['total_bytes']} (trace {dry['trace_s']} s)")
            check(same, f"{tag}: the {kind} cell's census differs between the fake "
                  "and the real world")
            del real
            gc.collect()  # the ranks' frames hold their chunks in cycles
            torch.cuda.empty_cache()
    print(f"{tag}: every rank's logits == the single-device port within {PARITY_TOL} "
          f"(max abs err {err:.3e}); prefill {PREFILL_14} + {TICKS_14} ticks: world "
          f"{world_s:.3f} s, single device {single_s:.3f} s")
    return {"config": tag, "max_abs_err": err, "world_s": world_s, "single_s": single_s,
            "census": census, "card": card}


def long_prefill(port: Port, device, card: str) -> dict:
    """14e: SERVE_ARCH at its published width cut to 2 layers, f32 with
    TF32 off, B_14E rows of PREFILL_14E tokens: the single-device port's
    prefill first (then freed), then the same prefill on a threaded (data
    1, model 4) world on the card, each rank its chunks of the weights
    (copies; the whole weights freed before the world starts): every
    rank's logits == the single-device port's within PARITY_TOL, and each
    rank's share of the card's `max_memory_allocated` over the world's
    prefill (its chunks counted, what earlier phases hold not) == the dry
    run's peak a rank (arguments + temp) of the same cell on a fake world
    within PEAK_TOL_14."""
    import gc

    torch = port.torch
    ss = port.serve_sharded
    full = port.get_config(SERVE_ARCH)
    cfg = dataclasses.replace(full, n_layers=2, dtype="float32")
    api = port.build_model(cfg)
    dims, names = WORLD_14E
    mesh = port.Mesh((device,) * math.prod(dims), names, dims)
    B, T = B_14E, PREFILL_14E
    tag = f"14e {SERVE_ARCH} (n_layers {full.n_layers} -> 2, f32), B {B} x T {T} on {dims}"
    gc.collect()  # earlier worlds' chunks, held in their frames' cycles
    torch.cuda.empty_cache()
    held0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    toks = torch.from_numpy(np.random.default_rng(SEED + 145).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)).to(device)
    with f32_products(torch):
        params = api.init(torch.Generator(device).manual_seed(SEED))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, caches = api.prefill(params, {"tokens": toks}, cache_len=T)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        single_peak = torch.cuda.max_memory_allocated()
        del caches
        layout = ss.Layout(mesh, B, T)
        chunks = [ss.shard_params(params, mesh, r) for r in range(mesh.size)]
        chunk_bytes = sum(t.numel() * t.element_size() for p in chunks
                          for t in [*p.parameters(), *p.buffers()])
        del params
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() - chunk_bytes  # not the world's
        torch.cuda.reset_peak_memory_stats()

        def rank(r):
            lg, _ = ss.prefill(api, chunks[r], {"tokens": layout.rows(toks, r)}, layout)
            torch.cuda.synchronize()
            return lg

        t0 = time.perf_counter()
        got = port.local_world.run(rank, mesh)
        world_s = time.perf_counter() - t0
        share = (torch.cuda.max_memory_allocated() - held) / mesh.size
        err = max(agree(port, g, want, f"{tag}: rank {r}") for r, g in enumerate(got))
        del got, chunks, want
        gc.collect()
        torch.cuda.empty_cache()
    shape = port.ShapeSpec("prefill_14e", "prefill", T, B)
    dry = port.dryrun.run_cell(SERVE_ARCH, shape.name, "1x4", mesh=mesh, shape=shape,
                               cfg=cfg)
    m = dry["memory"]
    rel = (m["peak_bytes"] - share) / share
    print(f"{tag}: every rank's logits == the single-device port within {PARITY_TOL} "
          f"(max abs err {err:.3e}); world {world_s:.3f} s, single device {single_s:.3f} s "
          f"(its peak {(single_peak - held0) / 1e9:.3f} GB above the {held0 / 1e9:.3f} GB "
          f"earlier phases hold); a rank's share of the card's "
          f"max_memory_allocated {share / 1e9:.3f} GB, the dry run's peak a rank "
          f"{m['peak_bytes'] / 1e9:.3f} GB ({m['argument_bytes'] / 1e9:.3f} GB arguments, "
          f"{m['temp_bytes'] / 1e9:.3f} GB temp; dry run / card - 1 = {rel:+.4f}, bound "
          f"{PEAK_TOL_14}); dot FLOPs a rank {dry['cost']['flops']:.4e}, collectives "
          f"{dry['collectives']['total_bytes'] / 1e9:.3f} GB a rank (sent "
          f"{dry['collectives']['traffic'] / 1e9:.3f}), trace {dry['trace_s']} s")
    check(abs(rel) <= PEAK_TOL_14, f"{tag}: the dry run's peak a rank is {rel:+.4f} off "
          "the card's share")
    return {"config": tag, "max_abs_err": err, "world_s": world_s, "single_s": single_s,
            "single_peak_bytes": single_peak - held0, "held_bytes": held0,
            "share_bytes": share, "dry": m,
            "dry_flops": dry["cost"]["flops"], "dry_collectives": dry["collectives"],
            "peak_rel": rel, "card": card}


def dryrun_cli(port: Port, card: str, out_dir: Path) -> dict:
    """14d: `python -m repro_torch.launch.dryrun` on the CLI_14 cells, both
    meshes, the mesh on the card, one process a cell, all at once, within
    CLI_TIMEOUT_14: each cell's record; an `error` record or a missing
    skip record fails the phase."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {(arch, shape): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
         shape, "--mesh", "both", "--out", str(out_dir), "--device", "cuda"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, shape in CLI_14}
    try:
        for (arch, shape), proc in procs.items():
            try:
                _, err = proc.communicate(
                    timeout=max(1.0, CLI_TIMEOUT_14 - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                check(False, f"14d: the dry run of {arch} x {shape} ran past "
                      f"{CLI_TIMEOUT_14} s")
            check(proc.returncode == 0, f"14d: the dry run of {arch} x {shape} exited "
                  f"{proc.returncode}: {err[-2000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    recs = {}
    for arch, shape in CLI_14:
        for mk in ("single", "multi"):
            r = json.loads((out_dir / f"{arch}__{shape}__{mk}.json").read_text())
            recs[f"{arch}__{shape}__{mk}"] = r
            check(r["status"] in ("ok", "skipped"), f"14d {arch} x {shape} x {mk}: "
                  f"{r.get('error')}")
            if r["status"] == "skipped":
                print(f"14d {arch} x {shape} x {mk}: skipped ({r['reason']})")
                continue
            m, c = r["memory"], r["collectives"]
            print(f"14d {arch} x {shape} x {mk}: {r['status']}, arguments "
                  f"{m['argument_bytes'] / 1e9:.3f} GB a rank, temp "
                  f"{m['temp_bytes'] / 1e9:.3f} GB, {r['cost']['flops']:.4e} dot FLOPs a "
                  f"rank, collectives {c['total_bytes'] / 1e6:.1f} MB a rank (results; sent "
                  f"{c['traffic'] / 1e6:.1f} MB), trace {r['trace_s']} s")
    check(any(r["status"] == "skipped" for r in recs.values()), "14d: no skip record")
    print(f"14d: {len(recs)} records in {wall:.1f} s wall ({card})")
    return {"records": recs, "wall_s": wall, "card": card}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    t_start = time.perf_counter()
    # 12c's checkpoints, which 13c restores onto the mesh
    train_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    try:
        port = Port()
        with phase("phase 1: device and build"):
            card = device_line()
            print(f"card: {card}")
            build_kernels(port)
            rate = b1_rate(port, device)
        with phase("phase 2: kernels vs plain versions"):
            kernel_vs_plain(port, device)
        B, N, K = 65536, 1024, 9
        with phase("batches (set-up)"):
            batches = make_batches(32, 8192, 64, 2048, 50000, 0.10)
        port.reset_counts()
        with phase("phase 3: pure path at full width"):
            pure = pure_path(port, device, B, N, K)
        per_shape = {"3: B 65,536 x N 1,024, K 9": port.counts()}
        with phase("phase 4: admission"):
            admit = admission(port, device, batches, card)
        per_shape.update({f"4: {label}, B 8,192 ragged": r["launches"]
                          for label, r in admit.items()})
        before6 = port.counts()
        with phase("phase 6a: single hash, many strings"):
            single = {"6a": single_path(port, device, 65536, 1024, 256)}
        with phase("phase 6b: single hash, long strings"):
            single["6b"] = single_path(port, device, 64, 1 << 20, 16)
            hm = ("multilinear_hm", "gf_multilinear_hm")
            single["6b-odd"] = single_path(port, device, 64, (1 << 20) - 1, 16,
                                           families=hm)
        with phase("phase 6c: streaming fingerprints"):
            stream = streaming(port, device)
        launches = port.counts()
        per_shape["6: single hash and streaming"] = {
            k: v - before6[k] for k, v in launches.items() if v > before6[k]}
        print(f"main path launches: {launches}")
        for label, c in per_shape.items():
            print(f"  launches in phase {label}: "
                  + json.dumps({k: v for k, v in c.items() if v}))
        check(all(v > 0 for v in launches.values()),
              "a kernel of the main path was never launched")
        check(launches["multihash"] == 99 and launches["gf_multihash"] == 35,
              "engine launches on the main path != 99 (multihash), 35 "
              "(gf_multihash): one launch per call and per batch")
        with phase("phase 5: measurements"):
            kernels, rows = measure(port, device, pure, batches[0], K, launches,
                                    card)
            more, single_rows = measure_single(port, device, single, launches,
                                               card, rate)
            kernels = [{**kernels, **more}[k] for k in KERNELS]
            rows += single_rows
        # phase 7 is a path of its own: its counts start at 0 here
        port.reset_counts()
        tree, tree_measures = {}, []
        with phase("phase 7a: tree fingerprints at a checkpoint size"):
            for family, n_words, prefix in (
                    ("multilinear", 1 << 28, 1 << 24),
                    ("gf_multilinear", 1 << 26, 1 << 22),
                    ("multilinear_hm", 1 << 26, 1 << 24)):
                tree[family], m = tree_fingerprints(port, device, family,
                                                    n_words, prefix, card)
                tree_measures.append(m)
        with phase("phase 7b: checkpoints"):
            ckpt = checkpoints(port, device, card)
        with phase("phase 7c: long-document dedup"):
            dedup = long_dedup(port, device, card)
        tree_launches = port.counts()
        want7 = (sum(r["launches"] for r in tree.values()) + ckpt["launches"]
                 + dedup["launches"])
        print(f"phase 7 launches: {tree_launches} (7a: "
              + ", ".join(f"{f} {r['launches']}" for f, r in tree.items())
              + f"; 7b {ckpt['launches']}; 7c {dedup['launches']})")
        check(tree_launches["multihash"] > 0 and tree_launches["gf_multihash"] > 0
              and tree_launches["multihash"] + tree_launches["gf_multihash"] == want7
              and not tree_launches["multilinear"] + tree_launches["gf_multilinear"],
              f"phase 7 launches {tree_launches} != {want7} engine launches")
        with phase("phase 7 measurements"):
            for m in tree_measures:
                m()
            del tree_measures
        # phase 8 is a path of its own: its counts start at 0 here
        port.reset_counts()
        port.tally = 0
        with phase("phase 8a: sharded hashing at the pure shape"):
            shard_pure, measure_8a = sharded_pure(port, device, pure)
        with phase("phase 8b: device-sharded Bloom filters at 10^8 items"):
            shard_bloom, measure_8b = sharded_bloom(port, device, batches[:8],
                                                    card)
        with phase("phase 8c: the admission service under faults"):
            shard_svc, svc_a, svc_b = sharded_service(port, device, batches[:4],
                                                      card)
        with phase("phase 8d: the lifted routes"):
            lifted = lifted_routes(port, device, batches, int(
                tree["gf_multilinear"]["root"], 16), svc_a, svc_b, card)
        del svc_a, svc_b
        shard_launches = port.counts()
        print(f"phase 8 launches: {shard_launches} (checked call by call: "
              f"{port.tally})")
        check(shard_launches["multihash"] > 0 and shard_launches["gf_multihash"] > 0
              and shard_launches["multihash"] + shard_launches["gf_multihash"]
              == port.tally
              and not shard_launches["multilinear"] + shard_launches["gf_multilinear"],
              f"phase 8 launches {shard_launches} != {port.tally} engine launches")
        with phase("phase 8 measurements"):
            measure_8a()
            measure_8b()
        # phase 9 is a path of its own: its counts start at 0 here
        port.reset_counts()
        port.tally = 0
        with phase("phase 9a: battery adapters, baselines and core.gf"):
            battery_adapters(port, device)
        with phase("phase 9b: the probe path at the battery's size"):
            probe_rows, measure_9b = probe_path_launches(port, device, card)
        probe_tally = port.tally
        # the battery's own probe path: one launch a call, D a sharded call
        port.tally += sum(1 + r["shards"] for r in probe_rows)
        with phase("phase 9c: the full battery"):
            battery, quality_report = full_battery(port, device, card)
        battery_launches = port.counts()
        print(f"phase 9 launches: {battery_launches} (9b checked call by call: "
              f"{probe_tally}; 9c's probe path: {port.tally - probe_tally})")
        check(battery_launches["multihash"] > 0 and battery_launches["gf_multihash"] > 0
              and battery_launches["multihash"] + battery_launches["gf_multihash"]
              == port.tally
              and not battery_launches["multilinear"] + battery_launches["gf_multilinear"],
              f"phase 9 launches {battery_launches} != {port.tally} engine launches")
        with phase("phase 9 measurements"):
            measure_9b()
        rows += probe_rows
        # phase 10 is a path of its own: its counts start at 0 here
        port.reset_counts()
        port.tally = 0
        with phase("phase 10a: model parity at full width (2 layers, f32)"):
            parity = model_parity(port, device, card)
        with phase("phase 10b: serving mistral_nemo_12b at its published size"):
            serving = serve_family(port, device, card, SERVE_ARCH, tag="10b",
                                   n_drawn=25, repeats=SERVE_REPEATS,
                                   n_new=SERVE_NEW, count_params=True,
                                   profile_prefill=True)
        serve_counts = port.counts()
        print(f"phase 10 launches: {serve_counts} (checked call by call: "
              f"{port.tally})")
        check(serve_counts["multihash"] > 0
              and serve_counts["multihash"] == port.tally
              and not serve_counts["gf_multihash"] + serve_counts["multilinear"]
              + serve_counts["gf_multilinear"],
              f"phase 10 launches {serve_counts} != {port.tally} multihash launches")
        with phase("phase 10 measurements"):
            prefix_row = prefix_key_row(port, device, card)
        rows.append(prefix_row)
        # phase 11 is a path of its own: its counts start at 0 here
        port.reset_counts()
        port.tally = 0
        with phase("phase 11a: MoE, SSM and enc-dec parity at full width (f32)"):
            parity11 = {name: model_parity(port, device, card, name, n,
                                           tag=f"11a {name}")
                        for name, n in PARITY_11}
            parity11["jamba mamba sublayer"] = mamba_parity(port, device, card)
        serving11 = {}
        for name, n_layers, admissions in SERVE_11:
            with phase(f"phase 11b: serving {name}"):
                serving11[name] = serve_family(port, device, card, name, n_layers,
                                               admissions)
        with phase(f"phase 11b: {WHISPER} through its model API"):
            serving11[WHISPER] = whisper_serve(port, device, card)
        counts11 = port.counts()
        print(f"phase 11 launches: {counts11} (checked call by call: {port.tally})")
        check(counts11["multihash"] > 0 and counts11["multihash"] == port.tally
              and not counts11["gf_multihash"] + counts11["multilinear"]
              + counts11["gf_multilinear"],
              f"phase 11 launches {counts11} != {port.tally} multihash launches")
        # phase 12 is a path of its own: its counts start at 0 here
        port.reset_counts()
        port.tally = 0
        with phase("phase 12a: one train step, card == CPU (f32)"):
            parity12 = {name: train_parity(port, device, card, name, n)
                        for name, n in PARITY_12}
        with phase(f"phase 12b: training {TRAIN_ARCH} at its published size"):
            train12 = train_full(port, device, card)
        with phase("phase 12c: the Trainer, a fault, checkpoints and serving"):
            system12 = train_system(port, device, card, train_dir.name)
        counts12 = port.counts()
        print(f"phase 12 launches: {counts12} (12c's predicted and the "
              f"pipelines' counted: {port.tally})")
        check(counts12["multihash"] > 0 and counts12["multihash"] == port.tally
              and not counts12["gf_multihash"] + counts12["multilinear"]
              + counts12["gf_multilinear"],
              f"phase 12 launches {counts12} != {port.tally} multihash launches")
        # phase 13 is a path of its own: its counts start at 0 here
        port.reset_counts()
        port.tally = 0
        with phase("phase 13a: the sharding rules at full size"):
            rules13 = rules_at_full_size(port, card)
        with phase("phase 13b: the sharded train step on an 8-rank world"):
            cfg13 = dataclasses.replace(port.get_config(TRAIN_ARCH), n_layers=2)
            train13 = {TRAIN_ARCH: sharded_train(
                port, device, card, TRAIN_ARCH, 2, STEPS_13,
                train_batches(port, device, cfg13, STEPS_13), (True, False))}
            train13[f"{TRAIN_ARCH}_accum2"] = sharded_train(
                port, device, card, TRAIN_ARCH, 2, 2,
                train_batches(port, device, cfg13, 2), (True,), grad_accum=2)
            smoke = port.get_config("llama4_maverick_400b_a17b", smoke=True)
            g = np.random.default_rng(SEED + 14)
            train13["llama4_smoke"] = sharded_train(
                port, device, card, "llama4_maverick_400b_a17b", None, 1,
                [{"tokens": g.integers(0, smoke.vocab_size, (8, 16)).astype(np.int32),
                  "labels": g.integers(0, smoke.vocab_size, (8, 16)).astype(np.int32)}],
                (True,))
        with phase("phase 13c: restore onto the mesh"):
            restore13 = restore_onto_mesh(port, device, card, train_dir.name, SYSTEM_STEPS)
        train_dir.cleanup()
        with phase("phase 13d: hierarchical_psum on the card"):
            psum13 = psum_on_card(port, device, card)
        counts13 = port.counts()
        print(f"phase 13 launches: {counts13} (13c's predicted and the pipeline's "
              f"counted: {port.tally})")
        check(counts13["multihash"] > 0 and counts13["multihash"] == port.tally
              and not counts13["gf_multihash"] + counts13["multilinear"]
              + counts13["gf_multilinear"],
              f"phase 13 launches {counts13} != {port.tally} multihash launches")
        # phase 14 is a path of its own: its counts start at 0 here
        port.reset_counts()
        with phase("phase 14a: the census against the card"):
            dry14 = {"census_vs_card": census_vs_card(port, device, card)}
        with phase("phase 14b: collective bytes against 13b"):
            dry14["census_vs_13b"] = census_vs_13b(port, device, card)
        dry14["serving"] = {}
        for name, n_layers, B in SERVE_14:
            with phase(f"phase 14c: sharded serving, {name}, B {B}"):
                dry14["serving"][f"{name}_B{B}"] = sharded_serving(port, device, card,
                                                                   name, n_layers, B)
        with phase("phase 14d: the dry run's CLI on production cells"):
            dry14["cli"] = dryrun_cli(port, card, ROOT / "chiprun_out" / "dryrun_14")
        with phase("phase 14e: sequence-parallel prefill at 32,768 tokens"):
            dry14["long_prefill"] = long_prefill(port, device, card)
        counts14 = port.counts()
        print(f"phase 14 launches: {counts14} (the dry run launches no kernel)")
        check(not any(counts14.values()), f"phase 14 launched kernels: {counts14}")
        for rec in kernels:
            rec["phase14_launches"] = counts14[rec["name"]]
            rec["phase13_launches"] = counts13[rec["name"]]
            rec["phase12_launches"] = counts12[rec["name"]]
            rec["phase8_launches"] = shard_launches[rec["name"]]
            rec["phase9_launches"] = battery_launches[rec["name"]]
            rec["phase10_launches"] = serve_counts[rec["name"]]
            rec["phase11_launches"] = counts11[rec["name"]]
            if rec["name"] == "multihash":
                rec["serve_prefix"] = {k: prefix_row[k] for k in (
                    "ms", "graph_ms", "plain_ms", "bound_ms", "max_abs_err")}
            probe = [r for r in probe_rows if r["kernel"] == rec["name"]]
            if probe:
                rec["battery_probe"] = {k: max(r[k] for r in probe)
                                        for k in ("ms", "graph_ms", "plain_ms",
                                                  "bound_ms", "design_floor_ms",
                                                  "max_abs_err") if k in probe[0]}
            leaf = {"multihash": tree["multilinear"],
                    "gf_multihash": tree["gf_multilinear"]}.get(rec["name"])
            if leaf is not None:
                rec["tree_leaf"] = {**leaf["leaf"],
                                    "tree_launches": tree_launches[rec["name"]]}
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(
            {"card": card, "rows": rows, "admission": admit,
             "launches_per_shape": per_shape,
             "stream": stream, "kernels": kernels, "tree": tree,
             "checkpoint": ckpt, "long_dedup": dedup,
             "tree_launches": tree_launches,
             "sharded": {"pure": shard_pure, "bloom": shard_bloom,
                         "service": shard_svc, "lifted": lifted,
                         "launches": shard_launches},
             "quality": {"battery": battery, "launches": battery_launches},
             "serving": {"parity": parity, "serve": serving,
                         "launches": serve_counts},
             "serving_11": {"parity": parity11, "serve": serving11,
                            "launches": counts11},
             "training_12": {"parity": parity12, "train": train12,
                             "trainer": system12, "launches": counts12},
             "sharding_13": {"rules": rules13, "train": train13, "restore": restore13,
                             "psum": psum13, "launches": counts13},
             "dryrun_14": dry14},
            indent=1))
        (out_dir / "quality_report.json").write_text(json.dumps(quality_report,
                                                                indent=1))
        print(f"total {time.perf_counter() - t_start:.3f} s wall; card {card}")
        print(json.dumps({"kernels": kernels}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        train_dir.cleanup()


if __name__ == "__main__":
    sys.exit(main())
