"""Gemma3-27B [dense]: 5:1 local:global sliding attention, 262k vocab, 128k
ctx [hf:google/gemma-3-1b-pt family; unverified]. The giant vocabulary makes
this arch the hashed-embedding (paper-technique) showcase -- see the
`gemma3_27b_hashed` variant below used by benchmarks/ablation."""
import dataclasses

from . import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab_size=262144,
    attention="sliding_global",
    sliding_window=1024,
    global_every=6,            # 5 local : 1 global
    rope_theta=1e4,            # local layers
    rope_theta_global=1e6,     # global layers
    qk_norm=True,
    act="swiglu",              # gemma uses gelu-approx glu; swiglu-class
    tie_embeddings=True,
    # long_500k RUNS: local layers cache only the 1024 window (ring), global
    # layers SP-shard their cache over 'data'.
    skip_shapes=(),
    source="hf:google/gemma-3-27b-pt (dims per model card); unverified",
)

HASHED = dataclasses.replace(
    CONFIG, name="gemma3_27b_hashed", hashed_embedding=True,
    hashed_vocab_factor=4, hashed_n_hashes=2)

SMOKE = ArchConfig(
    name="gemma3_27b_smoke",
    family="dense",
    n_layers=7,                # 1 block of 6 + 1 tail layer
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    attention="sliding_global",
    sliding_window=8,
    global_every=6,
    qk_norm=True,
    tie_embeddings=True,
    remat=False,
    ce_chunk=8,
    source="reduced gemma3_27b",
)

SMOKE_HASHED = dataclasses.replace(
    SMOKE, name="gemma3_smoke_hashed", hashed_embedding=True,
    hashed_vocab_factor=4, hashed_n_hashes=2)
