"""Llama4-Maverick-400B-A17B [moe]: 128 experts top-1 + shared expert, early
fusion [hf:meta-llama/Llama-4-*; unverified]. The 400B giant: Adafactor +
FSDP over pods to fit 16 GB/chip HBM (DESIGN.md §5)."""
from . import ArchConfig

CONFIG = ArchConfig(
    name="llama4_maverick_400b_a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=202048,
    moe=True,
    n_experts=128,
    experts_per_token=1,
    moe_every=2,               # interleaved MoE (every other layer) -> 400B total
    moe_offset=1,
    shared_expert=True,
    rope_theta=5e5,
    act="swiglu",
    tie_embeddings=False,
    optimizer="adafactor",
    fsdp_pods=True,
    skip_shapes=("long_500k",),
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family); unverified",
)

SMOKE = ArchConfig(
    name="llama4_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    vocab_size=512,
    moe=True,
    n_experts=8,
    experts_per_token=1,
    shared_expert=True,
    tie_embeddings=False,
    optimizer="adafactor",
    remat=False,
    ce_chunk=8,
    source="reduced llama4_maverick",
)
