"""Granite-3.0-1B-A400M [moe]: 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]. Also the hash-router (paper
technique) showcase: see HASH_ROUTED variant."""
import dataclasses

from . import ArchConfig

CONFIG = ArchConfig(
    name="granite_moe_1b_a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab_size=49155,
    moe=True,
    n_experts=32,
    experts_per_token=8,
    rope_theta=1e4,
    act="swiglu",
    tie_embeddings=True,
    skip_shapes=("long_500k",),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

HASH_ROUTED = dataclasses.replace(CONFIG, name="granite_moe_hash", router="hash")

SMOKE = ArchConfig(
    name="granite_moe_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=64,
    vocab_size=499,            # non-power-of-two like the original
    moe=True,
    n_experts=8,
    experts_per_token=4,
    tie_embeddings=True,
    remat=False,
    ce_chunk=8,
    source="reduced granite_moe",
)

SMOKE_HASH = dataclasses.replace(SMOKE, name="granite_smoke_hash", router="hash")
