"""Jamba-v0.1-52B [hybrid]: Mamba+attention 1:7 interleave, MoE 16e top-2
every 2nd layer [arXiv:2403.19887; hf]. Runs long_500k (SSM state + 4
SP-sharded attention caches)."""
from . import ArchConfig

CONFIG = ArchConfig(
    name="jamba_v0_1_52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    moe=True,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,              # 1 attention per 8 layers (1:7)
    attn_offset=4,
    ssm_type="mamba",
    d_state=16,
    ssm_expand=2,
    pos_kind="rope",
    act="swiglu",
    tie_embeddings=False,
    skip_shapes=(),
    source="arXiv:2403.19887; hf:ai21labs/Jamba-v0.1",
)

SMOKE = ArchConfig(
    name="jamba_smoke",
    family="hybrid",
    n_layers=8,                # 2 blocks of 4
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    moe=True,
    n_experts=4,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    attn_every=4,
    attn_offset=2,
    ssm_type="mamba",
    d_state=4,
    ssm_expand=2,
    ssm_chunk=4,
    tie_embeddings=False,
    remat=False,
    ce_chunk=8,
    source="reduced jamba_v0_1_52b",
)
