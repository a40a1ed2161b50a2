"""RWKV-6 (Finch) 1.6B [ssm]: attention-free, data-dependent decay
[arXiv:2404.05892; unverified]. Head size 64 -> 32 heads. Runs long_500k
(O(1) state -- the shape this family exists for)."""
from . import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6_1_6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                # head_size 64
    n_kv_heads=32,
    d_head=64,
    d_ff=7168,
    vocab_size=65536,
    ssm_type="rwkv6",
    pos_kind="none",
    norm="layernorm",
    act="gelu",
    tie_embeddings=False,
    skip_shapes=(),
    source="arXiv:2404.05892 (RWKV-6 Finch); unverified",
)

SMOKE = ArchConfig(
    name="rwkv6_smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    ssm_type="rwkv6",
    pos_kind="none",
    norm="layernorm",
    rwkv_chunk=4,
    tie_embeddings=False,
    remat=False,
    ce_chunk=8,
    source="reduced rwkv6_1_6b",
)
