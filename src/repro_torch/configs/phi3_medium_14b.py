"""Phi-3-medium-14B [dense]: RoPE SwiGLU GQA [arXiv:2404.14219; unverified]."""
from . import ArchConfig

CONFIG = ArchConfig(
    name="phi3_medium_14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_head=128,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=1e4,
    act="swiglu",
    tie_embeddings=False,
    skip_shapes=("long_500k",),
    source="arXiv:2404.14219; unverified",
)

SMOKE = ArchConfig(
    name="phi3_medium_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=160,
    vocab_size=256,
    tie_embeddings=False,
    remat=False,
    ce_chunk=8,
    source="reduced phi3_medium_14b",
)
