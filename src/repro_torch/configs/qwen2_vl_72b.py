"""Qwen2-VL-72B [vlm]: M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
Backbone only per spec: the vision frontend is a STUB -- input_specs()
provides precomputed patch embeddings for the first `vision_prefix` slots."""
from . import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_vl_72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab_size=152064,
    pos_kind="mrope",
    mrope_sections=(16, 24, 24),
    vision_prefix=256,
    rope_theta=1e6,
    act="swiglu",
    attn_bias=True,            # qwen2 uses qkv biases
    tie_embeddings=False,
    skip_shapes=("long_500k",),
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B",
)

SMOKE = ArchConfig(
    name="qwen2_vl_smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    pos_kind="mrope",
    mrope_sections=(2, 3, 3),
    vision_prefix=4,
    attn_bias=True,
    tie_embeddings=False,
    remat=False,
    ce_chunk=8,
    source="reduced qwen2_vl_72b",
)
