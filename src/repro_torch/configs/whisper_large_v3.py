"""Whisper-large-v3 [audio]: enc-dec, conv frontend STUB [arXiv:2212.04356].
input_specs() provides precomputed frame embeddings (B, 1500, d_model).
decode_32k is lowered mechanically on the backbone (real model caps at 448
decoder positions -- noted in DESIGN.md §6); long_500k skipped (full attn)."""
from . import ArchConfig

CONFIG = ArchConfig(
    name="whisper_large_v3",
    family="audio",
    n_layers=32,               # decoder layers
    n_encoder_layers=32,
    encdec=True,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,             # full MHA
    d_head=64,
    d_ff=5120,
    vocab_size=51866,
    pos_kind="learned",
    encoder_positions=1500,
    norm="layernorm",
    act="gelu",
    attn_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
    source="arXiv:2212.04356; hf:openai/whisper-large-v3",
)

SMOKE = ArchConfig(
    name="whisper_smoke",
    family="audio",
    n_layers=2,
    n_encoder_layers=2,
    encdec=True,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    pos_kind="learned",
    encoder_positions=12,
    norm="layernorm",
    act="gelu",
    attn_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    remat=False,
    ce_chunk=8,
    source="reduced whisper_large_v3",
)
