"""Mistral-Nemo-12B [dense]: GQA, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]."""
from . import ArchConfig

CONFIG = ArchConfig(
    name="mistral_nemo_12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    act="swiglu",
    tie_embeddings=False,
    skip_shapes=("long_500k",),
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)

SMOKE = ArchConfig(
    name="mistral_nemo_smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=2,
    d_head=12,
    d_ff=96,
    vocab_size=384,
    tie_embeddings=False,
    remat=False,
    ce_chunk=8,
    source="reduced mistral_nemo_12b",
)
