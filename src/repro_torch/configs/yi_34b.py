"""Yi-34B [dense]: llama-arch GQA [arXiv:2403.04652; hf]."""
from . import ArchConfig

CONFIG = ArchConfig(
    name="yi_34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5e6,
    act="swiglu",
    tie_embeddings=False,
    skip_shapes=("long_500k",),  # pure full attention (DESIGN.md §6)
    source="arXiv:2403.04652; hf:01-ai/Yi-34B",
)

SMOKE = ArchConfig(
    name="yi_34b_smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=128,
    vocab_size=512,
    tie_embeddings=False,
    remat=False,
    ce_chunk=8,
    source="reduced yi_34b",
)
