"""Architecture configs + input-shape registry (the port's own copy of
`repro.configs`, field for field).

Each assigned architecture has its own module exporting CONFIG (the exact
published dims) and SMOKE (a reduced same-family config for CPU tests).
`get_config(name)` / `list_configs()` are the public entry points. Every id
resolves here, also the families whose model code is still to be ported:
`models.build` raises for those.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int | None = None        # default d_model // n_heads
    # attention
    attention: str = "full"          # full | sliding_global | none
    sliding_window: int = 1024
    global_every: int = 0            # gemma3: 1 global per 6 layers
    rope_theta: float = 1e4
    rope_theta_global: float = 1e6   # gemma3 global layers
    pos_kind: str = "rope"           # rope | mrope | learned | sinusoidal | none
    qk_norm: bool = False
    attn_bias: bool = False
    # ffn
    act: str = "swiglu"
    mlp_bias: bool = False
    # moe
    moe: bool = False
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1               # MoE on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    shared_expert: bool = False
    router: str = "learned"          # learned | hash (paper technique)
    capacity_factor: float = 1.25
    # hybrid (jamba): attention on layers where i % attn_every == attn_offset
    attn_every: int = 0
    attn_offset: int = 0
    # ssm
    ssm_type: str | None = None      # mamba | rwkv6
    d_state: int = 16
    ssm_expand: int = 2
    ssm_chunk: int = 64
    rwkv_chunk: int = 16
    # embeddings
    tie_embeddings: bool = True
    hashed_embedding: bool = False
    hashed_vocab_factor: int = 4     # n_buckets = vocab // factor
    hashed_n_hashes: int = 2
    # enc-dec (whisper)
    encdec: bool = False
    n_encoder_layers: int = 0
    encoder_positions: int = 1500
    # vlm
    vision_prefix: int = 0           # tokens provided as patch embeddings
    mrope_sections: tuple = (16, 24, 24)
    # norms / dtypes
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # training-time knobs
    optimizer: str = "adamw"         # adamw | adafactor (giants)
    fsdp_pods: bool = False
    remat: bool = True
    seq_shard_activations: bool = True
    ce_chunk: int = 256
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    causal_skip: bool = False        # §Perf lever; baseline off
    moe_groups: int = 0              # 0 -> #data shards at call time
    grad_accum: int = 1
    # shape applicability
    skip_shapes: tuple = ()
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic total parameter count (for 6ND roofline MODEL_FLOPS)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        dh = self.head_dim
        emb = V * D if not self.hashed_embedding else (V // self.hashed_vocab_factor) * D + V * self.hashed_n_hashes
        total = emb
        if not self.tie_embeddings:
            total += V * D
        att = D * self.n_heads * dh + 2 * D * self.n_kv_heads * dh + self.n_heads * dh * D
        ffn_mults = 3 if self.act == "swiglu" else 2
        dense_ffn = ffn_mults * D * F
        moe_ffn = self.n_experts * ffn_mults * D * F + D * self.n_experts
        if self.shared_expert:
            moe_ffn += dense_ffn
        d_inner = self.ssm_expand * D
        dt_rank = -(-D // 16)
        mamba = D * 2 * d_inner + d_inner * 4 + d_inner * (dt_rank + 2 * self.d_state) \
            + dt_rank * d_inner + d_inner * self.d_state + 2 * d_inner + d_inner * D
        rwkv_tm = 6 * D * D + 2 * D * 64 + 7 * D
        rwkv_cm = 2 * D * F // 2 + D * D  # rwkv ffn uses its own d_ff
        for i in range(L):
            is_attn = self._layer_is_attention(i)
            if self.ssm_type == "rwkv6":
                total += rwkv_tm + (D * F + F * D + D * D)  # time+channel mix
                continue
            if is_attn:
                total += att
            else:
                total += mamba
            if self._layer_is_moe(i):
                total += moe_ffn
            elif not self.encdec or True:
                total += dense_ffn if (self.ssm_type != "mamba" or is_attn or self.family == "hybrid") else 0
        if self.encdec:
            total += self.n_encoder_layers * (att + dense_ffn)
            total += self.n_encoder_layers * 2 * D + L * 3 * D  # norms-ish
            total += L * att  # cross attention
        return int(total)

    def _layer_is_attention(self, i: int) -> bool:
        if self.ssm_type is None:
            return True
        if self.family == "hybrid" and self.attn_every:
            return i % self.attn_every == self.attn_offset
        return False

    def _layer_is_moe(self, i: int) -> bool:
        if not self.moe:
            return False
        return i % self.moe_every == self.moe_offset

    def _layer_is_global_attn(self, i: int) -> bool:
        if self.attention != "sliding_global":
            return True
        return (i + 1) % (self.global_every or 1) == 0

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.moe:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        ffn_mults = 3 if self.act == "swiglu" else 2
        full_moe = self.n_experts * ffn_mults * D * F
        active_moe = self.experts_per_token * ffn_mults * D * F
        n_moe_layers = sum(self._layer_is_moe(i) for i in range(self.n_layers))
        return self.param_count() - n_moe_layers * (full_moe - active_moe)


# ---------------------------------------------------------------------------
# Input shapes (assigned set). decode_* / long_* lower serve_step.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCH_IDS = [
    "yi_34b",
    "gemma3_27b",
    "mistral_nemo_12b",
    "phi3_medium_14b",
    "jamba_v0_1_52b",
    "llama4_maverick_400b_a17b",
    "granite_moe_1b_a400m",
    "rwkv6_1_6b",
    "qwen2_vl_72b",
    "whisper_large_v3",
]


# paper-technique variants addressable as --arch ids (ablation cells)
_VARIANTS = {
    "gemma3_27b_hashed": ("gemma3_27b", "HASHED", "SMOKE_HASHED"),
    "granite_moe_hash": ("granite_moe_1b_a400m", "HASH_ROUTED", "SMOKE_HASH"),
}


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name in _VARIANTS:
        base, attr, smoke_attr = _VARIANTS[name]
        mod = importlib.import_module(f".{base}", __package__)
        return getattr(mod, smoke_attr if smoke else attr)
    mod = importlib.import_module(f".{name}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG


def list_configs() -> list[str]:
    return list(ARCH_IDS)


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, honouring per-arch skips."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            skipped = s.name in cfg.skip_shapes
            if include_skipped or not skipped:
                out.append((a, s.name))
    return out
