"""LM assembly: the block-structured layer stack of every assigned family.

The port of `repro.models.transformer`. An architecture is a sequence of
homogeneous *blocks* plus an optional *tail*; each block is a short list of
sublayer descriptors (attention / mamba / rwkv, each with a dense or MoE
FFN):
  dense (yi, mistral, phi3, qwen2-vl) .... L blocks x [attn+dense]
  gemma3 (5:1 local:global) .............. 10 blocks x [5 local, 1 global] + 2 tail
  llama4 / granite (MoE) ................. L blocks x [attn+moe]
  jamba (1:7 attn:mamba, MoE every 2nd) .. 4 blocks x [8 sublayers]
  rwkv6 .................................. L blocks x [time_mix+channel_mix]
(whisper's encoder-decoder lives in encdec.py on the same sublayers.)

Parameters are a `layers.ParamTree` whose paths are the reference's
pytree paths, with the blocks as a list (`blocks.3.s0.attn.wq.w` is the
reference's `blocks/s0/attn/wq/w[3]`): a Python loop over the blocks takes
the place of `lax.scan`. Caches keep the reference's stacked layout
(`caches["blocks"]["s0"]["k"]` is (n_blocks, B, S, Hkv, dh)); each block
reads and writes a view of its row, in place.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..core.pytree import map_with_paths
from ..parallel.partition import WHOLE
from ..parallel.sharding import constraint, seq_axis
from . import attention as attn
from . import layers, ssm
from . import moe as moe_mod
from .layers import ParamTree


@dataclasses.dataclass(frozen=True)
class SubDesc:
    kind: str                 # attn | mamba | rwkv
    causal: bool = True
    window: Optional[int] = None
    theta: float = 1e4
    ffn: Optional[str] = "dense"   # dense | moe | None (rwkv has its own)
    cross: bool = False            # whisper decoder cross-attention


def block_spec(cfg):
    """-> (n_blocks, [SubDesc] per block, [SubDesc] tail)."""
    if cfg.family == "hybrid":  # jamba
        per = cfg.attn_every
        subs = []
        for i in range(per):
            kind = "attn" if i % per == cfg.attn_offset else "mamba"
            ffn = "moe" if (cfg.moe and i % cfg.moe_every == cfg.moe_offset) else "dense"
            subs.append(SubDesc(kind=kind, ffn=ffn, theta=cfg.rope_theta))
        _check_period(cfg, per)
        return cfg.n_layers // per, subs, []
    if cfg.ssm_type == "rwkv6":
        return cfg.n_layers, [SubDesc(kind="rwkv", ffn=None)], []
    if cfg.attention == "sliding_global":
        per = cfg.global_every
        subs = [
            SubDesc(kind="attn", window=cfg.sliding_window, theta=cfg.rope_theta,
                    ffn="moe" if cfg.moe else "dense")
            for _ in range(per - 1)
        ] + [SubDesc(kind="attn", window=None, theta=cfg.rope_theta_global,
                     ffn="moe" if cfg.moe else "dense")]
        n_blocks = cfg.n_layers // per
        n_tail = cfg.n_layers - n_blocks * per
        tail = [dataclasses.replace(subs[i]) for i in range(n_tail)]
        return n_blocks, subs, tail
    if cfg.moe and cfg.moe_every > 1:  # interleaved MoE (llama4-style)
        per = cfg.moe_every
        subs = [SubDesc(kind="attn",
                        ffn="moe" if i % per == cfg.moe_offset else "dense",
                        theta=cfg.rope_theta)
                for i in range(per)]
        _check_period(cfg, per)
        return cfg.n_layers // per, subs, []
    ffn = "moe" if cfg.moe else "dense"
    return cfg.n_layers, [SubDesc(kind="attn", ffn=ffn, theta=cfg.rope_theta)], []


def _check_period(cfg, per: int) -> None:
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of the block period {per}")


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _norm_init(cfg, gen):
    return layers.rmsnorm_init(gen, cfg.d_model) if cfg.norm == "rmsnorm" \
        else layers.layernorm_init(gen, cfg.d_model)


def _norm_apply(cfg, p, x):
    return layers.rmsnorm(p, x, cfg.norm_eps) if cfg.norm == "rmsnorm" \
        else layers.layernorm(p, x, cfg.norm_eps)


def init_sublayer(gen, cfg, desc: SubDesc, dtype):
    p = {"ln1": _norm_init(cfg, gen)}
    if desc.kind == "attn":
        p["attn"] = attn.attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim, bias=cfg.attn_bias, dtype=dtype)
        if desc.cross:
            p["cross_ln"] = _norm_init(cfg, gen)
            p["cross"] = attn.attention_init(
                gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                bias=cfg.attn_bias, dtype=dtype)
    elif desc.kind == "mamba":
        p["mamba"] = ssm.mamba_init(gen, cfg.d_model, d_state=cfg.d_state,
                                    expand=cfg.ssm_expand, dtype=dtype)
    elif desc.kind == "rwkv":
        p["rwkv"] = ssm.rwkv6_init(gen, cfg.d_model, cfg.n_heads, cfg.d_ff,
                                   dtype=dtype)
        p["ln2"] = _norm_init(cfg, gen)
        p["rwkv_cm"] = ssm.rwkv6_channel_mix_init(gen, cfg.d_model, cfg.d_ff,
                                                  dtype=dtype)
        return p
    if desc.ffn == "dense":
        p["ln2"] = _norm_init(cfg, gen)
        p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, act=cfg.act,
                                   bias=cfg.mlp_bias, dtype=dtype)
    elif desc.ffn == "moe":
        p["ln2"] = _norm_init(cfg, gen)
        p["moe"] = moe_mod.moe_init(
            gen, cfg.d_model, cfg.d_ff, cfg.n_experts, router=cfg.router,
            shared_expert=cfg.shared_expert, act=cfg.act, dtype=dtype)
    return p


def init_block(gen, cfg, subs, dtype):
    return {f"s{i}": init_sublayer(gen, cfg, d, dtype) for i, d in enumerate(subs)}


def init_lm(gen: torch.Generator, cfg, train: bool = False) -> ParamTree:
    """Weights drawn from `gen` on its device, matrices held in the compute
    dtype (norm scales and the leaves the reference uses uncast in f32).
    With `train`, every float leaf is an f32 master taking gradients (the
    reference's `init` and optimizer keep f32 leaves; bf16 masters drift
    within a few steps)."""
    dtype = torch.float32 if train else compute_dtype(cfg)
    n_blocks, subs, tail = block_spec(cfg)
    params = {}
    if cfg.hashed_embedding:
        params["embed"] = layers.hashed_embedding_init(
            gen, cfg.vocab_size, cfg.d_model,
            cfg.vocab_size // cfg.hashed_vocab_factor, cfg.hashed_n_hashes, dtype)
    else:
        params["embed"] = layers.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                                dtype)
    params["blocks"] = [init_block(gen, cfg, subs, dtype) for _ in range(n_blocks)]
    if tail:
        params["tail"] = init_block(gen, cfg, tail, dtype)
    params["final_norm"] = _norm_init(cfg, gen)
    if not cfg.tie_embeddings or cfg.hashed_embedding:
        params["lm_head"] = {"w": layers.init_normal(
            gen, (cfg.d_model, cfg.vocab_size), 1.0 / math.sqrt(cfg.d_model), dtype)}
    return ParamTree(params, trainable=train)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg, tokens, dtype, *, part=WHOLE, sp=False, patch=None):
    """The token embedding (the `patch` embeddings in place of the first
    positions) in the stream's layout (`sp`). With a
    `parallel.partition.Partition` of several model ranks whose table is
    split over them: each rank looks up the tokens of its rows of the
    vocabulary, the rows summed over the ranks."""
    if cfg.hashed_embedding:
        e = params["embed"]
        nb = cfg.vocab_size // cfg.hashed_vocab_factor
        table = {"mix": e["mix"], "const_key_hi": e["const_key_hi"],
                 "const_key_lo": e["const_key_lo"],
                 "hashed": {"w": part.fit(e["hashed"]["w"], 0, nb)}} if part.M > 1 else e
        x, kind = layers.hashed_embed(table, tokens, nb, cfg.hashed_n_hashes, dtype), "full"
    else:
        w = params["embed"]["tok"]["w"]
        if w.shape[0] == cfg.vocab_size:
            x, kind = layers.embed(params["embed"], tokens, dtype), "full"
        else:  # the rank's rows of the vocabulary
            local = tokens.long() - part.r * w.shape[0]
            mine = (local >= 0) & (local < w.shape[0])
            x = layers.embed({"tok": {"w": w}}, torch.where(mine, local, 0), dtype)
            x, kind = x * mine[..., None].to(dtype), "partial"
    x = part.exit(x, kind, sp=sp and patch is None)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    if patch is None:
        return x
    P = patch.shape[1]
    return part.own(torch.cat([patch.to(dtype), x[:, P:]], dim=1), sp)


def unembed_matrix(params, cfg, dtype):
    """(D, V) projection for logits."""
    if "lm_head" in params:
        return params["lm_head"]["w"].to(dtype)
    return params["embed"]["tok"]["w"].to(dtype).T


# ---------------------------------------------------------------------------
# sublayer application (train / prefill / decode share this body)
# ---------------------------------------------------------------------------

def _positions_for(cfg, T, offset, vision_prefix, device):
    pos = offset + torch.arange(T, device=device)
    if cfg.pos_kind == "mrope":
        # text stream: t=h=w=pos ; vision prefix: t=0, (h, w) on a grid
        side = max(1, int(math.sqrt(max(vision_prefix, 1))))
        vis = pos < vision_prefix
        t = torch.where(vis, 0, pos)
        h = torch.where(vis, pos // side, pos)
        w = torch.where(vis, pos % side, pos)
        return torch.stack([t, h, w])  # (3, T)
    return pos  # (T,)


def _apply_rope_q_or_k(cfg, x, positions, theta):
    if cfg.pos_kind == "mrope":
        return layers.apply_mrope(x, positions, cfg.mrope_sections, theta)
    if cfg.pos_kind == "rope":
        return layers.apply_rope(x, positions, theta)
    return x  # learned/sinusoidal handled at embedding; 'none' for ssm


def _qk_norm(cfg, q, k):
    if not cfg.qk_norm:
        return q, k

    def _n(t):
        f = t.float()
        return (f * torch.rsqrt((f * f).mean(-1, keepdim=True) + 1e-6)).to(t.dtype)
    return _n(q), _n(k)


def _write(cache, **new):
    """Copy new state tensors into the cache's views, in place."""
    for name, t in new.items():
        cache[name].copy_(t)


def apply_sublayer(p, x, desc: SubDesc, cfg, *, mode, pos_offset=0, cache=None,
                   token_ids=None, moe_groups=1, dtype=torch.bfloat16, part=WHOLE,
                   sp=False, enc=None):
    """x: (B, T, D). mode: 'train' | 'prefill' | 'decode'. `cache` (this
    sublayer's, a view) is written in place; `enc` is the encoder output a
    'train' pass of whisper's decoder cross-attends to (serving reads its
    K/V from the cache). Returns (x, aux): aux is the MoE balance loss of
    an MoE FFN, else None. With a `parallel.partition.Partition` (the
    sharded train step's, or sharded serving's), x is the rank's part of
    the stream (`sp`: its share of the sequence), `p` its gathered weights,
    `cache` its chunk, and each sublayer computes the rank's share
    (`parallel.partition`): a prefill's attention its query rows, a decode
    step's every head against its chunk of the cache's positions."""
    D, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    aux = None

    def out(o, kind, w):  # the output projection, in the stream's layout
        return part.exit(*part.linear(o, kind == "cols", w, H * dh, D, dtype), sp=sp)

    h = part.enter(_norm_apply(cfg, p["ln1"], x), sp)
    T = h.shape[1]
    if desc.kind == "attn":
        positions = _positions_for(cfg, T, pos_offset,
                                   cfg.vision_prefix if mode != "decode" else 0, x.device)

        def rope(q, k, q0=0):  # q's rows from position q0 of the sequence
            pq = positions if q.shape[1] == T else positions[..., q0:q0 + q.shape[1]]
            q = _apply_rope_q_or_k(cfg, q, pq, desc.theta)
            k = _apply_rope_q_or_k(cfg, k, positions, desc.theta)
            return _qk_norm(cfg, q, k)

        if mode == "decode":
            q = attn._heads(attn.project(p["attn"]["wq"], h, H * dh, dtype, part), dh)
            k, v = attn.kv_project(p["attn"], h, cfg.n_kv_heads, dh, dtype, part)
            q, k = rope(q, k)
            attn.cache_insert(cache, k, v, pos_offset, part)
            o = attn.decode_attend(cache, q, pos_offset, window=desc.window, part=part)
            o, kind = o.reshape(*o.shape[:2], -1), "full"
        else:
            fill = None
            if mode == "prefill" and cache is not None:
                def fill(k, v):
                    attn.prefill_cache(cache, k, v, T, part)
            kw = dict(n_heads=H, n_kv_heads=cfg.n_kv_heads, d_head=dh, dtype=dtype,
                      part=part, rope=rope, causal=desc.causal, window=desc.window,
                      chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k, fill=fill)
            if mode == "prefill" and part.M > 1:  # projected, in the stream's layout
                o, kind = attn.attend_rows(p["attn"], h, sp=sp, **kw), "rows"
            else:
                o, kind = attn.attend(p["attn"], h, h, **kw)
        x = x + constraint(o if kind == "rows" else out(o, kind, p["attn"]["wo"]), "batch",
                           None, None)
        if desc.cross:  # whisper's decoder: K/V of the encoder output
            hc = part.enter(_norm_apply(cfg, p["cross_ln"], x), sp)
            if enc is not None:
                oc, kind = attn.attend(p["cross"], hc, enc, n_heads=H,
                                       n_kv_heads=cfg.n_kv_heads, d_head=dh, dtype=dtype,
                                       part=part, causal=False, chunk_q=cfg.attn_chunk_q,
                                       chunk_k=cfg.attn_chunk_k)
            else:  # cached once a request
                oc, kind = attn.cross_attend(p["cross"], hc, cache,
                                             n_enc=cfg.encoder_positions, n_heads=H,
                                             d_head=dh, dtype=dtype, part=part, sp=sp,
                                             chunk_q=cfg.attn_chunk_q,
                                             chunk_k=cfg.attn_chunk_k)
            x = x + (oc if kind == "rows" else out(oc, kind, p["cross"]["wo"]))
    elif desc.kind == "mamba":
        c = cache if cache is not None else {}
        o, (conv_s, ssm_s) = ssm.mamba_forward(
            p["mamba"], h, d_state=cfg.d_state, chunk=cfg.ssm_chunk,
            conv_state=c.get("conv"), ssm_state=c.get("ssm"), dtype=dtype,
            return_state=True, part=part, d_inner=cfg.ssm_expand * D, sp=sp)
        if cache is not None:
            _write(cache, conv=conv_s, ssm=ssm_s)
        x = x + constraint(o, "batch", None, None)
    else:  # rwkv: time mix and channel mix, no FFN
        c = cache if cache is not None else {}
        o, (wkv, sh_tm) = ssm.rwkv6_time_mix(
            p["rwkv"], h, cfg.n_heads, chunk=cfg.rwkv_chunk, state=c.get("wkv"),
            shift_state=c.get("shift_tm"), dtype=dtype, return_state=True, part=part,
            sp=sp)
        x = x + o
        h2 = part.enter(_norm_apply(cfg, p["ln2"], x), sp)
        o2, sh_cm = ssm.rwkv6_channel_mix(p["rwkv_cm"], h2, shift_state=c.get("shift_cm"),
                                          dtype=dtype, return_state=True, part=part,
                                          d_ff=cfg.d_ff, sp=sp)
        if cache is not None:
            _write(cache, wkv=wkv, shift_tm=sh_tm, shift_cm=sh_cm)
        return x + o2, aux

    if desc.ffn == "dense":
        h = part.enter(_norm_apply(cfg, p["ln2"], x), sp)
        x = x + layers.mlp(p["mlp"], h, act=cfg.act, dtype=dtype, part=part, d_ff=cfg.d_ff,
                           sp=sp)
    elif desc.ffn == "moe":
        h = part.enter(_norm_apply(cfg, p["ln2"], x), sp)
        o, moe_aux = moe_mod.moe_apply(
            p["moe"], h, n_experts=cfg.n_experts, k=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor, groups=moe_groups,
            router=cfg.router, token_ids=token_ids, act=cfg.act, dtype=dtype, part=part,
            d_ff=cfg.d_ff, sp=sp)
        aux = moe_aux["balance_loss"]
        x = x + o
    seq_sh = seq_axis(x.shape[1]) if cfg.seq_shard_activations else None
    return constraint(x, "batch", seq_sh, None), aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_sublayer_cache(cfg, desc: SubDesc, B, S, dtype=torch.bfloat16, device=None):
    if desc.kind == "attn":
        if desc.window is not None and S > desc.window:
            return attn.make_ring_cache(B, desc.window, cfg.n_kv_heads, cfg.head_dim,
                                        dtype, device)
        return attn.make_linear_cache(B, S, cfg.n_kv_heads, cfg.head_dim, dtype,
                                      device, sp_shard=S > 65536)
    dev = resolve_device(device)
    f32 = torch.float32
    if desc.kind == "mamba":
        d_inner = cfg.ssm_expand * cfg.d_model
        d_conv = 4
        return {"conv": torch.zeros(B, d_conv - 1, d_inner, dtype=dtype, device=dev),
                "ssm": constraint(torch.zeros(B, d_inner, cfg.d_state, dtype=f32,
                                              device=dev), None, "model", None)}
    if desc.kind == "rwkv":
        dk = cfg.d_model // cfg.n_heads
        return {"wkv": constraint(torch.zeros(B, cfg.n_heads, dk, dk, dtype=f32,
                                              device=dev), None, "model", None, None),
                "shift_tm": torch.zeros(B, cfg.d_model, dtype=dtype, device=dev),
                "shift_cm": torch.zeros(B, cfg.d_model, dtype=dtype, device=dev)}
    raise ValueError(desc.kind)


def init_caches(cfg, B, S, dtype=None, device=None, part=WHOLE):
    """Cache tree in the reference's layout: leaves under 'blocks' stacked
    (n_blocks, ...), 'tail' leaves unstacked. With a serving
    `parallel.partition.ServingPartition`, each leaf is the rank's chunk
    of the B rows' caches (`local_caches`)."""
    dtype = dtype or compute_dtype(cfg)
    device = resolve_device(device)
    if part.cache_len is not None:
        return local_caches(init_caches(cfg, B, S, dtype, torch.device("meta")), part,
                            device)
    n_blocks, subs, tail = block_spec(cfg)

    def stacked(desc):
        one = init_sublayer_cache(cfg, desc, B, S, dtype, device)
        return {k: v.expand(n_blocks, *v.shape).clone() for k, v in one.items()}

    caches = {"blocks": {f"s{i}": stacked(d) for i, d in enumerate(subs)}}
    if tail:
        caches["tail"] = {f"s{i}": init_sublayer_cache(cfg, d, B, S, dtype, device)
                          for i, d in enumerate(tail)}
    return caches


def local_caches(shapes, part, device):
    """A cache tree of meta tensors (the whole caches' shapes) -> the
    rank's chunks at their cache placements (`part.cache_chunk`) on
    `device`: zeros, and -1 for a ring cache's position tags."""
    def leaf(path, t):
        shape = [s.stop - s.start for s in part.cache_chunk(path, t.shape)]
        return torch.full(shape, -1 if path.endswith("pos") else 0, dtype=t.dtype,
                          device=device)

    return map_with_paths(leaf, shapes)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

TOP = ("embed", "lm_head", "final_norm")


def forward(params, cfg, tokens, *, mode="train", pos_offset=0, caches=None,
            patch_embeds=None, moe_groups=1, part=WHOLE, top=None):
    """tokens: (B, T) integer tensor. Returns (hidden (B,T,D), aux, caches):
    aux is the sum of the MoE layers' balance losses (0 without MoE);
    `caches` are the ones given, written in place (None in 'train' mode).
    The hash router reads the tokens as its token ids (the reference
    passes them to every sublayer, zeros for the other routers). In
    'train' mode with gradients on and `cfg.remat`, each block is
    recomputed in the backward (the reference's `jax.checkpoint` of its
    scan body, nothing saved): the same values, activation memory of one
    residual a block; the tail is not, as in the reference.

    With a `parallel.partition.Partition` (the sharded train step's): the
    rank's share, hidden in the stream's layout; each block's weights are
    gathered inside its (remat'd) function, the embedding, final norm and
    unembedding once (`top`: those already gathered, `part.tops(params,
    TOP)`)."""
    dtype = compute_dtype(cfg)
    _, subs, tail = block_spec(cfg)
    top = top if top is not None else part.tops(params, TOP)
    sp = part.seq(cfg, tokens.shape[1])
    x = embed_tokens(top, cfg, tokens, dtype, part=part, sp=sp, patch=patch_embeds)
    x = constraint(x, "batch", seq_axis(tokens.shape[1]) if cfg.seq_shard_activations
                   else None, None)
    kw = dict(mode=mode, pos_offset=pos_offset, moe_groups=moe_groups, dtype=dtype,
              token_ids=tokens if cfg.moe and cfg.router == "hash" else None, part=part,
              sp=sp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(b, p_block, x, aux):
        p_block = part.gather(p_block)
        for i, desc in enumerate(subs):
            cache = None if caches is None else {
                k: t[b] for k, t in caches["blocks"][f"s{i}"].items()}  # views
            x, a = apply_sublayer(p_block[f"s{i}"], x, desc, cfg, cache=cache, **kw)
            aux = aux if a is None else aux + a
        return x, aux

    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    for b, p_block in enumerate(params["blocks"]):
        if remat:
            x, aux = checkpoint(block, b, p_block, x, aux, use_reentrant=False)
        else:
            x, aux = block(b, p_block, x, aux)
    p_tail = part.gather(params["tail"]) if tail else None
    for i, desc in enumerate(tail):
        cache = None if caches is None else caches["tail"][f"s{i}"]
        x, a = apply_sublayer(p_tail[f"s{i}"], x, desc, cfg, cache=cache, **kw)
        aux = aux if a is None else aux + a
    x = _norm_apply(cfg, top["final_norm"], x)
    return x, aux, caches


# ---------------------------------------------------------------------------
# chunked cross entropy (never materializes (B,T,V))
# ---------------------------------------------------------------------------

def _chunk_loss(h, W, labels, weights, z_loss):
    """Summed CE plus z-loss of one (B, C) chunk; its (B, C, V) f32 logits
    exist only inside the call."""
    logits = constraint((h @ W).float(), "batch", None, "model")  # (B, C, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    zl = z_loss * lse.square()
    return ((lse - ll + zl) * weights).sum()


def _split_chunk_loss(part, h, W, labels, weights, z_loss):
    """`_chunk_loss` against the rank's rows of the vocabulary (W its
    columns): the max, the sum and the label's logit over "model"."""
    logits = (h @ W).float()                                   # (B, C, V/M)
    m = part.max_(logits.detach().amax(dim=-1))
    lse = m + torch.log(part.sum(torch.exp(logits - m[..., None]).sum(dim=-1)))
    local = labels.long() - part.r * W.shape[1]
    mine = (local >= 0) & (local < W.shape[1])
    ll = logits.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
    ll = part.sum(torch.where(mine, ll, 0.0))
    return ((lse - ll + z_loss * lse.square()) * weights).sum()


def chunked_ce_loss(params, cfg, hidden, labels, mask=None, z_loss=1e-4, *, part=WHOLE,
                    sp=False):
    """Mean CE over the (B, T) labels, in T chunks of `cfg.ce_chunk`. With
    gradients on, each chunk is recomputed in the backward (the
    reference's `jax.checkpoint` of its chunk body), so no chunk's logits
    outlive it. With a `parallel.partition.Partition` of several model
    ranks (hidden in the stream's layout, `sp`): the rank's share of the
    mean, each rank counting the tokens it owns -- with the vocabulary
    split, every token against the rank's rows; else the rank's own
    tokens."""
    B, T = labels.shape
    # T gathered across 'model' once; the CE chunks slice an unsharded T
    hidden = constraint(hidden, "batch", None, None)
    W = unembed_matrix(params, cfg, hidden.dtype)  # (D, V), or the rank's columns
    count = mask.sum().clamp_min(1) if mask is not None else max(B * T, 1)
    weights = mask.float() if mask is not None else torch.ones(
        B, T, dtype=torch.float32, device=hidden.device)
    fn = _chunk_loss
    if W.shape[1] != cfg.vocab_size:  # the rank's rows of the vocabulary
        hidden, fn = part.enter(hidden, sp), functools.partial(_split_chunk_loss, part)
        weights = weights * part.owned(B, T, hidden.device)
    elif sp:  # the rank's positions
        labels, weights = part.own(labels, sp), part.own(weights, sp)
    elif part.M > 1:  # every position, each counted by one rank
        weights = weights * part.owned(B, T, hidden.device)
    Tl = hidden.shape[1]
    C = min(cfg.ce_chunk, Tl)
    if Tl % C:
        raise ValueError(f"sequence length {Tl} is not a multiple of the CE "
                         f"chunk {C}")
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, Tl, C):
        args = (hidden[:, c0:c0 + C], W, labels[:, c0:c0 + C],
                weights[:, c0:c0 + C], z_loss)
        total = total + (checkpoint(fn, *args, use_reentrant=False)
                         if remat else fn(*args))
    return total / count


def lm_loss(params, cfg, batch, moe_groups=1, balance_coef=0.01, *, part=WHOLE):
    """CE plus `balance_coef` times the MoE balance loss, and the metrics
    {"ce", "balance"}; the loss carries the gradient of both terms. With a
    `parallel.partition.Partition` (the sharded train step's): the rank's
    share -- the CE of the tokens it owns, the balance loss counted once
    over the model ranks -- so that the model ranks' losses add up to
    their rows' loss; "ce" is the rank's CE share, "balance" the whole
    balance loss."""
    top = part.tops(params, TOP)
    tokens = batch["tokens"]
    hidden, aux, _ = forward(params, cfg, tokens, mode="train",
                             patch_embeds=batch.get("patch_embeds"),
                             moe_groups=moe_groups, part=part, top=top)
    ce = chunked_ce_loss(top, cfg, hidden, batch["labels"], batch.get("mask"), part=part,
                         sp=part.seq(cfg, tokens.shape[1]))
    return ce + balance_coef / part.M * aux, {"ce": ce, "balance": aux}


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------

def logits_of(top, cfg, hidden, part=WHOLE):
    """(B, V) f32 logits of hidden's last position (B, T or 1, D), every
    column on every model rank (with the vocabulary split over "model",
    the ranks' columns gathered)."""
    return part.fit((hidden[:, -1:] @ unembed_matrix(top, cfg, hidden.dtype)).float(), -1,
                    cfg.vocab_size)[:, 0]


def prefill(params, cfg, tokens, cache_len=None, moe_groups=1, patch_embeds=None,
            part=WHOLE):
    """-> (logits (B, V) of the last position, caches). With a serving
    `parallel.partition.ServingPartition`: the rank's rows (`tokens` its
    rows, whole along T) and its chunks of their caches."""
    B, T = tokens.shape
    caches = init_caches(cfg, B * part.nb, cache_len or T, device=tokens.device, part=part)
    top = part.tops(params, TOP)
    hidden, _, caches = forward(params, cfg, tokens, mode="prefill",
                                caches=caches, patch_embeds=patch_embeds,
                                moe_groups=moe_groups, part=part, top=top)
    if part.seq(cfg, T):  # the last position is the last model rank's
        hidden = part.whole(hidden[:, -1:], 1)
    return logits_of(top, cfg, hidden, part), caches


def decode_step(params, cfg, caches, token, pos: int, moe_groups=1, part=WHOLE):
    """token: (B, 1) integer tensor; pos: the absolute position (an int).
    Returns (logits (B, V), caches), the caches written in place."""
    top = part.tops(params, TOP)
    hidden, _, caches = forward(params, cfg, token, mode="decode",
                                pos_offset=int(pos), caches=caches,
                                moe_groups=moe_groups, part=part, top=top)
    return logits_of(top, cfg, hidden, part), caches
