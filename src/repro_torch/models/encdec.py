"""Whisper-style encoder-decoder backbone (the conv frontend is a stub:
`input_specs()` gives precomputed frame embeddings (B, S_enc, D)).

The port of `repro.models.encdec`. Encoder: bidirectional attention over
the frames plus sinusoidal positions. Decoder: causal self-attention,
cross-attention (the encoder's K/V, cached once per request) and an MLP,
with learned positions (8,192 rows). Built from the sublayers of
transformer.py; the layer stacks are lists, as the LM's blocks are
(`enc_layers.3.attn.wq.w` is the reference's `enc_layers/attn/wq/w[3]`).
With gradients on and `cfg.remat`, each encoder layer and each decoder
layer of a 'train' pass is recomputed in the backward, as the reference
checkpoints its scan bodies.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.partition import WHOLE
from ..parallel.sharding import constraint
from . import attention as attn
from . import layers
from .layers import ParamTree, init_normal
from .transformer import (SubDesc, _norm_apply, _norm_init, apply_sublayer,
                          chunked_ce_loss, compute_dtype, embed_tokens, init_sublayer,
                          init_sublayer_cache, local_caches, logits_of)

ENC_DESC = SubDesc(kind="attn", causal=False, ffn="dense")
DEC_DESC = SubDesc(kind="attn", causal=True, ffn="dense", cross=True)
DEC_POSITIONS = 8192
TOP = ("embed", "pos_dec", "enc_norm", "final_norm")


def init_encdec(gen: torch.Generator, cfg, train: bool = False) -> ParamTree:
    """Weights drawn from `gen` on its device, matrices in the compute
    dtype (norm scales and biases in f32); with `train`, f32 masters that
    take gradients (`transformer.init_lm`)."""
    dtype = torch.float32 if train else compute_dtype(cfg)
    return ParamTree({
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "pos_dec": {"w": init_normal(gen, (DEC_POSITIONS, cfg.d_model), 0.01, dtype)},
        "enc_layers": [init_sublayer(gen, cfg, ENC_DESC, dtype)
                       for _ in range(cfg.n_encoder_layers)],
        "blocks": [{"s0": init_sublayer(gen, cfg, DEC_DESC, dtype)}
                   for _ in range(cfg.n_layers)],
        "enc_norm": _norm_init(cfg, gen),
        "final_norm": _norm_init(cfg, gen),
    }, trainable=train)


def encode(params, cfg, frames, moe_groups=1, *, part=WHOLE, top=None):
    """frames: (B, S_enc, D) precomputed conv-frontend output (stub). With
    a `parallel.partition.Partition`: the rank's share of each layer, the
    output whole on every model rank."""
    dtype = compute_dtype(cfg)
    B, S, D = frames.shape
    top = top if top is not None else part.tops(params, TOP)
    sp = part.seq(cfg, S)
    x = frames.to(dtype) + layers.sinusoidal_positions(S, D, frames.device).to(dtype)[None]
    x = part.own(constraint(x, "batch", None, None), sp)

    def layer(p, x):
        return apply_sublayer(part.gather(p), x, ENC_DESC, cfg, mode="train",
                              moe_groups=moe_groups, dtype=dtype, part=part, sp=sp)[0]

    remat = cfg.remat and torch.is_grad_enabled()
    for p in params["enc_layers"]:
        x = checkpoint(layer, p, x, use_reentrant=False) if remat else layer(p, x)
    return part.enter(_norm_apply(cfg, top["enc_norm"], x), sp)


def _cross_kv(p_layer, cfg, enc_out, part=WHOLE):
    return attn.kv_project(p_layer["s0"]["cross"], enc_out, cfg.n_kv_heads, cfg.head_dim,
                           enc_out.dtype, part)


def decoder_cache_shapes(cfg, B, S, dtype) -> dict:
    """The decoder caches' tree as meta tensors (shapes only): what
    `init_decoder_caches` makes for B rows of S positions."""
    n = cfg.n_layers
    base = init_sublayer_cache(cfg, DEC_DESC, B, S, dtype, "meta")
    cache = {k: v.expand(n, *v.shape) for k, v in base.items()}
    cross = (n, B, cfg.encoder_positions, cfg.n_kv_heads, cfg.head_dim)
    cache.update({name: torch.empty(cross, dtype=dtype, device="meta")
                  for name in ("cross_k", "cross_v")})
    return {"blocks": {"s0": cache}}


def init_decoder_caches(params, cfg, enc_out, B, S, part=WHOLE):
    """Per layer, stacked (n_layers, ...) as the reference stacks them: the
    self-attention's linear cache and the cross K/V of `enc_out`. With a
    serving `parallel.partition.ServingPartition` (`enc_out` its rows of
    the B, whole): the rank's chunks."""
    dtype = enc_out.dtype
    kv = [_cross_kv(p, cfg, enc_out, part) for p in params["blocks"]]
    if part.cache_len is not None:
        shapes = decoder_cache_shapes(cfg, B, S, dtype)
        cross = {name: shapes["blocks"]["s0"].pop(name) for name in ("cross_k", "cross_v")}
        cache = local_caches(shapes, part, enc_out.device)["blocks"]["s0"]
        for i, name in enumerate(("cross_k", "cross_v")):
            span = part.cache_chunk(f"blocks/s0/{name}", cross[name].shape)[2]
            cache[name] = torch.stack([pair[i][:, span] for pair in kv])
        return {"blocks": {"s0": cache}}
    n = len(params["blocks"])
    base = init_sublayer_cache(cfg, DEC_DESC, B, S, dtype, enc_out.device)
    cache = {k: v.expand(n, *v.shape).clone() for k, v in base.items()}
    for i, name in enumerate(("cross_k", "cross_v")):
        cache[name] = torch.stack([pair[i] for pair in kv])
    return {"blocks": {"s0": cache}}


def decoder_forward(params, cfg, tokens, *, mode, caches=None, enc_out=None,
                    pos_offset=0, moe_groups=1, part=WHOLE, top=None):
    """Returns (hidden (B, T, D), caches): the caches given, written in
    place. Without caches ('train') the cross K/V come from `enc_out`.
    With a `parallel.partition.Partition`: the rank's share, hidden in the
    stream's layout."""
    dtype = compute_dtype(cfg)
    T = tokens.shape[1]
    top = top if top is not None else part.tops(params, TOP)
    sp = part.seq(cfg, T)
    x = embed_tokens(top, cfg, tokens, dtype, part=part, sp=sp)
    pos = part.own((pos_offset + torch.arange(T, device=x.device))[None], sp)[0]
    x = x + top["pos_dec"]["w"].to(dtype)[pos][None]
    x = constraint(x, "batch", None, None)
    enc = None if caches is not None else enc_out.to(dtype)

    def layer(b, p_layer, x):
        c = None if caches is None else {k: t[b] for k, t in caches["blocks"]["s0"].items()}
        return apply_sublayer(part.gather(p_layer)["s0"], x, DEC_DESC, cfg, mode=mode,
                              pos_offset=pos_offset, cache=c, moe_groups=moe_groups,
                              dtype=dtype, part=part, sp=sp, enc=enc)[0]

    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    for b, p_layer in enumerate(params["blocks"]):
        x = (checkpoint(layer, b, p_layer, x, use_reentrant=False) if remat
             else layer(b, p_layer, x))
    return _norm_apply(cfg, top["final_norm"], x), caches


def encdec_loss(params, cfg, batch, moe_groups=1, *, part=WHOLE):
    """batch: frames (B, S_enc, D), tokens (B, T), labels (B, T). With a
    `parallel.partition.Partition`: the rank's share of the CE
    (`transformer.lm_loss`)."""
    top = part.tops(params, TOP)
    enc_out = encode(params, cfg, batch["frames"], moe_groups, part=part, top=top)
    tokens = batch["tokens"]
    hidden, _ = decoder_forward(params, cfg, tokens, mode="train", enc_out=enc_out,
                                moe_groups=moe_groups, part=part, top=top)
    ce = chunked_ce_loss(top, cfg, hidden, batch["labels"], batch.get("mask"), part=part,
                         sp=part.seq(cfg, tokens.shape[1]))
    return ce, {"ce": ce, "balance": torch.zeros((), dtype=torch.float32,
                                                 device=ce.device)}


def encdec_prefill(params, cfg, frames, tokens, cache_len=None, moe_groups=1, part=WHOLE):
    """-> (logits (B, V) of the last position, caches); with a serving
    `parallel.partition.ServingPartition`, the rank's rows and chunks
    (`transformer.prefill`)."""
    B, T = tokens.shape
    top = part.tops(params, TOP)
    enc_out = encode(params, cfg, frames, moe_groups, part=part, top=top)
    caches = init_decoder_caches(params, cfg, enc_out, B * part.nb, cache_len or T, part)
    hidden, caches = decoder_forward(params, cfg, tokens, mode="prefill",
                                     caches=caches, moe_groups=moe_groups, part=part,
                                     top=top)
    if part.seq(cfg, T):  # the last position is the last model rank's
        hidden = part.whole(hidden[:, -1:], 1)
    return logits_of(top, cfg, hidden, part), caches


def encdec_decode_step(params, cfg, caches, token, pos: int, moe_groups=1, part=WHOLE):
    """token: (B, 1); pos: the absolute position (an int). Returns (logits
    (B, V), caches), the caches written in place."""
    top = part.tops(params, TOP)
    hidden, caches = decoder_forward(params, cfg, token, mode="decode",
                                     caches=caches, pos_offset=int(pos),
                                     moe_groups=moe_groups, part=part, top=top)
    return logits_of(top, cfg, hidden, part), caches
