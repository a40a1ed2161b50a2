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

from ..parallel.sharding import constraint
from . import attention as attn
from . import layers
from .layers import ParamTree, init_normal
from .transformer import (SubDesc, _norm_apply, _norm_init, apply_sublayer,
                          chunked_ce_loss, compute_dtype, init_sublayer,
                          init_sublayer_cache, unembed_matrix)

ENC_DESC = SubDesc(kind="attn", causal=False, ffn="dense")
DEC_DESC = SubDesc(kind="attn", causal=True, ffn="dense", cross=True)
DEC_POSITIONS = 8192


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


def encode(params, cfg, frames, moe_groups=1):
    """frames: (B, S_enc, D) precomputed conv-frontend output (stub)."""
    dtype = compute_dtype(cfg)
    B, S, D = frames.shape
    x = frames.to(dtype) + layers.sinusoidal_positions(S, D, frames.device).to(dtype)[None]
    x = constraint(x, "batch", None, None)

    def layer(p, x):
        return apply_sublayer(p, x, ENC_DESC, cfg, mode="train",
                              moe_groups=moe_groups, dtype=dtype)[0]

    remat = cfg.remat and torch.is_grad_enabled()
    for p in params["enc_layers"]:
        x = checkpoint(layer, p, x, use_reentrant=False) if remat else layer(p, x)
    return _norm_apply(cfg, params["enc_norm"], x)


def _cross_kv(p_layer, cfg, enc_out):
    return attn.kv_project(p_layer["s0"]["cross"], enc_out, cfg.head_dim,
                           enc_out.dtype)


def init_decoder_caches(params, cfg, enc_out, B, S):
    """Per layer, stacked (n_layers, ...) as the reference stacks them: the
    self-attention's linear cache and the cross K/V of `enc_out`."""
    dtype = enc_out.dtype
    base = init_sublayer_cache(cfg, DEC_DESC, B, S, dtype, enc_out.device)
    n = len(params["blocks"])
    cache = {k: v.expand(n, *v.shape).clone() for k, v in base.items()}
    kv = [_cross_kv(p, cfg, enc_out) for p in params["blocks"]]
    cache["cross_k"] = torch.stack([k for k, _ in kv])
    cache["cross_v"] = torch.stack([v for _, v in kv])
    return {"blocks": {"s0": cache}}


def decoder_forward(params, cfg, tokens, *, mode, caches=None, enc_out=None,
                    pos_offset=0, moe_groups=1):
    """Returns (hidden (B, T, D), caches): the caches given, written in
    place. Without caches ('train') the cross K/V come from `enc_out`."""
    dtype = compute_dtype(cfg)
    T = tokens.shape[1]
    x = layers.embed(params["embed"], tokens, dtype)
    pos = pos_offset + torch.arange(T, device=x.device)
    x = x + params["pos_dec"]["w"].to(dtype)[pos][None]
    x = constraint(x, "batch", None, None)
    def layer(b, p_layer, x):
        if caches is not None:
            c = {k: t[b] for k, t in caches["blocks"]["s0"].items()}  # views
        else:
            ck, cv = _cross_kv(p_layer, cfg, enc_out.to(dtype))
            c = {"cross_k": ck, "cross_v": cv}
        return apply_sublayer(p_layer["s0"], x, DEC_DESC, cfg, mode=mode,
                              pos_offset=pos_offset, cache=c,
                              moe_groups=moe_groups, dtype=dtype)[0]

    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    for b, p_layer in enumerate(params["blocks"]):
        x = (checkpoint(layer, b, p_layer, x, use_reentrant=False) if remat
             else layer(b, p_layer, x))
    return _norm_apply(cfg, params["final_norm"], x), caches


def encdec_loss(params, cfg, batch, moe_groups=1):
    """batch: frames (B, S_enc, D), tokens (B, T), labels (B, T)."""
    enc_out = encode(params, cfg, batch["frames"], moe_groups)
    hidden, _ = decoder_forward(params, cfg, batch["tokens"], mode="train",
                                enc_out=enc_out, moe_groups=moe_groups)
    ce = chunked_ce_loss(params, cfg, hidden, batch["labels"], batch.get("mask"))
    return ce, {"ce": ce, "balance": torch.zeros((), dtype=torch.float32,
                                                 device=ce.device)}


def encdec_prefill(params, cfg, frames, tokens, cache_len=None, moe_groups=1):
    B, T = tokens.shape
    enc_out = encode(params, cfg, frames, moe_groups)
    caches = init_decoder_caches(params, cfg, enc_out, B, cache_len or T)
    hidden, caches = decoder_forward(params, cfg, tokens, mode="prefill",
                                     caches=caches, moe_groups=moe_groups)
    W = unembed_matrix(params, cfg, hidden.dtype)
    return (hidden[:, -1] @ W).float(), caches


def encdec_decode_step(params, cfg, caches, token, pos: int, moe_groups=1):
    """token: (B, 1); pos: the absolute position (an int). Returns (logits
    (B, V), caches), the caches written in place."""
    hidden, caches = decoder_forward(params, cfg, token, mode="decode",
                                     caches=caches, pos_offset=int(pos),
                                     moe_groups=moe_groups)
    W = unembed_matrix(params, cfg, hidden.dtype)
    return constraint((hidden[:, -1] @ W).float(), "batch", "model"), caches
