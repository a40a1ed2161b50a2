"""Uniform per-arch API: build(cfg) -> ModelAPI with init / loss / prefill /
decode_step / init_caches / input_specs. The serving engine goes through
this; `configs.get_config(name)` and then `build()`.

The port of `repro.models.model_zoo`, for all 10 architectures and their
variants. Batches may hold numpy arrays or tensors; they are moved to the
parameters' device. `loss` is the forward loss: gradients are a later
slice. `moe_groups` is the number of MoE dispatch groups (capacity is per
group, so it decides which tokens drop).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs import ArchConfig, ShapeSpec
from . import encdec, transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable                  # (torch.Generator) -> params
    loss: Callable                  # (params, batch, moe_groups) -> (loss, metrics)
    prefill: Callable               # (params, batch, cache_len, moe_groups) -> (logits, caches)
    decode_step: Callable           # (params, caches, token, pos, moe_groups) -> (logits, caches)
    init_caches: Callable           # (B, S, device=None) -> caches
    input_specs: Callable           # (ShapeSpec) -> dict name -> (shape, dtype)


def build(cfg: ArchConfig) -> ModelAPI:
    if cfg.encdec:
        return _build_encdec(cfg)
    return _build_lm(cfg)


def params_device(params) -> torch.device:
    return next(params.parameters()).device


def _on(params, batch: dict) -> dict:
    dev = params_device(params)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _batch_specs_lm(cfg, shape: ShapeSpec):
    B, T = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": ((B, T), i32)}
        if shape.kind == "train":
            specs["labels"] = ((B, T), i32)
        if cfg.vision_prefix:
            specs["patch_embeds"] = ((B, cfg.vision_prefix, cfg.d_model),
                                     torch.bfloat16)
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"token": ((B, 1), i32), "pos": ((), i32)}


def _build_lm(cfg: ArchConfig) -> ModelAPI:
    def init(gen: torch.Generator):
        """Weights drawn from `gen` on its device."""
        return transformer.init_lm(gen, cfg)

    def loss(params, batch, moe_groups=1):
        return transformer.lm_loss(params, cfg, _on(params, batch),
                                   moe_groups=moe_groups)

    def prefill(params, batch, cache_len=None, moe_groups=1):
        b = _on(params, batch)
        return transformer.prefill(params, cfg, b["tokens"], cache_len=cache_len,
                                   moe_groups=moe_groups,
                                   patch_embeds=b.get("patch_embeds"))

    def decode_step(params, caches, token, pos, moe_groups=1):
        token = torch.as_tensor(token, device=params_device(params))
        return transformer.decode_step(params, cfg, caches, token, pos,
                                       moe_groups=moe_groups)

    def init_caches(B, S, device=None):
        return transformer.init_caches(cfg, B, S, device=device)

    def input_specs(shape: ShapeSpec):
        return _batch_specs_lm(cfg, shape)

    return ModelAPI(cfg, init, loss, prefill, decode_step, init_caches, input_specs)


def _build_encdec(cfg: ArchConfig) -> ModelAPI:
    def init(gen: torch.Generator):
        """Weights drawn from `gen` on its device."""
        return encdec.init_encdec(gen, cfg)

    def loss(params, batch, moe_groups=1):
        return encdec.encdec_loss(params, cfg, _on(params, batch),
                                  moe_groups=moe_groups)

    def prefill(params, batch, cache_len=None, moe_groups=1):
        b = _on(params, batch)
        return encdec.encdec_prefill(params, cfg, b["frames"], b["tokens"],
                                     cache_len=cache_len, moe_groups=moe_groups)

    def decode_step(params, caches, token, pos, moe_groups=1):
        token = torch.as_tensor(token, device=params_device(params))
        return encdec.encdec_decode_step(params, cfg, caches, token, pos,
                                         moe_groups=moe_groups)

    def init_caches(B, S, device=None):
        # the reference's own refusal: the decoder's cross K/V come from
        # the encoder output, which only prefill has
        raise NotImplementedError("enc-dec caches require enc_out; use prefill")

    def input_specs(shape: ShapeSpec):
        B, T = shape.global_batch, shape.seq_len
        frames = ((B, cfg.encoder_positions, cfg.d_model), torch.bfloat16)
        if shape.kind in ("train", "prefill"):
            specs = {"frames": frames, "tokens": ((B, T), torch.int32)}
            if shape.kind == "train":
                specs["labels"] = ((B, T), torch.int32)
            return specs
        return {"token": ((B, 1), torch.int32), "pos": ((), torch.int32)}

    return ModelAPI(cfg, init, loss, prefill, decode_step, init_caches, input_specs)
