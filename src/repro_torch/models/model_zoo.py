"""Uniform per-arch API: build(cfg) -> ModelAPI with init / loss / prefill /
decode_step / init_caches / input_specs. The serving engine goes through
this; `configs.get_config(name)` and then `build()`.

The port of `repro.models.model_zoo`. This slice builds the attention
families with a dense FFN (yi, mistral, phi3, gemma3 and its hashed
variant, qwen2-vl); a config with MoE, Mamba or RWKV sublayers, or the
encoder-decoder, raises `NotImplementedError` at `build` (the next slice).
Batches may hold numpy arrays or tensors; they are moved to the
parameters' device. `loss` is the forward loss: gradients are a later
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs import ArchConfig, ShapeSpec
from . import transformer
from .transformer import NEXT_SLICE


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable                  # (torch.Generator) -> params
    loss: Callable                  # (params, batch) -> (loss, metrics)
    prefill: Callable               # (params, batch, cache_len) -> (logits, caches)
    decode_step: Callable           # (params, caches, token, pos) -> (logits, caches)
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
    transformer.check_ported(cfg)

    def init(gen: torch.Generator):
        """Weights drawn from `gen` on its device."""
        return transformer.init_lm(gen, cfg)

    def loss(params, batch):
        return transformer.lm_loss(params, cfg, _on(params, batch))

    def prefill(params, batch, cache_len=None):
        b = _on(params, batch)
        return transformer.prefill(params, cfg, b["tokens"], cache_len=cache_len,
                                   patch_embeds=b.get("patch_embeds"))

    def decode_step(params, caches, token, pos):
        token = torch.as_tensor(token, device=params_device(params))
        return transformer.decode_step(params, cfg, caches, token, pos)

    def init_caches(B, S, device=None):
        return transformer.init_caches(cfg, B, S, device=device)

    def input_specs(shape: ShapeSpec):
        return _batch_specs_lm(cfg, shape)

    return ModelAPI(cfg, init, loss, prefill, decode_step, init_caches, input_specs)


def _build_encdec(cfg: ArchConfig) -> ModelAPI:
    raise NotImplementedError(f"{cfg.name}: the encoder-decoder is {NEXT_SLICE}")
