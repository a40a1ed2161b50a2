"""Weight carry-over from the reference, both ways: `params_from_jax` and
its inverse `reference_layout`, with `reference_leaves`, the port's tree
seen leaf by leaf as the reference flattens its own.

The reference draws its weights with `jax.random`, the port with a
`torch.Generator`; the same seed gives different numbers. To hold the two
packages against each other, the reference's parameter pytree (as nested
dicts of numpy arrays: `jax.tree.map(np.asarray, params)`) becomes the
port's `ParamTree`:

- the stacked `blocks` (leading axis n_blocks) become a list of per-block
  trees, since the port loops over blocks;
- `enc_layers` (whisper's encoder, stacked over `n_encoder_layers`)
  becomes a list too;
- `tail`, `final_norm`, `enc_norm`, `lm_head`, `pos_dec` and `embed` keep
  their paths;
- matrices are held in the config's compute dtype (the reference casts its
  f32 weights to it at every use: same values); the leaves it uses uncast
  stay f32: norm scales and biases, the learned router's `router.w`,
  Mamba's `A_log`, `D` and `dt_bias`, RWKV's `decay` and `bonus`;
- the u32 key planes (the hashed embedding's `const_key_*`, the hash
  router's `const_hash_*`) become int64 tensors of the same u32 values;
- with `train`, every float leaf is an f32 master that takes gradients
  (the reference's own leaves are f32).

`reference_layout` turns the port's tree back into the reference's nested
dict (blocks stacked, key planes u32), of tensors where the port's lie:
what a training checkpoint stores, so either package resumes the other's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..core.device import as_u32_values, resolve_device
from ..core.pytree import flatten_with_paths, map_with_paths
from .layers import ParamTree
from .transformer import block_spec, compute_dtype

_ORDER = ("embed", "pos_dec", "enc_layers", "blocks", "tail", "enc_norm",
          "final_norm", "lm_head")
# leaves the reference uses uncast in f32 (a linear's bias is "b", cast at use)
_F32_LEAVES = ("scale", "bias", "A_log", "D", "dt_bias", "decay", "bonus")
_F32_PATHS = (("router", "w"),)
_KEY_PLANES = ("const_key", "const_hash")


def held_dtype(path: tuple, dtype: torch.dtype) -> torch.dtype:
    """The dtype a serving tree holds the float leaf at `path` (the
    reference's keys) in, and the models read it in: f32 for the leaves the
    reference uses uncast, else the compute dtype `dtype` (cast at use)."""
    return (torch.float32 if path[-1] in _F32_LEAVES or tuple(path[-2:]) in _F32_PATHS
            else dtype)


def params_from_jax(cfg, tree: dict, device=None, train: bool = False) -> ParamTree:
    """The reference's parameter pytree (numpy or tensor leaves) as the
    port's parameters on `device` (default: the card); with `train`, f32
    masters that take gradients."""
    device = resolve_device(device)
    dtype = torch.float32 if train else compute_dtype(cfg)
    stacked = {"blocks": block_spec(cfg)[0], "enc_layers": cfg.n_encoder_layers}

    def leaf(path, a):
        if path[-1].startswith(_KEY_PLANES):
            return as_u32_values(a, device)
        held = held_dtype(path, dtype)
        t = a.detach() if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a, np.float32))
        return t.to(device=device, dtype=held, copy=True)

    def walk(node, path, row=None):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,), row) for k, v in node.items()}
        if row is None:
            return leaf(path, node)
        n = stacked[path[0]]
        if np.shape(node)[0] != n:
            raise ValueError(f"{cfg.name}: a stacked {path[0]} leaf has leading "
                             f"axis {np.shape(node)[0]}, expected {n}")
        return leaf(path, node[row])

    unknown = set(tree) - set(_ORDER)
    if unknown:
        raise ValueError(f"unknown top-level parameters {sorted(unknown)}")
    out = {k: [walk(tree[k], (k,), r) for r in range(stacked[k])] if k in stacked
           else walk(tree[k], (k,)) for k in _ORDER if k in tree}
    return ParamTree(out, trainable=train)


class Stack(list):
    """The port's per-block tensors of one leaf that the reference stacks
    on a leading axis (its `blocks` and `enc_layers`); a leaf to
    `core.pytree`, which flattens only exact lists."""


class Leaf(NamedTuple):
    """One leaf of the reference's parameter pytree, seen in the port:
    its path ("blocks/s0/attn/wq/w"), the port's tensors (one a block for
    a stacked leaf, else one) and whether the reference stacks it."""
    path: str
    tensors: list
    stacked: bool

    @property
    def shape(self) -> tuple:
        """The reference's shape of the leaf (stacked: blocks first)."""
        one = tuple(self.tensors[0].shape)
        return (len(self.tensors),) + one if self.stacked else one


def _rows(rows: list):
    """Per-block nested dicts -> one nested dict of `Stack`s."""
    if isinstance(rows[0], dict):
        return {k: _rows([r[k] for r in rows]) for k in rows[0]}
    return Stack(rows)


def nested(params):
    """The port's tree as the reference's nested dict without a copy: a
    `ModuleList` of blocks becomes a dict of `Stack`s, a leaf stays the
    port's tensor."""
    if isinstance(params, nn.ModuleList):
        return _rows([nested(m) for m in params])
    if isinstance(params, nn.Module):
        return {k: nested(v) for k, v in {**params._parameters, **params._buffers,
                                           **params._modules}.items()}
    return params


def reference_leaves(params) -> list:
    """[Leaf] of a `ParamTree` in the reference's flatten order (sorted
    keys at every level): the order its optimizer, gradient norm and
    gradient compression visit the leaves in."""
    return [Leaf(path, list(x), True) if isinstance(x, Stack) else Leaf(path, [x], False)
            for path, x in flatten_with_paths(nested(params))]


def as_reference(x):
    """One leaf as the reference holds it: a `Stack` stacked, an int64 key
    plane as u32, detached, where it lies."""
    t = torch.stack([r.detach() for r in x]) if isinstance(x, Stack) else x.detach()
    return t.to(torch.uint32) if t.dtype == torch.int64 else t


def reference_layout(params) -> dict:
    """The inverse of `params_from_jax`: the reference's nested dict of the
    port's parameters, as tensors on their device (stacked copies; float
    leaves in their own dtype, key planes u32)."""
    return map_with_paths(lambda _p, x: as_reference(x), nested(params))
