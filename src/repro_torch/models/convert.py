"""Weight carry-over from the reference: `params_from_jax`.

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
  router's `const_hash_*`) become int64 tensors of the same u32 values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .layers import ParamTree
from .transformer import block_spec, compute_dtype

_ORDER = ("embed", "pos_dec", "enc_layers", "blocks", "tail", "enc_norm",
          "final_norm", "lm_head")
# leaves the reference uses uncast in f32 (a linear's bias is "b", cast at use)
_F32_LEAVES = ("scale", "bias", "A_log", "D", "dt_bias", "decay", "bonus")
_F32_PATHS = (("router", "w"),)
_KEY_PLANES = ("const_key", "const_hash")


def params_from_jax(cfg, tree: dict, device=None) -> ParamTree:
    """The reference's parameter pytree (numpy leaves) as the port's
    parameters on `device` (default: the card)."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg)
    stacked = {"blocks": block_spec(cfg)[0], "enc_layers": cfg.n_encoder_layers}

    def leaf(path, a):
        a = np.asarray(a)
        if path[-1].startswith(_KEY_PLANES):
            return torch.from_numpy(a.astype(np.uint32).astype(np.int64)).to(device)
        held = (torch.float32 if path[-1] in _F32_LEAVES or path[-2:] in _F32_PATHS
                else dtype)
        return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=held)

    def walk(node, path, row=None):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,), row) for k, v in node.items()}
        if row is None:
            return leaf(path, node)
        n = stacked[path[0]]
        if np.shape(node)[0] != n:
            raise ValueError(f"{cfg.name}: a stacked {path[0]} leaf has leading "
                             f"axis {np.shape(node)[0]}, expected {n}")
        return leaf(path, np.asarray(node)[row])

    unknown = set(tree) - set(_ORDER)
    if unknown:
        raise ValueError(f"unknown top-level parameters {sorted(unknown)}")
    out = {k: [walk(tree[k], (k,), r) for r in range(stacked[k])] if k in stacked
           else walk(tree[k], (k,)) for k in _ORDER if k in tree}
    return ParamTree(out)
