"""Weight carry-over from the reference: `params_from_jax`.

The reference draws its weights with `jax.random`, the port with a
`torch.Generator`; the same seed gives different numbers. To hold the two
packages against each other, the reference's parameter pytree (as nested
dicts of numpy arrays: `jax.tree.map(np.asarray, params)`) becomes the
port's `ParamTree`:

- the stacked `blocks` (leading axis n_blocks) become a list of per-block
  trees, since the port loops over blocks;
- `tail`, `final_norm`, `lm_head` and `embed` keep their paths;
- matrices are held in the config's compute dtype (the reference casts its
  f32 weights to it at every use: same values), norm scales and biases in
  f32;
- the hashed embedding's `const_key_hi`/`const_key_lo` u32 planes become
  int64 tensors of the same u32 values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .layers import ParamTree
from .transformer import block_spec, check_ported, compute_dtype

_ORDER = ("embed", "blocks", "tail", "final_norm", "lm_head")
_F32_LEAVES = ("scale", "bias")  # norm parameters (a linear's bias is "b")


def params_from_jax(cfg, tree: dict, device=None) -> ParamTree:
    """The reference's parameter pytree (numpy leaves) as the port's
    parameters on `device` (default: the card)."""
    check_ported(cfg)
    device = resolve_device(device)
    dtype = compute_dtype(cfg)
    n_blocks = block_spec(cfg)[0]

    def leaf(name, a):
        a = np.asarray(a)
        if name.startswith("const_key"):
            return torch.from_numpy(a.astype(np.uint32).astype(np.int64)).to(device)
        held = torch.float32 if name in _F32_LEAVES else dtype
        return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=held)

    def walk(node, name, block=None):
        if isinstance(node, dict):
            return {k: walk(v, k, block) for k, v in node.items()}
        if block is None:
            return leaf(name, node)
        if np.shape(node)[0] != n_blocks:
            raise ValueError(f"{cfg.name}: a stacked block leaf has leading "
                             f"axis {np.shape(node)[0]}, expected {n_blocks}")
        return leaf(name, np.asarray(node)[block])

    unknown = set(tree) - set(_ORDER)
    if unknown:
        raise ValueError(f"unknown top-level parameters {sorted(unknown)}")
    out = {k: walk(tree[k], k) for k in _ORDER if k in tree and k != "blocks"}
    out["blocks"] = [walk(tree["blocks"], "blocks", b) for b in range(n_blocks)]
    return ParamTree({k: out[k] for k in _ORDER if k in out})
