"""Nested containers of arrays ("pytrees"), flattened with path strings.

The one flatten that `hash.tree.fingerprint_pytree` and the checkpointer
share. Order and paths equal `jax.tree_util.tree_flatten_with_path`
followed by the reference's `_leaf_path`, so the port and the reference
name and order the leaves of a state identically:

- a plain ``dict`` (or ``defaultdict``) goes in sorted key order, an
  ``OrderedDict`` in insertion order (a PyTorch ``state_dict`` keeps its
  own order); a key's path part is ``str(key)``;
- a list or tuple gives its index, a namedtuple ``.field``;
- ``None`` is an empty subtree (no leaf);
- anything else (a tensor, a numpy array, a Python scalar) is a leaf.

Path parts are joined with ``/``.
"""
from __future__ import annotations

import collections


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(node):
    """[(path part, child)] of a container in flatten order, or None for a
    leaf."""
    if node is None:
        return []
    if isinstance(node, collections.OrderedDict):
        return [(str(k), v) for k, v in node.items()]
    if type(node) in (dict, collections.defaultdict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if type(node) in (list, tuple):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] of every leaf of `tree`, in the reference's order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for part, child in kids:
        out += flatten_with_paths(child, f"{prefix}/{part}" if prefix else part)
    return out


def map_with_paths(fn, tree, prefix: str = ""):
    """`tree` with every leaf replaced by fn(path, leaf), called in flatten
    order; containers are rebuilt as their own types, a dict with its own
    key order (the inverse of `flatten_with_paths`)."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    vals = [map_with_paths(fn, child, f"{prefix}/{part}" if prefix else part)
            for part, child in kids]
    if tree is None:
        return None
    if isinstance(tree, dict):
        order = (list(tree) if isinstance(tree, collections.OrderedDict)
                 else sorted(tree))
        done = dict(zip(order, vals))
        out = {k: done[k] for k in tree}
        if isinstance(tree, collections.defaultdict):
            return collections.defaultdict(tree.default_factory, out)
        return type(tree)(out) if isinstance(tree, collections.OrderedDict) else out
    return type(tree)(*vals) if _is_namedtuple(tree) else type(tree)(vals)
