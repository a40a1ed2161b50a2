"""The port's int8 gradient compression (`repro_torch.parallel.collectives`)
against the reference's (`repro.parallel.collectives`) on the CPU, exact.

The random bits are JAX's original Threefry layout, which the port's
`quality.keygen` reproduces, so the reference runs under
`jax.threefry_partitionable(False)` (JAX 0.9 defaults to the other
layout). Every compared value is exact: the int8 codes, the scales, the
dequantized gradients and the error-feedback residuals (f32 division,
floor and compare are IEEE operations in both frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import collectives as jcol
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.parallel import collectives as tcol


def rng(seed):
    return np.random.Generator(np.random.Philox(key=np.uint64(seed)))


@pytest.fixture(autouse=True)
def original_threefry():
    with jax.threefry_partitionable(False):
        yield


def grads_tree(seed=0) -> dict:
    """A gradient tree of mixed shapes and scales: stacked (3, ...) leaves,
    a vector, a 0-d leaf and a list."""
    g = rng(seed)
    f = lambda *s, scale=1.0: (g.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    return {"blocks": {"w": f(3, 16, 24, scale=1e-3), "scale": f(3, 24)},
            "embed": {"w": f(101, 24, scale=30.0)},
            "tiny": f(),
            "list": [f(7), f(2, 5, scale=1e-6)]}


def as_t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def assert_equal_trees(port, ref):
    got, want = dict(flatten_with_paths(port)), dict(flatten_with_paths(ref))
    assert set(got) == set(want)
    for path, w in want.items():
        x = got[path]
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        assert x.dtype == np.asarray(w).dtype, path
        np.testing.assert_array_equal(x, np.asarray(w), err_msg=path)


@pytest.mark.parametrize("shape", [(1,), (1000,), (33, 7), (4, 16, 24)])
@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e4])
def test_quantize_dequantize_exact(shape, scale):
    g = rng(1)
    x = (g.normal(size=shape) * scale).astype(np.float32)
    bits = g.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    jq, js = jcol.quantize_int8(jnp.asarray(x), jnp.asarray(bits))
    tq, ts = tcol.quantize_int8(torch.from_numpy(x),
                                torch.from_numpy(bits.astype(np.int64)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tcol.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jcol.dequantize_int8(jq, js)))


@pytest.mark.parametrize("seed", [0, 7])
def test_compress_grads_int8_exact(seed):
    tree = grads_tree()
    want = jcol.compress_grads_int8(jax.tree.map(jnp.asarray, tree), seed=seed)
    assert_equal_trees(tcol.compress_grads_int8(as_t(tree), seed=seed),
                       jax.tree.map(np.asarray, want))


def test_compress_keeps_bf16_and_counts_integer_leaves():
    """A bf16 leaf comes back bf16; an integer leaf (the place of a key
    plane's gradient) passes through and is counted in the leaf index i of
    fold_in(key, i): the leaf after it draws the reference's bits of
    index 1. (The reference's own compress raises on a float0 leaf.)"""
    x = rng(2).normal(size=(5, 9)).astype(np.float32)
    keys = torch.arange(6)
    out = tcol.compress_grads_int8([keys, torch.from_numpy(x)], seed=3)
    assert out[0] is keys
    key = jax.random.fold_in(jax.random.key(3), 1)
    bits = jax.random.bits(key, x.shape, jnp.uint32)
    q, s = jcol.quantize_int8(jnp.asarray(x), bits)
    np.testing.assert_array_equal(out[1].numpy(),
                                  np.asarray(jcol.dequantize_int8(q, s)))
    b16 = tcol.compress_grads_int8([torch.from_numpy(x).bfloat16()])[0]
    assert b16.dtype == torch.bfloat16


def test_error_feedback_compress_exact():
    tree = grads_tree(3)
    res = jax.tree.map(lambda a: (rng(4).normal(size=a.shape) * 1e-3)
                       .astype(np.float32), tree)
    j_out, j_res = jcol.error_feedback_compress(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, res), seed=5)
    t_out, t_res = tcol.error_feedback_compress(as_t(tree), as_t(res), seed=5)
    assert_equal_trees(t_out, jax.tree.map(np.asarray, j_out))
    assert_equal_trees(t_res, jax.tree.map(np.asarray, j_res))
    # feeding the residual back: a second round, exact again
    j2, jr2 = jcol.error_feedback_compress(jax.tree.map(jnp.asarray, tree), j_res,
                                           seed=6)
    t2, tr2 = tcol.error_feedback_compress(as_t(tree), t_res, seed=6)
    assert_equal_trees(t2, jax.tree.map(np.asarray, j2))
    assert_equal_trees(tr2, jax.tree.map(np.asarray, jr2))
