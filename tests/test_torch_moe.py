"""The port's MoE layer (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`) on the CPU.

The same seeded numpy inputs and the reference's weights go through both.
Integers (the hash router's expert ids, the dispatch tables) are exact;
float32 within rtol = atol = 1e-5 (one layer); bfloat16 within the few
ulps of `tests/test_torch_models.py`'s BF16 (the reference runs op by op
here, as it does outside `jax.jit`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jm
from repro_torch.models import moe as tm

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -5, atol=2.0 ** -3)
DT = {"float32": (jnp.float32, torch.float32, F32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def rng(seed):
    return np.random.Generator(np.random.Philox(key=np.uint64(seed)))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def to_torch(tree):
    """A reference parameter tree (numpy leaves) as the port holds it:
    float leaves as f32 tensors, u32 key planes as int64."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(np.array(a, np.float32))


def reference_params(E, router="learned", shared=False, act="swiglu", D=32, F=48):
    return jax.tree.map(np.asarray, jm.moe_init(
        jax.random.key(E), D, F, E, router=router, shared_expert=shared, act=act))


# ---------------------------------------------------------------------------
# the hash router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("E", [8, 32, 128])
def test_hash_route_exact(E, k):
    """The same key planes (`KeyBuffer(seed=0x40E + E).u64(34)`) and the same
    expert ids, token ids 0, 2^31 and 2^32-1 (as int32 bits) included."""
    p = reference_params(E, router="hash")
    planes = tm.hash_router_keys(E, "cpu")
    for name in ("const_hash_hi", "const_hash_lo"):
        np.testing.assert_array_equal(planes[name].numpy(), p[name].astype(np.int64))
    edge = np.array([0, 1, 2**31, 2**31 - 1, 2**32 - 1, 2**32 - 2], np.uint32)
    ids = np.concatenate([edge, rng(E + k).integers(0, 2**32, 250, dtype=np.uint64)
                          .astype(np.uint32)]).view(np.int32).reshape(2, -1)
    want = np.asarray(jm._hash_route({n: jnp.asarray(p[n]) for n in planes},
                                     jnp.asarray(ids), E, k))
    got = tm._hash_route(planes, torch.from_numpy(ids), E, k)
    assert got.shape == (ids.size, k)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got.min() >= 0 and got.max() < E


# ---------------------------------------------------------------------------
# dispatch and combine
# ---------------------------------------------------------------------------

def port_tables(idx, slot, gate, E, C):
    """The reference's inverse routing tables (inv_idx, slot_gate) of one
    group, from the port's slot of each (token, choice) pair."""
    n, k = idx.shape
    inv = np.full((E, C), n, np.int64)
    sg = np.zeros((E, C), np.float32)
    for t in range(n):
        for j in range(k):
            if slot[t, j] < C:
                assert inv[idx[t, j], slot[t, j]] == n  # every real slot once
                inv[idx[t, j], slot[t, j]] = t
                sg[idx[t, j], slot[t, j]] = gate[t, j]
    return inv, sg


@pytest.mark.parametrize("case", ["no drops", "drops", "collision", "one expert"])
def test_dispatch_tables_exact(case):
    """Slots, the capacity buffer and the inverse tables == the reference's,
    with forced drops (a small capacity), a token that picks one expert
    twice (it takes two slots) and every pair on one expert."""
    g = rng(3)
    n, k, E, D = 24, 2, 6, 8
    idx = g.integers(0, E, (n, k))
    C = {"no drops": n * k, "drops": 3, "collision": n * k, "one expert": 5}[case]
    if case == "collision":
        idx[::3, 1] = idx[::3, 0]
    if case == "one expert":
        idx[:] = 2
    gate = g.random((n, k)).astype(np.float32)
    x = g.normal(size=(n, D)).astype(np.float32)
    buf_j, inv_j, sg_j = jm._group_dispatch(jnp.asarray(x), jnp.asarray(idx, jnp.int32),
                                            jnp.asarray(gate), E, C)
    tidx = torch.from_numpy(idx)[None]
    slot = tm._group_dispatch(tidx, E, C)
    buf_t = tm._dispatch(torch.from_numpy(x)[None], tidx, slot, E, C)[0]
    np.testing.assert_array_equal(buf_t.numpy(), np.asarray(buf_j))
    inv_t, sg_t = port_tables(idx, slot[0].numpy(), gate, E, C)
    np.testing.assert_array_equal(inv_t, np.asarray(inv_j))
    np.testing.assert_array_equal(sg_t, np.asarray(sg_j))
    drops = int((slot >= C).sum())
    assert (drops > 0) == (case in ("drops", "one expert"))
    if case == "collision":
        twice = slot[0, ::3]
        assert (twice[:, 0] != twice[:, 1]).all()  # two slots of one expert


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["no drops", "drops", "collision"])
def test_combine_matches_in_the_reference_order(case, dt):
    """Each token's kept contributions, added in flat slot order, == the
    reference's scatter-add: bit for bit, in bf16 too."""
    g = rng(4)
    n, k, E, D = 20, 3, 5, 16
    idx = g.integers(0, E, (n, k))
    if case == "collision":
        idx[::2, 2] = idx[::2, 0]
    C = 4 if case == "drops" else n * k
    jd, td, _ = DT[dt]
    gate = g.random((n, k)).astype(np.float32)
    out = g.normal(size=(E, C, D)).astype(np.float32)
    _, inv_j, sg_j = jm._group_dispatch(jnp.zeros((n, D)), jnp.asarray(idx, jnp.int32),
                                        jnp.asarray(gate, jd), E, C)
    want = jm._group_combine_scatter(jnp.asarray(out, jd), inv_j, sg_j, n)
    tidx = torch.from_numpy(idx)[None]
    slot = tm._group_dispatch(tidx, E, C)
    got = tm._combine(torch.from_numpy(out).to(td)[None], tidx, slot,
                      torch.from_numpy(gate).to(td)[None], C)[0]
    np.testing.assert_array_equal(as_np(got), as_np(want))


def test_capacity_rule():
    assert tm.capacity_of(8, 1, 128, 1.25) == 1  # llama4's decode: B 8, k 1
    assert tm.capacity_of(1500, 8, 32, 1.25) == 469
    assert tm.capacity_of(4, 8, 32, 1.25) == 8  # never below k


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("router", ["learned", "hash"])
def test_moe_apply_matches(router, groups, shared, act, dt):
    """Both routers, G in {1, 2} (capacity is per group), with and without
    the shared expert, swiglu and gelu; outputs and the balance loss."""
    E, k = 8, 2
    p = reference_params(E, router=router, shared=shared, act=act)
    g = rng(5)
    x = g.normal(size=(2, 12, 32)).astype(np.float32)
    ids = g.integers(0, 500, (2, 12)).astype(np.int32)
    jd, td, tol = DT[dt]
    kw = dict(n_experts=E, k=k, groups=groups, router=router, act=act)
    y_j, aux_j = jm.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x, jd),
                              token_ids=jnp.asarray(ids), dtype=jd, **kw)
    y_t, aux_t = tm.moe_apply(to_torch(p), torch.from_numpy(x).to(td),
                              token_ids=torch.from_numpy(ids), dtype=td, **kw)
    assert y_t.dtype == td and y_t.shape == x.shape
    np.testing.assert_allclose(as_np(y_t), as_np(y_j), **tol)
    np.testing.assert_allclose(float(aux_t["balance_loss"]),
                               float(aux_j["balance_loss"]), **tol)
    assert (float(aux_t["balance_loss"]) == 0) == (router == "hash")


@pytest.mark.parametrize("capacity_factor", [0.25, 0.5])
@pytest.mark.parametrize("router", ["learned", "hash"])
def test_moe_apply_with_drops_matches(router, capacity_factor):
    """A small capacity factor drops most pairs; the dropped ones add
    nothing, in both packages alike."""
    E, k = 4, 2
    p = reference_params(E, router=router)
    g = rng(6)
    x = g.normal(size=(3, 10, 32)).astype(np.float32)
    ids = g.integers(0, 50, (3, 10)).astype(np.int32)
    kw = dict(n_experts=E, k=k, capacity_factor=capacity_factor, router=router)
    y_j, _ = jm.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                          token_ids=jnp.asarray(ids), dtype=jnp.float32, **kw)
    y_t, _ = tm.moe_apply(to_torch(p), torch.from_numpy(x),
                          token_ids=torch.from_numpy(ids), dtype=torch.float32, **kw)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32)
    assert (y_t.abs().sum(-1) == 0).any()  # some tokens lost every pair


def test_moe_apply_refuses_what_the_reference_asserts():
    p = to_torch(reference_params(4, router="hash"))
    x = torch.zeros(1, 3, 32)
    with pytest.raises(ValueError, match="token ids"):
        tm.moe_apply(p, x, n_experts=4, k=1, router="hash", dtype=torch.float32)
    with pytest.raises(ValueError, match="groups"):
        tm.moe_apply(p, x, n_experts=4, k=1, router="hash", groups=2,
                     token_ids=torch.zeros(1, 3, dtype=torch.int32),
                     dtype=torch.float32)


def test_moe_init_matches_reference_layout():
    """The same leaves, shapes and scales; the learned router in f32, the
    experts in the compute dtype, drawn one expert at a time."""
    for router, shared, act in [("learned", True, "swiglu"), ("hash", False, "gelu")]:
        want = reference_params(8, router=router, shared=shared, act=act)
        got = tm.moe_init(torch.Generator().manual_seed(0), 32, 48, 8, router=router,
                          shared_expert=shared, act=act, dtype=torch.bfloat16)
        flat_w = {".".join(k.key for k in p): v
                  for p, v in jax.tree_util.tree_leaves_with_path(want)}
        flat_g = {".".join(k.key for k in p): v
                  for p, v in jax.tree_util.tree_leaves_with_path(got)}
        assert set(flat_g) == set(flat_w)
        for name, v in flat_w.items():
            t = flat_g[name]
            assert tuple(t.shape) == v.shape, name
            if name.startswith("const_hash"):
                np.testing.assert_array_equal(t.numpy(), v.astype(np.int64))
                continue
            assert t.dtype == (torch.float32 if name == "router.w" else torch.bfloat16)
            assert abs(t.float().std().item() / v.std() - 1) < 0.15, name
