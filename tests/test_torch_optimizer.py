"""The port's optimizers (`repro_torch.train.optimizer`) against the
reference's (`repro.train.optimizer`) on the CPU.

The same seeded numpy gradients go to both, on a tree in the reference's
layout: stacked blocks (a (3, 8) norm scale -- a per-block 1-D leaf the
reference stacks into a matrix -- and a (3, 4, 6, 5) expert stack), an
unstacked matrix and vector, and u32 `const_` key planes (one stacked)
that pass through untouched. The port holds the blocks as a list, the
reference stacked. Tolerances:
- the schedule, in f32 in both: rtol 1e-6, atol 1e-7 x peak_lr (its
  cosine may differ by an ulp, 6e-8, between the two frameworks, and
  1 + cos cancels near the end of the decay);
- the global norm: rtol 1e-6;
- parameters and optimizer state after 1 and 5 updates from the same
  gradients: |port - reference| <= 1e-6 x the leaf's largest magnitude
  (+1e-12 for an all-zero leaf).
The reference's own `tests/test_optimizer.py` cases are mirrored on the
port at the end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.models.convert import reference_layout, reference_leaves
from repro_torch.models.layers import ParamTree
from repro_torch.train import optimizer as topt

N_BLOCKS = 3
SCHED = dict(peak_lr=0.05, warmup_steps=2, decay_steps=20)


def rng(seed):
    return np.random.Generator(np.random.Philox(key=np.uint64(seed)))


def ref_tree(seed=0) -> dict:
    """A parameter tree in the reference's layout (numpy leaves)."""
    g = rng(seed)
    f = lambda *s: g.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "blocks": {"ln": {"scale": f(N_BLOCKS, 8)},
                   "moe": {"w_up": {"w": f(N_BLOCKS, 4, 6, 5)},
                           "const_hash_hi": np.arange(N_BLOCKS * 34, dtype=np.uint32)
                           .reshape(N_BLOCKS, 34) * np.uint32(2654435761)}},
        "embed": {"w": f(11, 8)},
        "final_norm": {"scale": f(8)},
        "const_key": np.array([7, 2**32 - 1, 5, 0, 9, 1], np.uint32),
    }


def port_tree(tree: dict, stacked=("blocks",)) -> ParamTree:
    """The port's trainable tree of a reference-layout tree: `stacked`
    keys become a list of per-block trees, u32 leaves int64."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            return torch.from_numpy(a.astype(np.int64))
        return torch.from_numpy(np.array(a, np.float32))

    def walk(node, row=None):
        if isinstance(node, dict):
            return {k: walk(v, row) for k, v in node.items()}
        return leaf(node if row is None else np.asarray(node)[row])

    return ParamTree({k: [walk(v, r) for r in range(N_BLOCKS)] if k in stacked
                      else walk(v) for k, v in tree.items()}, trainable=True)


def ref_grads(tree, seed) -> dict:
    """Seeded gradients for the float leaves; an integer leaf's place holds
    zeros of its dtype (skipped by the reference's norm and update, as a
    float0 gradient is)."""
    g = rng(seed)
    return jax.tree.map(lambda a: g.normal(size=a.shape).astype(np.float32)
                        if a.dtype == np.float32 else np.zeros_like(a), tree)


def port_grads(params, grads: dict) -> list:
    """The reference's gradients in the port's form: one entry a reference
    leaf, None for an integer leaf."""
    flat = dict(flatten_with_paths(grads))
    return [[torch.from_numpy(np.array(r)) for r in flat[leaf.path]] if leaf.stacked
            else [torch.from_numpy(np.array(flat[leaf.path]))]
            if leaf.tensors[0].is_floating_point() else None
            for leaf in reference_leaves(params)]


def as_np(t):
    t = torch.as_tensor(t)
    return t.numpy().astype(np.int64) if t.dtype == torch.uint32 else t.numpy()


def assert_trees_close(port: dict, ref: dict, rel=1e-6):
    got, want = dict(flatten_with_paths(port)), dict(flatten_with_paths(ref))
    assert set(got) == set(want)
    for path, w in want.items():
        w, x = np.asarray(w), as_np(got[path])
        assert x.shape == w.shape, path
        if w.dtype.kind == "f":
            err = np.abs(x - w).max(initial=0.0)
            assert err <= rel * np.abs(w).max(initial=0.0) + 1e-12, (path, err)
        else:
            np.testing.assert_array_equal(x, w.astype(np.int64), err_msg=path)


def test_schedule_matches_reference():
    for kw in (SCHED, dict(peak_lr=3e-4, warmup_steps=100, decay_steps=300),
               dict(peak_lr=1e-3, warmup_steps=0, decay_steps=250, min_ratio=0.0)):
        js, ts = jopt.Schedule(**kw), topt.Schedule(**kw)
        for step in range(301):
            got, want = ts(step), js(step)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-7 * kw["peak_lr"],
                                       err_msg=f"{kw} step {step}")
        assert float(ts(torch.tensor(7, dtype=torch.int32))) == float(ts(7))


def test_global_norm_and_clip_match_reference():
    tree = ref_tree()
    grads = ref_grads(tree, 1)
    params = port_tree(tree)
    pg = port_grads(params, grads)
    np.testing.assert_allclose(topt.global_norm(pg).numpy(),
                               np.asarray(jopt.global_norm(grads)), rtol=1e-6)
    for max_norm in (1.0, 1e3):
        (jc, jn), (tc, tn) = (jopt.clip_by_global_norm(grads, max_norm),
                              topt.clip_by_global_norm(pg, max_norm))
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
        for leaf, g in zip(reference_leaves(params), tc):
            want = dict(flatten_with_paths(jc))[leaf.path]
            if g is None:
                continue
            got = torch.stack(g) if leaf.stacked else g[0]
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-7)


def run_both(name: str, n_updates: int):
    tree = ref_tree()
    js, jo = jopt.Schedule(**SCHED), getattr(jopt, name)
    ts, to = topt.Schedule(**SCHED), getattr(topt, name)
    j = jo(js, weight_decay=0.1) if name == "adafactor" else jo(js)
    t = to(ts, weight_decay=0.1) if name == "adafactor" else to(ts)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = j.init(jp)
    tp = port_tree(tree)
    tstate = t.init(tp)
    for step in range(n_updates):
        grads = ref_grads(tree, 10 + step)
        jp, jstate, jm = j.update(jax.tree.map(jnp.asarray, grads), jstate, jp, step)
        tp2, tstate, tm = t.update(port_grads(tp, grads), tstate, tp, step)
        assert tp2 is tp  # updated in place
        np.testing.assert_allclose(tm["grad_norm"].numpy(), np.asarray(jm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].numpy(), np.asarray(jm["lr"]), rtol=1e-6)
    return (jp, jstate), (tp, tstate)


@pytest.mark.parametrize("n_updates", [1, 5])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_match_reference(name, n_updates):
    (jp, jstate), (tp, tstate) = run_both(name, n_updates)
    assert_trees_close(reference_layout(tp), jax.tree.map(np.asarray, jp))
    assert_trees_close(tstate, jax.tree.map(np.asarray, jstate))
    # the key planes passed through untouched, in the parameters and the state
    keys = dict(flatten_with_paths(reference_layout(tp)))
    np.testing.assert_array_equal(as_np(keys["const_key"]), ref_tree()["const_key"])
    np.testing.assert_array_equal(as_np(keys["blocks/moe/const_hash_hi"]),
                                  ref_tree()["blocks"]["moe"]["const_hash_hi"])


def test_adafactor_factors_a_stacked_vector_across_blocks():
    """The per-block (8,) norm scale is the reference's (3, 8) matrix: one
    row statistic a block and one column statistic shared by the blocks;
    the expert stack (3, 4, 6, 5) keeps (3, 4, 6) rows and (3, 4, 5)
    columns. Holding the blocks apart (per-block statistics, per-block
    update clip) gives another optimizer, which the reference disagrees
    with."""
    (jp, _), (tp, tstate) = run_both("adafactor", 5)
    st = tstate["f"]["blocks"]
    assert st["ln"]["scale"]["vr"].shape == (N_BLOCKS,)
    assert st["ln"]["scale"]["vc"].shape == (8,)
    assert st["moe"]["w_up"]["w"]["vr"].shape == (N_BLOCKS, 4, 6)
    assert st["moe"]["w_up"]["w"]["vc"].shape == (N_BLOCKS, 4, 5)
    # the same blocks as three unstacked subtrees: statistics a block
    tree = ref_tree()
    apart = {k: v for k, v in tree.items() if k != "blocks"}
    for b in range(N_BLOCKS):
        apart[f"block{b}"] = jax.tree.map(lambda a: np.asarray(a)[b], tree["blocks"])
    ts = topt.Schedule(**SCHED)
    t = topt.adafactor(ts, weight_decay=0.1)
    params = ParamTree(jax.tree.map(
        lambda a: torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                                   else np.array(a)), apart), trainable=True)
    state = t.init(params)
    for step in range(5):
        g = ref_grads(tree, 10 + step)
        g_apart = {k: v for k, v in g.items() if k != "blocks"}
        for b in range(N_BLOCKS):
            g_apart[f"block{b}"] = jax.tree.map(lambda a: np.asarray(a)[b], g["blocks"])
        t.update(port_grads(params, g_apart), state, params, step)
    got = np.stack([params[f"block{b}"]["ln"]["scale"].detach().numpy()
                    for b in range(N_BLOCKS)])
    want = np.asarray(jp["blocks"]["ln"]["scale"])
    assert np.abs(got - want).max() > 1e-4


# ---------------------------------------------------------------------------
# the reference's tests/test_optimizer.py, on the port
# ---------------------------------------------------------------------------

def _quadratic_problem(opt, steps=200):
    target = torch.tensor([1.5, -2.0, 0.5])
    params = ParamTree({"layer": {"w": torch.zeros(3)},
                        "const_keys": torch.tensor([7, 7])}, trainable=True)
    state = opt.init(params)
    metrics = None
    for step in range(steps):
        loss = ((params["layer"]["w"] - target) ** 2).sum()
        (g,) = torch.autograd.grad(loss, [params["layer"]["w"]])
        params, state, metrics = opt.update([None, [g]], state, params, step)
    return params, metrics


def test_adamw_converges():
    opt = topt.adamw(topt.Schedule(peak_lr=0.05, warmup_steps=10, decay_steps=200),
                     weight_decay=0.0)
    params, metrics = _quadratic_problem(opt)
    np.testing.assert_allclose(params["layer"]["w"].detach().numpy(),
                               [1.5, -2.0, 0.5], atol=0.05)
    assert float(metrics["grad_norm"]) >= 0


def test_adamw_leaves_consts_alone():
    opt = topt.adamw(topt.Schedule(peak_lr=0.05, warmup_steps=10, decay_steps=100))
    params, _ = _quadratic_problem(opt, steps=20)
    assert params["const_keys"].tolist() == [7, 7]


def test_adafactor_converges():
    opt = topt.adafactor(topt.Schedule(peak_lr=0.05, warmup_steps=10, decay_steps=300))
    params, _ = _quadratic_problem(opt, steps=300)
    np.testing.assert_allclose(params["layer"]["w"].detach().numpy(),
                               [1.5, -2.0, 0.5], atol=0.1)


def test_adafactor_matrix_state_is_factored():
    opt = topt.adafactor(topt.Schedule())
    st = opt.init(ParamTree({"mlp": {"w": torch.zeros(32, 8)}}, trainable=True))
    leaf = st["f"]["mlp"]["w"]
    assert set(leaf) == {"vr", "vc"}
    assert leaf["vr"].shape == (32,)
    assert leaf["vc"].shape == (8,)


def test_clip_by_global_norm():
    clipped, norm = topt.clip_by_global_norm([[torch.full((4,), 10.0)]], 1.0)
    assert abs(float(norm) - 20.0) < 1e-4
    np.testing.assert_allclose(clipped[0][0].numpy(), 0.5, rtol=1e-5)


def test_schedule_shape():
    s = topt.Schedule(peak_lr=1e-3, warmup_steps=10, decay_steps=100, min_ratio=0.1)
    assert float(s(0)) == 0.0
    assert abs(float(s(10)) - 1e-3) < 1e-9
    assert float(s(100)) <= 1e-3 * 0.1 + 1e-9
    assert abs(float(s(5)) - 0.5e-3) < 1e-9


def test_make_optimizer_names():
    s = topt.Schedule()
    assert topt.make_optimizer("adamw", s).init is not None
    assert topt.make_optimizer("adafactor", s).init is not None
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd", s)
