"""The port's state-space layers (`repro_torch.models.ssm`: Mamba and
RWKV-6) against the reference's (`repro.models.ssm`) on the CPU.

The same seeded numpy inputs, states and the reference's weights go
through both, at T in {1, 5, chunk, chunk+1, 2*chunk+3}, from zero and
from carried states, and a prefill split in two against a whole one.
Tolerances: float32 rtol = atol = 1e-5 (one layer); bfloat16 the BF16 of
`tests/test_torch_models.py`, the reference running op by op (outside
`jax.jit`), as the port does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as js
from repro_torch.models import ssm as ts

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -5, atol=2.0 ** -3)
DT = {"float32": (jnp.float32, torch.float32, F32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}
D, H, N = 32, 4, 4   # d_model, RWKV heads (dk 8), Mamba d_state
CHUNK = 4            # both layers' chunk here (the SMOKE configs' own)
LENGTHS = [1, 5, CHUNK, CHUNK + 1, 2 * CHUNK + 3]


def rng(seed):
    return np.random.Generator(np.random.Philox(key=np.uint64(seed)))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


def pair(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


@pytest.fixture(scope="module")
def mamba():
    return pair(jax.tree.map(np.asarray, js.mamba_init(jax.random.key(1), D, d_state=N)))


@pytest.fixture(scope="module")
def rwkv():
    return pair(jax.tree.map(np.asarray, js.rwkv6_init(jax.random.key(2), D, H, 64)))


@pytest.fixture(scope="module")
def channel_mix():
    return pair(jax.tree.map(np.asarray, js.rwkv6_channel_mix_init(jax.random.key(3), D, 64)))


def inputs(T, seed, dt, shapes=()):
    """x (2, T, D) and optional states of `shapes`, as (jax, torch) pairs;
    states in f32 unless their shape is marked ("x", shape) for the
    compute dtype."""
    jd, td, _ = DT[dt]
    g = rng(seed)
    x = g.normal(size=(2, T, D)).astype(np.float32)
    out = [(jnp.asarray(x, jd), torch.from_numpy(x).to(td))]
    for kind, shape in shapes:
        a = (g.normal(size=shape) * 0.5).astype(np.float32)
        if kind == "x":
            out.append((jnp.asarray(a, jd), torch.from_numpy(a).to(td)))
        else:
            out.append((jnp.asarray(a), torch.from_numpy(a)))
    return out


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("T", LENGTHS)
def test_mamba_matches(mamba, T, carried, dt):
    """Output, conv tail and state: T == 1 takes the decode fast path,
    the others the chunked scan with dt = 0 padding."""
    (jp, tp), (jd, td, tol) = mamba, DT[dt]
    DI = 2 * D
    (jx, tx), *states = inputs(T, T, dt, [("x", (2, 3, DI)), ("f", (2, DI, N))]
                               if carried else [])
    kw = dict(d_state=N, chunk=CHUNK, return_state=True)
    js_kw = {"conv_state": states[0][0], "ssm_state": states[1][0]} if carried else {}
    ts_kw = {"conv_state": states[0][1], "ssm_state": states[1][1]} if carried else {}
    y_j, (c_j, h_j) = js.mamba_forward(jp, jx, dtype=jd, **kw, **js_kw)
    y_t, (c_t, h_t) = ts.mamba_forward(tp, tx, dtype=td, **kw, **ts_kw)
    assert y_t.dtype == td and c_t.dtype == td and h_t.dtype == torch.float32
    close(y_t, y_j, tol)
    np.testing.assert_array_equal(as_np(c_t), as_np(c_j))  # a slice of the input
    close(h_t, h_j, F32 if dt == "float32" else BF16)


@pytest.mark.parametrize("split", [1, 3, CHUNK, CHUNK + 2])
def test_mamba_split_prefill_equals_whole(mamba, split):
    """Two calls with the states carried == one call over the whole
    sequence (the reference's chunk boundaries move; the values agree to
    f32 rounding), and each call == the reference's."""
    (jp, tp) = mamba
    (jx, tx), = inputs(2 * CHUNK + 3, 7, "float32")
    kw = dict(d_state=N, chunk=CHUNK, dtype=torch.float32, return_state=True)
    y_all, (c_all, h_all) = ts.mamba_forward(tp, tx, **kw)
    y1, (c1, h1) = ts.mamba_forward(tp, tx[:, :split], **kw)
    y2, (c2, h2) = ts.mamba_forward(tp, tx[:, split:], conv_state=c1, ssm_state=h1, **kw)
    close(torch.cat([y1, y2], 1), y_all, F32)
    close(h2, h_all, F32)
    np.testing.assert_array_equal(c2.numpy(), c_all.numpy())
    jkw = dict(d_state=N, chunk=CHUNK, dtype=jnp.float32, return_state=True)
    _, (jc1, jh1) = js.mamba_forward(jp, jx[:, :split], **jkw)
    y2_j, (_, h2_j) = js.mamba_forward(jp, jx[:, split:], conv_state=jc1,
                                       ssm_state=jh1, **jkw)
    close(y2, y2_j, F32)
    close(h2, h2_j, F32)


def test_mamba_decode_steps_equal_the_chunked_scan(mamba):
    """T == 1 steps from the carried states == the chunked scan."""
    tp = mamba[1]
    (_, tx), = inputs(2 * CHUNK + 1, 8, "float32")
    kw = dict(d_state=N, chunk=CHUNK, dtype=torch.float32, return_state=True)
    y_all, (_, h_all) = ts.mamba_forward(tp, tx, **kw)
    conv = ssm = None
    ys = []
    for t in range(tx.shape[1]):
        y, (conv, ssm) = ts.mamba_forward(tp, tx[:, t:t + 1], conv_state=conv,
                                          ssm_state=ssm, **kw)
        ys.append(y)
    close(torch.cat(ys, 1), y_all, F32)
    close(ssm, h_all, F32)


def test_linear_scan_equals_the_recurrence():
    g = rng(9)
    a = torch.from_numpy(g.random((11, 3, 5)).astype(np.float32))
    b = torch.from_numpy(g.normal(size=(11, 3, 5)).astype(np.float32))
    ahat, bhat = ts._linear_scan(a, b)
    h, p = torch.zeros(3, 5), torch.ones(3, 5)
    for t in range(11):
        h, p = a[t] * h + b[t], p * a[t]
        close(bhat[t], h, F32)
        close(ahat[t], p, F32)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("T", LENGTHS)
def test_rwkv_time_mix_matches(rwkv, T, carried, dt):
    """Output, wkv state and shift state: T == 1 the decode fast path, the
    others the chunked pairwise form with chunk padding."""
    (jp, tp), (jd, td, tol) = rwkv, DT[dt]
    dk = D // H
    (jx, tx), *states = inputs(T, 20 + T, dt, [("f", (2, H, dk, dk)), ("x", (2, D))]
                               if carried else [])
    js_kw = {"state": states[0][0], "shift_state": states[1][0]} if carried else {}
    ts_kw = {"state": states[0][1], "shift_state": states[1][1]} if carried else {}
    y_j, (s_j, l_j) = js.rwkv6_time_mix(jp, jx, H, chunk=CHUNK, dtype=jd,
                                        return_state=True, **js_kw)
    y_t, (s_t, l_t) = ts.rwkv6_time_mix(tp, tx, H, chunk=CHUNK, dtype=td,
                                        return_state=True, **ts_kw)
    assert y_t.dtype == td and s_t.dtype == torch.float32 and l_t.dtype == td
    close(y_t, y_j, tol)
    close(s_t, s_j, tol)
    np.testing.assert_array_equal(as_np(l_t), as_np(l_j))


@pytest.mark.parametrize("split", [1, 3, CHUNK, CHUNK + 2])
def test_rwkv_split_prefill_equals_whole(rwkv, split):
    jp, tp = rwkv
    (jx, tx), = inputs(2 * CHUNK + 3, 30, "float32")
    kw = dict(chunk=CHUNK, dtype=torch.float32, return_state=True)
    y_all, (s_all, l_all) = ts.rwkv6_time_mix(tp, tx, H, **kw)
    y1, (s1, l1) = ts.rwkv6_time_mix(tp, tx[:, :split], H, **kw)
    y2, (s2, l2) = ts.rwkv6_time_mix(tp, tx[:, split:], H, state=s1, shift_state=l1, **kw)
    close(torch.cat([y1, y2], 1), y_all, F32)
    close(s2, s_all, F32)
    jkw = dict(chunk=CHUNK, dtype=jnp.float32, return_state=True)
    _, (js1, jl1) = js.rwkv6_time_mix(jp, jx[:, :split], H, **jkw)
    y2_j, (s2_j, _) = js.rwkv6_time_mix(jp, jx[:, split:], H, state=js1,
                                        shift_state=jl1, **jkw)
    close(y2, y2_j, F32)
    close(s2, s2_j, F32)


def test_rwkv_decode_steps_equal_the_chunked_form(rwkv):
    tp = rwkv[1]
    (_, tx), = inputs(2 * CHUNK + 1, 31, "float32")
    kw = dict(chunk=CHUNK, dtype=torch.float32, return_state=True)
    y_all, (s_all, _) = ts.rwkv6_time_mix(tp, tx, H, **kw)
    state = shift = None
    ys = []
    for t in range(tx.shape[1]):
        y, (state, shift) = ts.rwkv6_time_mix(tp, tx[:, t:t + 1], H, state=state,
                                              shift_state=shift, **kw)
        ys.append(y)
    close(torch.cat(ys, 1), y_all, F32)
    close(state, s_all, F32)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("T", [1, 6])
def test_rwkv_channel_mix_matches(channel_mix, T, carried, dt):
    (jp, tp), (jd, td, tol) = channel_mix, DT[dt]
    (jx, tx), *st = inputs(T, 40 + T, dt, [("x", (2, D))] if carried else [])
    y_j, l_j = js.rwkv6_channel_mix(jp, jx, shift_state=st[0][0] if carried else None,
                                    dtype=jd, return_state=True)
    y_t, l_t = ts.rwkv6_channel_mix(tp, tx, shift_state=st[0][1] if carried else None,
                                    dtype=td, return_state=True)
    close(y_t, y_j, tol)
    np.testing.assert_array_equal(as_np(l_t), as_np(l_j))


def test_inits_match_reference_layout():
    """The same leaves and shapes; the f32 leaves the reference uses uncast
    (`A_log`, `D`, `dt_bias`, `decay`, `bonus`) equal its values or scale,
    the rest in the compute dtype."""
    gen = torch.Generator().manual_seed(0)
    for want, got in [
            (js.mamba_init(jax.random.key(0), D, d_state=N),
             ts.mamba_init(gen, D, d_state=N, dtype=torch.bfloat16)),
            (js.rwkv6_init(jax.random.key(0), D, H, 64),
             ts.rwkv6_init(gen, D, H, 64, dtype=torch.bfloat16)),
            (js.rwkv6_channel_mix_init(jax.random.key(0), D, 64),
             ts.rwkv6_channel_mix_init(gen, D, 64, dtype=torch.bfloat16))]:
        fw = {".".join(k.key for k in p): np.asarray(v)
              for p, v in jax.tree_util.tree_leaves_with_path(want)}
        fg = {".".join(k.key for k in p): v
              for p, v in jax.tree_util.tree_leaves_with_path(got)}
        assert set(fg) == set(fw)
        for name, v in fw.items():
            t = fg[name]
            assert tuple(t.shape) == v.shape, name
            f32 = name in ("A_log", "D", "dt_bias", "decay", "bonus")
            assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name
            if name in ("A_log", "D", "dt_bias", "decay"):
                np.testing.assert_allclose(t.numpy(), v, rtol=1e-6, atol=0)
            else:
                assert abs(t.float().std().item() / v.std() - 1) < 0.15, name
