"""Shared inputs for the tests that hold `repro_torch` against `repro`.

Every input is a seeded numpy array; the same arrays go through the JAX
reference and the PyTorch port, and every comparison is exact equality
(the hashing is integer and GF(2) arithmetic).
"""
import numpy as np
import torch

ENGINE_FAMILIES = ["multilinear", "multilinear_2x2", "multilinear_hm",
                   "gf_multilinear", "gf_multilinear_hm"]
MOD_GRID = [None, 1, 2**20, 4097, 2**32 - 1]


def rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=np.uint64(seed)))


def u32(g, shape) -> np.ndarray:
    return g.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def t32(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> int32 tensor of the same bits (the port's tokens)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def ragged(g, batch: int, max_len: int, min_len: int = 0):
    lens = g.integers(min_len, max_len + 1, size=batch)
    return [u32(g, int(n)) for n in lens]


def engine_case(seed: int, B: int, N: int, K: int, ragged_rows: bool):
    """(tokens (B, N) u32, key_hi/key_lo (K, N+1) u32 with m1 at column 0,
    length codes (B,) i32). Ragged cases hold L = 0, odd L, L = N and the
    padding codes -1 and 0; fixed cases use the code -(N+1)."""
    g = rng(seed)
    toks = u32(g, (B, N))
    kh, kl = u32(g, (K, N + 1)), u32(g, (K, N + 1))
    if ragged_rows:
        edge = [0, 1, N, N - 1, -1, 0, 3]
        lens = np.array((edge + list(g.integers(0, N + 1, size=B)))[:B],
                        np.int32)
    else:
        lens = np.full(B, -(N + 1), np.int32)
    return toks, kh, kl, lens


def cpu_mesh(D: int):
    """The port's mesh of D logical shards of the CPU."""
    from repro_torch.parallel import data_mesh

    return data_mesh(device="cpu", n_shards=D)


def bloom_bytes(dsb) -> np.ndarray:
    """A port or reference `DeviceShardedBloom`'s global bits as (m,) uint8."""
    return np.asarray(dsb.bits)[:dsb.m].astype(np.uint8)


def load_bloom_bytes(dsb, global_bits) -> None:
    """Start a port `DeviceShardedBloom` from a global (m,) 0/1 byte array --
    the reference filter's `np.asarray(bits)[:m]` -- split over its shards."""
    bits = np.zeros(dsb.m_local * dsb.n_shards, np.uint8)
    bits[:dsb.m] = np.asarray(global_bits, np.uint8)[:dsb.m]
    for d, shard in enumerate(dsb._bits):
        shard[:dsb.m_local] = torch.from_numpy(
            bits[d * dsb.m_local:(d + 1) * dsb.m_local])


def words_to_bytes(words: np.ndarray, m: int) -> np.ndarray:
    """A host `BloomFilter`'s u64 words as (m,) 0/1 bytes (bit i of the
    filter is bit i % 64 of word i // 64)."""
    return np.unpackbits(np.asarray(words, np.uint64).view(np.uint8),
                         bitorder="little")[:m]


def train_states_close(ref_state, port_state, lr_sum: float, state_rtol=1e-3,
                       noise=frozenset()) -> int:
    """Hold a port `TrainState` against a reference one (numpy or jax
    leaves) after the same steps: every leaf path, shape and dtype equal,
    integer leaves exact; parameters within 2 x lr_sum + 1e-5 (an element
    whose gradient is within rounding of 0 may take AdamW's +-lr step the
    other way in one package); the optimizer's state within state_rtol of
    its leaf's largest magnitude + 1e-9. Returns the count of parameter
    elements past 1e-5 (those flips), but for the parameter paths in
    `noise`: leaves whose gradient is 0 in exact arithmetic, each of whose
    elements steps by its rounding noise's sign in each package."""
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.train.train_state import to_reference

    want = {p: np.asarray(w) for p, w in flatten_with_paths(ref_state)}
    got = dict(flatten_with_paths(to_reference(port_state)))
    assert set(got) == set(want)
    flips = 0
    for path, w in want.items():
        g = got[path]
        g = g.numpy().astype(np.int64) if g.dtype == torch.uint32 else g.numpy()
        assert g.shape == w.shape, path
        if w.dtype.kind != "f":
            np.testing.assert_array_equal(g, w.astype(np.int64), err_msg=path)
            continue
        assert g.dtype == w.dtype, path
        err = np.abs(g - w)
        if path.startswith(".params/"):
            assert err.max(initial=0.0) <= 2 * lr_sum + 1e-5, (path, err.max())
            flips += 0 if path in noise else int((err > 1e-5).sum())
        else:
            assert err.max(initial=0.0) <= state_rtol * np.abs(w).max(initial=0.0) + 1e-9, \
                (path, err.max())
    return flips
