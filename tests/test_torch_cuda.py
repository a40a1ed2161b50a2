"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips where no CUDA device exists (decided inside
the test, never at import). Run on the card with
`PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py -s`.
This file imports no JAX: the card's machine has none.
"""
import numpy as np
import pytest
import torch

from _torch_port import ENGINE_FAMILIES, MOD_GRID, engine_case, ragged, rng, t32
from repro_torch.core import hostref
from repro_torch.hash import Hasher, HashSpec
from repro_torch.hash.hasher import planes_to_keys
from repro_torch.hash import TreeHasher, TreeSpec, stream_digest_host
from repro_torch.kernels import _build, autotune, ref
from repro_torch.kernels import gf_multihash as gfmh
from repro_torch.kernels import gf_multilinear as gfk
from repro_torch.kernels import multihash as mhk
from repro_torch.kernels import multilinear as mlk
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_kernels_build(cuda):
    log = _build.build_all()
    for name in _build.KERNELS:
        assert _build.library_path(name).exists()
        print(name, log.get(name, {}).get("ptxas", "(cached)"))


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("ragged_rows", [False, True])
@pytest.mark.parametrize("mod_m", MOD_GRID)
@pytest.mark.parametrize("K", [1, 3, 9, 20])
def test_kernel_matches_plain(cuda, family, ragged_rows, mod_m, K):
    B, N = 37, 301  # B not a multiple of the rows per block, N odd
    toks, kh, kl, lens = engine_case(0xC0DA + K, B, N, K, ragged_rows)
    width = N + 1  # even for the HM families; the last column reads 0
    keys = torch.from_numpy(planes_to_keys(kh, kl))
    keys = torch.nn.functional.pad(keys, (0, 1))
    args = (t32(toks), keys, torch.from_numpy(lens))
    want = ops.multihash(*args, family=family, mod_m=mod_m, width=width)
    counts = (mhk.launch_count(), gfmh.launch_count())
    got = ops.multihash(*(a.to(cuda) for a in args), family=family,
                        mod_m=mod_m, width=width)
    torch.cuda.synchronize()
    assert mhk.launch_count() + gfmh.launch_count() == sum(counts) + 1
    assert torch.equal(got.cpu(), want)
    plain_on_card = (ref.gf_multihash_ref if family.startswith("gf_")
                     else ref.multihash_ref)(*(a.to(cuda) for a in args),
                                             family=family, mod_m=mod_m,
                                             width=width)
    assert torch.equal(got, plain_on_card)


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("K", [1, 3, 9, 20])
@pytest.mark.parametrize("N", [100, 1100])  # one column split; four
@pytest.mark.parametrize("B", [1, 31, 32, 33, 129, 8192])
def test_engine_tile_edges_match_plain(cuda, family, K, N, B):
    """The engine's layout edges: row blocks (128 or 256 rows) cut short, widths
    across the 32-column tile and the column split (on at N 1,100, where a
    second pass combines four splits), ragged rows whose kend lies just
    before, at and after a tile or split edge, codes 0 and -1, every mod_m."""
    g = rng(0xED6E + 7 * B + N + K)
    W = N + 2
    kernel = "gf_multihash" if family.startswith("gf_") else "multihash"
    split = mhk.split_of(kernel, B, W, cuda)
    splits = autotune.engine_splits(W, split)
    assert (splits > 1) == (N == 1100)
    edge = [0, -1, 30, 31, 32, 33, 34, 62, 63, 64, 65, split - 2, split - 1,
            split, split + 1, N - 1, N, -(N + 1), -33, -34]
    edge = [e for e in edge if -(N + 1) <= e <= N]
    lens = g.integers(-(N + 1), N + 1, size=B).astype(np.int32)
    lens[:min(B, len(edge))] = (g.permutation(edge) if B < len(edge)
                                else edge)[:min(B, len(edge))]
    toks = t32(g.integers(0, 2**32, (B, N), dtype=np.uint64).astype(np.uint32))
    keys = torch.from_numpy(g.integers(0, 2**64, (K, W + 1),
                                       dtype=np.uint64).view(np.int64))
    args = [a.to(cuda) for a in (toks, keys, torch.from_numpy(lens))]
    plain = ref.gf_multihash_ref if family.startswith("gf_") else ref.multihash_ref
    for mod_m in MOD_GRID:
        before = mhk.launch_count() + gfmh.launch_count()
        got = ops.multihash(*args, family=family, mod_m=mod_m, width=W)
        torch.cuda.synchronize()
        assert mhk.launch_count() + gfmh.launch_count() == before + 1
        assert torch.equal(got, plain(*args, family=family, mod_m=mod_m,
                                      width=W)), mod_m


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("B", [300, 8192])
def test_engine_many_functions_match_plain(cuda, family, B):
    """K = 50 (a Bloom filter at a 1e-15 false-positive rate): the engine
    hashes 9 functions a pass, 6 passes, into one (B, K, 2) result."""
    g = rng(0x50 + B)
    N, K = 301, 50
    W = N + 1
    toks = t32(g.integers(0, 2**32, (B, N), dtype=np.uint64).astype(np.uint32))
    keys = torch.from_numpy(g.integers(0, 2**64, (K, W + 1),
                                       dtype=np.uint64).view(np.int64))
    lens = torch.from_numpy(g.integers(-(N + 1), N + 1, B).astype(np.int32))
    args = [a.to(cuda) for a in (toks, keys, lens)]
    plain = ref.gf_multihash_ref if family.startswith("gf_") else ref.multihash_ref
    for mod_m in (None, 4097):
        got = ops.multihash(*args, family=family, mod_m=mod_m, width=W)
        assert torch.equal(got, plain(*args, family=family, mod_m=mod_m,
                                      width=W)), mod_m


@pytest.mark.parametrize("all_ones", [False, True])
@pytest.mark.parametrize("split", [autotune.ENGINE_MAX_SPLIT, 4096])
def test_tensor_core_sums_exact_at_the_widest_split(cuda, split, all_ones):
    """The integer kernel's tensor-core path keeps s32 byte-product sums over
    a split: at the widest split (8,192 columns) of all-ones tokens and keys
    they reach 4 x 255^2 x 8,192, just below 2^31, and must stay exact; a
    wider split is refused by the launcher."""
    B, N, K = 64, 2 * autotune.ENGINE_MAX_SPLIT, 9
    W = N + 2
    g = rng(0x0F1)
    if all_ones:
        toks = torch.full((B, N), -1, dtype=torch.int32)
        keys = torch.full((K, W + 1), -1, dtype=torch.int64)
    else:
        toks = t32(g.integers(0, 2**32, (B, N), dtype=np.uint64).astype(np.uint32))
        keys = torch.from_numpy(g.integers(0, 2**64, (K, W + 1),
                                           dtype=np.uint64).view(np.int64))
    lens = torch.full((B,), N, dtype=torch.int32)
    toks, keys, lens = toks.to(cuda), keys.to(cuda), lens.to(cuda)
    splits = autotune.engine_splits(W, split)
    out = torch.empty((B, K, 2), dtype=torch.int64, device=cuda)
    part = torch.empty((splits, K, B), dtype=torch.int64, device=cuda)
    _build.launch("multihash", cuda, toks, keys, lens, out, part, B, N, W, K,
                  keys.stride(0), 0, split, 0, None, None)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.multihash_ref(toks, keys, lens, width=W))
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch("multihash", cuda, toks, keys, lens, out, part, B, N, W,
                      K, keys.stride(0), 0, autotune.ENGINE_MAX_SPLIT + 32, 0,
                      None, None)


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
def test_hasher_on_card_matches_host_twin(cuda, family):
    h = Hasher.from_spec(HashSpec(family=family, n_hashes=9, out_bits=64,
                                  seed=0x77), max_len=64)
    assert h.device.type == "cuda"
    items = ragged(rng(4), 50, 700)  # grows the batch keys past capacity
    np.testing.assert_array_equal(h.hash_batch(items),
                                  h.hash_batch(items, backend="host"))
    toks = rng(5).integers(0, 2**32, (33, 64), dtype=np.uint64).astype(np.uint32)
    slots = h(toks).cpu().numpy().astype(np.uint64)
    surf = (slots[..., 0] << np.uint64(32)) | slots[..., 1]
    np.testing.assert_array_equal(surf, h.hash_batch(toks, backend="host"))
    np.testing.assert_array_equal(
        h.probe_indices(toks, 4097).cpu().numpy(),
        hostref.mod_u64_np(surf, 4097).astype(np.int64))


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("N", [1, 2, 7, 1024, 4097, 65537])
@pytest.mark.parametrize("B", [1, 8, 300])
def test_single_hash_kernel_matches_plain(cuda, family, N, B):
    """Kernels 3-4 == their plain versions: one and several column tiles
    or splits, odd N (HM hashes floor(N / 2) pairs), row groups cut short,
    int32 tokens with the sign bit set; kernel 4 also in its finish mode."""
    g = rng(0x5EED + N + B)
    toks = t32(g.integers(0, 2**32, (B, N), dtype=np.uint64).astype(np.uint32))
    keys = torch.from_numpy(g.integers(0, 2**64, N, dtype=np.uint64).view(np.int64))
    gf = family.startswith("gf_")
    kern, plain = ((gfk.gf_hash_blocks, ref.gf_accumulate_ref) if gf
                   else (mlk.hash_blocks, ref.multilinear_accumulate_ref))
    if gf:
        keys = keys.to(torch.int32)
    before = mlk.launch_count() + gfk.launch_count()
    got = kern(toks.to(cuda), keys.to(cuda), family=family)
    torch.cuda.synchronize()
    assert mlk.launch_count() + gfk.launch_count() == before + 1
    assert torch.equal(got.cpu(), plain(toks, keys, family=family))
    assert torch.equal(got, plain(toks.to(cuda), keys.to(cuda), family=family))
    if gf:  # the finish mode: m1 (key 0) and Barrett in the kernel's write
        k33 = torch.cat([torch.tensor([-0x1234567], dtype=torch.int32), keys])
        got = gfk.gf_hash_rows(toks.to(cuda), k33.to(cuda), family=family)
        torch.cuda.synchronize()
        assert gfk.launch_count() == before - mlk.launch_count() + 2
        assert torch.equal(got.cpu(), ref.gf_hash_ref(toks, keys, k33[0],
                                                      family=family))


def test_gf_b1_fragments_one_hot(cuda):
    """Every (token bit u, key bit v) pair at every column of a 32-column
    step: row 32 i + u holds the token 1 << u at column i, whose key is
    1 << i, so its hash is 1 << (u + i). Pins the b1 fragments' bit order
    and which token each 32 bits of A and B are."""
    N = 32
    toks = torch.zeros((N * 32, N), dtype=torch.int64)
    rows = torch.arange(N * 32)
    toks[rows, rows // 32] = 1 << (rows % 32)
    keys = (1 << torch.arange(N, dtype=torch.int64))
    toks, keys = toks.to(torch.int32), keys.to(torch.int32)
    got = gfk.gf_hash_blocks(toks.to(cuda), keys.to(cuda)).cpu()
    acc = 1 << (rows % 32 + rows // 32)
    assert torch.equal(got, torch.stack([acc >> 32, acc & 0xFFFFFFFF], 1))
    assert torch.equal(got, ref.gf_accumulate_ref(toks, keys))


def test_gf_b1_counts_exact_at_the_widest_split(cuda):
    """All-ones rows of 2^26 - 1 columns in one split: every output bit's
    s32 count reaches 32 (2^26 - 1), just below 2^31, and must keep its
    parity; the xor of an odd number of clmul(~0, ~0) is one of them. A
    split above 2^26 columns is refused."""
    B, N = 16, autotune.GF_SINGLE_MAX_SPLIT - 1
    toks = torch.full((B, N), -1, dtype=torch.int32, device=cuda)
    keys = torch.full((N,), -1, dtype=torch.int32, device=cuda)
    out = torch.empty((B, 2), dtype=torch.int64, device=cuda)
    _build.launch("gf_multilinear", cuda, toks, keys, out, out, B, N, 0, 0,
                  autotune.GF_SINGLE_MAX_SPLIT)
    torch.cuda.synchronize()
    p = int(ref.bmul32(torch.tensor(0xFFFFFFFF), torch.tensor(0xFFFFFFFF)))
    assert torch.equal(out.cpu(), torch.tensor([[p >> 32, p & 0xFFFFFFFF]] * B))
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch("gf_multilinear", cuda, toks, keys, out, out, B, N, 0, 0,
                      autotune.GF_SINGLE_MAX_SPLIT + 32)


@pytest.mark.parametrize("family", ["gf_multilinear", "gf_multilinear_hm"])
def test_gf_hash_is_one_launch(cuda, family):
    """`gf_hash` on the card is one counted kernel launch a call, with m1
    and Barrett inside it, equal to its plain version."""
    g = rng(0x0E1)
    toks = t32(g.integers(0, 2**32, (300, 1031), dtype=np.uint64).astype(np.uint32))
    keys = g.integers(0, 2**32, 1032, dtype=np.uint64).astype(np.uint32)
    t = toks.to(cuda)
    k = torch.from_numpy(keys.view(np.int32)).to(cuda)
    for _ in range(3):
        before = (gfk.launch_count(), mlk.launch_count())
        got = ops.gf_hash(t, k, family=family)
        assert (gfk.launch_count(), mlk.launch_count()) == (before[0] + 1, before[1])
    k32 = torch.from_numpy(keys.view(np.int32))
    assert torch.equal(got.cpu(), ref.gf_hash_ref(toks, k32[1:], k32[0],
                                                  family=family))


def test_stream_digest_on_card_matches_cpu(cuda):
    spec = HashSpec(family="multilinear", seed=0x57)
    h = Hasher.from_spec(spec, max_len=256)
    hc = Hasher.from_spec(spec, max_len=256, device="cpu")
    toks = t32(rng(6).integers(0, 2**32, 50_000, dtype=np.uint64).astype(np.uint32))
    st, stc = h.stream(256, 256), hc.stream(256, 256)
    for a, b in ((0, 1), (1, 300), (300, 49_999), (49_999, 50_000)):
        before = mlk.launch_count()
        st = h.update(st, toks[a:b].to(cuda))
        stc = hc.update(stc, toks[a:b])
        assert mlk.launch_count() == before + int(b // 256 > a // 256)
    want = stream_digest_host(h, toks.numpy().view(np.uint32), 256, 256)
    assert h.digest_int(st) == hc.digest_int(stc) == want


# -- tree fingerprints and the engine's tree-leaf shape -------------------------

@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("B", [1, 255, 2**16 + 3])
def test_engine_tree_leaf_shape_matches_plain(cuda, family, B):
    """The tree's leaf launch: K 1, 64-bit surface, fixed length, N 256
    (`TreeSpec()`'s leaf_words), one column split."""
    N = 256
    th = TreeHasher(TreeSpec(family=family, seed=0x7EE))
    toks = torch.randint(-2**31, 2**31, (B, N), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(B)).to(cuda)
    lens = torch.full((B,), -(N + 1), dtype=torch.int32, device=cuda)
    kernel = "gf_multihash" if family.startswith("gf_") else "multihash"
    assert autotune.engine_splits(N, mhk.split_of(kernel, B, N, cuda)) == 1
    before = ops.launch_count()
    got = th.hasher(toks)
    assert ops.launch_count() == before + 1
    plain = ref.gf_multihash_ref if family.startswith("gf_") else ref.multihash_ref
    assert torch.equal(got, plain(toks, th.hasher.keys, lens, family=family,
                                  width=N))


@pytest.mark.parametrize("family,B", [("multilinear", 2**23 + 5),
                                      ("gf_multilinear", 2**24 + 5)])
def test_engine_covers_more_rows_than_one_grid(cuda, family, B):
    """Past 65,535 row blocks (8,388,480 rows of the integer kernel,
    16,776,960 of the carry-less one) the launcher runs row chunks: one
    counted launch, equal to the plain version on the card."""
    N = 8
    wrapper = gfmh if family.startswith("gf_") else mhk
    toks = torch.randint(-2**31, 2**31, (B, N), dtype=torch.int32, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(B))
    keys = torch.from_numpy(rng(B).integers(0, 2**64, (1, N + 1),
                                            dtype=np.uint64).view(np.int64)).to(cuda)
    lens = torch.full((B,), -(N + 1), dtype=torch.int32, device=cuda)
    before = wrapper.launch_count()
    got = ops.multihash(toks, keys, lens, family=family, width=N)
    assert wrapper.launch_count() == before + 1
    plain = ref.gf_multihash_ref if family.startswith("gf_") else ref.multihash_ref
    assert torch.equal(got, plain(toks, keys, lens, family=family, width=N))


def test_fingerprint_array_on_card_equals_host_bytes(cuda):
    """A CUDA tensor's bytes hashed where they lie == the same bytes
    staged from the host == the CPU port; odd byte lengths, bf16,
    non-contiguous and 0-d tensors."""
    th, tc = TreeHasher(TreeSpec(leaf_words=8)), TreeHasher(
        TreeSpec(leaf_words=8), device="cpu")
    th256 = TreeHasher()
    base = torch.randn(37, 29, generator=torch.Generator().manual_seed(3)).to(cuda)
    cases = [base, base.t(), base[:, ::3], base.to(torch.bfloat16),
             base.to(torch.bfloat16)[1:, 5:], base[2, 2], base > 0,
             torch.arange(7, dtype=torch.uint8, device=cuda),
             torch.arange(5, dtype=torch.int16, device=cuda),
             torch.zeros(0, device=cuda)]
    for x in cases:
        raw = x.contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
        for h, hc in ((th, tc), (th256, None)):
            before = ops.launch_count()
            got = h.fingerprint_array(x)
            assert ops.launch_count() == before + 1
            assert got == h.fingerprint_bytes(raw)
            if hc is not None:
                assert got == hc.fingerprint_array(x.cpu()) == hc.fingerprint_bytes(raw)


def test_tree_digest_on_card_matches_cpu(cuda):
    """fingerprint, digest_tokens (0-d tensor n_tokens on the card) and
    digest_host agree between the card and the CPU for every family."""
    toks = rng(7).integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    for family in ENGINE_FAMILIES:
        th = TreeHasher(TreeSpec(leaf_words=64, family=family))
        tc = TreeHasher(TreeSpec(leaf_words=64, family=family), device="cpu")
        want = tc.fingerprint(toks)
        assert th.fingerprint(toks) == th.fingerprint(t32(toks).to(cuda)) == want
        assert th.digest_host(toks) == want
        buf = torch.zeros(6000, dtype=torch.int32, device=cuda)
        buf[:5000] = t32(toks).to(cuda)
        hi, lo = th.digest_tokens(buf, n_tokens=torch.tensor(5000, device=cuda)).tolist()
        assert (hi << 32) | lo == want


def test_tree_stream_on_card_matches_cpu(cuda):
    toks = t32(rng(8).integers(0, 2**32, 70_001, dtype=np.uint64).astype(np.uint32))
    th, tc = TreeHasher(), TreeHasher(device="cpu")
    s, sc = th.stream(leaf_batch=16), tc.stream(leaf_batch=16)
    # a flush (one launch on the card) once 16 leaves of 256 words are buffered
    for a, b, flush in ((0, 1, 0), (1, 4095, 0), (4095, 4097, 1), (4097, 70_000, 1),
                        (70_000, 70_001, 0)):
        before = mhk.launch_count()
        s.update(toks[a:b].to(cuda) if a % 2 else toks[a:b].numpy())
        sc.update(toks[a:b])
        assert mhk.launch_count() - before == flush
    assert s.digest_int() == sc.digest_int() == th.fingerprint(toks.to(cuda))
    assert s.digest_int() == tc.fingerprint(toks)


def _sharded_bloom_run(mesh, transport, A, B):
    from repro_torch.hash import DeviceShardedBloom

    f = DeviceShardedBloom(n_items=5000, mesh=mesh, probe_transport=transport)
    f.add_batch(A)
    present = f.contains_batch(B)
    admitted = f.check_and_add_batch(B)
    return (present, admitted, f.words().cpu().numpy(), dict(f.stats),
            f.bytes_moved)


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("kind", ["host", "all_gather", "routed", "overflow"])
def test_device_sharded_bloom_on_card_matches_cpu(cuda, kind, D):
    """DeviceShardedBloom over D logical shards of the card == the same
    filter over D logical shards of the CPU: verdicts, words, overflow
    stats and bytes moved."""
    from repro_torch.hash import ProbeTransport
    from repro_torch.parallel import data_mesh

    g = rng(0xB10 + D)
    A = ragged(g, 300, 64, min_len=1)
    B = ragged(g, 200, 64, min_len=1) + A[:100] + A[:3]
    transport = (ProbeTransport("routed", capacity_factor=0.5, capacity_slack=0)
                 if kind == "overflow" else kind)
    cpu, card = (_sharded_bloom_run(data_mesh(device=dev, n_shards=D),
                                    transport, A, B) for dev in ("cpu", cuda))
    for a, b in zip(cpu[:3], card[:3]):
        np.testing.assert_array_equal(a, b)
    assert cpu[3:] == card[3:]
    assert (card[3]["overflow_fallbacks"] > 0) == (kind == "overflow")


@pytest.mark.parametrize("family", ["multilinear", "gf_multilinear_hm"])
def test_sharded_hasher_on_card_matches_cpu(cuda, family):
    from repro_torch.parallel import data_mesh

    spec = HashSpec(family=family, n_hashes=5, out_bits=64, variable_length=True)
    items = ragged(rng(0x5A), 301, 90)
    want = Hasher.from_spec(spec, device="cpu").sharded(
        data_mesh(device="cpu", n_shards=3)).hash_batch(items)
    sh = Hasher.from_spec(spec, device=cuda).sharded(
        data_mesh(device=cuda, n_shards=4))
    counts = mhk.launch_count() + gfmh.launch_count()
    np.testing.assert_array_equal(sh.hash_batch(items), want)
    assert mhk.launch_count() + gfmh.launch_count() == counts + 4


def test_device_sharded_bloom_launch_part_has_no_host_sync(cuda):
    """After staging, a routed add and a routed verdict launch without one
    host sync (torch.cuda.set_sync_debug_mode('error') raises on any)."""
    from repro_torch.hash import DeviceShardedBloom
    from repro_torch.parallel import data_mesh

    docs = ragged(rng(0x5C), 512, 300, min_len=1)
    for kind in ("routed", "all_gather"):
        f = DeviceShardedBloom(n_items=10**5, probe_transport=kind,
                               mesh=data_mesh(device=cuda, n_shards=4))
        st = f._stage(docs)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            f._add_staged(st)
            out, _ = f._verdict_staged(st, insert=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out = out.cpu().numpy()
        assert out[:st.B].all() and not out[st.Bp:].any()


@pytest.fixture
def f32_matmul():
    """Full-f32 products on the card (no TF32), restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("name", ["mistral_nemo_12b", "gemma3_27b_hashed",
                                  "qwen2_vl_72b"])
def test_smoke_model_on_card_matches_cpu(cuda, f32_matmul, name):
    """SMOKE prefill (ring caches included), two decode steps and the loss on
    the card == on the CPU, in f32 at rtol = atol = 1e-4, from one set of
    seeded weights."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = dataclasses.replace(get_config(name, smoke=True), dtype="float32")
    api = build(cfg)
    cpu = api.init(torch.Generator().manual_seed(7))
    card = copy.deepcopy(cpu).to(cuda)  # Module.to moves in place
    g = rng(0x30DE)
    batch = {"tokens": g.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32),
             "labels": g.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
    if cfg.vision_prefix:
        batch["patch_embeds"] = g.normal(
            size=(2, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    tol = dict(rtol=1e-4, atol=1e-4)
    pre = {k: v for k, v in batch.items() if k != "labels"}
    (lc, cc), (lg, cg) = (api.prefill(p, pre, cache_len=24) for p in (cpu, card))
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), **tol)
    tok = lc.argmax(-1, keepdim=True).int().numpy()
    for pos in (16, 17):
        (lc, cc), (lg, cg) = (api.decode_step(p, c, tok, pos)
                              for p, c in ((cpu, cc), (card, cg)))
        np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), **tol)
        tok = lc.argmax(-1, keepdim=True).int().numpy()
    np.testing.assert_allclose(float(api.loss(card, batch)[0]),
                               float(api.loss(cpu, batch)[0]), **tol)


def test_serve_engine_on_card_matches_cpu(cuda, f32_matmul):
    """The engine on the card (prompt keys by the engine kernel, tree keys,
    admission through a device-sharded filter) == on the CPU: tokens,
    stats, verdicts; one engine launch for the short prompts' keys."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(get_config("mistral_nemo_12b", smoke=True),
                              dtype="float32")
    api = build(cfg)
    cpu = api.init(torch.Generator().manual_seed(8))
    g = rng(0x5E)
    ps = [g.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
          for n in (3, 20, 9, 14, 6)]
    ps += [ps[1].copy(), ps[3].copy()]
    for items in (None, 4096):
        out = []
        for params, dev in ((cpu, "cpu"), (copy.deepcopy(cpu).to(cuda), cuda)):
            eng = ServeEngine(api, params, n_slots=3, max_seq=40,
                              tree_prompt_words=12, admission_items=items,
                              device=dev)
            reqs = [Request(i, p.copy(), max_new_tokens=5) for i, p in enumerate(ps)]
            c0 = mhk.launch_count()
            eng.submit_all(reqs)
            out.append(([r.out_tokens for r in reqs], [r.admitted for r in reqs],
                        eng.stats, mhk.launch_count() - c0))
        assert out[1][:3] == out[0][:3]
        if items is None:  # 1 launch for the short prompts, 1 per long one
            assert out[1][3] == 1 + sum(len(p) >= 12 for p in ps)


@pytest.mark.parametrize("name", ["mistral_nemo_12b", "granite_moe_hash",
                                  "llama4_maverick_400b_a17b"])
def test_train_step_on_card_matches_cpu(cuda, f32_matmul, name):
    """One train step (f32 masters, f32 compute, TF32 off) on the card ==
    on the CPU from the same state and batch: the loss and grad norm within
    1e-4 relative, the parameters within 2 x lr (an element whose gradient
    is within rounding of 0 may take AdamW's +-lr step the other way; the
    adafactor step of llama4 is clipped to lr too) and, past 1e-5, on at
    most 64 elements; the key planes exact."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train import Schedule, init_state, make_optimizer, make_train_step
    from repro_torch.train.train_state import copy_to

    cfg = dataclasses.replace(get_config(name, smoke=True), dtype="float32")
    api = build(cfg)
    lr = 1e-3
    opt = make_optimizer(cfg.optimizer, Schedule(peak_lr=lr, warmup_steps=0))
    cpu = init_state(api, opt, torch.Generator().manual_seed(4))
    card = copy_to(cpu, cuda)
    g = rng(0x7A)
    batch = {"tokens": g.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32),
             "labels": g.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
    step = make_train_step(api, opt)
    cpu, mc = step(cpu, batch)
    card, mg = step(card, batch)
    for k in ("loss", "grad_norm", "ce", "balance"):
        np.testing.assert_allclose(float(mg[k]), float(mc[k]), rtol=1e-4, atol=1e-6)
    flips = 0
    for (n, a), (_, b) in zip(cpu.params.named_parameters(),
                              card.params.named_parameters()):
        err = (b.detach().cpu() - a.detach()).abs()
        assert float(err.max()) <= 2 * lr + 1e-6, n
        flips += int((err > 1e-5).sum())
    for (n, a), (_, b) in zip(cpu.params.named_buffers(), card.params.named_buffers()):
        assert torch.equal(a, b.cpu()), n
    assert flips <= 64, flips

