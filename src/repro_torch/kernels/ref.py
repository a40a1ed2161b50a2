"""Plain PyTorch versions of the CUDA kernels.

`multihash_ref` and `gf_multihash_ref` (the fused K-hash engine),
`multilinear_accumulate_ref` and `gf_accumulate_ref` (the single-hash raw
accumulators) and `gf_hash_ref` (the carry-less single hash with its m1 and
Barrett finish) compute exactly what the CUDA kernels in `csrc/` compute,
with ordinary tensor operations. They run the CPU path of the kernel
wrappers (`kernels.multihash`, `gf_multihash`, `multilinear`,
`gf_multilinear`) and are what `chip_smoke.py` holds each kernel against
on the card. They follow the reference's oracles (`repro.kernels.ref.
multihash_ref`, `gf_multihash_ref`) and its length-code algebra
(`repro.kernels.multihash._mask_tile`) operation for operation, on int64
tensors that carry u32 lanes and u64 accumulators (see `core.limbs`).

Engine layout shared by the plain versions and the kernels:

- tokens: (B, N) int32 holding u32 bits, C-contiguous;
- keys:   (K, >= W+1) int64 holding u64 key bits; column 0 is each
  function's m1, column 1 + i multiplies token i (the carry-less families
  use the low 32 bits);
- lens:   (B,) int32 length codes (`core.hostref.encode_lengths`): code >= 0
  is a variable-length row of L tokens (sentinel 1 at position L), code < 0
  a fixed-length row of -code-1 tokens; padding rows use -1 or 0;
- width:  W >= N columns are hashed; tokens past N read as 0, so callers
  never copy tokens to pad them to the sentinel/even width;
- output: (B, K, 2) int64 holding u32 values in the reference's slots:
  (hash32, lo) for the integer families, (hash32, acc_hi) for the carry-less
  ones; with `mod_m`, (surface mod m, hash32).

Single-hash layout (`single_shapes`): tokens (B, N) int32 as above; keys
(N,) without m1, int64 u64 bits (integer families) or int32 u32 bits
(carry-less ones); output (B, 2) int64 holding the u32 (hi, lo) of the raw
accumulator. The HM families hash floor(N / 2) pairs: the reference pads
an odd row with a zero token and a zero key, so its last token adds
(k + s) * 0 = 0.

`gf_matrix_accumulate_ref` and `bmul32` are CPU twins of the two product
forms of the carry-less single-hash kernel (`csrc/gf_single.cuh`): the
GF(2) matrix product that its plain family runs on the b1 tensor cores,
and the integer-multiply carry-less product of its HM family. The tests
hold them against the bit-serial form; nothing on the card calls them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import gf as gf_core
from ..core.gf import xor_reduce
from ..core.limbs import MASK32, as_plan, hi32, lo32, mod_u64

INT_FAMILIES = ("multilinear", "multilinear_2x2", "multilinear_hm")
GF_FAMILIES = ("gf_multilinear", "gf_multilinear_hm")
PAIRWISE = ("multilinear_hm", "gf_multilinear_hm")


def engine_shapes(tokens, keys, lens, width, family):
    """Validate the engine operands; returns (B, N, K, W)."""
    if tokens.dtype != torch.int32 or tokens.dim() != 2:
        raise TypeError(f"tokens must be (B, N) int32, got {tuple(tokens.shape)} "
                        f"{tokens.dtype}")
    if keys.dtype != torch.int64 or keys.dim() != 2:
        raise TypeError(f"keys must be (K, W+1) int64, got {tuple(keys.shape)} "
                        f"{keys.dtype}")
    B, N = tokens.shape
    K = keys.shape[0]
    W = N if width is None else int(width)
    if lens.dtype != torch.int32 or tuple(lens.shape) != (B,):
        raise TypeError(f"lens must be ({B},) int32, got {tuple(lens.shape)} "
                        f"{lens.dtype}")
    if not (tokens.device == keys.device == lens.device):
        raise ValueError("tokens, keys and lens must be on one device")
    if not (tokens.is_contiguous() and keys.stride(1) == 1
            and lens.is_contiguous()):
        raise ValueError("tokens, lens and key rows must be contiguous")
    if K < 1:
        raise ValueError("need at least one key row")
    if W < N or keys.shape[1] < W + 1:
        raise ValueError(f"width {W} must cover the {N} token columns and "
                         f"fit the {keys.shape[1] - 1} positional keys")
    if family in PAIRWISE and W % 2:
        raise ValueError(f"{family} pairs lanes: width {W} must be even")
    if family not in INT_FAMILIES + GF_FAMILIES:
        raise ValueError(f"unknown engine family {family!r}")
    return B, N, K, W


def mask_lengths(tokens: torch.Tensor, lens: torch.Tensor, width: int):
    """(tok_eff (B, W) int64, live (B, W) bool) under the length codes.

    tokens at or past lm read 0 (and past N, where there are none), position
    lm reads the sentinel 1 on variable-length rows, and key lanes at or
    past kend = even(lm + is_var) are dead, so HM pair terms vanish there.
    """
    tok = tokens.to(torch.int64) & MASK32
    tok = F.pad(tok, (0, width - tok.shape[1]))
    col = torch.arange(width, dtype=torch.int64, device=tok.device)[None, :]
    code = lens.to(torch.int64)[:, None]
    is_var = code >= 0
    lm = torch.where(is_var, code, -code - 1)
    tok_eff = torch.where(col < lm, tok, (is_var & (col == lm)).to(torch.int64))
    end = lm + is_var.to(torch.int64)
    kend = end + (end & 1)
    return tok_eff, col < kend


def multihash_ref(tokens, keys, lens, *, family="multilinear", mod_m=None,
                  width=None):
    """K integer Multilinear hashes of every row -> (B, K, 2) int64 slots.

    acc = m1 + sum key * tok mod 2^64 (HM: sum (k + s)(k' + s') over lane
    pairs); slots (acc >> 32, acc & 0xFFFFFFFF), or with `mod_m`
    (acc mod m, acc >> 32).
    """
    B, N, K, W = engine_shapes(tokens, keys, lens, width, family)
    if family not in INT_FAMILIES:
        raise ValueError(f"{family!r} is not an integer engine family")
    plan = as_plan(mod_m)
    tok, live = mask_lengths(tokens, lens, W)
    out = torch.empty((B, K, 2), dtype=torch.int64, device=tokens.device)
    for k in range(K):
        kp = torch.where(live, keys[k, 1:W + 1][None, :], 0)
        if family == "multilinear_hm":
            prod = (kp[:, 0::2] + tok[:, 0::2]) * (kp[:, 1::2] + tok[:, 1::2])
        else:
            prod = kp * tok
        acc = prod.sum(dim=1) + keys[k, 0]
        if plan is None:
            out[:, k, 0] = hi32(acc)
            out[:, k, 1] = lo32(acc)
        else:
            out[:, k, 0] = mod_u64(acc, plan)
            out[:, k, 1] = hi32(acc)
    return out


def gf_multihash_ref(tokens, keys, lens, *, family="gf_multilinear",
                     mod_m=None, width=None):
    """K carry-less GF(2^32) hashes of every row -> (B, K, 2) int64 slots.

    acc = m1_lo xor (xor of clmul(key_lo, tok)) (HM: clmul(k ^ s, k' ^ s')
    over lane pairs); h32 = Barrett(acc) mod p(x); slots (h32, acc >> 32),
    or with `mod_m` (((h32 << 32) | acc_hi) mod m, h32).
    """
    B, N, K, W = engine_shapes(tokens, keys, lens, width, family)
    if family not in GF_FAMILIES:
        raise ValueError(f"{family!r} is not a carry-less engine family")
    plan = as_plan(mod_m)
    tok, live = mask_lengths(tokens, lens, W)
    out = torch.empty((B, K, 2), dtype=torch.int64, device=tokens.device)
    for k in range(K):
        kp = torch.where(live, keys[k, 1:W + 1][None, :] & MASK32, 0)
        if family == "gf_multilinear_hm":
            prod = gf_core.clmul32(kp[:, 0::2] ^ tok[:, 0::2],
                                   kp[:, 1::2] ^ tok[:, 1::2])
        else:
            prod = gf_core.clmul32(kp, tok)
        acc = xor_reduce(prod) ^ (keys[k, 0] & MASK32)
        h32 = gf_core.barrett_reduce(acc)
        acc_hi = acc >> 32  # acc < 2^63: no sign bits to mask
        if plan is None:
            out[:, k, 0] = h32
            out[:, k, 1] = acc_hi
        else:
            out[:, k, 0] = mod_u64((h32 << 32) | acc_hi, plan)
            out[:, k, 1] = h32
    return out


def single_shapes(tokens, keys, family, families):
    """Validate the single-hash operands; returns (B, N)."""
    if family not in families:
        raise ValueError(f"unknown family {family!r}; have {families}")
    if tokens.dtype != torch.int32 or tokens.dim() != 2:
        raise TypeError(f"tokens must be (B, N) int32, got {tuple(tokens.shape)} "
                        f"{tokens.dtype}")
    B, N = tokens.shape
    kdt = torch.int32 if family in GF_FAMILIES else torch.int64
    if keys.dtype != kdt or tuple(keys.shape) != (N,):
        raise TypeError(f"keys must be ({N},) {kdt}, got {tuple(keys.shape)} "
                        f"{keys.dtype}")
    if tokens.device != keys.device:
        raise ValueError("tokens and keys must be on one device")
    if not (tokens.is_contiguous() and keys.is_contiguous()):
        raise ValueError("tokens and keys must be contiguous")
    return B, N


def hashed_cols(N: int, family: str) -> int:
    """Columns a single-hash row of N tokens hashes (HM: whole pairs)."""
    return N - N % 2 if family in PAIRWISE else N


def _split(acc: torch.Tensor) -> torch.Tensor:
    return torch.stack([hi32(acc), lo32(acc)], dim=1)


def multilinear_accumulate_ref(tokens, keys, family="multilinear"):
    """(B, N) tokens x (N,) u64 keys (no m1) -> (B, 2) int64 (hi, lo) of
    sum k_i s_i mod 2^64 (HM: sum (k_2p + s_2p)(k_2p+1 + s_2p+1))."""
    B, N = single_shapes(tokens, keys, family, INT_FAMILIES)
    s = tokens.to(torch.int64) & MASK32
    if family == "multilinear_hm":
        c = hashed_cols(N, family)
        prod = ((keys[None, 0:c:2] + s[:, 0:c:2])
                * (keys[None, 1:c:2] + s[:, 1:c:2]))
    else:
        prod = keys[None, :] * s
    return _split(prod.sum(dim=1))


def gf_accumulate_ref(tokens, keys32, family="gf_multilinear"):
    """(B, N) tokens x (N,) u32 keys (no m1) -> (B, 2) int64 (hi, lo) of the
    63-bit xor of clmul(k_i, s_i) (HM: clmul(k_2p ^ s_2p, k_2p+1 ^ s_2p+1))."""
    B, N = single_shapes(tokens, keys32, family, GF_FAMILIES)
    s = tokens.to(torch.int64) & MASK32
    k = (keys32.to(torch.int64) & MASK32)[None, :]
    if family == "gf_multilinear_hm":
        c = hashed_cols(N, family)
        prod = gf_core.clmul32(k[:, 0:c:2] ^ s[:, 0:c:2],
                               k[:, 1:c:2] ^ s[:, 1:c:2])
    else:
        prod = gf_core.clmul32(k, s)
    return _split(xor_reduce(prod))


def gf_hash_ref(tokens, keys32, m1, family="gf_multilinear"):
    """(B, N) tokens x (N,) u32 keys (no m1) and the u32 m1 (an int or a
    0-d tensor) -> (B,) int64 hashes Barrett(acc ^ m1) mod p(x): the plain
    version of the kernel's finish mode."""
    acc = gf_accumulate_ref(tokens, keys32, family=family)
    m1 = torch.as_tensor(m1, dtype=torch.int64, device=tokens.device) & MASK32
    return gf_core.barrett_reduce(((acc[:, 0] << 32) | acc[:, 1]) ^ m1)


def _s64(x: int) -> int:
    """A u64 bit pattern as the int64 value of the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def brev32(x: torch.Tensor) -> torch.Tensor:
    """Bit reversal of u32 values held in int64 (CUDA's __brev)."""
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                        (8, 0x00FF00FF), (16, 0x0000FFFF)):
        x = ((x >> shift) & mask) | ((x & mask) << shift)
    return x


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of u32 values held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 >> 24) & 0xFF


def toeplitz_word(k: torch.Tensor, j: int) -> torch.Tensor:
    """The b1 B operand's word of key k (u32 in int64) for output bit j of
    the product: bit v is k[j - v] (0 outside 0..31). From r = brev(k),
    whose bit 31 - u is k[u]: r >> (31 - j) for j < 32, else
    (r << (j - 31)) mod 2^32 -- the kernel's funnel shifts."""
    r = brev32(k)
    return r >> (31 - j) if j < 32 else (r << (j - 31)) & MASK32


def gf_matrix_accumulate_ref(tokens, keys32, family="gf_multilinear"):
    """The plain family's raw accumulator as the kernel's GF(2) matrix
    product: bit j of acc[b] is the parity of sum_i popc(s[b, i] &
    toeplitz_word(k[i], j)), the AND-popcount count that one b1 mma column
    accumulates (A word: a token as it is; B word: `toeplitz_word`).
    -> (B, 2) int64 (hi, lo), equal to `gf_accumulate_ref`."""
    single_shapes(tokens, keys32, family, ("gf_multilinear",))
    s = tokens.to(torch.int64) & MASK32
    k = (keys32.to(torch.int64) & MASK32)[None, :]
    acc = torch.zeros(s.shape[0], dtype=torch.int64, device=s.device)
    for j in range(63):  # bit 63 of a 63-bit product is never set
        count = popcount32(s & toeplitz_word(k, j)).sum(dim=1)
        acc |= (count & 1) << j
    return _split(acc)


_CLASS = [_s64(0x1111111111111111 << c) for c in range(4)]


def bmul32(a, b) -> torch.Tensor:
    """Carry-less 32x32 -> 63-bit product of u32 values (int64 tensors) by
    integer multiplies with holes (Pornin's bmul, BearSSL ghash_ctmul):
    a_c = a & (0x11111111 << c), likewise b; the integer product of a
    class pair has at most 8 terms at any bit, fewer than the 16 that
    would carry into the next bit of the same class, so the bits of output
    class r in xor_(c + d = r mod 4) a_c * b_d are the carry-less product's.
    int64 multiplies wrap mod 2^64, which keeps every bit."""
    a = torch.as_tensor(a, dtype=torch.int64)
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    ac = [a & (0x11111111 << c) for c in range(4)]
    bc = [b & (0x11111111 << c) for c in range(4)]
    out = 0
    for r in range(4):
        z = ac[0] * bc[r]
        for c in range(1, 4):
            z = z ^ (ac[c] * bc[(r - c) % 4])
        out = out | (z & _CLASS[r])
    return out
