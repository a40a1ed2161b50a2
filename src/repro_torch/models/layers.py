"""Building-block layers: norms, activations, RoPE/M-RoPE, embeddings
(including the paper-powered hashed embedding), MLPs.

The port of `repro.models.layers`. Functions take their parameters as a
tree addressed like the reference's dicts (`p["w"]`, `"b" in p`): a plain
dict of tensors, or a `ParamTree`, the module tree the models hold their
weights in. `*_init(gen, ...)` draws from an explicit `torch.Generator` on
the generator's device: the reference's shapes, distributions and scales,
not its values (`models.convert.params_from_jax` carries those across).

Weights the reference stores in f32 and casts to the compute dtype at
every use (`linear`, `embed`, the unembedding) may be held in that dtype
(`dtype=` of the inits): the cast is the same, so the values are too.
Norm scales stay f32. Training holds every float leaf in f32 (the
reference's masters) and casts at use; the gradients flow back through
those casts.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..core.keys import KeyBuffer
from ..parallel.partition import WHOLE
from ..parallel.sharding import constraint, seq_axis

MASK32 = 0xFFFFFFFF


class ParamTree(nn.Module):
    """A parameter tree as nested modules: one module per dict of the
    reference's pytree (a sublayer, a block, an embedding), addressed as
    the reference addresses its dicts (`p["attn"]["wq"]["w"]`), with the
    reference's names as `state_dict` paths (`blocks.0.s0.attn.wq.w`; a
    list becomes a `ModuleList`). Float leaves are parameters, integer
    leaves buffers. A serving tree's parameters take no gradient; a
    `trainable` tree's do, except under a path holding ``const_`` (the
    reference's filter of non-trainable leaves)."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        for name, v in tree.items():
            train = trainable and "const_" not in name
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v, train))
            elif isinstance(v, list):
                self.add_module(name, nn.ModuleList(ParamTree(t, train) for t in v))
            elif v.is_floating_point():
                self.register_parameter(name, nn.Parameter(v, requires_grad=train))
            else:
                self.register_buffer(name, v)

    def __getitem__(self, name: str):
        if name in self:
            return getattr(self, name)
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._buffers or name in self._modules


def init_normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32 on the generator's device, then held in
    `dtype` (the reference's f32 value, cast as it casts at use)."""
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def _norm_init(gen, d, scale_offset=0.0):
    return {"scale": torch.zeros(d, dtype=torch.float32, device=gen.device)
            + scale_offset}


def rmsnorm_init(gen, d):
    # gemma convention: scale stored as (1 + w); init w=0 -> scale 1
    return _norm_init(gen, d)


def rmsnorm(params, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"])).to(dt)


def layernorm_init(gen, d):
    z = torch.zeros(d, dtype=torch.float32, device=gen.device)
    return {"scale": z, "bias": z.clone()}


def layernorm(params, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"]) + params["bias"]).to(dt)


def linear_init(gen, d_in, d_out, bias=False, scale=None, dtype=torch.float32):
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    p = {"w": init_normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=gen.device)
    return p


def linear(params, x, dtype=None):
    w = params["w"]
    if dtype is not None:
        w = w.to(dtype)
    y = x @ w
    if "b" in params:
        b = params["b"]
        y = y + (b.to(dtype) if dtype is not None else b)
    return y


def _silu(x):
    return x * torch.sigmoid(x)  # jax.nn.silu's own form (two roundings in bf16)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def act_fn(name: str):
    return {"swiglu": None, "gelu": _gelu, "silu": _silu}.get(name)


def mlp_init(gen, d_model, d_ff, act="swiglu", bias=False, dtype=torch.float32):
    p = {"w_up": linear_init(gen, d_model, d_ff, bias=bias, dtype=dtype),
         "w_down": linear_init(gen, d_ff, d_model, bias=bias, dtype=dtype)}
    if act == "swiglu":
        p["w_gate"] = linear_init(gen, d_model, d_ff, bias=bias, dtype=dtype)
    return p


def mlp(params, x, act="swiglu", dtype=torch.bfloat16, *, part=WHOLE, d_ff=None,
        sp=False):
    """The FFN of x (B, T, D). With a `parallel.partition.Partition` of
    several model ranks, x is the sublayer's whole sequence, the weights
    the rank's (`d_ff` the whole width): its columns of w_gate and w_up,
    its rows of w_down; the result in the stream's layout (`sp`)."""
    D = x.shape[-1]
    Fd = d_ff or params["w_up"]["w"].shape[1]
    up, kind, _ = part.linear(x, False, params["w_up"], D, Fd, dtype)
    if act == "swiglu":
        h = _silu(part.linear(x, False, params["w_gate"], D, Fd, dtype)[0]) * up
    else:
        h = act_fn(act)(up)
    # context-parallel: hidden stays T-sharded over 'model'
    h = constraint(h, "batch", seq_axis(h.shape[1]), None)
    return part.exit(*part.linear(h, kind == "cols", params["w_down"], Fd, D, dtype), sp=sp)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float):
    """Half-dim inverse frequencies (d_head//2,)."""
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


def _inv_freqs(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    """`rope_freqs` on `device`, uploaded once per (width, theta, device)
    rather than at every layer of every step; under `FakeTensorMode` (the
    dry run) a fake tensor each call, which the cache must not keep."""
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
        return torch.from_numpy(rope_freqs(d_head, theta)).to(device)
    return _inv_freqs_cached(d_head, theta, device)


@functools.lru_cache(maxsize=64)
def _inv_freqs_cached(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rope_freqs(d_head, theta)).to(device)


def _rotate(x, ang):
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta=10000.0):
    """x: (..., T, H, d_head); positions: broadcastable to (..., T)."""
    inv = _inv_freqs(x.shape[-1], float(theta), x.device)
    return _rotate(x, positions[..., None].float() * inv)  # angles (..., T, d/2)


def apply_mrope(x, positions_thw, sections=(16, 24, 24), theta=10000.0):
    """Qwen2-VL M-RoPE: the d_head/2 frequency slots are split into
    (temporal, height, width) sections, each rotated by its own position
    stream. positions_thw: (3, ..., T). For text tokens all three streams
    are equal, reducing to standard RoPE.
    """
    d = x.shape[-1]
    inv = _inv_freqs(d, float(theta), x.device)
    sec = np.asarray(sections)
    if sec.sum() != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"d_head/2 = {d // 2}")
    sec_id = torch.from_numpy(np.repeat(np.arange(3), sec)).to(x.device)
    pos = positions_thw[sec_id].movedim(0, -1)  # (..., T, d/2)
    return _rotate(x, pos.float() * inv)


def sinusoidal_positions(T: int, d: int, device=None):
    pos = np.arange(T)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / (10000 ** (dim / d))
    out = np.zeros((T, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(resolve_device(device))


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embedding_init(gen, vocab, d_model, dtype=torch.float32):
    return {"tok": {"w": init_normal(gen, (vocab, d_model), 0.02, dtype)}}


class _EmbedLookup(torch.autograd.Function):
    """The reference's `_embed_lookup`: a row gather in the compute dtype
    whose backward scatter-adds the cotangent into an f32 (V, D) zero
    table and rounds once to the compute dtype (a bf16 scatter-add over
    many tokens would lose bits). `index_put_(accumulate=True)` sums the
    duplicates of a token in a fixed order on the card too (it sorts the
    indices; no atomics), so the gradient repeats bit for bit."""

    @staticmethod
    def forward(ctx, w, tokens, dtype):
        ctx.save_for_backward(tokens)
        ctx.w_dtype = w.dtype
        ctx.vocab = w.shape[0]
        return w[tokens].to(dtype)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        D = g.shape[-1]
        dw = constraint(g.new_zeros((ctx.vocab, D), dtype=torch.float32), "model", "data")
        dw.index_put_((tokens.reshape(-1),), g.reshape(-1, D).float(),
                      accumulate=True)
        dw = constraint(dw, "model", "data")
        return dw.to(g.dtype).to(ctx.w_dtype), None, None


def embed(params, tokens, dtype=torch.bfloat16):
    """Row gather of the token table in `dtype`, with the reference's
    scatter-add backward (`_EmbedLookup`)."""
    return _EmbedLookup.apply(params["tok"]["w"], tokens.long(), dtype)


def hashed_embedding_init(gen, vocab, d_model, n_buckets, n_hashes=2,
                          dtype=torch.float32):
    """The paper's technique at the model layer: the 'hashing trick'.

    Instead of a (vocab, d) table, keep a (n_buckets, d) table addressed by
    `n_hashes` independent MULTILINEAR hashes of the token id, plus a small
    (vocab, n_hashes) learned mixing weight (Svenstrup et al. hash
    embeddings). Strong universality gives provable collision bounds: any
    two token ids share bucket j with probability exactly 1/n_buckets.

    Ids are strings of length 1 (32-bit char), so h(t) = (m1 + m2*t mod
    2^64) >> 32. The key planes are the reference's, as int64 tensors of u32
    values (the port's lanes).
    """
    keys = KeyBuffer(seed=0xE64B + n_hashes).u64(2 * n_hashes + 2)
    hi = (keys >> np.uint64(32)).astype(np.int64)
    lo = (keys & np.uint64(MASK32)).astype(np.int64)
    return {
        "hashed": {"w": init_normal(gen, (n_buckets, d_model), 0.02, dtype)},
        "mix": {"w": init_normal(gen, (vocab, n_hashes), 0.5, dtype)},
        # constants (non-trainable)
        "const_key_hi": torch.from_numpy(hi).to(gen.device),
        "const_key_lo": torch.from_numpy(lo).to(gen.device),
    }


def token_hashes(key_hi, key_lo, tokens, modulus, n_hashes):
    """(..., n_hashes) int64: hash j of each token id is the length-1
    Multilinear ((m2*t + m1) mod 2^64 >> 32) mod `modulus`, with (m1, m2)
    the key pair (2j, 2j+1) of the u32 planes `key_hi`/`key_lo`. In int64
    lanes whose multiply and add wrap mod 2^64 (`>>` of int64 is
    arithmetic, hence the mask after the shift)."""
    t = tokens.long() & MASK32  # the reference's tokens.astype(uint32)
    k = (key_hi << 32) | key_lo  # u64 bits
    out = []
    for h in range(n_hashes):
        s = k[2 * h + 1] * t + k[2 * h]
        out.append(((s >> 32) & MASK32) % modulus)
    return torch.stack(out, dim=-1)


def hashed_buckets(params, tokens, n_buckets, n_hashes=2):
    """(..., n_hashes) int64 bucket ids of the hashed embedding."""
    return token_hashes(params["const_key_hi"], params["const_key_lo"], tokens,
                        n_buckets, n_hashes)


def hashed_embed(params, tokens, n_buckets, n_hashes=2, dtype=torch.bfloat16):
    """Plain autograd: the gathers' backward accumulates in the table's
    dtype (f32 masters), the reference's in the compute dtype (it casts a
    table before gathering from it). Equal in f32; in bf16 the port's
    gradient of `hashed` and `mix` is the more exact one."""
    buckets = hashed_buckets(params, tokens, n_buckets, n_hashes)
    mix = params["mix"]["w"][tokens.long()].to(dtype)  # (..., n_hashes)
    table = params["hashed"]["w"]
    stacked = torch.stack([table[buckets[..., h]].to(dtype)
                           for h in range(n_hashes)], dim=-1)  # (..., d, n_hashes)
    return torch.einsum("...dh,...h->...d", stacked, mix)
