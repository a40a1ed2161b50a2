"""Attention: GQA with flash-style chunked softmax, sliding windows (gemma3
local:global), and KV caches (linear + ring-buffer).

The port of `repro.models.attention` in plain PyTorch operations (the
reference has no Pallas here: its `flash_attention` is a `lax.scan` in
jnp). The numerics are the reference's: scores and accumulators in f32,
its internal padding to chunk multiples with the `kv_len` mask, the GQA
repeat per kv chunk. Memory: prefill never materializes (Tq, Tk) scores,
only (B, H, Tq, Ck) per kv chunk.

Caches are updated IN PLACE (`cache_insert`, `ring_prefill`,
`linear_prefill` write into the tensors they are given and return the same
dict); the reference returns new arrays. The values are the reference's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..parallel.partition import WHOLE
from ..parallel.sharding import (constraint, dim_range, even_split, is_dtensor, seq_axis,
                                 write_at)
from .layers import init_normal

NEG_INF = -1e30


def attention_init(gen, d_model, n_heads, n_kv, d_head, bias=False,
                   dtype=torch.float32):
    """Projections stored FUSED-2D -- (d_model, H*dh) -- as the reference
    stores them; heads are a view."""
    s = 1.0 / math.sqrt(d_model)
    p = {
        "wq": {"w": init_normal(gen, (d_model, n_heads * d_head), s, dtype)},
        "wk": {"w": init_normal(gen, (d_model, n_kv * d_head), s, dtype)},
        "wv": {"w": init_normal(gen, (d_model, n_kv * d_head), s, dtype)},
        "wo": {"w": init_normal(gen, (n_heads * d_head, d_model),
                                1.0 / math.sqrt(n_heads * d_head), dtype)},
    }
    if bias:
        for key, n in (("wq", n_heads * d_head), ("wk", n_kv * d_head),
                       ("wv", n_kv * d_head), ("wo", d_model)):
            p[key]["b"] = torch.zeros(n, dtype=dtype, device=gen.device)
    return p


def _proj(p, x, dtype):
    y = x @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def _heads(y, d_head):
    """(B, T, H*dh) -> (B, T, H, dh). On a DTensor whose fused dim is split
    over mesh axes that do not divide the H heads (8 KV heads over 16
    model ranks), DTensor cannot split the dim into heads: the fused dim
    is first gathered over those axes (a redistribution by hand)."""
    B, T, F = y.shape
    return even_split(y, 2, F // d_head).reshape(B, T, -1, d_head)


def q_project(params, x, d_head, dtype=torch.bfloat16):
    """The query alone (cross-attention reads its keys and values from the
    encoder's cache)."""
    return _heads(_proj(params["wq"], x, dtype), d_head)


def kv_project(params, x, d_head, dtype=torch.bfloat16):
    """The keys and values alone (the encoder output's, for that cache)."""
    return (_heads(_proj(params["wk"], x, dtype), d_head),
            _heads(_proj(params["wv"], x, dtype), d_head))


def qkv_project(params, x, d_head, dtype=torch.bfloat16):
    return (q_project(params, x, d_head, dtype),
            *kv_project(params, x, d_head, dtype))


def out_project(params, attn_out, dtype=torch.bfloat16):
    B, T = attn_out.shape[:2]
    return _proj(params["wo"], attn_out.reshape(B, T, -1), dtype)


def attend(params, hq, hkv, *, n_heads, n_kv_heads, d_head, dtype, part=WHOLE,
           rope=None, causal=True, window=None, chunk_q=512, chunk_k=1024, fill=None):
    """Attention of hq's queries over hkv's keys and values (B, T, D), both
    whole along the sequence, with the projections `params` -> (o (B, Tq,
    ·), kind), o laid out as the rows of wo that `part.linear`'s kind says.
    With one model rank: every head ("full"). Else the rank's heads
    ("cols") when its query columns hold whole heads that read whole KV
    heads (whole GQA groups, or a part of one), else the rank's share of
    the (row, head) pairs, gathered to every head ("full"). `rope(q, k) ->
    (q, k)` positions the heads (None: cross-attention); `fill(k, v)` takes
    a prefill's keys and values for its cache."""
    D, H, Hkv, dh = hq.shape[-1], n_heads, n_kv_heads, d_head
    G = H // Hkv
    q, qk, _ = part.linear(hq, False, params["wq"], D, H * dh, dtype)
    k, kk, _ = part.linear(hkv, False, params["wk"], D, Hkv * dh, dtype)
    v, vk, _ = part.linear(hkv, False, params["wv"], D, Hkv * dh, dtype)
    B, Tq, Tk = hq.shape[0], hq.shape[1], hkv.shape[1]

    def core(q, k, v):
        if rope is not None:
            q, k = rope(q, k)
        if fill is not None:
            fill(k, v)
        return flash_attention(q, k, v, causal=causal, window=window, chunk_q=chunk_q,
                               chunk_k=chunk_k)

    if part.M == 1:
        o = core(_heads(q, dh), _heads(k, dh), _heads(v, dh))
        return o.reshape(B, Tq, -1), "full"
    if qk == "cols" and q.shape[-1] % dh == 0:
        Hl = q.shape[-1] // dh
        h0 = part.r * Hl
        if Hl % G == 0 or G % Hl == 0:
            k0, k1 = h0 // G, (h0 + Hl - 1) // G + 1
            o = core(q.reshape(B, Tq, Hl, dh), _kv_heads(part, k, kk, k0, k1, dh),
                     _kv_heads(part, v, vk, k0, k1, dh))
            return o.reshape(B, Tq, Hl * dh), "cols"
    q, k, v = (part.whole(t) if kind == "cols" else t
               for t, kind in ((q, qk), (k, kk), (v, vk)))
    U = B * H
    if U % part.M:
        o = core(q.reshape(B, Tq, H, dh), k.reshape(B, Tk, Hkv, dh),
                 v.reshape(B, Tk, Hkv, dh))
        return o.reshape(B, Tq, H * dh), "full"
    Ul = U // part.M
    units = torch.arange(part.r * Ul, (part.r + 1) * Ul, device=q.device)
    kv_of = (units // H) * Hkv + (units % H) // G

    def pairs(t, T, n):  # (B, T, n*dh) -> (T, B*n, dh)
        return t.reshape(B, T, n, dh).permute(1, 0, 2, 3).reshape(T, B * n, dh)

    qu = pairs(q, Tq, H).narrow(1, part.r * Ul, Ul)
    ku = pairs(k, Tk, Hkv).index_select(1, kv_of)
    vu = pairs(v, Tk, Hkv).index_select(1, kv_of)
    o = core(qu[None], ku[None], vu[None])                            # (1, Tq, Ul, dh)
    o = part.whole(o, 2)[0]                                           # (Tq, U, dh)
    return o.reshape(Tq, B, H, dh).permute(1, 0, 2, 3).reshape(B, Tq, H * dh), "full"


def _kv_heads(part, t, kind, k0: int, k1: int, dh: int):
    """KV heads [k0, k1) of a key or value projection of the kind
    `part.linear` gave it."""
    B, T, n = t.shape
    if kind == "cols" and n == (k1 - k0) * dh and part.r * (k1 - k0) == k0:
        return t.reshape(B, T, k1 - k0, dh)
    if kind == "cols":
        t = part.whole(t)
    return t[..., k0 * dh:k1 * dh].reshape(B, T, k1 - k0, dh)


def _chunk_scores_mask(q_pos, k_pos, causal, window, kv_len=None):
    """(Cq, Ck) additive mask from absolute positions."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones(dq.shape[0], dk.shape[1], dtype=torch.bool, device=dq.device)
    if causal:
        ok = ok & (dk <= dq)
    if window is not None:
        ok = ok & ((dq - dk) < window)
    if kv_len is not None:
        ok = ok & (dk < kv_len)  # internal kv padding
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    q_offset=0, chunk_q: int = 512, chunk_k: int = 1024):
    """Online-softmax attention. q: (B, Tq, H, dh); k/v: (B, Tk, Hkv, dh).

    Returns (B, Tq, H, dh). Per kv chunk the scores are (B, H, Tq, Ck) in
    f32; every query row is in each chunk's product, as in the reference
    (its `chunk_q` only sets the padding of Tq).
    """
    if is_dtensor(q):
        return _on_ranks(q, k, v, lambda q, k, v: flash_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            chunk_q=chunk_q, chunk_k=chunk_k))
    B, Tq, H, dh = q.shape
    Tk_real, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    chunk_q = min(chunk_q, Tq)
    chunk_k = min(chunk_k, Tk_real)
    # internal padding to chunk multiples (masked out via kv_len / q slice)
    pad_q = (-Tq) % chunk_q
    pad_k = (-Tk_real) % chunk_k
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    Tq_p, Tk = Tq + pad_q, Tk_real + pad_k
    kv_len = Tk_real if pad_k else None
    scale = 1.0 / math.sqrt(dh)
    # context-parallel layout: q T-sharded over 'model', k/v whole
    q = constraint(q, "batch", seq_axis(Tq_p), None, None)
    k = constraint(k, "batch", None, None, None)
    v = constraint(v, "batch", None, None, None)
    q_pos = q_offset + torch.arange(Tq_p, device=q.device)

    acc = torch.zeros(B, H, Tq_p, dh, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq_p), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, H, Tq_p, dtype=torch.float32, device=q.device)

    def kv_step(acc, m, l, k0):
        kc, vc = k[:, k0:k0 + chunk_k], v[:, k0:k0 + chunk_k]
        if G > 1:
            kc = kc.repeat_interleave(G, dim=2)
            vc = vc.repeat_interleave(G, dim=2)
        k_pos = k0 + torch.arange(chunk_k, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kc).float() * scale
        s = s + _chunk_scores_mask(q_pos, k_pos, causal, window, kv_len)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(kc.dtype), vc).float()
        return acc, m_new, l

    # with gradients, each kv step is recomputed in the backward (the
    # reference's `jax.checkpoint` of its step): no chunk's (Tq, Ck)
    # probabilities are saved, so the saved tiles never add up to the
    # (Tq, Tk) matrix flash attention exists to avoid
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    for k0 in range(0, Tk, chunk_k):
        if remat:
            acc, m, l = checkpoint(kv_step, acc, m, l, k0, use_reentrant=False)
        else:
            acc, m, l = kv_step(acc, m, l, k0)
    out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out.movedim(1, 2)[:, :Tq]  # (B, Tq, H, dh)


def _on_ranks(q, k, v, fn):
    """fn(q, k, v) -> (B, Tq, H, dh) of DTensors, run by each rank on its
    own batch rows and query heads as plain tensors: attention is
    independent across rows and heads, so no op of it needs DTensor's
    rules (which cannot flatten a batch and a head dim sharded over two
    mesh axes without strided shards). A redistribution by hand: q, k and
    v keep their rows sharded over the batch axes and are gathered along
    the sequence; the heads are split over 'model' when it divides them
    into whole groups of the GQA grouping (else q is gathered too), and k
    and v keep the KV heads this rank's query heads read."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = q.device_mesh
    B, _, H, _ = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qp, kp, nb, heads = [], [], 1, None
    for i, a in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        hl = H // n
        if a in ("pod", "data") and B % (nb * n) == 0 and k.shape[0] == B:
            qp.append(Shard(0))
            kp.append(Shard(0))
            nb *= n
        elif a == "model" and H % n == 0 and (hl % G == 0 or G % hl == 0):
            qp.append(Shard(2))
            kp.append(Shard(2) if Hkv % n == 0 else Replicate())
            heads = (i, hl) if Hkv % n else None
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    ql = q.redistribute(mesh, qp).to_local()
    kl = k.redistribute(mesh, kp).to_local()
    vl = v.redistribute(mesh, kp).to_local()
    if heads is not None:  # KV heads whole on every rank: keep this rank's
        i, hl = heads
        h0 = mesh.get_coordinate()[i] * hl
        k0, k1 = h0 // G, (h0 + hl - 1) // G + 1
        kl, vl = kl[:, :, k0:k1], vl[:, :, k0:k1]
    out = fn(ql, kl, vl)
    return DTensor.from_local(out, mesh, qp, run_check=False)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def make_linear_cache(B, S, n_kv, d_head, dtype=torch.bfloat16, device=None,
                      sp_shard=False):
    """Standard cache: {'k','v'} of (B, S, Hkv, dh). sp_shard shards the S
    dim over 'data' (long-context decoding). Cache dicts carry NO metadata
    leaves, so they stack across blocks; ring caches are identified by the
    presence of a 'pos' buffer."""
    shape = (B, S, n_kv, d_head)
    dev = resolve_device(device)
    k = torch.zeros(shape, dtype=dtype, device=dev)
    v = torch.zeros(shape, dtype=dtype, device=dev)
    if sp_shard:
        k = constraint(k, None, "data", None, None)
        v = constraint(v, None, "data", None, None)
    return {"k": k, "v": v}


def make_ring_cache(B, W, n_kv, d_head, dtype=torch.bfloat16, device=None):
    """Sliding-window ring buffer: (B, W, Hkv, dh) + absolute position tags
    (-1 = empty), shared by the batch rows. Invariant: position p lives in
    slot p % W."""
    cache = make_linear_cache(B, W, n_kv, d_head, dtype, device)
    cache["pos"] = torch.full((W,), -1, dtype=torch.int32,
                              device=cache["k"].device)
    return cache


def is_ring(cache) -> bool:
    return "pos" in cache


def cache_insert(cache, k_new, v_new, index: int):
    """Write (B, 1, Hkv, dh) at absolute position `index` (a Python int),
    in place (on a mesh, by the ranks whose chunk of S holds it:
    `parallel.sharding.write_at`)."""
    slot = index % cache["k"].shape[1] if is_ring(cache) else index
    write_at(cache["k"], 1, slot, k_new)
    write_at(cache["v"], 1, slot, v_new)
    if is_ring(cache):
        write_at(cache["pos"], 0, slot, torch.full((1,), index, dtype=torch.int32,
                                                   device=cache["pos"].device))
    return cache


def ring_prefill(cache, k, v, T):
    """Fill a ring cache from a length-T prefill, in place, preserving the
    slot = p % W invariant so later cache_insert() overwrites the oldest
    entry."""
    W = cache["k"].shape[1]
    if T < W:
        linear_prefill(cache, k, v, T)
        slots = torch.arange(W, dtype=torch.int32, device=k.device)
        write_at(cache["pos"], 0, 0, torch.where(slots < T, slots, -1))
        return cache
    # last W positions T-W..T-1; position p -> slot p % W (static roll)
    shift = (T - W) % W
    cache["k"].copy_(_roll(k[:, -W:], shift))
    cache["v"].copy_(_roll(v[:, -W:], shift))
    pos = T - W + torch.arange(W, dtype=torch.int32, device=k.device)
    cache["pos"].copy_(torch.roll(pos, shift))
    return cache


def _roll(x, shift: int):
    """torch.roll along dim 1; on a DTensor as two slices and a cat (the
    same values: PyTorch 2.11's DTensor has no rule for roll)."""
    if not is_dtensor(x):
        return torch.roll(x, shift, dims=1)
    if shift == 0:
        return x
    return torch.cat([x[:, -shift:], x[:, :-shift]], dim=1)


def linear_prefill(cache, k, v, T):
    """Positions 0..T-1 from the prefill, zeros past them, in place."""
    for name, new in (("k", k), ("v", v)):
        write_at(cache[name], 1, 0, new)
        write_at(cache[name], 1, T, 0)
    return cache


def decode_attend(cache, q, index: int, window=None):
    """q: (B, 1, H, dh) against the cache at decode position `index`.

    Full softmax over the cache S dim -- O(S) per token. Returns
    (B, 1, H, dh).
    """
    if is_dtensor(cache["k"]):
        return _decode_attend_sharded(cache, q, index, window)
    B, _, H, dh = q.shape
    Hkv = cache["k"].shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, 1, Hkv, G, dh)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, cache["k"]).float() * scale
    if is_ring(cache):
        pos = cache["pos"]  # (W,)
        ok = (pos >= 0) & (pos <= index)
    else:
        pos = torch.arange(cache["k"].shape[1], device=q.device)
        ok = pos <= index
    if window is not None:
        ok = ok & ((index - pos) < window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqs,bshd->bhgqd", p.to(cache["v"].dtype), cache["v"])
    return out.movedim(3, 1).reshape(B, 1, H, dh)


def _decode_attend_sharded(cache, q, index: int, window=None):
    """`decode_attend` on a cache of DTensors whose S is split over mesh
    axes (flash-decoding): each rank scores the query against its own
    chunk of S for every head of its batch rows, then the softmax's max,
    its sum and the weighted values are combined across the axes that
    split S by all-reduces (max, sum, sum). A redistribution by hand: the
    query is gathered to every head and laid out as the cache's rows."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    k = cache["k"]
    mesh = k.device_mesh
    H, dh = q.shape[2:]
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in k.placements]
    ql = q.redistribute(mesh, rows).to_local()
    kl, vl = k.to_local(), cache["v"].to_local()
    groups = [mesh.get_group(i) for i, p in enumerate(k.placements) if p.is_shard(1)]
    lo, hi = dim_range(k, 1)
    if is_ring(cache):
        pos = cache["pos"]  # replicated by the cache rules
        pos = (pos.to_local() if is_dtensor(pos) else pos)[lo:hi]
        ok = (pos >= 0) & (pos <= index)
    else:
        pos = torch.arange(lo, hi, device=kl.device)
        ok = pos <= index
    if window is not None:
        ok = ok & ((index - pos) < window)
    qg = ql.reshape(ql.shape[0], 1, Hkv, G, dh)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, kl).float() * scale
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqs,bshd->bhgqd", p.to(vl.dtype), vl).float()
    for g in groups:
        dist.all_reduce(l, group=g)
        dist.all_reduce(o, group=g)
    out = (o / l).to(vl.dtype).movedim(3, 1).reshape(ql.shape[0], 1, H, dh)
    return DTensor.from_local(out, mesh, rows, run_check=False)
