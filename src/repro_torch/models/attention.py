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

Sharded serving (a `parallel.partition.ServingPartition`) takes the
reference's serving layout: a prefill's attention is context-parallel
(`attend_rows`: the rank's query rows against k/v gathered whole), a
rank's cache is its chunk of the positions (`cache_pspec`) and writes only
the positions it holds, and a decode step combines the chunks by
flash-decoding (`_combine_chunks`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..parallel.partition import WHOLE
from ..parallel.sharding import constraint, seq_axis
from .layers import init_normal, linear

NEG_INF = -1e30
# the most query rows a model rank scores at once in a context-parallel
# prefill: the reference's own share at its production prefill (32,768
# tokens over 16 model ranks), so a longer share (fewer ranks, a longer
# prompt) runs in pieces and never holds a wider f32 score tile
Q_ROWS = 2048


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


def _heads(y, d_head):
    """(B, T, H*dh) -> (B, T, H, dh)."""
    B, T, F = y.shape
    return y.reshape(B, T, F // d_head, d_head)


def project(p, x, n: int, dtype, part=WHOLE):
    """x @ w (+ b) of a projection of n output columns, every column on
    every model rank (the rank's columns gathered where the rules split
    them)."""
    y, kind, _ = part.linear(x, False, p, x.shape[-1], n, dtype)
    return part.whole(y) if kind == "cols" else y


def whole_weights(p, dim: int, n: int, part=WHOLE) -> dict:
    """A projection's weights with `dim` of w whole (gathered over "model"
    where the rules split it); the bias as it is (the rules replicate
    it)."""
    out = {"w": part.fit(p["w"], dim, n)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def kv_project(params, x, n_kv_heads, d_head, dtype=torch.bfloat16, part=WHOLE):
    """The keys and values alone (the encoder output's, for that cache):
    every KV head."""
    n = n_kv_heads * d_head
    return (_heads(project(params["wk"], x, n, dtype, part), d_head),
            _heads(project(params["wv"], x, n, dtype, part), d_head))


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


def attend_rows(params, h, *, n_heads, n_kv_heads, d_head, dtype, part, sp, rope,
                causal=True, window=None, chunk_q=512, chunk_k=1024, fill=None):
    """Prefill's attention in the reference's context-parallel layout,
    projected: each model rank computes the query rows of its share of the
    stream (`sp`; every row when the stream is whole) against the keys and
    values of the whole sequence, every head, with wq and wo whole, so the
    output lands in the stream's layout with no sum over "model". The
    keys and values are the rank's columns gathered; the queries run
    Q_ROWS rows at a time, so no score tile is wider than (B, H, Q_ROWS,
    chunk_k). `rope(q, k, q0)` positions the heads (q's rows from position
    q0); `fill(k, v)` takes the keys and values for the cache."""
    k, v = kv_project(params, h, n_kv_heads, d_head, dtype, part)
    hq = part.own(h, sp)
    q0 = part.r * hq.shape[1] if sp else 0
    q, k = rope(_query(params, hq, n_heads * d_head, d_head, dtype, part), k, q0)
    if fill is not None:
        fill(k, v)
    return _rows_out(params, q, k, v, q0=q0, part=part, dtype=dtype, causal=causal,
                     window=window, chunk_q=chunk_q, chunk_k=chunk_k)


def _query(params, hq, n: int, d_head: int, dtype, part):
    """The heads of hq's rows, wq gathered whole."""
    return _heads(linear(whole_weights(params["wq"], 1, n, part), hq, dtype), d_head)


def _rows_out(params, q, k, v, *, q0, part, dtype, causal, window, chunk_q, chunk_k):
    """q (B, Tq, H, dh), rows from position q0, against the whole k, v,
    Q_ROWS rows at a time, projected by wo gathered whole -> (B, Tq, D)."""
    B, Tq, H, dh = q.shape
    o = torch.cat([flash_attention(q[:, c0:c0 + Q_ROWS], k, v, causal=causal,
                                   window=window, q_offset=q0 + c0, chunk_q=chunk_q,
                                   chunk_k=chunk_k)
                   for c0 in range(0, Tq, Q_ROWS)], dim=1)
    return linear(whole_weights(params["wo"], 0, H * dh, part), o.reshape(B, Tq, H * dh),
                  dtype)


def cross_attend(params, hc, cache, *, n_enc: int, n_heads, d_head, dtype, part=WHOLE,
                 sp=False, chunk_q=512, chunk_k=1024):
    """Cross-attention of hc (B, T, D) over the encoder's cached keys and
    values (the rank's chunk of their n_enc positions). Prefill (T > 1)
    with several model ranks: `attend_rows`' layout, the chunk gathered
    whole; returns the projected output in the stream's layout and
    "rows". Else -> (o (B, T, H*dh), "full"): the heads of every query,
    against a chunk split over mesh axes by flash-decoding."""
    H, dh = n_heads, d_head
    ck, cv = cache["cross_k"], cache["cross_v"]
    lo, hi, axes = part.span("cross_k", n_enc)
    T = hc.shape[1]
    if T > 1 and part.M > 1:
        q = _query(params, part.own(hc, sp), H * dh, dh, dtype, part)
        return _rows_out(params, q, part.join(ck, 1, axes), part.join(cv, 1, axes),
                         q0=0, part=part, dtype=dtype, causal=False, window=None,
                         chunk_q=chunk_q, chunk_k=chunk_k), "rows"
    q = _heads(project(params["wq"], hc, H * dh, dtype, part), dh)
    if axes:
        ok = torch.ones(hi - lo, dtype=torch.bool, device=q.device)
        o = _combine_chunks(q, ck, cv, ok, part, axes)
    else:
        o = flash_attention(q, ck, cv, causal=False, chunk_q=chunk_q, chunk_k=chunk_k)
    return o.reshape(*o.shape[:2], -1), "full"


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


def _span(cache, part):
    """(lo, hi, axes) of a self-attention cache's positions on this rank:
    a ring cache of W = its position tags' length, a linear one of the
    partition's cache length (its own length with one rank)."""
    n = cache["pos"].shape[0] if is_ring(cache) else part.cache_len or cache["k"].shape[1]
    return part.span("k", n)


def _put(local, lo: int, start: int, value) -> None:
    """Positions [start, start + n) along dim 1 of `value` (a number: to
    the end) into `local`, the chunk that holds positions lo.. of dim 1,
    in place: the part of the range that falls in the chunk."""
    hi = lo + local.shape[1]
    if isinstance(value, (int, float)):
        a = max(lo, start)
        if a < hi:
            local.narrow(1, a - lo, hi - a).fill_(value)
        return
    a, b = max(lo, start), min(hi, start + value.shape[1])
    if a < b:
        local.narrow(1, a - lo, b - a).copy_(value.narrow(1, a - start, b - a))


def cache_insert(cache, k_new, v_new, index: int, part=WHOLE):
    """Write (B, 1, Hkv, dh) at absolute position `index` (a Python int),
    in place (by the rank whose chunk of the positions holds its slot)."""
    slot = index % cache["pos"].shape[0] if is_ring(cache) else index
    lo = _span(cache, part)[0]
    _put(cache["k"], lo, slot, k_new)
    _put(cache["v"], lo, slot, v_new)
    if is_ring(cache):
        cache["pos"].narrow(0, slot, 1).fill_(index)
    return cache


def prefill_cache(cache, k, v, T, part=WHOLE):
    """A length-T prefill's keys and values (B, T, Hkv, dh), whole along
    T, into the rank's chunk of the cache, in place."""
    write = ring_prefill if is_ring(cache) else linear_prefill
    return write(cache, k, v, T, part)


def ring_prefill(cache, k, v, T, part=WHOLE):
    """Fill a ring cache from a length-T prefill, in place, preserving the
    slot = p % W invariant so later cache_insert() overwrites the oldest
    entry."""
    W = cache["pos"].shape[0]
    if T < W:
        linear_prefill(cache, k, v, T, part)
        slots = torch.arange(W, dtype=torch.int32, device=k.device)
        cache["pos"].copy_(torch.where(slots < T, slots, -1))
        return cache
    # last W positions T-W..T-1; position p -> slot p % W (static roll)
    lo = _span(cache, part)[0]
    shift = (T - W) % W
    _put(cache["k"], lo, 0, torch.roll(k[:, -W:], shift, dims=1))
    _put(cache["v"], lo, 0, torch.roll(v[:, -W:], shift, dims=1))
    pos = T - W + torch.arange(W, dtype=torch.int32, device=k.device)
    cache["pos"].copy_(torch.roll(pos, shift))
    return cache


def linear_prefill(cache, k, v, T, part=WHOLE):
    """Positions 0..T-1 from the prefill, zeros past them, in place."""
    lo = _span(cache, part)[0]
    for name, new in (("k", k), ("v", v)):
        _put(cache[name], lo, 0, new)
        _put(cache[name], lo, T, 0)
    return cache


def decode_attend(cache, q, index: int, window=None, part=WHOLE):
    """q: (B, 1, H, dh) against the cache at decode position `index`.

    Full softmax over the cache S dim -- O(S) per token. Returns
    (B, 1, H, dh). On a chunk of the positions split over mesh axes:
    flash-decoding (`_combine_chunks`)."""
    lo, hi, axes = _span(cache, part)
    if is_ring(cache):
        pos = cache["pos"][lo:hi] if axes else cache["pos"]  # (W,): the slots' tags
        ok = (pos >= 0) & (pos <= index)
    else:
        pos = torch.arange(lo, hi, device=q.device) if axes else \
            torch.arange(cache["k"].shape[1], device=q.device)
        ok = pos <= index
    if window is not None:
        ok = ok & ((index - pos) < window)
    if axes:
        return _combine_chunks(q, cache["k"], cache["v"], ok, part, axes)
    B, _, H, dh = q.shape
    Hkv = cache["k"].shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, 1, Hkv, G, dh)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, cache["k"]).float() * scale
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqs,bshd->bhgqd", p.to(cache["v"].dtype), cache["v"])
    return out.movedim(3, 1).reshape(B, 1, H, dh)


def _combine_chunks(q, k, v, ok, part, axes):
    """Flash-decoding: q (B, Tq, H, dh), every head, against the rank's
    chunk k, v (B, S_chunk, Hkv, dh) of positions split over `axes`, `ok`
    (S_chunk,) the positions it may read; each rank scores its chunk, then
    the softmax's max, its sum and the weighted values are combined over
    `axes` by all-reduces (max, sum, sum)."""
    import torch.distributed as dist

    B, Tq, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Tq, Hkv, G, dh)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k).float() * (1.0 / math.sqrt(dh))
    s = torch.where(ok, s, NEG_INF)
    m = part.reduce(s.amax(dim=-1, keepdim=True), axes, op=dist.ReduceOp.MAX)
    p = torch.exp(s - m)
    l = part.reduce(p.sum(dim=-1, keepdim=True), axes)
    o = part.reduce(torch.einsum("bhgqs,bshd->bhgqd", p.to(v.dtype), v).float(), axes)
    return (o / l).to(v.dtype).movedim(3, 1).reshape(B, Tq, H, dh)
