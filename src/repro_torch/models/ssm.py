"""State-space / linear-attention layers: Mamba (S6) and RWKV-6 (Finch).

The port of `repro.models.ssm` in plain PyTorch operations (the
reference's is jnp, no Pallas). Both are *chunked*: the sequence is
processed in fixed-size chunks with a carried state, and a single token
(T == 1, decode) takes a one-step fast path.

Mamba pads T to a multiple of its chunk with dt = 0 steps (identity: the
carried state after the padding is the last real one) and, within a chunk,
solves the linear recurrence h_t = a_t h_{t-1} + b_t with a log-step
(Hillis-Steele) scan of the reference's associative combine; the chunks
run in order. The reference uses `jax.lax.associative_scan`, which
combines in another order: the same values up to f32 rounding.

RWKV-6 pads T to its chunk (16) and uses the reference's pairwise
log-decay form per chunk, masked before `exp`, with the decays clamped
twice. The parts of a chunk that do not read the carried state are
computed for all chunks at once; only the (H, dk, dv) state runs chunk by
chunk. Per chunk the operations are the reference's, in its order.

States are f32: Mamba's (B, DI, N) and RWKV's (B, H, dk, dv); the conv
tail (B, d_conv-1, DI) and the token-shift states (B, D) are in the
compute dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.partition import WHOLE
from ..parallel.sharding import constraint
from . import layers
from .layers import init_normal

# ---------------------------------------------------------------------------
# Mamba (S6)
# ---------------------------------------------------------------------------


def mamba_init(gen, d_model, d_state=16, expand=2, d_conv=4, dt_rank=None,
               dtype=torch.float32):
    """Projections and the conv filter in `dtype` (the reference casts them
    at use); `dt_bias`, `A_log` and `D` in f32 (used uncast)."""
    d_inner = expand * d_model
    dt_rank = dt_rank or -(-d_model // 16)
    s = 1.0 / math.sqrt(d_model)
    dev = gen.device
    A = torch.arange(1, d_state + 1, dtype=torch.float32, device=dev).expand(
        d_inner, d_state)
    f32 = torch.float32
    return {
        "in_proj": {"w": init_normal(gen, (d_model, 2 * d_inner), s, dtype)},
        "conv": {"w": init_normal(gen, (d_inner, d_conv), 0.2, dtype)},
        "x_proj": {"w": init_normal(gen, (d_inner, dt_rank + 2 * d_state),
                                    1.0 / math.sqrt(d_inner), dtype)},
        "dt_proj": {"w": init_normal(gen, (dt_rank, d_inner),
                                     1.0 / math.sqrt(dt_rank), dtype)},
        "dt_bias": torch.log(torch.expm1(torch.full((d_inner,), 0.01, dtype=f32,
                                                    device=dev))),
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones(d_inner, dtype=f32, device=dev),
        "out_proj": {"w": init_normal(gen, (d_inner, d_model),
                                      1.0 / math.sqrt(d_inner), dtype)},
    }


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 0 from h = 0, as
    the pairs (prod a, h): the reference's combine (al*ar, ar*bl + br) in
    log2(L) doubling steps."""
    L = a.shape[0]
    d = 1
    while d < L:
        b = torch.cat([b[:d], a[d:] * b[:-d] + b[d:]])
        a = torch.cat([a[:d], a[d:] * a[:-d]])
        d *= 2
    return a, b


def _mamba_scan_chunked(dt, xc, Bs, Cs, A, h0, chunk):
    """Selective scan over T in chunks, discretizing inside the chunk.

    dt, xc: (B, T, DI) f32; Bs, Cs: (B, T, N) f32; A: (DI, N); h0 (B, DI, N).
    Returns (ys (B, T, DI), hT). Neither the state sequence nor dA/dBx
    exist past one (chunk, B, DI, N) tile."""
    T = dt.shape[1]
    h = h0
    ys = []
    for t0 in range(0, T, chunk):
        dt_c = dt[:, t0:t0 + chunk].transpose(0, 1)    # (chunk, B, DI)
        xc_c = xc[:, t0:t0 + chunk].transpose(0, 1)
        b_c = Bs[:, t0:t0 + chunk].transpose(0, 1)     # (chunk, B, N)
        c_c = Cs[:, t0:t0 + chunk].transpose(0, 1)
        dA = torch.exp(dt_c[..., None] * A)            # (chunk, B, DI, N)
        dBx = (dt_c * xc_c)[..., None] * b_c[:, :, None, :]
        ahat, bhat = _linear_scan(dA, dBx)
        hs = ahat * h + bhat
        ys.append(torch.einsum("tbdn,tbn->btd", hs, c_c))
        h = hs[-1]
    return torch.cat(ys, dim=1), h


def _mamba_scan(dt, xc, Bs, Cs, A, ssm_state, chunk):
    """The selective scan of (B, T, DI) dt (f32) and xc, (B, T, N) B and C,
    A (DI, N) and the carried state (B, DI, N) -> (y (B, T, DI), state)."""
    T = dt.shape[1]
    if T == 1:  # decode fast path (single-step discretization)
        dA1 = torch.exp(dt[:, 0, :, None] * A)
        dBx1 = (dt[:, 0] * xc[:, 0].float())[..., None] * Bs[:, 0].float()[:, None, :]
        hT = dA1 * ssm_state + dBx1
        return torch.einsum("bdn,bn->bd", hT, Cs[:, 0].float())[:, None], hT
    pad = (-T) % chunk
    # dt = 0 padding -> dA = exp(0) = 1, dBx = 0: identity steps, so the
    # carried state after the padding equals the last REAL state
    dt_f, xc_f, Bs_f, Cs_f = (F.pad(a.float(), (0, 0, 0, pad)) for a in (dt, xc, Bs, Cs))
    c = min(chunk, dt_f.shape[1])
    if not (torch.is_grad_enabled() and dt_f.requires_grad):
        y, hT = _mamba_scan_chunked(dt_f, xc_f, Bs_f, Cs_f, A, ssm_state, c)
        return y[:, :T], hT
    # with gradients, each chunk is recomputed in the backward: only the
    # state between chunks is saved, not a chunk's (chunk, B, DI, N) tiles
    # and their log-step scan
    h, ys = ssm_state, []
    for t0 in range(0, dt_f.shape[1], c):
        y, h = checkpoint(_mamba_scan_chunked, dt_f[:, t0:t0 + c], xc_f[:, t0:t0 + c],
                          Bs_f[:, t0:t0 + c], Cs_f[:, t0:t0 + c], A, h, c,
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :T], h


def mamba_forward(params, x, *, d_state=16, chunk=64, conv_state=None,
                  ssm_state=None, dtype=torch.bfloat16, return_state=False, part=WHOLE,
                  d_inner=None, sp=False):
    """x: (B, T, D). Optional incoming states (decode / chunked prefill):
    conv_state (B, d_conv-1, DI), ssm_state (B, DI, N) f32. With a
    `parallel.partition.Partition` of several model ranks (x the whole
    sequence, `d_inner` the whole DI): the rank's channels -- in_proj
    regathered into its columns of x and of z, the x_proj product summed
    over the ranks -- and the result in the stream's layout (`sp`)."""
    B, T, D = x.shape
    conv = params["conv"]["w"]
    DIl, d_conv = conv.shape
    DI = d_inner or DIl
    w = params["in_proj"]["w"]
    c0 = part.r * DIl
    if w.shape[1] != 2 * DI and B * T < D:
        # the rank's columns of [x | z] are not its channels: gather the
        # product (fewer elements than the weight: a decode step's few rows)
        xz = part.whole(layers.linear({"w": w}, x, dtype))
        xz = torch.cat([xz[..., c0:c0 + DIl], xz[..., DI + c0:DI + c0 + DIl]], dim=-1)
    else:  # the weight, gathered, regathered into the rank's channels
        w = part.fit(w, 1, 2 * DI)
        if DIl != DI:
            w = torch.cat([w[:, c0:c0 + DIl], w[:, DI + c0:DI + c0 + DIl]], dim=1)
        xz = layers.linear({"w": w}, x, dtype)
    xin, z = xz.chunk(2, dim=-1)
    xin = constraint(xin, "batch", None, "model")

    # causal depthwise conv over T with carried tail
    if conv_state is None:
        conv_state = torch.zeros(B, d_conv - 1, DIl, dtype=dtype, device=x.device)
    xin_ext = torch.cat([conv_state, xin], dim=1)
    new_conv_state = xin_ext[:, -(d_conv - 1):] if d_conv > 1 else conv_state
    w = conv.to(dtype)  # (DI, k)
    xc = sum(xin_ext[:, i:i + T] * w[:, i] for i in range(d_conv))
    xc = layers._silu(xc)

    # (on a mesh the product over the split channels is a partial sum:
    # its all-reduce, before the split into dt, B and C)
    xp = params["x_proj"]
    proj, kind, _ = part.linear(xc, DIl != DI, xp, DI, xp["w"].shape[1], dtype)
    if kind == "partial":
        proj = part.sum(proj)
    proj = constraint(proj, "batch", None, None)
    dt_rank = proj.shape[-1] - 2 * d_state
    dt, Bs, Cs = proj.split([dt_rank, d_state, d_state], dim=-1)
    dt = _softplus(layers.linear({"w": part.fit(params["dt_proj"]["w"], 1, DIl)}, dt,
                                 dtype).float()
                   + part.fit(params["dt_bias"], 0, DIl))  # (B, T, DI) f32
    A = -torch.exp(part.fit(params["A_log"], 0, DIl))  # (DI, N)

    if ssm_state is None:
        ssm_state = torch.zeros(B, DIl, d_state, dtype=torch.float32, device=x.device)
    y, hT = _mamba_scan(dt, xc, Bs, Cs, A, ssm_state, chunk)
    y = y + part.fit(params["D"], 0, DIl) * xc.float()
    y = y.to(dtype) * layers._silu(z)
    out = part.exit(*part.linear(y, DIl != DI, params["out_proj"], DI, D, dtype), sp=sp)
    if return_state:
        return out, (new_conv_state, hT)
    return out


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent per-channel decay linear attention
# ---------------------------------------------------------------------------

def rwkv6_init(gen, d_model, n_heads, d_ff, decay_lora=64, dtype=torch.float32):
    """Matrices and the token-shift mixes in `dtype` (cast at use);
    `decay` and `bonus` in f32 (used uncast)."""
    dk = d_model // n_heads
    s = 1.0 / math.sqrt(d_model)
    dev = gen.device
    f32 = torch.float32

    def lin(d_in, d_out, scale=s):
        return {"w": init_normal(gen, (d_in, d_out), scale, dtype)}

    return {
        "mix": torch.rand((5, d_model), generator=gen, device=dev).to(dtype),  # r,k,v,g,w
        "w_r": lin(d_model, d_model),
        "w_k": lin(d_model, d_model),
        "w_v": lin(d_model, d_model),
        "w_g": lin(d_model, d_model),
        # data-dependent decay: low-rank adapter (Finch)
        "w_decay_a": lin(d_model, decay_lora),
        "w_decay_b": lin(decay_lora, d_model, 1.0 / math.sqrt(decay_lora)),
        "decay": torch.full((d_model,), -6.0, dtype=f32, device=dev),  # base log-log decay
        "bonus": init_normal(gen, (n_heads, dk), 0.1, f32),
        "w_o": lin(d_model, d_model),
    }


def _token_shift(x, mix, shift_state=None):
    """RWKV token shift: lerp(x, x_{t-1}, mix). shift_state: (B, D) last x."""
    if shift_state is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev = torch.cat([shift_state[:, None], x[:, :-1]], dim=1)
    return x + mix * (prev - x), x[:, -1]


def _rwkv_chunks(r, k, v, log_w, u, state, chunk):
    """The chunked pairwise log-decay form. r, k, v, log_w: (B, Tp, H, dk)
    f32 with Tp a multiple of `chunk`; state (B, H, dk, dv). Returns
    (y (B, Tp, H, dv), new state)."""
    B, Tp, H, dk = r.shape
    nc = Tp // chunk

    def split(a):
        return a.reshape(B, nc, chunk, H, dk)

    rc, kc, vc, wc = map(split, (r, k, v, log_w))
    b = wc.cumsum(dim=2)                         # cumulative log decay
    b_prev = b - wc                              # decay up to t-1
    # intra-chunk: pairwise E[t,s,d] = exp(b_{t-1} - b_s), s < t. Mask
    # BEFORE exp: for s >= t the exponent is positive and would overflow.
    expo = b_prev[:, :, :, None] - b[:, :, None]  # (B, nc, C(t), C(s), H, dk)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=r.device).tril(-1)
    expo = expo.masked_fill(~tri[:, :, None, None], -math.inf)
    A = torch.einsum("bcthk,bcshk,bctshk->bctsh", rc, kc, torch.exp(expo))
    diag = torch.einsum("bcthk,bcthk->bcth", rc * u, kc)     # the bonus u
    out_intra = torch.einsum("bctsh,bcshv->bcthv", A, vc) + diag[..., None] * vc
    # state update: S' = decay(all) * S + sum_s decay(s+1..C) k_s v_s^T
    b_last = b[:, :, -1]                         # (B, nc, H, dk)
    k_dec = kc * torch.exp(b_last[:, :, None] - b)
    kv = torch.einsum("bcshk,bcshv->bchkv", k_dec, vc)
    decay = torch.exp(b_last)[..., None]
    S = state
    before = []
    for c in range(nc):
        before.append(S)
        S = decay[:, c] * S + kv[:, c]
    # inter-chunk: r_t . (decay(0..t-1) * S)
    out_state = torch.einsum("bcthk,bchkv->bcthv", rc * torch.exp(b_prev),
                             torch.stack(before, dim=1))
    return (out_state + out_intra).reshape(B, Tp, H, dk), S


def _wkv(r, k, v, log_w, u, state, chunk):
    """The WKV recurrence of (B, T, H, dk) r, k, v, log decays, bonus u
    (H, dk) and carried state (B, H, dk, dv) -> (y (B, T, H, dv), state)."""
    T = r.shape[1]
    if T == 1:  # decode fast path: out = r.(state + u k v^T); state = w*state + k v^T
        kv = torch.einsum("bhk,bhv->bhkv", k[:, 0].float(), v[:, 0].float())
        out = torch.einsum("bhk,bhkv->bhv", r[:, 0].float(),
                           state + u[None, :, :, None] * kv)
        return out[:, None], torch.exp(log_w[:, 0])[..., None] * state + kv
    pad = (-T) % chunk
    r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)).float() for a in (r, k, v))
    log_w = F.pad(log_w, (0, 0, 0, 0, 0, pad))
    y, new_state = _rwkv_chunks(r, k, v, log_w, u, state, chunk)
    return y[:, :T], new_state


def rwkv6_time_mix(params, x, n_heads, *, chunk=16, state=None, shift_state=None,
                   dtype=torch.bfloat16, return_state=False, part=WHOLE, sp=False):
    """x: (B, T, D) -> (B, T, D). state: (B, H, dk, dv) f32 carried. With a
    `parallel.partition.Partition` of several model ranks (x the whole
    sequence): the rank's heads, or every head where its columns hold no
    whole ones; the result in the stream's layout (`sp`)."""
    B, T, D = x.shape
    dk = D // n_heads
    mix = params["mix"]
    xr, last = _token_shift(x, mix[0].to(dtype), shift_state)
    xk, _ = _token_shift(x, mix[1].to(dtype), shift_state)
    xv, _ = _token_shift(x, mix[2].to(dtype), shift_state)
    xg, _ = _token_shift(x, mix[3].to(dtype), shift_state)
    xw, _ = _token_shift(x, mix[4].to(dtype), shift_state)

    rkv = [part.linear(t, False, params[n], D, D, dtype)
           for t, n in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v"))]
    if any(kind == "cols" for _, kind, _ in rkv) and rkv[0][0].shape[-1] % dk:
        rkv = [(part.whole(y) if kind == "cols" else y, "full", None)
               for y, kind, _ in rkv]  # the heads do not split: all of them
    (r, _, _), (k, _, _), (v, _, _) = rkv
    Dl = r.shape[-1]
    H = Dl // dk
    r, k, v = (t.reshape(B, T, H, dk) for t in (r, k, v))
    g = layers._silu(part.fit(part.linear(xg, False, params["w_g"], D, D, dtype)[0], -1, Dl))
    # data-dependent log decay (clamped for fp32 chunk math)
    lora = params["w_decay_a"]["w"].shape[1]
    a = torch.tanh(part.linear(xw, False, params["w_decay_a"], D, lora, dtype)[0])
    ww = part.fit(params["decay"], 0, Dl) + layers.linear(
        {"w": part.fit(params["w_decay_b"]["w"], 1, Dl)}, a, dtype).float()
    log_w = -torch.exp(ww.clamp(-8.0, 1.0))            # (B,T,D) in [-e, -3e-4]
    log_w = log_w.clamp(-10.0, -1e-4).reshape(B, T, H, dk)
    u = part.fit(params["bonus"], 0, H)  # (H, dk)

    if state is None:
        state = torch.zeros(B, H, dk, dk, dtype=torch.float32, device=x.device)
    y, new_state = _wkv(r, k, v, log_w, u, state, chunk)
    y = y.reshape(B, T, Dl)

    y = y.to(dtype) * g
    out = part.exit(*part.linear(y, Dl != D, params["w_o"], D, D, dtype), sp=sp)
    if return_state:
        return out, (new_state, last)
    return out


def rwkv6_channel_mix_init(gen, d_model, d_ff, dtype=torch.float32):
    s = 1.0 / math.sqrt(d_model)
    return {
        "mix": torch.rand((2, d_model), generator=gen, device=gen.device).to(dtype),
        "ffn_k": {"w": init_normal(gen, (d_model, d_ff), s, dtype)},
        "ffn_v": {"w": init_normal(gen, (d_ff, d_model), 1.0 / math.sqrt(d_ff), dtype)},
        "ffn_r": {"w": init_normal(gen, (d_model, d_model), s, dtype)},
    }


def rwkv6_channel_mix(params, x, *, shift_state=None, dtype=torch.bfloat16,
                      return_state=False, part=WHOLE, d_ff=None, sp=False):
    """With a `parallel.partition.Partition` of several model ranks (x the
    whole sequence, `d_ff` the whole width): the rank's FFN columns or, with
    every weight whole (the rules split none of them), every column on the
    rank's own positions -- or, where the stream is whole, the rank's share
    of the columns; the result in the stream's layout (`sp`)."""
    D = x.shape[-1]
    Fd = d_ff or params["ffn_k"]["w"].shape[1]
    xk, last = _token_shift(x, params["mix"][0].to(dtype), shift_state)
    xr, _ = _token_shift(x, params["mix"][1].to(dtype), shift_state)
    pk, pv = params["ffn_k"], params["ffn_v"]
    whole = (pk["w"].shape == (D, Fd) and pv["w"].shape == (Fd, D)
             and params["ffn_r"]["w"].shape == (D, D))
    # with every weight whole and the stream whole on every model rank (a
    # decode step), each rank takes its share of the FFN's columns
    split = whole and not sp and part.M > 1 and Fd % part.M == 0
    if split:
        pk, pv = {"w": part.mine(pk["w"], 1)}, {"w": part.mine(pv["w"], 0)}
    elif whole:
        xk, xr = part.own(xk, sp), part.own(xr, sp)
    k, kk, _ = part.linear(xk, False, pk, D, Fd, dtype)
    k = constraint(torch.relu(k).square(), "batch", None, "model")
    kv, kind, _ = part.linear(k, kk == "cols", pv, Fd, D, dtype)
    r, rk, _ = part.linear(xr, False, params["ffn_r"], D, D, dtype)
    if rk == "partial":
        r = part.sum(r)
    out = torch.sigmoid(part.fit(r, -1, kv.shape[-1])) * kv
    if split or not whole:
        out = part.exit(out, kind, sp=sp)
    if return_state:
        return out, last
    return out
