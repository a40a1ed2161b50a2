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


def mamba_forward(params, x, *, d_state=16, chunk=64, conv_state=None,
                  ssm_state=None, dtype=torch.bfloat16, return_state=False):
    """x: (B, T, D). Optional incoming states (decode / chunked prefill):
    conv_state (B, d_conv-1, DI), ssm_state (B, DI, N) f32."""
    B, T, D = x.shape
    d_conv = params["conv"]["w"].shape[1]
    xz = layers.linear(params["in_proj"], x, dtype)
    xin, z = xz.chunk(2, dim=-1)
    DI = xin.shape[-1]
    xin = constraint(xin, "batch", None, "model")

    # causal depthwise conv over T with carried tail
    if conv_state is None:
        conv_state = torch.zeros(B, d_conv - 1, DI, dtype=dtype, device=x.device)
    xin_ext = torch.cat([conv_state, xin], dim=1)
    new_conv_state = xin_ext[:, -(d_conv - 1):] if d_conv > 1 else conv_state
    w = params["conv"]["w"].to(dtype)  # (DI, k)
    xc = sum(xin_ext[:, i:i + T] * w[:, i] for i in range(d_conv))
    xc = layers._silu(xc)

    proj = layers.linear(params["x_proj"], xc, dtype)
    dt_rank = proj.shape[-1] - 2 * d_state
    dt, Bs, Cs = proj.split([dt_rank, d_state, d_state], dim=-1)
    dt = _softplus(layers.linear(params["dt_proj"], dt, dtype).float()
                   + params["dt_bias"])  # (B, T, DI) f32
    A = -torch.exp(params["A_log"])  # (DI, N)

    if ssm_state is None:
        ssm_state = torch.zeros(B, DI, d_state, dtype=torch.float32, device=x.device)
    if T == 1:  # decode fast path (single-step discretization)
        dA1 = torch.exp(dt[:, 0, :, None] * A)
        dBx1 = (dt[:, 0] * xc[:, 0].float())[..., None] * Bs[:, 0].float()[:, None, :]
        hT = dA1 * ssm_state + dBx1
        y = torch.einsum("bdn,bn->bd", hT, Cs[:, 0].float())[:, None]
    else:
        pad = (-T) % chunk
        # dt = 0 padding -> dA = exp(0) = 1, dBx = 0: identity steps, so the
        # carried state after the padding equals the last REAL state
        dt_f, xc_f, Bs_f, Cs_f = (F.pad(a.float(), (0, 0, 0, pad))
                                  for a in (dt, xc, Bs, Cs))
        y, hT = _mamba_scan_chunked(dt_f, xc_f, Bs_f, Cs_f, A, ssm_state,
                                    min(chunk, dt_f.shape[1]))
        y = y[:, :T]
    y = y + params["D"] * xc.float()
    y = y.to(dtype) * layers._silu(z)
    out = layers.linear(params["out_proj"], y, dtype)
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


def rwkv6_time_mix(params, x, n_heads, *, chunk=16, state=None, shift_state=None,
                   dtype=torch.bfloat16, return_state=False):
    """x: (B, T, D) -> (B, T, D). state: (B, H, dk, dv) f32 carried."""
    B, T, D = x.shape
    H = n_heads
    dk = D // H
    mix = params["mix"]
    xr, last = _token_shift(x, mix[0].to(dtype), shift_state)
    xk, _ = _token_shift(x, mix[1].to(dtype), shift_state)
    xv, _ = _token_shift(x, mix[2].to(dtype), shift_state)
    xg, _ = _token_shift(x, mix[3].to(dtype), shift_state)
    xw, _ = _token_shift(x, mix[4].to(dtype), shift_state)

    r = layers.linear(params["w_r"], xr, dtype).reshape(B, T, H, dk)
    k = layers.linear(params["w_k"], xk, dtype).reshape(B, T, H, dk)
    v = layers.linear(params["w_v"], xv, dtype).reshape(B, T, H, dk)
    g = layers._silu(layers.linear(params["w_g"], xg, dtype))
    # data-dependent log decay (clamped for fp32 chunk math)
    ww = params["decay"] + layers.linear(
        params["w_decay_b"],
        torch.tanh(layers.linear(params["w_decay_a"], xw, dtype)), dtype).float()
    log_w = -torch.exp(ww.clamp(-8.0, 1.0))            # (B,T,D) in [-e, -3e-4]
    log_w = log_w.clamp(-10.0, -1e-4).reshape(B, T, H, dk)
    u = params["bonus"]  # (H, dk)

    if state is None:
        state = torch.zeros(B, H, dk, dk, dtype=torch.float32, device=x.device)

    if T == 1:  # decode fast path: out = r.(state + u k v^T); state = w*state + k v^T
        kv = torch.einsum("bhk,bhv->bhkv", k[:, 0].float(), v[:, 0].float())
        out = torch.einsum("bhk,bhkv->bhv", r[:, 0].float(),
                           state + u[None, :, :, None] * kv)
        new_state = torch.exp(log_w[:, 0])[..., None] * state + kv
        y = out.reshape(B, 1, D)
    else:
        pad = (-T) % chunk
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)).float() for a in (r, k, v))
        log_w = F.pad(log_w, (0, 0, 0, 0, 0, pad))
        y, new_state = _rwkv_chunks(r, k, v, log_w, u, state, chunk)
        y = y.reshape(B, -1, D)[:, :T]

    y = y.to(dtype) * g
    out = layers.linear(params["w_o"], y, dtype)
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
                      return_state=False):
    xk, last = _token_shift(x, params["mix"][0].to(dtype), shift_state)
    xr, _ = _token_shift(x, params["mix"][1].to(dtype), shift_state)
    k = torch.relu(layers.linear(params["ffn_k"], xk, dtype)).square()
    k = constraint(k, "batch", None, "model")
    kv = layers.linear(params["ffn_v"], k, dtype)
    out = torch.sigmoid(layers.linear(params["ffn_r"], xr, dtype)) * kv
    if return_state:
        return out, last
    return out
