"""A plain decoder with routed experts, its loss, gradients and AdamW:
the reference that decides a training cell's `correct`.

Plain torch in float32 with TF32 off (inside `Trainer`'s calls), written
from the configuration file's keys alone; it imports nothing of the
program. What it computes, a block at a time:

- RMSNorm with gain 1 + scale (eps `rms_norm_eps`), computed in f32;
- causal grouped-query attention with rotary positions (the rotate-half
  form, base `rope_theta`, positions 0 .. T-1 in every row), scores
  scaled by 1/sqrt(head width), a block of query rows at a time;
- routed experts: softmax router in f32, the top `num_experts_per_tok`
  experts of each token, gates its top probabilities renormalised; each
  expert takes its pairs in token order up to a capacity of max(k,
  ceil(N k / E * capacity_factor)) pairs a group of N tokens and drops
  the rest; each expert a SwiGLU FFN (silu(x W_gate) * (x W_up)) W_down;
  the Switch balance loss E * sum_e f_e p_e (f_e: share of tokens whose
  first choice is e; p_e: mean router probability);
- the tied unembedding, the mean over every position of the cross
  entropy plus `z_loss` * logsumexp^2; the loss adds `balance_coef`
  times the balance losses summed over the layers;
- AdamW: the gradients clipped together to a global norm of `clip_norm`,
  the two moments, their bias corrections, decoupled weight decay on
  every leaf; the rate warms up linearly over `warmup_steps` from 0, then
  falls by a half cosine to `min_ratio` of its peak at `decay_steps`.

`draw` makes the weights from the seed on the device, one normal draw for
all of them: the benchmark hands the same draw to the program and to
this reference. Each block is recomputed in the backward (activation
memory of one block), which changes no value.

With `precision="fp8"` (the control), every product that the
configuration runs in bf16 takes its operands rounded to float8 with a
per-tensor scale (e4m3 forward, e5m2 for the gradients), accumulated in
f32: the step below bf16. The router, the norms and the loss stay f32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PREFIX = "blocks/s0/"  # the stacked leaves: one row a layer
Q_ROWS = 1024  # query rows of attention's scores at a time


@dataclasses.dataclass(frozen=True)
class Arch:
    L: int
    D: int
    H: int
    Hkv: int
    F: int
    E: int
    k: int
    V: int
    theta: float
    eps: float
    capacity_factor: float
    balance_coef: float
    z_loss: float

    @property
    def dh(self) -> int:
        return self.D // self.H

    @classmethod
    def of(cls, cfg: dict) -> "Arch":
        """The widths of a configuration file (the published keys)."""
        return cls(cfg["num_hidden_layers"], cfg["hidden_size"],
                   cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["intermediate_size"], cfg["num_local_experts"],
                   cfg["num_experts_per_tok"], cfg["vocab_size"], float(cfg["rope_theta"]),
                   float(cfg["rms_norm_eps"]), float(cfg["capacity_factor"]),
                   float(cfg["balance_coef"]), float(cfg["z_loss"]))


def shapes(a: Arch) -> dict:
    """{path: (shape, scale)} of every weight, layers stacked first; the
    draw is N(0, 1) * scale (norm gains 0: a gain of 1)."""
    L, D, HD, KD, F_, E = a.L, a.D, a.H * a.dh, a.Hkv * a.dh, a.F, a.E
    s = D ** -0.5
    return {"embed/tok/w": ((a.V, D), 0.02),
            PREFIX + "ln1/scale": ((L, D), 0.0),
            PREFIX + "attn/wq/w": ((L, D, HD), s),
            PREFIX + "attn/wk/w": ((L, D, KD), s),
            PREFIX + "attn/wv/w": ((L, D, KD), s),
            PREFIX + "attn/wo/w": ((L, HD, D), HD ** -0.5),
            PREFIX + "ln2/scale": ((L, D), 0.0),
            PREFIX + "moe/router/w": ((L, D, E), s),
            PREFIX + "moe/w_gate/w": ((L, E, D, F_), s),
            PREFIX + "moe/w_up/w": ((L, E, D, F_), s),
            PREFIX + "moe/w_down/w": ((L, E, F_, D), F_ ** -0.5),
            "final_norm/scale": ((D,), 0.0)}


def draw(a: Arch, seed: int, device) -> dict:
    """{path: f32 tensor} from `seed`: one normal draw on `device` for every
    weight, each leaf a scaled view of it."""
    sh = shapes(a)
    sizes = [math.prod(shape) for shape, _ in sh.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for (path, (shape, scale)), part in zip(sh.items(), flat.split(sizes)):
        out[path] = part.view(shape).mul_(scale)
    return out


def per_leaf(tree: dict) -> dict:
    """{leaf name: tensor} with each stacked leaf split into its layers'
    rows (`<path>[<layer>]`)."""
    out = {}
    for path, t in tree.items():
        if path.startswith(PREFIX):
            out.update((f"{path}[{i}]", row) for i, row in enumerate(t.unbind(0)))
        else:
            out[path] = t
    return out


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype` under a per-tensor scale that maps its largest
    magnitude to the format's largest, back in f32."""
    top = torch.finfo(dtype).max
    s = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * s).clamp(-top, top).to(dtype).float() / s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g, torch.float8_e5m2)
        ga = g8 @ b8.transpose(-1, -2)
        gb = a8.transpose(-1, -2) @ g8
        return _unbroadcast(ga, a8.shape), _unbroadcast(gb, b8.shape)


def _unbroadcast(g, shape):
    while g.dim() > len(shape):
        g = g.sum(0)
    for d, n in enumerate(shape):
        if n == 1 and g.shape[d] != 1:
            g = g.sum(d, keepdim=True)
    return g


def matmul(precision: str):
    if precision == "float32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x, theta):
    """x (B, T, H, dh), rotate-half form."""
    T, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(a: Arch, w: dict, h, mm):
    """w: the layer's weights ({name after PREFIX: tensor}). The scores are
    taken `Q_ROWS` query rows at a time against the keys up to the block's
    last row: the same values, with at most (B, H, Q_ROWS, T) of them."""
    B, T, _ = h.shape
    q = rope(mm(h, w["attn/wq/w"]).view(B, T, a.H, a.dh), a.theta)
    k = rope(mm(h, w["attn/wk/w"]).view(B, T, a.Hkv, a.dh), a.theta)
    v = mm(h, w["attn/wv/w"]).view(B, T, a.Hkv, a.dh)
    G = a.H // a.Hkv
    q = q.transpose(1, 2)                                        # (B, H, T, dh)
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    pos = torch.arange(T, device=h.device)
    outs = []
    for q0 in range(0, T, Q_ROWS):
        q1 = min(q0 + Q_ROWS, T)
        s = mm(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2)) / math.sqrt(a.dh)
        s = s.masked_fill(pos[None, :q1] > pos[q0:q1, None], float("-inf"))
        outs.append(mm(torch.softmax(s, dim=-1), v[:, :, :q1]))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(B, T, a.H * a.dh)
    return mm(o, w["attn/wo/w"])


def capacity(a: Arch, n: int) -> int:
    return max(a.k, int(math.ceil(n * a.k / a.E * a.capacity_factor)))


def experts(a: Arch, w: dict, x, mm):
    """x (N, D), one group -> (y (N, D), balance loss)."""
    N = x.shape[0]
    probs = torch.softmax(x @ w["moe/router/w"], dim=-1)               # (N, E)
    top, idx = torch.topk(probs, a.k, dim=-1)
    gate = (top / top.sum(-1, keepdim=True).clamp_min(1e-9)).reshape(-1)
    pair_e = idx.reshape(-1)                                          # token-major
    # each pair's rank among its expert's pairs, in token order
    rank = (F.one_hot(pair_e, a.E).T.cumsum(1) - 1).gather(0, pair_e[None])[0]
    pairs = torch.nonzero(rank < capacity(a, N))[:, 0]
    pairs = pairs[torch.argsort(pair_e[pairs], stable=True)]          # by expert
    counts = torch.bincount(pair_e[pairs], minlength=a.E).tolist()
    wg, wu, wd = (w[f"moe/{m}/w"].unbind(0) for m in ("w_gate", "w_up", "w_down"))
    y = torch.zeros_like(x)
    for e, mine in enumerate(pairs.split(counts)):
        if not len(mine):
            continue
        tok = mine // a.k
        xe = x[tok]
        he = F.silu(mm(xe, wg[e])) * mm(xe, wu[e])
        y = y.index_add(0, tok, mm(he, wd[e]) * gate[mine, None])
    first = F.one_hot(idx[:, 0], a.E).float().mean(0)
    return y, a.E * (first * probs.mean(0)).sum()


def block(a: Arch, w: dict, x, mm):
    B, T, D = x.shape
    x = x + attention(a, w, rmsnorm(x, w["ln1/scale"], a.eps), mm)
    h = rmsnorm(x, w["ln2/scale"], a.eps)
    y, balance = experts(a, w, h.reshape(B * T, D), mm)
    return x + y.view(B, T, D), balance


def loss(a: Arch, W: dict, tokens, labels, mm) -> tuple:
    """-> (loss, ce): the mean over every position."""
    x = W["embed/tok/w"][tokens.long()]
    # each layer's rows of the stacked leaves, split once (a row taken by
    # indexing would give its gradient the whole leaf's size)
    rows = {p[len(PREFIX):]: t.unbind(0) for p, t in W.items() if p.startswith(PREFIX)}
    balance = torch.zeros((), device=x.device)
    for l in range(a.L):
        w = {name: r[l] for name, r in rows.items()}
        x, b = checkpoint(block, a, w, x, mm, use_reentrant=False)
        balance = balance + b
    h = rmsnorm(x, W["final_norm/scale"], a.eps).reshape(-1, a.D)
    logits = mm(h, W["embed/tok/w"].T)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.reshape(-1, 1).long())[:, 0]
    ce = (lse - ll + a.z_loss * lse.square()).mean()
    return ce + a.balance_coef * balance, ce


# ---------------------------------------------------------------------------
# the optimizer and the trainer
# ---------------------------------------------------------------------------

def rate(sched: dict, step: int) -> float:
    peak, warm = sched["peak_lr"], sched["warmup_steps"]
    if step < warm:
        return peak * step / warm
    prog = min(max((step - warm) / max(sched["decay_steps"] - warm, 1), 0.0), 1.0)
    return peak * (sched["min_ratio"] + (1 - sched["min_ratio"])
                   * 0.5 * (1 + math.cos(math.pi * prog)))


@contextlib.contextmanager
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Trainer:
    """The reference's training state and step, with the program's
    interface in a run: `step(batch)`, `leaves()`, `first_grads()`.

    weights: {path: f32 tensor} (`draw`), copied; opt, sched: the
    configuration's `optimizer` and `schedule`."""

    def __init__(self, a: Arch, weights: dict, opt: dict, sched: dict,
                 precision: str = "float32"):
        self.a, self.opt, self.sched = a, opt, sched
        self.W = {p: w.detach().clone().requires_grad_() for p, w in weights.items()}
        self.M = {p: torch.zeros_like(w) for p, w in weights.items()}
        self.V = {p: torch.zeros_like(w) for p, w in weights.items()}
        self.mm = matmul(precision)
        self.t = 0

    def step(self, batch: dict) -> torch.Tensor:
        o = self.opt
        with no_tf32():
            total, _ = loss(self.a, self.W, batch["tokens"], batch["labels"], self.mm)
            grads = torch.autograd.grad(total, list(self.W.values()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(o["clip_norm"] / norm.clamp_min(1e-9), max=1.0)
            lr = rate(self.sched, self.t)
            bc1 = 1 - o["b1"] ** (self.t + 1)
            bc2 = 1 - o["b2"] ** (self.t + 1)
            for (path, w), g in zip(self.W.items(), grads):
                g = g * scale
                m, v = self.M[path], self.V[path]
                m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                v.mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
                upd = (m / bc1) / ((v / bc2).sqrt() + o["eps"])
                w.sub_(lr * (upd + o["weight_decay"] * w))
        self.t += 1
        return total.detach()

    def leaves(self) -> dict:
        return per_leaf({p: w.detach() for p, w in self.W.items()})

    def first_grads(self) -> dict:
        """Each leaf's first clipped gradient, from the first moment after
        one step: m = (1 - b1) g."""
        return {n: m / (1 - self.opt["b1"]) for n, m in per_leaf(self.M).items()}
