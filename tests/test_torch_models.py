"""The port's models (`repro_torch.models`) against the reference's
(`repro.models`) on the CPU.

The same seeded numpy inputs go through both packages, and the reference's
weights cross over by `params_from_jax`. Tolerances:
- float32: rtol = atol = 1e-5 for one layer function, 1e-4 for a whole
  model (sums run in another order in the two frameworks, so the last
  bits differ: a few 1e-6 on logits of size ~4);
- bfloat16: the two frameworks round to bf16 at different places (XLA's
  CPU backend rounds after each elementwise op, PyTorch inside fused
  ones), so results differ by a few bf16 ulps: BF16 = rtol 2^-5, atol
  2^-3 (on values up to ~4, whose ulp is 2^-6; the largest difference
  seen over the six dense SMOKE models is ~0.075);
- integers (bucket ids, ring position tags): exact.

The MoE and state-space families in bf16 are held against the reference
executed op by op (`jax.disable_jit`): under `jax.jit`, XLA fuses bf16
chains and rounds elsewhere, and a router that then picks another expert
(a near tie, or llama4's decode capacity of 1 slot) moves whole tokens.
The reference's own jit and op-by-op bf16 logits differ by up to 1.93 on
llama4_smoke's decode (0.28 on its prefill), while the port's differ
from the op-by-op ones by 0.04. Two consequences, measured on these
inputs:
- f32 states summed from bf16 inputs (Mamba's `ssm`, RWKV's `wkv`) are
  held within 2^-5 of the state's largest magnitude: the reference's own
  jit and op-by-op rwkv6_smoke `wkv` states differ by 0.195 (max 15.7),
  the port's from the op-by-op ones by 0.231;
- jamba_smoke (learned top-2 of 4 experts after bf16 Mamba layers) has
  router inputs that differ by a few ulps from the reference's, and one
  token's top-2 flips on a near tie (port probabilities 0.2394 and 0.2392,
  the reference's 0.2383 and 0.2411). Its bf16 cases therefore share the
  routes: the port takes the reference's expert ids (`shared_routes`), each
  port route that would differ is asserted to be such a tie, and the rest
  of the model is held at BF16. Its decode steps are held one at a time,
  each from the reference's caches: a step's bf16 rounding alone moves its
  logits by about 0.15 against the f32 model's in either package (the
  reference's 0.148 and 0.172 on the two steps, the port's 0.096 and
  0.187), so two steps of the port's own caches sum past BF16's atol (0.152
  at the second step) though neither package is nearer the f32 result.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.models import attention as tattn
from repro_torch.models import build as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.models import params_from_jax
from repro_torch.models import transformer as ttf

F32 = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2.0 ** -5, atol=2.0 ** -3)
DENSE = ["yi_34b", "mistral_nemo_12b", "phi3_medium_14b", "gemma3_27b",
         "gemma3_27b_hashed", "qwen2_vl_72b"]
ROUTED_OR_SSM = ["jamba_v0_1_52b", "llama4_maverick_400b_a17b",
                 "granite_moe_1b_a400m", "granite_moe_hash", "rwkv6_1_6b"]
LMS = DENSE + ROUTED_OR_SSM
CASES = [(n, dt) for dt in ("float32", "bfloat16") for n in LMS]
SHARED_ROUTES = {("jamba_v0_1_52b", "bfloat16")}
ALL = LMS + ["whisper_large_v3"]
B, T = 2, 16
TOL = {"float32": MODEL, "bfloat16": BF16}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rng(seed):
    return np.random.Generator(np.random.Philox(key=np.uint64(seed)))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


def both(x, dt="float32"):
    """A numpy array as (jax array, torch tensor) of dtype `dt`."""
    jd, td = DT[dt]
    return jnp.asarray(x, jd), torch.from_numpy(np.asarray(x)).to(td)


def tree_pair(tree):
    """A dict of numpy arrays as (jax tree, torch tree)."""
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_norms_match(dt):
    g = rng(1)
    x = g.normal(size=(2, 5, 24)).astype(np.float32)
    p = {"scale": g.normal(size=24).astype(np.float32),
         "bias": g.normal(size=24).astype(np.float32)}
    (jx, tx), (jp, tp) = both(x, dt), tree_pair(p)
    tol = F32 if dt == "float32" else BF16
    close(tlayers.rmsnorm(tp, tx), jlayers.rmsnorm(jp, jx), tol)
    close(tlayers.layernorm(tp, tx), jlayers.layernorm(jp, jx), tol)
    assert tlayers.rmsnorm(tp, tx).dtype == DT[dt][1]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu", "silu"])
@pytest.mark.parametrize("bias", [False, True])
def test_mlp_and_linear_match(act, bias, dt):
    g = rng(2)
    x = g.normal(size=(2, 3, 16)).astype(np.float32)
    p = jax.tree.map(np.asarray, jlayers.mlp_init(jax.random.key(0), 16, 40,
                                                  act=act, bias=bias))
    if bias:  # the init's biases are zeros; make them count
        p = {k: dict(v, b=g.normal(size=v["b"].shape).astype(np.float32))
             for k, v in p.items()}
    (jx, tx), (jp, tp) = both(x, dt), tree_pair(p)
    jd, td = DT[dt]
    tol = F32 if dt == "float32" else BF16
    close(tlayers.mlp(tp, tx, act=act, dtype=td),
          jlayers.mlp(jp, jx, act=act, dtype=jd), tol)
    close(tlayers.linear(tp["w_up"], tx, td), jlayers.linear(jp["w_up"], jx, jd), tol)
    close(tlayers.linear(tp["w_up"], torch.from_numpy(x)),
          jlayers.linear(jp["w_up"], jnp.asarray(x)), F32)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches(theta, dt):
    g = rng(3)
    x = g.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7) + 5
    (jx, tx) = both(x, dt)
    tol = F32 if dt == "float32" else BF16
    np.testing.assert_array_equal(tlayers.rope_freqs(16, theta),
                                  jlayers.rope_freqs(16, theta))
    close(tlayers.apply_rope(tx, torch.from_numpy(pos), theta),
          jlayers.apply_rope(jx, jnp.asarray(pos), theta), tol)
    thw = np.stack([np.where(pos < 8, 0, pos), np.where(pos < 8, pos // 2, pos),
                    np.where(pos < 8, pos % 2, pos)])
    close(tlayers.apply_mrope(tx, torch.from_numpy(thw), (2, 3, 3), theta),
          jlayers.apply_mrope(jx, jnp.asarray(thw), (2, 3, 3), theta), tol)
    with pytest.raises(ValueError, match="sections"):
        tlayers.apply_mrope(tx, torch.from_numpy(thw), (2, 3, 2), theta)


def test_sinusoidal_positions_match():
    got = tlayers.sinusoidal_positions(11, 12, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jlayers.sinusoidal_positions(11, 12)))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_embed_matches(dt):
    p = jax.tree.map(np.asarray, jlayers.embedding_init(jax.random.key(1), 50, 8))
    toks = rng(4).integers(0, 50, size=(3, 6)).astype(np.int32)
    jp, tp = tree_pair(p)
    jd, td = DT[dt]
    np.testing.assert_array_equal(
        as_np(tlayers.embed(tp, torch.from_numpy(toks), td)),
        as_np(jlayers.embed(jp, jnp.asarray(toks), jd)))


@pytest.mark.parametrize("n_hashes", [1, 2, 3])
@pytest.mark.parametrize("n_buckets", [7, 128, 1000])
def test_hashed_embedding_buckets_exact(n_buckets, n_hashes):
    """The reference's own `hashed_embed` reveals its bucket ids: with
    table row r = r and a one-hot mix on hash h, the output is hash h's
    bucket (exact in f32). The port's `hashed_buckets` must equal them."""
    vocab = 3000
    p = jax.tree.map(np.asarray, jlayers.hashed_embedding_init(
        jax.random.key(2), vocab, 4, n_buckets, n_hashes))
    tp = tlayers.hashed_embedding_init(torch.Generator().manual_seed(0), vocab, 4,
                                       n_buckets, n_hashes)
    for plane in ("const_key_hi", "const_key_lo"):  # the same Philox keys
        np.testing.assert_array_equal(tp[plane].numpy(), p[plane].astype(np.int64))
    g = rng(5)
    toks = np.concatenate([[0, 1, vocab - 1], g.integers(0, vocab, 200)]).astype(np.int32)
    got = tlayers.hashed_buckets({k: torch.from_numpy(p[k].astype(np.int64))
                                  for k in ("const_key_hi", "const_key_lo")},
                                 torch.from_numpy(toks), n_buckets, n_hashes)
    table = np.repeat(np.arange(n_buckets, dtype=np.float32)[:, None], 4, axis=1)
    for h in range(n_hashes):
        mix = np.zeros((vocab, n_hashes), np.float32)
        mix[:, h] = 1
        ref = dict(p, hashed={"w": table}, mix={"w": mix})
        out = jlayers.hashed_embed(jax.tree.map(jnp.asarray, ref), jnp.asarray(toks),
                                   n_buckets, n_hashes, jnp.float32)
        np.testing.assert_array_equal(got[:, h].numpy(),
                                      np.asarray(out)[:, 0].astype(np.int64))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_hashed_embed_matches(dt):
    p = jax.tree.map(np.asarray, jlayers.hashed_embedding_init(
        jax.random.key(3), 500, 16, 125, 2))
    toks = rng(6).integers(0, 500, size=(2, 9)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {"hashed": {"w": torch.from_numpy(np.array(p["hashed"]["w"]))},
          "mix": {"w": torch.from_numpy(np.array(p["mix"]["w"]))},
          "const_key_hi": torch.from_numpy(p["const_key_hi"].astype(np.int64)),
          "const_key_lo": torch.from_numpy(p["const_key_lo"].astype(np.int64))}
    jd, td = DT[dt]
    close(tlayers.hashed_embed(tp, torch.from_numpy(toks), 125, 2, td),
          jlayers.hashed_embed(jp, jnp.asarray(toks), 125, 2, jd),
          F32 if dt == "float32" else BF16)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    # (Tq, Tk, H, Hkv, causal, window, chunk_q, chunk_k, q_offset)
    (16, 16, 4, 4, True, None, 512, 1024, 0),   # one chunk, MHA
    (13, 13, 4, 2, True, None, 4, 5, 0),        # GQA, Tq/Tk not chunk multiples
    (13, 13, 6, 2, True, 4, 4, 5, 0),           # windowed, G = 3
    (7, 19, 4, 1, False, None, 3, 8, 0),        # cross-shaped, MQA
    (5, 12, 4, 2, True, 6, 2, 5, 7),            # offset queries, window
])
def test_flash_attention_matches(case, dt):
    Tq, Tk, H, Hkv, causal, window, cq, ck, q_off = case
    g = rng(7)
    q = g.normal(size=(2, Tq, H, 8)).astype(np.float32)
    k = g.normal(size=(2, Tk, Hkv, 8)).astype(np.float32)
    v = g.normal(size=(2, Tk, Hkv, 8)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = both(q, dt), both(k, dt), both(v, dt)
    kw = dict(causal=causal, window=window, q_offset=q_off, chunk_q=cq, chunk_k=ck)
    got = tattn.flash_attention(tq, tk, tv, **kw)
    assert got.shape == (2, Tq, H, 8) and got.dtype == DT[dt][1]
    close(got, jattn.flash_attention(jq, jk, jv, **kw),
          F32 if dt == "float32" else BF16)


@pytest.mark.parametrize("T_fill", [1, 5, 8, 11, 16, 21])
def test_ring_prefill_matches(T_fill):
    W = 8
    g = rng(8)
    k = g.normal(size=(2, T_fill, 2, 4)).astype(np.float32)
    v = g.normal(size=(2, T_fill, 2, 4)).astype(np.float32)
    want = jattn.ring_prefill(jattn.make_ring_cache(2, W, 2, 4, jnp.float32),
                              jnp.asarray(k), jnp.asarray(v), T_fill)
    got = tattn.ring_prefill(tattn.make_ring_cache(2, W, 2, 4, torch.float32, "cpu"),
                             torch.from_numpy(k), torch.from_numpy(v), T_fill)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    lin = tattn.linear_prefill(tattn.make_linear_cache(2, 24, 2, 4, torch.float32, "cpu"),
                               torch.from_numpy(k), torch.from_numpy(v), T_fill)
    jlin = jattn.linear_prefill(jattn.make_linear_cache(2, 24, 2, 4, jnp.float32),
                                jnp.asarray(k), jnp.asarray(v), T_fill)
    np.testing.assert_array_equal(lin["k"].numpy(), np.asarray(jlin["k"]))


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("window", [None, 3])
def test_cache_insert_and_decode_attend_match(ring, window):
    g = rng(9)
    S, W, T0 = 16, 6, 5
    k = g.normal(size=(2, T0, 2, 8)).astype(np.float32)
    v = g.normal(size=(2, T0, 2, 8)).astype(np.float32)
    if ring:
        jc = jattn.ring_prefill(jattn.make_ring_cache(2, W, 2, 8, jnp.float32),
                                jnp.asarray(k), jnp.asarray(v), T0)
        tc = tattn.ring_prefill(tattn.make_ring_cache(2, W, 2, 8, torch.float32, "cpu"),
                                torch.from_numpy(k), torch.from_numpy(v), T0)
    else:
        jc = jattn.linear_prefill(jattn.make_linear_cache(2, S, 2, 8, jnp.float32),
                                  jnp.asarray(k), jnp.asarray(v), T0)
        tc = tattn.linear_prefill(tattn.make_linear_cache(2, S, 2, 8, torch.float32, "cpu"),
                                  torch.from_numpy(k), torch.from_numpy(v), T0)
    for index in range(T0, T0 + 9):  # the ring wraps
        kn, vn = (g.normal(size=(2, 1, 2, 8)).astype(np.float32) for _ in range(2))
        q = g.normal(size=(2, 1, 4, 8)).astype(np.float32)
        jc = jattn.cache_insert(jc, jnp.asarray(kn), jnp.asarray(vn), index)
        tc = tattn.cache_insert(tc, torch.from_numpy(kn), torch.from_numpy(vn), index)
        for name in tc:
            np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
        close(tattn.decode_attend(tc, torch.from_numpy(q), index, window),
              jattn.decode_attend(jc, jnp.asarray(q), index, window), F32)


# ---------------------------------------------------------------------------
# the models, weights carried over from the reference
# ---------------------------------------------------------------------------

def test_block_spec_matches_for_every_config():
    for name in list(ARCH_IDS) + ["gemma3_27b_hashed", "granite_moe_hash"]:
        for smoke in (False, True):
            jn, js, jt = jtf.block_spec(jget(name, smoke=smoke))
            tn, ts, tt = ttf.block_spec(tget(name, smoke=smoke))
            assert tn == jn
            assert [dataclasses.asdict(d) for d in ts + tt] == \
                [dataclasses.asdict(d) for d in js + jt]


class Model:
    """One SMOKE config in one dtype, both packages, weights carried over."""

    def __init__(self, name, dt, tree):
        self.cfg = dataclasses.replace(jget(name, smoke=True), dtype=dt)
        self.tcfg = dataclasses.replace(tget(name, smoke=True), dtype=dt)
        self.japi, self.tapi = jbuild(self.cfg), tbuild(self.tcfg)
        self.tree = tree
        self.jp = jax.tree.map(jnp.asarray, self.tree)
        self.tp = params_from_jax(self.tcfg, self.tree, device="cpu")
        g = rng(10)
        cfg = self.cfg
        self.batch = {"tokens": g.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
                      "labels": g.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
        if cfg.vision_prefix:
            self.batch["patch_embeds"] = g.normal(
                size=(B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
        self.next = g.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)


class Zoo:
    """The reference's initial weights (numpy, f32, drawn once per SMOKE
    config whatever the compute dtype) and the `Model` pairs built on them,
    shared by the tests of this module."""

    def __init__(self):
        self._weights, self._models = {}, {}

    def weights(self, name):
        if name not in self._weights:
            api = jbuild(jget(name, smoke=True))
            self._weights[name] = jax.tree.map(
                np.asarray, jax.jit(api.init)(jax.random.key(0)))
        return self._weights[name]

    def model(self, name, dt):
        if (name, dt) not in self._models:
            self._models[(name, dt)] = Model(name, dt, self.weights(name))
        return self._models[(name, dt)]


@pytest.fixture(scope="module")
def zoo():
    return Zoo()


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def reference(fn, name, dt):
    """`fn` of the reference as the comparison runs it: jitted, or op by op
    for the MoE and state-space families in bf16 (module docstring)."""
    if dt == "bfloat16" and name in ROUTED_OR_SSM:
        def eager(*args):
            with jax.disable_jit():
                return fn(*args)
        return eager
    return jax.jit(fn)


def n_leaves(tree):
    return sum(n_leaves(v) for v in tree.values()) if isinstance(tree, dict) else 1


def torch_tree(tree):
    """A reference cache tree as torch tensors of the same dtypes."""
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_caches_equal(got, want, tol):
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert n_leaves(got) == len(flat)
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).replace("torch.", "") == str(leaf.dtype), path
        if leaf.dtype == jnp.int32:  # ring position tags
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
        elif tol is BF16 and leaf.dtype == jnp.float32:
            # an f32 state summed from bf16 inputs (Mamba's ssm, RWKV's wkv)
            np.testing.assert_allclose(as_np(node), as_np(leaf), rtol=0,
                                       atol=BF16["rtol"] * np.abs(as_np(leaf)).max())
        else:
            close(node, leaf, tol)


@pytest.fixture
def shared_routes(name, dt, monkeypatch):
    """For a case in SHARED_ROUTES: each learned-router top-k of the
    reference (run op by op) is recorded, and the port's next top-k takes
    those expert ids, with its own probabilities as gates. A token whose
    own port route would differ must be a near tie: the probabilities of
    the experts that trade places are within BF16's rtol of each other in
    both packages. Every recorded route must be taken by the end."""
    if (name, dt) not in SHARED_ROUTES:
        yield
        return
    routes = []
    j_top_k, t_topk = jax.lax.top_k, torch.topk

    def record(x, k):
        vals, idx = j_top_k(x, k)
        routes.append((np.asarray(x), np.asarray(idx)))
        return vals, idx

    def take(x, k, dim=-1, **kw):
        assert dim == -1 and routes, "a port top-k with no reference route"
        px, pi = routes.pop(0)
        idx = torch.from_numpy(pi.astype(np.int64))
        assert idx.shape == (x.shape[0], k)
        own = t_topk(x, k, dim=-1).indices
        for t in torch.nonzero((own.sort(-1).values != idx.sort(-1).values).any(-1)):
            t = int(t)
            out = sorted(set(own[t].tolist()) - set(pi[t].tolist()))
            into = sorted(set(pi[t].tolist()) - set(own[t].tolist()))
            for probs in (x[t].numpy(), px[t]):
                gap = np.abs(probs[out] - probs[into]).max()
                assert gap <= BF16["rtol"] * probs[out + into].max(), (t, out, into)
        return x.gather(-1, idx), idx

    monkeypatch.setattr(jax.lax, "top_k", record)
    monkeypatch.setattr(torch, "topk", take)
    yield
    assert not routes, f"{len(routes)} reference routes not taken"


@pytest.mark.parametrize("name,dt", CASES)
def test_forward_and_loss_match(zoo, name, dt, shared_routes):
    """Hidden states, the MoE balance term, `lm_loss` (CE + 0.01 balance)
    and its parts."""
    m = zoo.model(name, dt)
    tol = TOL[dt]
    (h_j, aux_j), (l_j, met_j) = reference(lambda p, b: (jtf.forward(
        p, m.cfg, b["tokens"], mode="train", patch_embeds=b.get("patch_embeds"))[:2],
        m.japi.loss(p, b)), name, dt)(m.jp, jbatch(m.batch))
    tb = {k: torch.from_numpy(v) for k, v in m.batch.items()}
    h_t, aux, caches = ttf.forward(m.tp, m.tcfg, tb["tokens"], mode="train",
                                   patch_embeds=tb.get("patch_embeds"))
    assert caches is None and h_t.dtype == DT[dt][1]
    assert (float(aux) > 0) == (m.cfg.moe and m.cfg.router == "learned")
    close(h_t, h_j, tol)
    close(aux, aux_j, tol)
    l_t, met_t = m.tapi.loss(m.tp, m.batch)
    close(l_t, l_j, tol)
    for part in ("ce", "balance"):
        close(met_t[part], met_j[part], tol)


@pytest.mark.parametrize("name,dt", CASES)
def test_prefill_and_decode_match(zoo, name, dt, shared_routes):
    """Prefill logits and caches (ring caches included: gemma3's window 8 <
    cache_len 24; Mamba's conv/ssm and RWKV's wkv/shift states), then two
    decode steps' logits and caches."""
    m = zoo.model(name, dt)
    tol = TOL[dt]
    S = T + 8
    pre = {k: v for k, v in m.batch.items() if k != "labels"}
    lj, cj = reference(lambda p, b: m.japi.prefill(p, b, cache_len=S),
                       name, dt)(m.jp, jbatch(pre))
    lt, ct = m.tapi.prefill(m.tp, pre, cache_len=S)
    assert lt.dtype == torch.float32 and lt.shape == (B, m.cfg.vocab_size)
    close(lt, lj, tol)
    assert_caches_equal(ct, cj, tol)
    step = reference(m.japi.decode_step, name, dt)
    tok = m.next
    for pos in (T, T + 1):
        if (name, dt) in SHARED_ROUTES:  # one step at a time (module docstring)
            ct = torch_tree(cj)
        lj, cj = step(m.jp, cj, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        lt, ct = m.tapi.decode_step(m.tp, ct, tok, pos)
        close(lt, lj, tol)
        assert_caches_equal(ct, cj, tol)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)[:, None]


@pytest.mark.parametrize("name", ["yi_34b", "gemma3_27b", "qwen2_vl_72b",
                                  "rwkv6_1_6b", "jamba_v0_1_52b",
                                  "llama4_maverick_400b_a17b", "granite_moe_hash"])
def test_decode_matches_forward(zoo, name):
    """Prefill(T-1) + decode(last) == the full forward's last logits in the
    port alone (the reference's `test_decode_matches_forward`, its 2e-3,
    with its capacity_factor 8: MoE drops are the one legitimate
    divergence between T and T-1 tokens)."""
    m = zoo.model(name, "float32")
    cfg = dataclasses.replace(m.tcfg, capacity_factor=8.0)
    api = tbuild(cfg)
    toks = torch.from_numpy(m.batch["tokens"])
    hidden, _, _ = ttf.forward(m.tp, cfg, toks, mode="train")
    full = (hidden[:, -1] @ ttf.unembed_matrix(m.tp, cfg, hidden.dtype)).float()
    _, caches = api.prefill(m.tp, {"tokens": toks[:, :T - 1]}, cache_len=T)
    logits, _ = api.decode_step(m.tp, caches, toks[:, T - 1:], T - 1)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_gemma3_ring_cache_window(zoo):
    """The reference's ring test in the port: decode past several wraps of
    the window-8 ring == the full forward restricted to the window."""
    m = zoo.model("gemma3_27b", "float32")
    toks = torch.from_numpy(rng(13).integers(0, m.cfg.vocab_size, (1, 24)))
    hidden, _, _ = ttf.forward(m.tp, m.tcfg, toks, mode="train")
    want = (hidden[:, -1] @ ttf.unembed_matrix(m.tp, m.tcfg, hidden.dtype)).float()
    logits, caches = m.tapi.prefill(m.tp, {"tokens": toks[:, :8]}, cache_len=24)
    for t in range(8, 24):
        logits, caches = m.tapi.decode_step(m.tp, caches, toks[:, t:t + 1], t)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)


# leaves the reference uses uncast (held f32 by the port, whatever the
# compute dtype), and leaves whose initial values are constants
F32_LEAVES = {"scale", "bias", "A_log", "D", "dt_bias", "decay", "bonus"}
CONSTANT_LEAVES = {"scale", "bias", "b", "A_log", "D", "dt_bias", "decay"}
# a drawn row with fewer elements than this is too few samples for the 15 %
# std bound (RWKV's (H, dk) `bonus` has 64); such rows are pooled per leaf
MIN_ROW = 256


def held_dtype(keys, compute=torch.bfloat16):
    """The dtype the port holds a reference leaf at path `keys` in."""
    if keys[-1].startswith(("const_key", "const_hash")):
        return torch.int64
    if keys[-1] in F32_LEAVES or keys[-2:] == ["router", "w"]:
        return torch.float32
    return compute


def port_leaves(want, cfg):
    """(state_dict name, reference path keys, reference array) of every leaf
    of the reference tree `want`, the stacked ones row by row."""
    rows = {"blocks": ttf.block_spec(cfg)[0], "enc_layers": cfg.n_encoder_layers}
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        keys = [k.key for k in path]
        for b in (range(rows[keys[0]]) if keys[0] in rows else [None]):
            name = ".".join([keys[0]] + ([str(b)] if b is not None else []) + keys[1:])
            yield name, keys, (leaf if b is None else leaf[b])


@pytest.mark.parametrize("name", ALL)
def test_init_shapes_names_and_scales_match(zoo, name):
    """`init` draws the reference's tree: the same paths (as state_dict
    names), shapes, the same constants (zeros, ones, Mamba's dt bias, RWKV's
    base decay and the key planes exactly; Mamba's A_log = log(1..N) within
    one f32 ulp, as XLA's CPU `log` of 7 is one ulp off the rounded value
    torch gives) and the same scales (each row's std within 15 %; rows under
    MIN_ROW elements pooled per leaf) elsewhere; each leaf in the dtype
    `params_from_jax` holds it in."""
    cfg = jget(name, smoke=True)
    want = zoo.weights(name)
    got = tbuild(tget(name, smoke=True)).init(torch.Generator().manual_seed(0))
    conv = params_from_jax(tget(name, smoke=True), want, device="cpu")
    sd, sd_conv = got.state_dict(), conv.state_dict()
    assert set(sd) == set(sd_conv)
    small = {}  # drawn leaves whose rows are under MIN_ROW, pooled
    for name_, keys, ref in port_leaves(want, cfg):
        t = sd[name_]
        assert tuple(t.shape) == ref.shape, name_
        assert t.dtype == sd_conv[name_].dtype == held_dtype(keys), name_
        if t.dtype == torch.int64:
            np.testing.assert_array_equal(t.numpy(), ref.astype(np.int64))
            np.testing.assert_array_equal(sd_conv[name_].numpy(), ref.astype(np.int64))
            continue
        held = torch.from_numpy(np.array(ref, np.float32)).to(t.dtype).float().numpy()
        assert torch.equal(sd_conv[name_].float(), torch.from_numpy(held)), name_
        if keys[-1] == "A_log":
            np.testing.assert_array_max_ulp(t.numpy(), held, maxulp=1)
        elif keys[-1] in CONSTANT_LEAVES:
            np.testing.assert_array_equal(t.float().numpy(), held)
        elif ref.size >= MIN_ROW:
            assert abs(t.float().std().item() / ref.std() - 1) < 0.15, name_
        else:
            pool = small.setdefault(tuple(keys), ([], []))
            pool[0].append(t.float().numpy().ravel())
            pool[1].append(np.asarray(ref, np.float32).ravel())
    for keys, (t, ref) in small.items():
        ratio = np.concatenate(t).std() / np.concatenate(ref).std()
        assert abs(ratio - 1) < 0.15, keys


@pytest.mark.parametrize("name", ["jamba_v0_1_52b", "rwkv6_1_6b", "granite_moe_1b_a400m",
                                  "granite_moe_hash", "llama4_maverick_400b_a17b"])
def test_bf16_tree_keeps_reference_dtypes(zoo, name):
    """`params_from_jax` of a bf16 config keeps each leaf the reference
    uses uncast in f32, bit for bit (`router.w`, `A_log`, `D`, `dt_bias`,
    `decay`, `bonus`, norm scales), and the hash router's key planes as
    int64 u32 values; the rest is bf16."""
    cfg = tget(name, smoke=True)
    assert cfg.dtype == "bfloat16"
    want = zoo.weights(name)
    sd = params_from_jax(cfg, want, device="cpu").state_dict()
    seen = set()
    for name_, keys, ref in port_leaves(want, cfg):
        t = sd[name_]
        seen.add(keys[-1] if keys[-2:] != ["router", "w"] else "router.w")
        if t.dtype == torch.bfloat16:
            assert held_dtype(keys) == torch.bfloat16, name_
            continue
        assert t.dtype == held_dtype(keys), name_
        np.testing.assert_array_equal(
            t.numpy(), ref.astype(np.int64) if t.dtype == torch.int64 else ref)
    expected = {"jamba_v0_1_52b": {"A_log", "D", "dt_bias", "router.w"},
                "rwkv6_1_6b": {"decay", "bonus"},
                "granite_moe_1b_a400m": {"router.w"},
                "granite_moe_hash": {"const_hash_hi", "const_hash_lo"},
                "llama4_maverick_400b_a17b": {"router.w"}}[name]
    assert expected <= seen


def test_input_specs_match():
    from repro.configs import SHAPES

    for name in ALL:
        j = jbuild(jget(name)).input_specs
        t = tbuild(tget(name)).input_specs
        for shape in SHAPES.values():
            want = {k: (v.shape, str(v.dtype)) for k, v in j(shape).items()}
            got = {k: (v[0], str(v[1]).replace("torch.", "")) for k, v in t(shape).items()}
            assert got == want


def test_entry_points_default_to_the_card():
    api = tbuild(tget("mistral_nemo_12b", smoke=True))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_caches(2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tget("mistral_nemo_12b", smoke=True), {})


@pytest.mark.parametrize("S", [6, 24])
@pytest.mark.parametrize("name", LMS)
def test_init_caches_layout_matches(name, S):
    """The same tree, shapes and dtypes; zeros, and ring tags at -1 (gemma3's
    window-8 layers take a ring only when S exceeds the window); Mamba's
    conv tail in the compute dtype and its state in f32, RWKV's wkv state
    in f32 and its shift states in the compute dtype."""
    cfg = jget(name, smoke=True)
    want = jtf.init_caches(cfg, 3, S)
    got = ttf.init_caches(tget(name, smoke=True), 3, S, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert n_leaves(got) == len(flat)
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).replace("torch.", "") == str(leaf.dtype), path
        np.testing.assert_array_equal(as_np(node), as_np(leaf))


@pytest.mark.parametrize("name", ["mistral_nemo_12b", "gemma3_27b_hashed"])
def test_loss_with_mask_matches(zoo, name):
    m = zoo.model(name, "float32")
    mask = (rng(14).random((B, T)) < 0.6).astype(np.float32)
    batch = dict(m.batch, mask=mask)
    (l_j, met_j) = jax.jit(m.japi.loss)(m.jp, jbatch(batch))
    l_t, met_t = m.tapi.loss(m.tp, batch)
    close(l_t, l_j, MODEL)
    close(met_t["ce"], met_j["ce"], MODEL)
    assert float(met_t["balance"]) == float(met_j["balance"]) == 0.0
