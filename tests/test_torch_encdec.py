"""The port's encoder-decoder (`repro_torch.models.encdec`, whisper) against
the reference's (`repro.models.encdec`) on the CPU, at whisper_smoke's
size.

The reference's weights cross over by `params_from_jax`; the same seeded
frames and tokens go through both: the encoder, the decoder caches (self
K/V and the cross K/V of the encoder output), the loss, prefill and two
decode steps. Tolerances are `tests/test_torch_models.py`'s: float32
1e-5 a layer and 1e-4 a model, bfloat16 its BF16 (whisper has no router
and no state, so the reference runs jitted).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build as jbuild
from repro.models import encdec as jed
from repro.models import transformer as jtf
from repro_torch.configs import get_config as tget
from repro_torch.models import build as tbuild
from repro_torch.models import encdec as ted
from repro_torch.models import params_from_jax
from repro_torch.models import transformer as ttf

NAME = "whisper_large_v3"
F32 = dict(rtol=1e-5, atol=1e-5)
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2.0 ** -5, atol=2.0 ** -3)}
B, T = 2, 8


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


class Whisper:
    def __init__(self, tree, dt):
        self.cfg = dataclasses.replace(jget(NAME, smoke=True), dtype=dt)
        self.tcfg = dataclasses.replace(tget(NAME, smoke=True), dtype=dt)
        self.japi, self.tapi = jbuild(self.cfg), tbuild(self.tcfg)
        self.jp = jax.tree.map(jnp.asarray, tree)
        self.tp = params_from_jax(self.tcfg, tree, device="cpu")
        g = np.random.Generator(np.random.Philox(key=np.uint64(17)))
        cfg = self.cfg
        self.batch = {
            "frames": g.normal(size=(B, cfg.encoder_positions, cfg.d_model)).astype(np.float32),
            "tokens": g.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            "labels": g.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
        self.next = g.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    tree = jax.tree.map(np.asarray, jax.jit(jbuild(jget(NAME, smoke=True)).init)(
        jax.random.key(0)))
    return {dt: Whisper(tree, dt) for dt in ("float32", "bfloat16")}


def leaves_equal(got, want, tol):
    flat = jax.tree_util.tree_leaves_with_path(want)
    n = 0
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).replace("torch.", "") == str(leaf.dtype), path
        close(node, leaf, tol)
        n += 1
    assert n == len(flat)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_encode_matches(models, dt):
    m = models[dt]
    want = jax.jit(lambda p, f: jed.encode(p, m.cfg, f))(m.jp, jnp.asarray(m.batch["frames"]))
    got = ted.encode(m.tp, m.tcfg, torch.from_numpy(m.batch["frames"]))
    assert got.dtype == ttf.compute_dtype(m.tcfg)
    close(got, want, F32 if dt == "float32" else TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_decoder_caches_match(models, dt):
    """The stacked (n_layers, B, ...) self-attention cache (zeros) and the
    cross K/V of one encoder output."""
    m = models[dt]
    jd = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    enc = np.array(jed.encode(m.jp, m.cfg, jnp.asarray(m.batch["frames"])), np.float32)
    want = jed.init_decoder_caches(m.jp, m.cfg, jnp.asarray(enc, jd), B, 12)
    got = ted.init_decoder_caches(m.tp, m.tcfg,
                                  torch.from_numpy(enc).to(ttf.compute_dtype(m.tcfg)), B, 12)
    assert sorted(got["blocks"]["s0"]) == sorted(want["blocks"]["s0"])
    leaves_equal(got, want, F32 if dt == "float32" else TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_loss_and_decoder_forward_match(models, dt):
    m = models[dt]
    jb = {k: jnp.asarray(v) for k, v in m.batch.items()}
    (l_j, met_j), h_j = jax.jit(lambda p, b: (
        m.japi.loss(p, b),
        jed.decoder_forward(p, m.cfg, b["tokens"], mode="train",
                            enc_out=jed.encode(p, m.cfg, b["frames"]))[0]))(m.jp, jb)
    l_t, met_t = m.tapi.loss(m.tp, m.batch)
    close(l_t, l_j, TOL[dt])
    close(met_t["ce"], met_j["ce"], TOL[dt])
    assert float(met_t["balance"]) == float(met_j["balance"]) == 0.0
    tb = {k: torch.from_numpy(v) for k, v in m.batch.items()}
    h_t, caches = ted.decoder_forward(m.tp, m.tcfg, tb["tokens"], mode="train",
                                      enc_out=ted.encode(m.tp, m.tcfg, tb["frames"]))
    assert caches is None
    close(h_t, h_j, TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_prefill_and_decode_match(models, dt):
    """Prefill logits and every cache leaf (self K/V written, cross K/V),
    then two decode steps."""
    m = models[dt]
    pre = {k: m.batch[k] for k in ("frames", "tokens")}
    S = T + 4
    lj, cj = jax.jit(lambda p, b: m.japi.prefill(p, b, cache_len=S))(
        m.jp, {k: jnp.asarray(v) for k, v in pre.items()})
    lt, ct = m.tapi.prefill(m.tp, pre, cache_len=S)
    assert lt.dtype == torch.float32 and lt.shape == (B, m.cfg.vocab_size)
    close(lt, lj, TOL[dt])
    leaves_equal(ct, cj, TOL[dt])
    step = jax.jit(m.japi.decode_step)
    tok = m.next
    for pos in (T, T + 1):
        lj, cj = step(m.jp, cj, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        lt, ct = m.tapi.decode_step(m.tp, ct, tok, pos)
        close(lt, lj, TOL[dt])
        leaves_equal(ct, cj, TOL[dt])
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)[:, None]


def test_decode_matches_decoder_forward(models):
    """Prefill(T-1) + decode(last) == the decoder's full forward at the
    last position, in the port alone (2e-3, the reference's decode test)."""
    m = models["float32"]
    frames = torch.from_numpy(m.batch["frames"])
    toks = torch.from_numpy(m.batch["tokens"])
    hidden, _ = ted.decoder_forward(m.tp, m.tcfg, toks, mode="train",
                                    enc_out=ted.encode(m.tp, m.tcfg, frames))
    full = (hidden[:, -1] @ ttf.unembed_matrix(m.tp, m.tcfg, hidden.dtype)).float()
    _, caches = m.tapi.prefill(m.tp, {"frames": frames, "tokens": toks[:, :T - 1]},
                               cache_len=T)
    logits, _ = m.tapi.decode_step(m.tp, caches, toks[:, T - 1:], T - 1)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_init_caches_raises_like_the_reference(models):
    m = models["float32"]
    with pytest.raises(NotImplementedError) as want:
        m.japi.init_caches(2, 8)
    with pytest.raises(NotImplementedError) as got:
        m.tapi.init_caches(2, 8, device="cpu")
    assert str(got.value) == str(want.value) == \
        "enc-dec caches require enc_out; use prefill"


def test_decoder_positions_and_encoder_desc():
    """The decoder's learned positions have 8,192 rows (not whisper's 448),
    the encoder is bidirectional, and `block_spec` gives the decoder's
    stack of n_layers."""
    cfg = tget(NAME, smoke=True)
    p = tbuild(cfg).init(torch.Generator().manual_seed(0))
    assert tuple(p["pos_dec"]["w"].shape) == (ted.DEC_POSITIONS, cfg.d_model) == (8192, 64)
    assert not ted.ENC_DESC.causal and ted.DEC_DESC.cross
    assert len(p["enc_layers"]) == cfg.n_encoder_layers
    assert len(p["blocks"]) == ttf.block_spec(cfg)[0] == jtf.block_spec(
        jget(NAME, smoke=True))[0]
