"""The port's serving engine (`repro_torch.serve`) against the reference's
(`repro.serve`) on the CPU.

Both engines serve the same request lists with the same weights (the
reference's, carried over by `params_from_jax`) in float32: the greedy
tokens, the stats, the prompt keys (host, batched-device and tree paths)
and the admission verdicts must be equal. Greedy tokens are argmaxes of
logits that agree to ~1e-6 (tests/test_torch_models.py), far inside the
gaps between the top logits of these seeded prompts.

The MoE and state-space families (granite_smoke_hash, rwkv6_smoke,
jamba_smoke) are served alike too, and every leaf of a spliced cache --
attention K/V, Mamba's conv tail and state, RWKV's wkv and shift states --
equals the reference's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build as jbuild
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.models import build as tbuild
from repro_torch.models import params_from_jax
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _PREFIX_KEY_SEED


def pair(name):
    cfg = dataclasses.replace(jget(name, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(tget(name, smoke=True), dtype="float32")
    japi, tapi = jbuild(cfg), tbuild(tcfg)
    jp = jax.jit(japi.init)(jax.random.key(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, (japi, jp), (tapi, tp)


@pytest.fixture(scope="module")
def mistral():
    return pair("mistral_nemo_12b")


@pytest.fixture(scope="module")
def gemma():
    return pair("gemma3_27b")


def engines(model, **kw):
    _, (japi, jp), (tapi, tp) = model
    return JEngine(japi, jp, **kw), ServeEngine(tapi, tp, device="cpu", **kw)


def prompts(vocab, lengths, seed, repeats=()):
    g = np.random.default_rng(seed)
    out = [g.integers(0, vocab, size=int(n)).astype(np.int32) for n in lengths]
    return out + [out[i].copy() for i in repeats]


def serve_both(model, ps, max_new=5, **kw):
    je, te = engines(model, **kw)
    jr = [JRequest(i, p.copy(), max_new_tokens=max_new) for i, p in enumerate(ps)]
    tr = [Request(i, p.copy(), max_new_tokens=max_new) for i, p in enumerate(ps)]
    je.submit_all(jr)
    te.submit_all(tr)
    return (je, jr), (te, tr)


def assert_served_alike(j, t):
    (je, jr), (te, tr) = j, t
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [(r.done, r.admitted) for r in tr] == [(r.done, r.admitted) for r in jr]
    assert te.stats == je.stats
    assert list(te.slot_pos) == list(je.slot_pos)


@pytest.mark.parametrize("admission_items", [None, 4096])
@pytest.mark.parametrize("n_slots", [1, 3])
def test_engine_serves_like_the_reference(mistral, n_slots, admission_items):
    """Waves of mixed lengths, exact repeats of earlier prompts (prefix hits
    without admission, rejections with it), a short prompt budget."""
    cfg = mistral[0]
    ps = prompts(cfg.vocab_size, [3, 17, 8, 12, 5, 19, 9, 4], 5, repeats=(1, 4, 1))
    j, t = serve_both(mistral, ps, max_seq=48, admission_items=admission_items)
    assert_served_alike(j, t)
    stats = t[0].stats
    if admission_items is None:
        assert stats["prefix_hits"] == 3 and stats["prefills"] == len(ps)
    else:
        assert stats["admission_rejects"] == 3 and stats["prefills"] == len(ps) - 3


def test_prompt_keys_match(mistral):
    """One-row keys, the one batched engine launch (pow2-bucketed rows and
    width, variable length) and the tree keys of long prompts."""
    cfg = mistral[0]
    ps = prompts(cfg.vocab_size, [1, 2, 7, 8, 9, 15, 16, 30, 31, 40], 6)
    je, te = engines(mistral, max_seq=64, tree_prompt_words=16)
    reqs_j = [JRequest(i, p) for i, p in enumerate(ps)]
    reqs_t = [Request(i, p) for i, p in enumerate(ps)]
    je._precompute_prompt_keys(reqs_j)
    te._precompute_prompt_keys(reqs_t)
    assert isinstance(te._pending_keys[1], torch.Tensor)  # left in flight
    je._drain_prompt_keys()
    te._drain_prompt_keys()
    assert te._pending_keys is None
    assert te._req_key_cache == je._req_key_cache
    assert te._req_key_cache == {i: te._prompt_key(p) for i, p in enumerate(ps)}
    assert [te._prompt_key(p) for p in ps] == [je._prompt_key(p) for p in ps]


def test_long_prompts_route_through_tree_path(mistral):
    cfg = mistral[0]
    je, te = engines(mistral, max_seq=64, tree_prompt_words=8)
    long_p, short_p = prompts(cfg.vocab_size, [12, 4], 7)
    from repro_torch.hash import TreeHasher, TreeSpec

    want = TreeHasher(TreeSpec(seed=_PREFIX_KEY_SEED), device="cpu").fingerprint(
        long_p.astype(np.uint32))
    assert te._prompt_key(long_p) == want == je._prompt_key(long_p)
    assert te._tree_hasher().spec == TreeSpec(seed=0x1E53)
    te._precompute_prompt_keys([Request(99, long_p.copy())])
    assert te._req_key_cache.pop(99) == want
    assert te._pending_keys is None  # no batched launch for a long-only wave
    ps = [long_p, short_p, long_p]
    j, t = serve_both(mistral, ps, max_new=3, max_seq=64, tree_prompt_words=8,
                      n_slots=2)
    assert_served_alike(j, t)
    assert t[0].stats["prefix_hits"] == 1
    assert t[0]._req_key_cache == {}


def test_overlong_prompt_rejected_before_any_state_change(mistral):
    _, te = engines(mistral, n_slots=2, max_seq=16)
    good = Request(0, np.arange(4, dtype=np.int32))
    bad = Request(1, np.arange(16, dtype=np.int32))  # == max_seq: no budget
    with pytest.raises(ValueError, match="prompt length 16 >= max_seq 16"):
        te.submit_all([good, bad])
    assert te._pending_keys is None and te._req_key_cache == {}
    assert te.stats["prefills"] == 0 and not good.done
    te.submit_all([good])
    assert good.done


def test_failed_submit_does_not_leak_fingerprint_state(mistral, monkeypatch):
    _, te = engines(mistral, n_slots=2, max_seq=64)
    reqs = [Request(i, np.arange(6, dtype=np.int32) + i) for i in range(4)]

    def boom(req, slot):
        raise RuntimeError("prefill OOM (simulated)")

    monkeypatch.setattr(te, "_assign", boom)
    with pytest.raises(RuntimeError, match="prefill OOM"):
        te.submit_all(reqs)
    assert te._pending_keys is None
    assert te._req_key_cache == {}
    monkeypatch.undo()
    te.submit_all(reqs)  # the retry starts clean and completes
    assert all(r.done for r in reqs)
    assert te._req_key_cache == {}


def test_admission_front_door_matches(mistral):
    """An explicit service over two host Bloom shards: the same verdicts,
    rejected requests never decoded and never prefilled."""
    import repro.hash as JH
    import repro_torch.hash as TH

    cfg, (japi, jp), (tapi, tp) = mistral
    ps = prompts(cfg.vocab_size, [8, 8, 8], 3, repeats=(0, 1, 2))
    svc_j = JH.AdmissionService(JH.InProcessTransport(JH.bloom_shard_backends(2, 1024)),
                                clock=JH.VirtualClock())
    svc_t = TH.AdmissionService(
        TH.InProcessTransport(TH.bloom_shard_backends(2, 1024, device="cpu")),
        clock=TH.VirtualClock(), device="cpu")
    je = JEngine(japi, jp, n_slots=2, max_seq=64, admission=svc_j)
    te = ServeEngine(tapi, tp, n_slots=2, max_seq=64, admission=svc_t, device="cpu")
    jr = [JRequest(i, p.copy(), max_new_tokens=4) for i, p in enumerate(ps)]
    tr = [Request(i, p.copy(), max_new_tokens=4) for i, p in enumerate(ps)]
    je.submit_all(jr)
    te.submit_all(tr)
    assert_served_alike((je, jr), (te, tr))
    assert [r.admitted for r in tr] == [True] * 3 + [False] * 3
    assert all(r.out_tokens == [] for r in tr[3:])
    assert te.stats["prefills"] == 3 and te.stats["admission_rejects"] == 3
    assert svc_t.stats == svc_j.stats


def test_greedy_matches_manual_decode(mistral):
    """Engine output == a manual prefill + decode loop for a single request."""
    _, _, (tapi, tp) = mistral
    prompt = np.arange(5, dtype=np.int32) + 3
    eng = ServeEngine(tapi, tp, n_slots=1, max_seq=32, device="cpu")
    req = Request(0, prompt.copy(), max_new_tokens=4)
    eng.submit_all([req])
    logits, caches = tapi.prefill(tp, {"tokens": prompt[None]}, cache_len=32)
    toks = [int(logits[0].argmax())]
    for pos in range(len(prompt), len(prompt) + 3):
        lg, caches = tapi.decode_step(tp, caches, np.array([[toks[-1]]], np.int32), pos)
        toks.append(int(lg[0].argmax()))
    assert req.out_tokens == toks


def test_gemma3_ring_pos_property_matches(gemma):
    """The reference's splice copies a cache leaf only when its slot axis
    has length n_slots, so the ring caches' `pos` tags ((n_blocks, W) and
    (W,)) stay -1 after `_assign` although their k is written; the port
    reproduces this, and serves the same tokens."""
    cfg = gemma[0]
    ps = prompts(cfg.vocab_size, [5, 11, 20], 8)
    (je, jr), (te, tr) = serve_both(gemma, ps, max_seq=64, n_slots=2)
    assert_served_alike((je, jr), (te, tr))
    je2, te2 = engines(gemma, max_seq=64, n_slots=2)
    je2._assign(JRequest(0, ps[2].copy()), 1)
    te2._assign(Request(0, ps[2].copy()), 1)
    rings = [("blocks", f"s{i}") for i in range(5)] + [("tail", "s0")]
    for part, sub in rings:
        want = je2.caches[part][sub]
        got = te2.caches[part][sub]
        np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
        assert (got["pos"] == -1).all()
        assert got["k"].abs().sum() > 0  # the prompt's keys were written
        np.testing.assert_allclose(got["k"].numpy(), np.asarray(want["k"]),
                                   rtol=1e-4, atol=1e-4)
    glob = te2.caches["blocks"]["s5"]  # the global layer's linear cache
    assert "pos" not in glob and glob["k"][:, 1].abs().sum() > 0


def test_engine_refuses_what_it_cannot_serve(mistral):
    _, _, (tapi, tp) = mistral
    with pytest.raises(TypeError, match="greedy"):  # decoding is greedy only
        ServeEngine(tapi, tp, greedy=False, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(tapi, tp)  # the default device is the card


SERVED_FAMILIES = ["granite_moe_hash", "rwkv6_1_6b", "jamba_v0_1_52b"]


@pytest.fixture(scope="module", params=SERVED_FAMILIES)
def family(request):
    return pair(request.param)


def test_engine_serves_the_new_families_like_the_reference(family):
    """Tokens, stats, slot positions and prompt keys of two waves with a
    repeat (a prefix hit); the hash router reads each slot's current token
    at decode."""
    cfg = family[0]
    ps = prompts(cfg.vocab_size, [3, 11, 6, 9, 5], 9, repeats=(1,))
    j, t = serve_both(family, ps, max_seq=32, n_slots=2)
    assert_served_alike(j, t)
    assert t[0].stats["prefix_hits"] == 1
    assert set(t[0]._prefix_logit_cache) == set(j[0]._prefix_logit_cache)


def test_splice_copies_every_state_leaf(family):
    """`_assign` into slot 1 writes every cache leaf's slot-1 row as the
    reference's engine does (SSM states included, all of them under
    'blocks' with the slot on axis 1), and leaves slot 0 at zero."""
    cfg = family[0]
    p = prompts(cfg.vocab_size, [7], 10)[0]
    je, te = engines(family, max_seq=16, n_slots=2)
    je._assign(JRequest(0, p.copy()), 1)
    te._assign(Request(0, p.copy()), 1)
    flat = jax.tree_util.tree_leaves_with_path(je.caches)
    for path, leaf in flat:
        node = te.caches
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        np.testing.assert_allclose(node.float().numpy(), np.asarray(leaf, np.float32),
                                   rtol=1e-4, atol=1e-4, err_msg=str(path))
        assert path[0].key == "blocks" and node.shape[1] == 2
        assert node[:, 1].abs().sum() > 0 and node[:, 0].abs().sum() == 0, path
    kinds = {k.key for path, _ in flat for k in path[-1:]}
    assert kinds & {"conv", "ssm", "wkv", "shift_tm", "shift_cm", "k"}
