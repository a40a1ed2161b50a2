"""The port's quality battery (`repro_torch.quality`) against the
reference's (`repro.quality`) on the CPU.

The reference draws its streams with `jax.random` under JAX's original
Threefry layout (`jax.threefry_partitionable(False)`, the layout the
committed QUALITY.json was made with); the port's own Threefry stream must
give the same bits. The same streams then go through both packages'
adapters, metrics and whole battery: keygen bits, adapter outputs and
histogram counts are equal exactly, and so is every report statistic but
`bic_max_corr`, which `compare_reports`' rtol covers (a float32 reduction).
"""
import copy
import json
import math
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import limbs as jlimbs
from repro.quality import families as jfam
from repro.quality import keygen as jkey
from repro.quality import metrics as jmet
from repro.quality import runner as jrun
from repro_torch.core import limbs as tlimbs
from repro_torch.quality import families as tfam
from repro_torch.quality import keygen as tkey
from repro_torch.quality import metrics as tmet
from repro_torch.quality import runner as trun

from _torch_port import rng, u32

pytestmark = pytest.mark.quality

QUALITY_JSON = Path(__file__).resolve().parents[1] / "QUALITY.json"
FAMILY_NAMES = [f.name for f in jfam.battery_families()]
SMALL_KEYS, SMALL_AVALANCHE = 1 << 12, 1 << 8


@pytest.fixture(autouse=True)
def original_threefry():
    with jax.threefry_partitionable(False):
        yield


def _np(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).astype(np.int64)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------------------
# keygen: the Threefry stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_battery_key_matches_reference(name):
    crc = zlib.crc32(name.encode())
    for ids in ((crc,), (crc, 99), (7,), ()):
        want = tuple(int(x) for x in np.asarray(jkey.battery_key(tkey.QUALITY_SEED, *ids)))
        assert tkey.battery_key(tkey.QUALITY_SEED, *ids) == want, ids


def test_crc_ids_cover_the_upper_half():
    """Several families' stream ids are >= 2^31: fold_in takes them as u32."""
    assert sum(zlib.crc32(n.encode()) >= 1 << 31 for n in FAMILY_NAMES) >= 3
    with pytest.raises(ValueError):
        tkey.fold_in((0, 1), 1 << 32)


@pytest.mark.parametrize("b,n", [(1, 1), (5, 3), (4, 4), (7, 5), (64, 8)])
def test_streams_match_reference(b, n):
    jk = jkey.battery_key(0x5AC1, 11, b)
    tk = tkey.battery_key(0x5AC1, 11, b)
    toks = tkey.token_batch(tk, b, n, device="cpu")
    np.testing.assert_array_equal(_np(toks), _np(jkey.token_batch(jk, b, n)))
    for got, want in zip(tkey.key_planes(tk, b, n + 1, device="cpu"),
                         jkey.key_planes(jk, b, n + 1)):
        np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(
        _np(tkey.pair_partner(tk, toks)),
        _np(jkey.pair_partner(jk, jnp.asarray(_np(toks).astype(np.uint32)))))


@pytest.mark.parametrize("size", [1, 2, 9, 1000])
def test_threefry_2x32_matches_reference(size):
    from jax._src import prng

    count = u32(rng(size), size)
    key = (0x12345678, 0x9ABCDEF0)
    want = prng.threefry_2x32(jnp.asarray(np.asarray(key, np.uint32)),
                              jnp.asarray(count))
    np.testing.assert_array_equal(_np(tkey.threefry_2x32(key, _t(count))),
                                  _np(want))


def test_seed_key_and_one_layout():
    assert tkey.seed_key(0x5AC1) == (0, 0x5AC1)
    want = tuple(int(x) for x in np.asarray(jax.random.PRNGKey(0x5AC1)))
    assert tkey.seed_key(0x5AC1) == want
    with pytest.raises(ValueError):
        tkey.seed_key(-1)


# ---------------------------------------------------------------------------
# adapters and controls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_adapter_matches_reference(name):
    tf = {f.name: f for f in tfam.battery_families()}[name]
    jf = {f.name: f for f in jfam.battery_families()}[name]
    assert (tf.acc64, tf.known_bad, tf.engine) == (jf.acc64, jf.known_bad, jf.engine)
    for n in (2, 4, 6, 8):
        assert tf.key_words(n) == jf.key_words(n)
    g = rng(zlib.crc32(name.encode()))
    for n in (2, 4, 6):
        kw = jf.key_words(n)
        toks, khi, klo = u32(g, (257, n)), u32(g, (257, kw)), u32(g, (257, kw))
        got = tf.fn(_t(toks), _t(khi), _t(klo))
        want = jf.fn(jnp.asarray(toks), jnp.asarray(khi), jnp.asarray(klo))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), _np(b))


def test_trunc16_leaves_the_shared_planes_alone():
    g = rng(0x7416)
    toks, khi, klo = (_t(u32(g, (8, 4))), _t(u32(g, (8, 5))), _t(u32(g, (8, 5))))
    hi0, lo0 = khi.clone(), klo.clone()
    tfam.multilinear_trunc16(toks, khi, klo)
    assert torch.equal(khi, hi0) and torch.equal(klo, lo0)


def test_registry_drives_the_sweep():
    assert [f.name for f in tfam.battery_families()] == FAMILY_NAMES
    assert trun.probe_path_families() == jrun.probe_path_families()


# ---------------------------------------------------------------------------
# metrics: measurements and threshold math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [2, 64, 4096])
def test_bucket_metrics_match_reference(nb):
    g = rng(nb)
    h1, h2 = u32(g, 4096), u32(g, 4096)
    h2[:40] = h1[:40]
    j1, j2, t1, t2 = jnp.asarray(h1), jnp.asarray(h2), _t(h1), _t(h2)
    np.testing.assert_array_equal(_np(tmet.lemire_buckets(t1, nb)),
                                  _np(jmet.lemire_buckets(j1, nb)))
    np.testing.assert_array_equal(_np(tmet.bucket_counts(t1, nb)),
                                  _np(jmet.bucket_counts(j1, nb)))
    assert int(tmet.collision_count(t1, t2)) == int(jmet.collision_count(j1, j2))
    r = min(nb, 64)
    np.testing.assert_array_equal(_np(tmet.joint_counts(t1, t2, r)),
                                  _np(jmet.joint_counts(j1, j2, r)))


@pytest.mark.parametrize("m", [1, 3, 4096, 4097, 8191, 2**32 - 1])
def test_mod_bucket_counts_match_reference(m):
    g = rng(m % 1000 + 5)
    hi, lo = u32(g, 8192), u32(g, 8192)
    hi[:4], lo[:4] = 0xFFFFFFFF, [0, 1, 0xFFFFFFFF, 0x80000000]
    got = tmet.mod_bucket_counts(_t(hi), _t(lo), tlimbs.ModPlan.for_modulus(m), 256)
    want = jmet.mod_bucket_counts(jnp.asarray(hi), jnp.asarray(lo),
                                  jlimbs.ModPlan.for_modulus(m), 256)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("name", ["multilinear", "gf_multilinear_hm",
                                  "bad_multilinear_trunc16"])
def test_avalanche_bic_matches_reference(name):
    tf = {f.name: f for f in tfam.battery_families()}[name]
    jf = {f.name: f for f in jfam.battery_families()}[name]
    g = rng(0xA7A1)
    kw = jf.key_words(2)
    toks, khi, klo = u32(g, (512, 2)), u32(g, (512, kw)), u32(g, (512, kw))
    counts, bic = tmet.avalanche_bic(tf.fn, _t(toks), _t(khi), _t(klo))
    jcounts, jbic = jmet.avalanche_bic(jf.fn, jnp.asarray(toks),
                                       jnp.asarray(khi), jnp.asarray(klo))
    np.testing.assert_array_equal(_np(counts), _np(jcounts))
    assert bic.dtype == torch.float32
    assert float(bic) == pytest.approx(float(jbic), rel=1e-6)
    assert tmet.sac_deviation(_np(counts), 512) == jmet.sac_deviation(np.asarray(jcounts), 512)


def test_threshold_math_is_the_references():
    for z in (-3.0, 0.0, 1.5, 6.0):
        assert tmet.normal_sf(z) == jmet.normal_sf(z)
    for p in (0.5, 0.01, 1e-9):
        assert tmet.normal_quantile_sf(p) == jmet.normal_quantile_sf(p)
    for stat, df in ((50.0, 63), (4200.0, 4095), (1.0, 2)):
        assert tmet.chi2_sigma(stat, df) == jmet.chi2_sigma(stat, df)
    for df in (2, 63, 4095):
        assert tmet.chi2_bound(df) == jmet.chi2_bound(df)
    for cells in (1, 4096, 63488):
        assert tmet.sidak_cell_z(cells) == jmet.sidak_cell_z(cells)
        assert tmet.sac_bound(cells, 1 << 16) == jmet.sac_bound(cells, 1 << 16)
        assert tmet.bic_bound(cells, 1 << 16) == jmet.bic_bound(cells, 1 << 16)
    for k, n in ((0, 10), (3, 1 << 21), (5, 1 << 15), (11, 10)):
        assert tmet.binom_logsf(k, n, 2.0 ** -32) == jmet.binom_logsf(k, n, 2.0 ** -32)
    for n in (1 << 12, 1 << 21):
        assert tmet.binom_crit(n, 2.0 ** -32) == jmet.binom_crit(n, 2.0 ** -32)
    c = u32(rng(3), 64) % 100 + 1
    assert tmet.chi2_stat(c, 50.0) == jmet.chi2_stat(c, 50.0)
    for m, nb in ((2**32 - 1, 64), (2**32 - 1, 4096)):
        np.testing.assert_array_equal(tmet.mod_bucket_expected(m, nb, 1 << 21),
                                      jmet.mod_bucket_expected(m, nb, 1 << 21))
    assert math.isinf(tmet.binom_logsf(11, 10, 0.5))


# ---------------------------------------------------------------------------
# the whole battery
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reports():
    """(reference, port) reports at 2^12 keys, computed once."""
    with jax.threefry_partitionable(False):
        ref = jrun.run_battery(SMALL_KEYS, SMALL_AVALANCHE,
                               progress=lambda *_: None)
    port = trun.run_battery(SMALL_KEYS, SMALL_AVALANCHE,
                            progress=lambda *_: None, device="cpu")
    return ref, port


def test_battery_matches_reference(reports):
    ref, port = reports
    assert trun.compare_reports(ref, port, verdicts_only=False) == []
    assert port["probe_path"] == ref["probe_path"]
    assert {k: v for k, v in port.items() if k not in ("families", "probe_path")} \
        == {k: v for k, v in ref.items() if k not in ("families", "probe_path")}
    for name, f in ref["families"].items():
        got = port["families"][name]
        assert (got["known_bad"], got["passed"]) == (f["known_bad"], f["passed"])
        for a, b in zip(got["metrics"], f["metrics"]):
            if a["name"] == "bic_max_corr":
                assert a["value"] == pytest.approx(b["value"], rel=1e-3)
                assert a["passed"] == b["passed"]
            else:
                assert a == b, (name, a, b)


def test_battery_flags_bads_passes_shipped(reports):
    _, port = reports
    assert port["self_validated"] and port["all_shipped_pass"]
    for name, f in port["families"].items():
        assert f["passed"] == (not f["known_bad"]), name
    pp = port["probe_path"]
    assert set(pp["families"]) == {"multilinear", "gf_multilinear"}
    for f in pp["families"].values():
        assert f["sharded_identical"] and len(f["metrics"]) == 2 * 3


def test_report_drift_detection(reports):
    _, port = reports
    broken = copy.deepcopy(port)
    m = broken["families"]["multilinear"]["metrics"][0]
    m["passed"] = False
    problems = trun.compare_reports(port, broken, verdicts_only=True)
    assert problems and "verdict flipped" in problems[0]
    m["passed"] = True
    m["value"] += 10.0
    problems = trun.compare_reports(port, broken, verdicts_only=False)
    assert problems and "statistic drifted" in problems[0]


@pytest.fixture(scope="module")
def smoke_cli(tmp_path_factory):
    """The CLI's smoke run on the CPU, checked against the committed
    report's verdicts and written to a temporary file: (rc, report)."""
    out = tmp_path_factory.mktemp("quality") / "smoke.json"
    rc = trun.main(["--smoke", "--device", "cpu", "--check-verdicts",
                    str(QUALITY_JSON), "--out", str(out)])
    return rc, json.loads(out.read_text())


def test_smoke_report_reproduces_committed_verdicts(smoke_cli):
    rc, report = smoke_cli
    assert rc == 0
    committed = json.loads(QUALITY_JSON.read_text())
    assert trun.compare_reports(committed, report, verdicts_only=True) == []
    assert (report["n_keys"], report["avalanche_keys"]) == \
        (trun.SMOKE_KEYS, trun.SMOKE_AVALANCHE_KEYS)


def test_runner_cli_round_trip(smoke_cli, tmp_path, monkeypatch):
    """A written report checks against itself (verdicts, and statistics at
    its own sizes) and the check writes nothing; a full run without --out
    is refused."""
    _, report = smoke_cli
    path = tmp_path / "smoke.json"
    path.write_text(json.dumps(report))
    monkeypatch.chdir(tmp_path)
    assert trun.main(["--check", str(path), "--device", "cpu"]) == 0
    with pytest.raises(SystemExit):
        trun.main(["--device", "cpu"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["smoke.json"]
