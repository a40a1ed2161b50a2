"""Port checkpointer (`repro_torch.checkpoint`) == reference
(`repro.checkpoint`): the same tree-v1 files, each package verifying and
restoring the other's checkpoints; keep-k, corruption, torn-commit
recovery, the root catching a manifest leaf swap, legacy migration and
the verify cache."""
import collections
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rng
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.hash import fingerprint_bytes as j_fingerprint_bytes
from repro.hash.tree import fingerprint_pytree as j_fingerprint_pytree
from repro_torch.checkpoint import (Checkpointer, CorruptCheckpointError,
                                    UnsupportedManifestScheme)
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.hash.tree import default_tree_hasher, root_of_leaf_fingerprints


def _arrays(seed=0):
    g = rng(seed)
    return {"w": g.standard_normal((16, 8)).astype(np.float32),
            "b16": g.standard_normal(5).astype(np.float32),
            "m": np.zeros((16, 8), np.float32),
            "step": np.int32(7 + seed),
            "odd": g.integers(0, 256, 7).astype(np.uint8),
            "sd0": np.arange(6, dtype=np.int32).reshape(2, 3),
            "sd1": g.standard_normal(3).astype(np.float32)}


def _torch_state(seed=0):
    a = _arrays(seed)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
    return {"params": {"w": t["w"], "b16": t["b16"].to(torch.bfloat16)},
            "opt": {"m": t["m"], "sd": collections.OrderedDict(
                [("z", t["sd0"]), ("a", t["sd1"])])},
            "step": t["step"], "blob": [t["odd"], None]}


def _jax_state(seed=0):
    a = _arrays(seed)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return {"params": {"w": j["w"], "b16": j["b16"].astype(jnp.bfloat16)},
            "opt": {"m": j["m"], "sd": collections.OrderedDict(
                [("z", j["sd0"]), ("a", j["sd1"])])},
            "step": j["step"], "blob": [j["odd"], None]}


PATHS = ["blob/0", "opt/m", "opt/sd/z", "opt/sd/a", "params/b16", "params/w",
         "step"]


def _ck(path, **kw):
    return Checkpointer(str(path), device="cpu", **kw)


def _leaves(out):
    """{path: float64 numpy} of a restored port (tensor) or reference state."""
    from repro_torch.core.pytree import flatten_with_paths

    return {p: np.asarray(x.float() if isinstance(x, torch.Tensor) else
                          np.asarray(x).astype(np.float64), np.float64)
            for p, x in flatten_with_paths(out)}


def _equal_states(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert list(la) == list(lb) == PATHS
    for p in la:
        np.testing.assert_array_equal(la[p], lb[p], err_msg=p)


def _manifest(root, step):
    with open(os.path.join(str(root), f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def test_same_files_as_reference(tmp_path):
    """Saving the same state gives the reference's manifest: paths, keys,
    shapes, dtypes, fingerprints and root."""
    _ck(tmp_path / "t").save(3, _torch_state())
    JCheckpointer(str(tmp_path / "j")).save(3, _jax_state())
    mt, mj = _manifest(tmp_path / "t", 3), _manifest(tmp_path / "j", 3)
    assert mt["scheme"] == mj["scheme"] == "tree-v1"
    assert list(mt["leaves"]) == list(mj["leaves"]) == PATHS
    assert mt["leaves"] == mj["leaves"] and mt["root"] == mj["root"]
    assert mt["leaves"]["params/b16"]["dtype"] == "bfloat16"
    data = np.load(tmp_path / "t" / "step_3" / "arrays.npz")
    assert sorted(data.files) == sorted(f"a{i}" for i in range(len(PATHS)))


def test_reference_writes_port_verifies_and_restores(tmp_path):
    JCheckpointer(str(tmp_path)).save(1, _jax_state(1))
    ck = _ck(tmp_path)
    assert ck.verify(1) and ck.latest_valid() == 1
    out = ck.restore(1, _torch_state())
    _equal_states(out, _jax_state(1))
    assert out["params"]["b16"].dtype == torch.bfloat16
    assert out["step"].dtype == torch.int32 and out["blob"][1] is None
    assert isinstance(out["opt"]["sd"], collections.OrderedDict)


def test_port_writes_reference_verifies_and_restores(tmp_path):
    ck = _ck(tmp_path)
    ck.save(2, _torch_state(2))
    jc = JCheckpointer(str(tmp_path))
    assert jc.verify(2) and jc.latest_valid() == 2
    out = jc.restore(2, _jax_state())
    _equal_states(out, _torch_state(2))
    assert out["params"]["b16"].dtype == jnp.bfloat16


def test_pytree_and_manifest_roots(tmp_path):
    """The manifest root is the pytree root of the STORED leaves (bf16 as
    float32); fingerprint_pytree hashes raw bf16 bytes -- both as the
    reference does."""
    from repro_torch.hash.tree import fingerprint_pytree

    th = default_tree_hasher(device="cpu")
    ck = _ck(tmp_path)
    ck.save(1, _torch_state())
    man = _manifest(tmp_path, 1)
    pairs = [(p, int(m["fingerprint"], 16)) for p, m in man["leaves"].items()]
    assert man["root"] == f"{root_of_leaf_fingerprints(pairs, th):016x}"
    pf = fingerprint_pytree(_torch_state(), th)
    jpf = j_fingerprint_pytree(_jax_state())
    assert (pf.root, pf.leaves) == (jpf.root, jpf.leaves)
    assert pf.leaf_map()["params/w"] == pairs[PATHS.index("params/w")][1]
    assert pf.leaf_map()["params/b16"] != pairs[PATHS.index("params/b16")][1]


def test_keep_k(tmp_path):
    ck = _ck(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _torch_state(s))
    assert ck.steps() == [3, 4]


def _flip_byte(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))


def test_corruption_detected(tmp_path):
    ck = _ck(tmp_path)
    ck.save(1, _torch_state(1))
    ck.save(2, _torch_state(2))
    _flip_byte(tmp_path / "step_2" / "arrays.npz")
    assert not ck.verify(2) and ck.verify(1) and ck.latest_valid() == 1
    assert not JCheckpointer(str(tmp_path)).verify(2)
    with pytest.raises(CorruptCheckpointError):
        ck.restore(2, _torch_state())


def test_clean_zip_wrong_bytes_fails_the_fingerprint(tmp_path):
    """An array rewritten in a valid zip: only the fingerprint catches it."""
    ck = _ck(tmp_path)
    ck.save(1, _torch_state())
    npz = tmp_path / "step_1" / "arrays.npz"
    data = dict(np.load(npz))
    data["a5"] = data["a5"].copy()
    data["a5"].reshape(-1)[0] += 1
    np.savez(npz, **data)
    assert not ck.verify(1)
    with pytest.raises(CorruptCheckpointError, match="fingerprint mismatch"):
        ck.restore(1, _torch_state())


def test_restore_errors(tmp_path):
    ck = _ck(tmp_path)
    ck.save(1, _torch_state())
    with pytest.raises(KeyError):
        ck.restore(1, {"different": torch.zeros(3)})
    # a mesh restore runs on a live process group of one rank a mesh
    # position (tests/test_torch_restore_mesh.py); fsdp_pods needs a mesh
    from repro_torch.parallel import Mesh

    mesh = Mesh((torch.device("cpu"),) * 2, ("data", "model"), (2, 1))
    with pytest.raises(RuntimeError, match="live process group"):
        ck.restore(1, _torch_state(), mesh=mesh)
    with pytest.raises(ValueError, match="pass mesh="):
        ck.restore(1, _torch_state(), fsdp_pods=True)
    man_path = tmp_path / "step_1" / "manifest.json"
    man = json.loads(man_path.read_text())
    man["leaves"]["params/w"]["fingerprint"] = "0" * 16
    man_path.write_text(json.dumps(man))
    with pytest.raises(CorruptCheckpointError, match="fingerprint mismatch"):
        ck.restore(1, _torch_state())


def test_crash_at_commit_keeps_old_checkpoint(tmp_path, monkeypatch):
    ck = _ck(tmp_path)
    ck.save(3, _torch_state(1))
    real_rename = os.rename

    def crashing_rename(src, dst):
        if str(src).endswith(".tmp"):
            raise OSError("simulated crash at commit")
        return real_rename(src, dst)

    with monkeypatch.context() as m:
        m.setattr(os, "rename", crashing_rename)
        with pytest.raises(OSError, match="simulated crash"):
            ck.save(3, _torch_state(2))
    assert os.path.exists(tmp_path / "step_3.old")
    ck2 = _ck(tmp_path)
    assert ck2.steps() == [3] and ck2.verify(3)
    assert not any(n.endswith((".tmp", ".old")) for n in os.listdir(tmp_path))
    _equal_states(ck2.restore(3, _torch_state()), _torch_state(1))


def test_crash_after_commit_sweeps_old_debris(tmp_path):
    ck = _ck(tmp_path)
    ck.save(2, _torch_state(4))
    src = tmp_path / "step_2"
    shutil.copytree(src, str(src) + ".old")
    os.makedirs(tmp_path / "step_9.tmp")
    ck2 = _ck(tmp_path)
    assert ck2.steps() == [2] and sorted(os.listdir(tmp_path)) == ["step_2"]
    _equal_states(ck2.restore(2, _torch_state()), _torch_state(4))


def test_root_catches_manifest_leaf_swap(tmp_path):
    ck = _ck(tmp_path)
    ck.save(1, {"a": torch.zeros(4), "b": torch.ones(4)})
    assert ck.verify(1)
    man_path = tmp_path / "step_1" / "manifest.json"
    man = json.loads(man_path.read_text())
    man["leaves"]["a"], man["leaves"]["b"] = man["leaves"]["b"], man["leaves"]["a"]
    man_path.write_text(json.dumps(man))
    ck._verify_cache.clear()
    assert not ck.verify(1)
    assert not JCheckpointer(str(tmp_path)).verify(1)


def _legacy_rewrite(step) -> None:
    """A committed step dir rewritten as a legacy stream-v0 checkpoint
    (host streaming fingerprints, no scheme/root), by the reference's
    own `fingerprint_bytes`."""
    man = json.loads((step / "manifest.json").read_text())
    data = np.load(step / "arrays.npz")
    man.pop("scheme"), man.pop("root")
    for meta in man["leaves"].values():
        meta["fingerprint"] = \
            f"{j_fingerprint_bytes(data[meta['key']].tobytes()):016x}"
    (step / "manifest.json").write_text(json.dumps(man))


def test_legacy_manifest_raises_and_migrates(tmp_path):
    ck = _ck(tmp_path)
    ck.save(1, _torch_state())
    tree_man = _manifest(tmp_path, 1)
    ck.save(2, _torch_state())
    _legacy_rewrite(tmp_path / "step_2")
    ck._verify_cache.clear()
    with pytest.raises(UnsupportedManifestScheme, match="tree-v1"):
        ck.verify(2)
    with pytest.raises(UnsupportedManifestScheme, match="migrate"):
        ck.restore(2, _torch_state())
    assert ck.latest_valid() == 1
    assert ck.migrate(2) and not ck.migrate(2)
    assert ck.verify(2) and ck.latest_valid() == 2
    man = _manifest(tmp_path, 2)
    assert man["root"] == tree_man["root"] and man["leaves"] == tree_man["leaves"]
    assert JCheckpointer(str(tmp_path)).verify(2)
    _equal_states(ck.restore(2, _torch_state()), _torch_state())


def test_migration_refuses_corrupt_legacy_checkpoint(tmp_path):
    ck = _ck(tmp_path)
    ck.save(1, _torch_state())
    step = tmp_path / "step_1"
    _legacy_rewrite(step)
    data = dict(np.load(step / "arrays.npz"))
    data["a0"] = data["a0"].copy()
    data["a0"].reshape(-1)[0] += 1
    np.savez(step / "arrays.npz", **data)
    with pytest.raises(CorruptCheckpointError, match="stream-v0"):
        ck.migrate(1)
    assert "scheme" not in _manifest(tmp_path, 1)


def test_verify_cache_skips_refingerprint(tmp_path, monkeypatch):
    ck = _ck(tmp_path)
    ck.save(1, _torch_state(1))
    ck.save(2, _torch_state(2))
    calls = {"n": 0}
    real_fp = ckpt_mod._leaf_fingerprint

    def counting_fp(arr, scheme, tree):
        calls["n"] += 1
        return real_fp(arr, scheme, tree)

    monkeypatch.setattr(ckpt_mod, "_leaf_fingerprint", counting_fp)
    assert ck.latest_valid() == 2
    first = calls["n"]
    assert first == len(PATHS)
    assert ck.latest_valid() == 2 and calls["n"] == first
    _flip_byte(tmp_path / "step_2" / "arrays.npz")
    assert ck.latest_valid() == 1 and calls["n"] > first


def test_leaf_fingerprint_rejects_retired_scheme():
    th = default_tree_hasher(device="cpu")
    arr = np.arange(1024, dtype=np.float32)
    assert ckpt_mod._leaf_fingerprint(arr, "tree-v1", th) == \
        th.fingerprint_bytes(arr.tobytes()) == \
        ckpt_mod._leaf_fingerprint(torch.from_numpy(arr), "tree-v1", th)
    for scheme in ("stream-v0", "banana-v9"):
        with pytest.raises(UnsupportedManifestScheme):
            ckpt_mod._leaf_fingerprint(arr, scheme, th)
