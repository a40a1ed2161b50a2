"""Fault-tolerant checkpointing with tree fingerprints: npz arrays + JSON
manifest, atomic renames, keep-last-k, latest-VALID resume.

The port of `repro.checkpoint.checkpointer`; the files on disk are the
reference's exactly, so each package verifies and restores the other's
checkpoints:

  <dir>/step_<n>.tmp/...   (written)   -> atomic rename to <dir>/step_<n>/
  <dir>/step_<n>/manifest.json         -- scheme "tree-v1", per-leaf {key,
                                          shape, dtype, fingerprint}, root
  <dir>/step_<n>/arrays.npz            -- the data, leaf i under key a{i}

Leaves are named and ordered by `core.pytree.flatten_with_paths` (the
reference's jax flatten order). A leaf's fingerprint is the tree
fingerprint (`hash.tree`, default `TreeSpec`) of its stored bytes; bf16
leaves are stored as float32 with dtype "bfloat16" and fingerprinted after
that conversion. A tensor on the card is fingerprinted there before it is
copied to the host, and `restore` fingerprints each array on the device
it uploads it to.

`restore(mesh=)` is the sharded (elastic) restore: every rank of the live
process group calls it and gets its own chunks of a `TrainState` under
`train.train_state.state_shardings` (the placements the sharded step
takes). The group's rank 0 reads each leaf, uploads and fingerprints it
once, and scatters the chunks; every rank raises on a mismatch.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
import zipfile

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.pytree import flatten_with_paths, map_with_paths
from ..hash import fingerprint_bytes
from ..hash.tree import default_tree_hasher, root_of_leaf_fingerprints

# Manifest integrity scheme: per-leaf TREE digests plus a pytree ROOT digest
# over (path, leaf_fp) pairs, so a manifest edit that swaps two intact
# leaves is also caught. The legacy "stream-v0" scheme (manifests without a
# "scheme" key) is RETIRED: verify/restore raise `UnsupportedManifestScheme`;
# `migrate_legacy_manifest(step_dir)` upgrades one in place.
_SCHEME_TREE = "tree-v1"
_SCHEME_LEGACY = "stream-v0"


class UnsupportedManifestScheme(RuntimeError):
    """The manifest's integrity scheme is no longer verifiable in-process;
    the bits on disk are fine -- upgrade the manifest offline with
    `migrate_legacy_manifest(step_dir)`."""


class CorruptCheckpointError(RuntimeError):
    """A checkpoint leaf failed its integrity fingerprint or cannot be read."""


def _leaf_fingerprint(arr, scheme: str, tree) -> int:
    """The integrity fingerprint of one stored array (numpy, or a tensor of
    the same bytes) under `scheme` -- the one hashing helper that save,
    verify and restore go through."""
    if scheme != _SCHEME_TREE:
        raise UnsupportedManifestScheme(
            f"manifest scheme {scheme!r} is retired; only {_SCHEME_TREE!r} "
            "verifies. Upgrade once with "
            "repro_torch.checkpoint.migrate_legacy_manifest(<step_dir>)")
    return tree.fingerprint_array(arr)


def _load(step_dir: str):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    return manifest, np.load(os.path.join(step_dir, "arrays.npz"))


class Checkpointer:
    """Checkpoints of nested dict/list/tuple states of tensors or numpy
    arrays in `directory`, the newest `keep` kept. Fingerprints run on
    `device` (the card unless the caller passes another)."""

    def __init__(self, directory: str, keep: int = 3, *, device=None):
        self.dir = directory
        self.keep = keep
        self.device = resolve_device(device)
        self.tree = default_tree_hasher(device=self.device)
        os.makedirs(directory, exist_ok=True)
        # verify() results memoized per step, keyed on a stat signature of
        # the checkpoint files -- latest_valid() stops re-fingerprinting
        # every checkpoint on every call
        self._verify_cache: dict[int, tuple[tuple, bool]] = {}
        self._recover()

    def _recover(self) -> None:
        """Sweep crash debris from interrupted saves. A `step_N.old` next
        to a committed `step_N` is the replaced checkpoint whose delete
        never ran: remove it. A `step_N.old` with NO `step_N` means the
        crash hit between rename-aside and commit: rename it back (the old
        checkpoint is intact and is the best state we have). Orphaned
        `step_N.tmp` dirs are partial writes: drop them."""
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if re.fullmatch(r"step_\d+\.tmp", name):
                shutil.rmtree(full, ignore_errors=True)
                continue
            m = re.fullmatch(r"(step_\d+)\.old", name)
            if m:
                final = os.path.join(self.dir, m.group(1))
                if os.path.exists(final):
                    shutil.rmtree(full, ignore_errors=True)
                else:
                    os.rename(full, final)

    # -- save ---------------------------------------------------------------

    def _stored(self, leaf):
        """(host array as stored, manifest dtype, fingerprint) of a leaf."""
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            dtype = "bfloat16" if t.dtype == torch.bfloat16 else None
            if dtype:
                t = t.float()
            fp = _leaf_fingerprint(t, _SCHEME_TREE, self.tree)  # where it lies
            arr = t.cpu().numpy()
        else:
            arr = np.asarray(leaf)
            dtype = "bfloat16" if arr.dtype.name == "bfloat16" else None
            if dtype:
                arr = arr.astype(np.float32)
            fp = _leaf_fingerprint(arr, _SCHEME_TREE, self.tree)
        return arr, dtype or str(arr.dtype), fp

    def save(self, step: int, state) -> str:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = {}
        manifest = {"step": step, "time": time.time(),
                    "scheme": _SCHEME_TREE, "leaves": {}}
        pairs = []
        for i, (path, leaf) in enumerate(flatten_with_paths(state)):
            arr, dtype, fp = self._stored(leaf)
            key = f"a{i}"
            arrays[key] = arr
            pairs.append((path, fp))
            manifest["leaves"][path] = {
                "key": key,
                "shape": list(arr.shape),
                "dtype": dtype,
                "fingerprint": f"{fp:016x}",
            }
        manifest["root"] = f"{root_of_leaf_fingerprints(pairs, self.tree):016x}"
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        # commit with NO torn window: the previous version of this step is
        # renamed ASIDE (cheap, atomic) rather than deleted first, so a
        # crash at any point leaves either the old or the new checkpoint
        # restorable -- never neither. `_recover` sweeps the `.old` debris
        # a crash can leave behind.
        old = final + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(final):
            os.rename(final, old)
        os.rename(tmp, final)  # atomic commit
        if os.path.exists(old):
            shutil.rmtree(old)
        self._verify_cache.pop(step, None)
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)
            self._verify_cache.pop(s, None)

    # -- verify ---------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _stat_sig(self, step: int) -> tuple | None:
        """(name, mtime_ns, size) signature of a checkpoint's files -- the
        verify cache key. None if the checkpoint is missing a file."""
        path = os.path.join(self.dir, f"step_{step}")
        try:
            return tuple(
                (fn, os.stat(os.path.join(path, fn)).st_mtime_ns,
                 os.stat(os.path.join(path, fn)).st_size)
                for fn in ("manifest.json", "arrays.npz"))
        except OSError:
            return None

    def verify(self, step: int) -> bool:
        """True iff every leaf fingerprint and the root check out. Results
        are cached per (step, file stat signature): repeated
        `latest_valid()` calls cost a couple of os.stat's, and any on-disk
        change invalidates the entry."""
        sig = self._stat_sig(step)
        if sig is None:
            return False
        cached = self._verify_cache.get(step)
        if cached is not None and cached[0] == sig:
            return cached[1]
        ok = self._verify_uncached(step)
        self._verify_cache[step] = (sig, ok)
        return ok

    def _verify_uncached(self, step: int) -> bool:
        try:
            manifest, data = _load(os.path.join(self.dir, f"step_{step}"))
            scheme = manifest.get("scheme", _SCHEME_LEGACY)
            pairs = []
            for leaf_path, meta in manifest["leaves"].items():
                got = _leaf_fingerprint(data[meta["key"]], scheme, self.tree)
                if f"{got:016x}" != meta["fingerprint"]:
                    return False
                pairs.append((leaf_path, got))
            if "root" in manifest:
                # pytree-level check: catches manifest edits that permute
                # or relabel individually-intact leaves
                root = root_of_leaf_fingerprints(pairs, self.tree)
                if f"{root:016x}" != manifest["root"]:
                    return False
            return True
        except UnsupportedManifestScheme:
            # not mere corruption: the bits may be fine but this process
            # cannot prove it -- surface the actionable error
            raise
        except Exception:
            return False

    def latest_valid(self) -> int | None:
        """Newest checkpoint whose every fingerprint verifies; corrupt,
        torn and un-migrated legacy checkpoints are skipped."""
        for s in reversed(self.steps()):
            try:
                if self.verify(s):
                    return s
            except UnsupportedManifestScheme:
                continue
        return None

    def migrate(self, step: int) -> bool:
        """Upgrade one legacy checkpoint's manifest to tree-v1 in place
        (see `migrate_legacy_manifest`); True if a rewrite happened."""
        out = migrate_legacy_manifest(os.path.join(self.dir, f"step_{step}"),
                                      tree=self.tree)
        self._verify_cache.pop(step, None)
        return out

    # -- restore ------------------------------------------------------------

    def restore(self, step: int, like, device=None, mesh=None,
                fsdp_pods: bool = False):
        """Load into the structure of `like` (a state of the same paths):
        tensors on `device` (default: the Checkpointer's), bf16 leaves as
        bf16. Each array is uploaded and fingerprinted there; a mismatch
        or an unreadable array raises `CorruptCheckpointError`.

        With `mesh` (every rank of the live process group calls it): this
        rank's chunks, a `TrainState` `like` (the reference's layout, e.g.
        `train_state.skeleton`) placed by `state_shardings(like, mesh,
        fsdp_pods)`, any other state whole on every rank."""
        device = self.device if device is None else resolve_device(device)
        path = os.path.join(self.dir, f"step_{step}")
        try:
            manifest, data = _load(path)
        except (zipfile.BadZipFile, ValueError) as exc:
            raise CorruptCheckpointError(f"step {step}: {exc}") from exc
        scheme = manifest.get("scheme", _SCHEME_LEGACY)

        def load(p, _leaf):
            meta = manifest["leaves"][p]
            try:
                arr = data[meta["key"]]
            except (zipfile.BadZipFile, ValueError, OSError) as exc:
                raise CorruptCheckpointError(
                    f"step {step}: leaf {p!r} cannot be read: {exc}") from exc
            t = torch.from_numpy(arr).to(device)
            want = _leaf_fingerprint(t, scheme, self.tree)
            if f"{want:016x}" != meta["fingerprint"]:
                raise CorruptCheckpointError(
                    f"step {step}: leaf {p!r} fingerprint mismatch "
                    f"(got {want:016x}, manifest {meta['fingerprint']})")
            return t.to(torch.bfloat16) if meta["dtype"] == "bfloat16" else t

        if mesh is None:
            if fsdp_pods:
                raise ValueError("fsdp_pods= places leaves on a mesh: pass mesh=")
            return map_with_paths(load, like)
        return self._restore_sharded(step, like, manifest, load, device, mesh, fsdp_pods)

    def _restore_sharded(self, step, like, manifest, load, device, mesh, fsdp_pods):
        """Rank 0 of the live group loads (reads, uploads, fingerprints)
        each leaf once and scatters its chunks; a failed leaf is broadcast
        as a flag first, so every rank raises."""
        import torch.distributed as dist

        from ..models.convert import Stack
        from ..parallel import sharding as sh
        from ..train.train_state import TrainState, state_shardings

        sh.device_mesh(mesh)  # the live group holds one rank a mesh position
        rank = dist.get_rank()
        if isinstance(like, TrainState):
            placed = dict(flatten_with_paths(state_shardings(like, mesh, fsdp_pods)))
        else:
            placed = {}
        whole = sh.NamedSharding(mesh, sh.P())

        def sharding_of(p):
            s = placed.get(p, whole)
            if isinstance(s, Stack):  # a port ParamTree's per-block layout
                return sh.NamedSharding(mesh, sh.P(None, *s[0].spec))
            return s

        def part(p, _leaf):
            meta = manifest["leaves"][p]
            s = sharding_of(p)
            shape = tuple(meta["shape"])
            dtype = (torch.bfloat16 if meta["dtype"] == "bfloat16"
                     else torch.from_numpy(np.zeros(0, meta["dtype"])).dtype)
            ok = torch.ones(1, dtype=torch.int32, device=device)
            chunks, err = None, None
            if rank == 0:
                try:
                    t = load(p, _leaf)
                    chunks = [s.local(t, r).contiguous() for r in range(mesh.size)]
                except CorruptCheckpointError as exc:
                    ok.zero_()
                    err = exc
            dist.broadcast(ok, src=0)
            if not int(ok.item()):
                raise err or CorruptCheckpointError(
                    f"step {step}: leaf {p!r} failed on rank 0")
            out = torch.empty(s.local_shape(shape), dtype=dtype, device=device)
            dist.scatter(out, chunks, src=0)
            return out

        return map_with_paths(part, like)


def migrate_legacy_manifest(step_dir: str, tree=None) -> bool:
    """Offline one-shot upgrade of a legacy `stream-v0` checkpoint to
    `tree-v1`: verify every leaf against its LEGACY host fingerprint
    (`hash.fingerprint_bytes`; migration must not launder corruption),
    recompute tree-v1 per-leaf digests (on `tree`'s device, default the
    card) plus the pytree root, and atomically rewrite `manifest.json`.
    Returns True if a rewrite happened, False if already tree-v1. Raises
    `CorruptCheckpointError` if a legacy fingerprint does not match."""
    manifest, data = _load(step_dir)
    if manifest.get("scheme") == _SCHEME_TREE:
        return False
    th = tree if tree is not None else default_tree_hasher()
    pairs = []
    for leaf_path, meta in manifest["leaves"].items():
        arr = data[meta["key"]]
        legacy = fingerprint_bytes(arr.tobytes())
        if f"{legacy:016x}" != meta["fingerprint"]:
            raise CorruptCheckpointError(
                f"{step_dir}: leaf {leaf_path!r} fails its legacy "
                f"stream-v0 fingerprint (got {legacy:016x}, manifest "
                f"{meta['fingerprint']}); refusing to migrate")
        fp = th.fingerprint_array(arr)
        meta["fingerprint"] = f"{fp:016x}"
        pairs.append((leaf_path, fp))
    manifest["scheme"] = _SCHEME_TREE
    manifest["root"] = f"{root_of_leaf_fingerprints(pairs, th):016x}"
    mpath = os.path.join(step_dir, "manifest.json")
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, mpath)
    return True
