"""Serving engine: slot-based continuous batching over prefill/decode.

The port of `repro.serve.engine`. A fixed pool of B slots decodes in
lockstep (one eager `decode_step` a tick); finished/empty slots are
refilled by prefilling the pending request into the slot's cache lane.
Prefix-dedup uses the paper's fingerprints: identical prompts hit a logits
cache. Prompt keys come from one `ShardedHasher` launch of the fused
K-hash engine (kernel 1 on the card) per `submit_all`, left in flight
(CUDA is asynchronous) until the first `_assign` needs a key; prompts at or
past `tree_prompt_words` take the tree fingerprint (one leaf launch each).
An optional `AdmissionService` rejects duplicate prompts before they cost
a prefill.

Differences of surface from the reference: `device=` (default: the card);
no `greedy=` (decoding is greedy, as the reference's, whose flag selects
nothing); decode is eager PyTorch (no jit, no CUDA graph); the caches are
updated in place, the splice included (`_splice`, the reference's rule,
see there).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import as_tokens, resolve_device
from ..hash import Hasher, HashSpec
from ..kernels.autotune import pow2_at_least
from ..models.model_zoo import params_device

_PREFIX_KEY_SEED = 0x1E53


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray           # (T,) int32
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    #: admission verdict (None = not checked / no admission service;
    #: False = rejected as a duplicate, completed without decoding)
    admitted: bool | None = None


def _splice(full: dict, one: dict, slot: int, n_slots: int, in_blocks=False):
    """Copy the single-row cache `one` into row `slot` of the batched cache
    `full`, in place, by the reference's rule: leaves under 'blocks' are
    layer-stacked (n_blocks, B, ...), so their slot axis is 1, and 0 for
    tail leaves; a leaf is copied only when that axis has length n_slots.
    A ring cache's `pos` tags ((n_blocks, W) or (W,)) therefore keep their
    initial -1 unless W == n_slots (`src/repro/serve/engine.py:207-215`), and
    the local layers' decode then ignores the prompt's keys: a property of
    the reference, reproduced."""
    for name, f in full.items():
        o = one[name]
        if isinstance(f, dict):
            _splice(f, o, slot, n_slots, in_blocks or name == "blocks")
            continue
        ax = 1 if in_blocks and f.ndim >= 2 else 0
        if o.ndim == f.ndim and f.shape[ax] == n_slots:
            f.select(ax, slot).copy_(o.select(ax, 0))


class ServeEngine:
    def __init__(self, api, params, *, n_slots: int = 4, max_seq: int = 256,
                 mesh=None, admission=None,
                 admission_items: int | None = None,
                 probe_transport="routed",
                 tree_prompt_words: int = 1 << 12, device=None):
        self.device = resolve_device(device)
        if params_device(params).type != self.device.type:
            raise ValueError(f"params on {params_device(params)}, engine on "
                             f"{self.device}")
        self.api = api
        self.params = params
        self.B = n_slots
        self.S = max_seq
        self._prefix_logit_cache: dict[int, torch.Tensor] = {}
        self._prefix_hasher = Hasher.from_spec(HashSpec(
            family="multilinear", n_hashes=1, out_bits=64,
            variable_length=True, seed=_PREFIX_KEY_SEED), device=self.device)
        # pending prompts are fingerprinted across the mesh data axis (B/D
        # rows per shard) and ASYNCHRONOUSLY: the launch is enqueued at
        # submit time and read only when _assign first needs a key, so
        # hashing overlaps prefill compute. mesh=None is every visible card
        # (the engine's device when it is not a card).
        self._prefix_sharded = self._prefix_hasher.sharded(mesh)
        # prompts at/past this length take the tree path instead of padding
        # the batched launch out to the longest prompt; routing is by
        # length alone, so a prompt's key is stable across batches
        self.tree_prompt_words = int(tree_prompt_words)
        self._mesh = mesh
        self._tree = None  # lazy TreeHasher; engines with short max_seq never build it
        self._pending_keys = None  # (req_ids, in-flight (B, 1, 2) tensor)
        self._req_key_cache: dict[int, int] = {}
        self.slots: list[Request | None] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int64)
        self.caches = api.init_caches(n_slots, max_seq, device=self.device)
        # optional fault-tolerant front door (hash.service): duplicate
        # prompts are rejected before they cost a prefill. `admission_items=`
        # builds one in-process: a single L2 shard whose filter is a
        # DeviceShardedBloom over the engine's mesh, probes moved under
        # `probe_transport` (default "routed").
        if admission is None and admission_items is not None:
            from ..hash.service import AdmissionService
            from ..parallel.sharding import data_mesh

            admission = AdmissionService.over_bloom_shards(
                1, int(admission_items),
                mesh=data_mesh(device=self.device) if mesh is None else mesh,
                probe_transport=probe_transport)
        self.admission = admission
        self.stats = {"prefix_hits": 0, "prefills": 0, "ticks": 0,
                      "degraded_ticks": 0, "l1_only_admits": 0,
                      "admission_rejects": 0, "admission_errors": 0}

    # -- prefix cache (paper fingerprints) -----------------------------------

    def _tree_hasher(self):
        if self._tree is None:
            from ..hash.tree import TreeHasher, TreeSpec

            self._tree = TreeHasher(TreeSpec(seed=_PREFIX_KEY_SEED),
                                    mesh=self._mesh, device=self.device)
        return self._tree

    def _prompt_key(self, prompt: np.ndarray) -> int:
        """64-bit fingerprint of one prompt, on the engine's device: the
        value the precompute path assigns it. Short prompts: a one-row
        launch of the prefix hasher. Long prompts (>= tree_prompt_words):
        the tree fingerprint."""
        toks = prompt.astype(np.uint32)
        if len(toks) >= self.tree_prompt_words:
            return self._tree_hasher().fingerprint(toks)
        return int(self._prefix_hasher.hash_batch([toks])[0, 0])

    def _precompute_prompt_keys(self, requests: "list[Request]") -> None:
        """Fingerprint every pending short prompt in ONE sharded engine
        launch, enqueued without a host sync (`_drain_prompt_keys` reads it
        on first use). Rows and width are pow2-bucketed, as the reference
        buckets them. Prompts at/past `tree_prompt_words` take the tree
        path instead (one leaf launch each, straight into the key cache)."""
        if not requests:
            return
        long_reqs = [r for r in requests
                     if len(r.prompt) >= self.tree_prompt_words]
        for r in long_reqs:
            self._req_key_cache[r.req_id] = self._tree_hasher().fingerprint(
                r.prompt.astype(np.uint32))
        requests = [r for r in requests
                    if len(r.prompt) < self.tree_prompt_words]
        if not requests:
            return
        prompts = [r.prompt.astype(np.uint32) for r in requests]
        n_pad = pow2_at_least(max((len(p) for p in prompts), default=1) or 1)
        b_pad = pow2_at_least(len(prompts))
        toks = np.zeros((b_pad, n_pad), np.uint32)
        lens = np.zeros(b_pad, np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
            lens[i] = len(p)
        self._prefix_sharded.ensure(n_pad)
        halves = self._prefix_sharded(as_tokens(toks, self.device),
                                      torch.from_numpy(lens).to(self.device))
        self._pending_keys = ([r.req_id for r in requests], halves)

    def _drain_prompt_keys(self) -> None:
        """Read the in-flight fingerprint launch (one sync for the whole
        pending batch) into the per-request key cache."""
        if self._pending_keys is None:
            return
        req_ids, halves = self._pending_keys
        self._pending_keys = None
        arr = halves[: len(req_ids), 0].cpu().numpy().astype(np.uint64)  # (hi, lo)
        fps = (arr[:, 0] << np.uint64(32)) | arr[:, 1]
        for rid, fp in zip(req_ids, fps):
            self._req_key_cache[rid] = int(fp)

    # -- admission (fault-tolerant front door) -------------------------------

    def _admit_wave(self, reqs: "list[Request]") -> None:
        """Admission-check one slot-pool's worth of pending requests through
        the `AdmissionService` (L1/L2 filters + retry/breaker). Called with
        the NEXT wave while the current decode step is in flight, so the
        host's admission work overlaps device compute. An admission outage
        the service itself could not absorb serves everything (the
        engine's job is to answer requests) and is counted in
        `stats["admission_errors"]`."""
        if self.admission is None:
            return
        todo = [r for r in reqs if r.admitted is None]
        if not todo:
            return
        try:
            mask = self.admission.admit_batch(
                [r.prompt.astype(np.uint32) for r in todo])
        except Exception:
            self.stats["admission_errors"] += 1
            for r in todo:
                r.admitted = True
            return
        for r, ok in zip(todo, mask):
            r.admitted = bool(ok)
        self.stats["l1_only_admits"] = self.admission.stats["l1_only_admits"]

    # -- slot management -----------------------------------------------------

    def _assign(self, req: Request, slot: int):
        """Prefill a single request into slot `slot` of the batched cache."""
        T = len(req.prompt)
        self._drain_prompt_keys()
        key = self._req_key_cache.pop(req.req_id, None)
        if key is None:
            key = self._prompt_key(req.prompt)
        tokens = torch.from_numpy(np.asarray(req.prompt, np.int32)[None])
        logits, cache1 = self.api.prefill(self.params, {"tokens": tokens},
                                          cache_len=self.S)
        if key in self._prefix_logit_cache:
            self.stats["prefix_hits"] += 1
        else:
            self._prefix_logit_cache[key] = logits[0].cpu()
        self.stats["prefills"] += 1
        _splice(self.caches, cache1, slot, self.B)
        self.slots[slot] = req
        self.slot_pos[slot] = T
        req.out_tokens.append(int(logits[0].argmax()))

    def submit_all(self, requests: list[Request]):
        # reject un-servable prompts up front, before any state is touched:
        # a prompt of max_seq tokens has no cache room for even one decode
        for r in requests:
            if len(r.prompt) >= self.S:
                raise ValueError(
                    f"request {r.req_id}: prompt length {len(r.prompt)} >= "
                    f"max_seq {self.S}; no decode budget -- raise max_seq "
                    "or truncate the prompt")
        pending = list(requests)
        self._admit_wave(pending[: self.B])  # first wave has no decode to hide behind
        self._precompute_prompt_keys(pending)
        try:
            while pending or any(s is not None for s in self.slots):
                # fill free slots (skipping admission-rejected requests --
                # they complete immediately with no tokens)
                for i in range(self.B):
                    while self.slots[i] is None and pending:
                        req = pending.pop(0)
                        if req.admitted is None:
                            self._admit_wave([req])
                        if req.admitted is False:
                            req.done = True
                            self.stats["admission_rejects"] += 1
                            continue
                        self._assign(req, i)
                if not any(s is not None for s in self.slots):
                    continue  # whole wave rejected; loop re-checks pending
                logits = self._tick_launch()
                # decode is in flight: admission-check the next wave on the
                # host while the device works
                self._admit_wave(pending[: self.B])
                self._tick_finish(logits)
        finally:
            # if _assign/tick raised mid-flight, drop the in-flight
            # fingerprint launch and evict this submission's cached keys so
            # a retry (or the next submit_all) starts clean
            self._pending_keys = None
            for r in requests:
                self._req_key_cache.pop(r.req_id, None)
        return requests

    def tick(self):
        """One lockstep decode step across all active slots.

        All slots share one decode position (the max over slots), as in the
        reference: a request assigned at a later tick decodes at a shifted
        absolute position, so its greedy output equals a solo run only if
        it joined at tick 0.
        """
        self._tick_finish(self._tick_launch())

    def _tick_launch(self):
        """Enqueue one decode step; returns the in-flight logits without a
        sync, so the host can do admission and bookkeeping meanwhile."""
        self.stats["ticks"] += 1
        if self.admission is not None and self.admission.degraded:
            self.stats["degraded_ticks"] += 1
        toks = np.zeros((self.B, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is not None:
                toks[i, 0] = req.out_tokens[-1]
        pos = int(max(self.slot_pos))  # lockstep position (simple engine)
        logits, self.caches = self.api.decode_step(
            self.params, self.caches, torch.from_numpy(toks), pos)
        return logits

    def _tick_finish(self, logits):
        """Read the decode step's greedy tokens (the sync point) and advance
        the slots."""
        nxt = logits.argmax(dim=-1).tolist()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.out_tokens.append(nxt[i])
            self.slot_pos[i] += 1
            if len(req.out_tokens) >= req.max_new_tokens or self.slot_pos[i] >= self.S - 1:
                req.done = True
                self.slots[i] = None
