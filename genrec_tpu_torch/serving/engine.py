"""In-process online inference engine (port of
genrec_tpu/serving/engine.py: ``ServingEngine`` with ``_PagedRunner``'s
slot-level continuous batching for paged generative heads, the dense
micro-batch path, ``_next_batch`` / ``_run_batch``, for the retrieval
heads, and the live planes: hot params reload, hot catalog swap, request
spans, the flight recorder, the memory ledger, SLO shedding and the
signal drain).

The paged request path:

1. `submit(Request)` validates the request, enqueues it on its head's
   queue and returns a Future.
2. The batcher thread ADMITS queued requests into free decode slots: a
   prefill micro-batch, padded up to a (batch, history) bucket of the
   `BucketLadder`, writes the requests' history K/V into the head's page
   pool (serving/kv_pool.py). With the prefix cache on (the default), each
   prefilled page run is retained under its history key, and a request
   whose full key is retained admits onto those pages without a prefill.
   Requests beyond the free slots, or for which no pages are left after
   the retained ones are reclaimed, stay queued and are admitted as
   slots finish.
3. Every batcher iteration advances ALL active slots one decode position
   in one call with per-slot step operands (with ``spec_decode``, 1 to
   1 + spec_depth positions through the speculative tree step); the
   cross-attention reads the pool through the paged-attention kernel.
4. Finished slots resolve their futures and free their pages at once, so
   the next admission can reuse them without waiting for the requests
   they were admitted with. A prefill or decode call that raises fails
   the futures of the slots it ran for and frees those slots.

The dense path (the retrieval and Qwen heads, and every head of an engine
built with ``paged=False``, TIGER's and COBRA's through their
whole-generate ``make_fn``): a head's queue is flushed as one micro-batch
when it holds ``max_batch`` requests, when its oldest request has waited
``max_wait_ms``, or when the engine drains (queues scanned round-robin, so
one busy head cannot starve another). The batch is padded to its (batch,
history) bucket, run as one call (``head.make_fn``, given the head's
runtime operands: the catalog trie, NoteLLM's bank), read back with one
host sync, and split by ``head.finalize``; a batch that raises fails its
own futures only.

Hot params reload: with ``ckpt_dir`` a watcher thread polls a directory
of params checkpoints (core/checkpoint.py; a sidecar or the trainer
publishes them) and restores strictly NEWER steps through the integrity
ladder, so a damaged step is quarantined and the engine keeps serving the
previous params. ``stage_params`` stages a tree directly. The batcher
applies a staged tree BETWEEN micro-batches once every paged slot has
drained (admission pauses meanwhile): the tensors are copied into the
heads' models in place (no reallocation), every head's ``on_params``
runs and every prefix index empties, so each request is answered by ONE
params version (``Response.params_step``).

Hot catalog swap: ``stage_catalog`` — or a `CatalogWatcher` per
``catalog_dirs`` entry (serving/catalog.py) — validates a
`CatalogSnapshot` and prepares it on the caller's thread (device trie,
item index, COBRA's tower encode); the batcher applies it after the paged
slots drain, emptying the head's prefix index first, so no request mixes
catalog versions (``Response.catalog_version``). Eager PyTorch has no
executables keyed on the trie's shape, so a snapshot on another capacity
rung swaps as a same-rung one does.

Observability (obs/): with an enabled ``tracer`` every request gets a
span tree keyed by the request id minted at submit — request ->
queue_wait -> admission -> prefill or warm_admit -> a decode_step a step
(on the speculative path draft -> tree_verify -> accept) -> finalize for
paged heads, queue_wait -> compute -> finalize for dense ones — and p99
outliers keep theirs as exemplars. The decode spans time the host's
dispatch of each step (the card runs ahead; the sync lands in the
finalize of the slot that finishes). The flight recorder gets lifecycle,
drain, swap, OOM-deferral and watcher events whether tracing is on or off.

Memory ledger (obs/memory.py): at ``start()`` each head is accounted —
params, ``catalog_operands``, ``kv_page_pool`` (with the reclaimable
``prefix_cache_pages`` inside it) and ``paged_slot_state`` — plus, on the
card, the measured transient of one prefill at the largest bucket and one
decode at the largest slot shape. ``hbm_budget_bytes`` makes the model a
gate: ``start()`` raises `HBMBudgetError` with the per-component
breakdown when it is over budget.

SLO guard (obs/slo.py): ``slo_targets`` declares per-head p99 /
queue-depth / deferral-rate objectives; the batcher polls the monitor off
the hot path, a sustained breach makes ``submit`` raise `OverloadError`
while queued and in-flight work completes, and hysteresis un-sheds.

Drain: ``stop()``, or SIGTERM / SIGINT latched by a one-shot
`PreemptionGuard` (``handle_signals=True``, installed by ``start()`` on
the main thread), finishes every queued and in-flight request and makes
new submissions raise `DrainingError`; the retained prefix pages and the
speculative scratch pages are then released.

Slot state (beams, log-probs, trie prefixes, suffix caches) stays on the
device between steps; the step counters, block tables and seq_lens are
host numpy and are copied to the device for each call. PyTorch runs
eagerly, so there is no AOT bucket warmup: the bucket ladder bounds the
prefill and micro-batch shapes.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from genrec_tpu_torch.core.checkpoint import flatten_tree
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder
from genrec_tpu_torch.obs.memory import MemoryLedger, tree_nbytes
from genrec_tpu_torch.obs.slo import SLOMonitor, SLOTarget
from genrec_tpu_torch.obs.spans import NULL_TRACER, SpanTracer
from genrec_tpu_torch.ops.spec_tree import tree_topology
from genrec_tpu_torch.serving.buckets import BucketLadder, default_ladder
from genrec_tpu_torch.serving.kv_pool import KVPagePool, PagedConfig, PoolExhausted, PrefixIndex
from genrec_tpu_torch.serving.metrics import ServingMetrics
from genrec_tpu_torch.serving.types import (
    DrainingError,
    HBMBudgetError,
    OverloadError,
    Request,
    Response,
    UnknownHeadError,
    normalize_spec_config,
)


def is_transient_fs_error(e: BaseException) -> bool:
    """A watcher pass that failed on the filesystem (a network-mount blip,
    a listing racing a writer's rename) rather than on a bug: retried with
    backoff, never read as "no new step"."""
    return isinstance(e, OSError)


def _operand_rung(op):
    """The capacity rung of a catalog operand: a trie's capacity, a
    tensor's (a NoteLLM bank's) shape."""
    return op.capacity if hasattr(op, "capacity") else tuple(op.shape)


def _tree_to(tree, device):
    """A nested mapping of tensors with every tensor on ``device``."""
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class _PagedRunner:
    """Slot-level continuous batching for ONE paged generative head. All
    methods run on the batcher thread.

    With speculation on (``spec_decode`` names the head, which
    ``supports_spec``), the decode call is the head's tree-verify step:
    each call commits 1 .. 1 + ``spec_depth`` codes a slot. Its topology
    (beams x fanout x depth) is one per runner, and the pool is extended
    by a scratch reservation of the tree's pages for every slot. With the
    prefix cache on, every cold prefill retains its page run under the
    head's history key, and a request whose full key is retained admits
    onto those pages without a prefill.

    A queue entry is (request, future, t_enqueued, trace), trace being
    (trace id, the request span's id, its parent's id) or None; a live
    slot's entry adds t_admitted.
    """

    def __init__(self, engine: "ServingEngine", head, cfg: PagedConfig):
        max_kv = head.paged_kv_tokens(10**9, engine._ladder.history_buckets[-1])
        if cfg.max_kv_tokens < max_kv:
            raise ValueError(
                f"paged config holds {cfg.max_kv_tokens} KV tokens/slot but "
                f"head {head.name!r} needs {max_kv} at the largest history "
                "bucket; raise pages_per_slot or page_size"
            )
        self.engine = engine
        self.head = head
        spec_cfg = engine._spec_decode
        want_spec = head.name in spec_cfg if isinstance(spec_cfg, frozenset) else spec_cfg
        self.spec_topology = None
        self._scratch_demand = 0
        if want_spec and head.supports_spec and head.spec_depth >= 1:
            # Before the state and the prefill are built: the head may add
            # drafter hints to both.
            head.enable_spec_drafting()
            self.spec_topology = tree_topology(head.top_k, engine._spec_fanout, head.spec_depth)
            # The tree's pages for every slot, pinned outside admissions;
            # the budget grows by them, so an explicit config keeps its
            # admission capacity.
            per_slot = -(-self.spec_topology.n_nodes // cfg.page_size)
            self._scratch_demand = cfg.max_slots * per_slot
            cfg = dataclasses.replace(cfg, num_pages=cfg.num_pages + self._scratch_demand)
        self.cfg = cfg
        self.device = head.device
        n_layers, n_heads, head_dim, dtype = head.paged_layout()
        self.pool = KVPagePool(cfg, n_layers, n_heads, head_dim, dtype,
                               device=self.device)
        self.pool.reserve_scratch(self._scratch_demand)
        self.state = head.paged_state_zeros(cfg.max_slots)
        self.steps = np.zeros(cfg.max_slots, np.int64)
        self.active = np.zeros(cfg.max_slots, bool)
        # (req, fut, t_enq, trace, t_admit) per live slot.
        self.entries: list = [None] * cfg.max_slots
        self.buckets: list = [None] * cfg.max_slots  # prefill (B, L) per slot
        self._decode = (head.make_spec_decode_paged_fn(engine._spec_fanout)
                        if self.spec_topology is not None else head.make_decode_paged_fn())
        # Futures already counted as deferred: the counter counts requests,
        # not the batcher's retries.
        self._oom_counted: set[int] = set()
        self.prefix = (PrefixIndex(self.pool.allocator, max_entries=engine._prefix_cache_entries)
                       if engine._prefix_cache else None)
        # Device bytes a page pins over all layers' K and V pools, measured
        # on the pools themselves (their dtype: fp32, bf16, or int8 rows and
        # their scales), as JAX measures them.
        self._page_nbytes = tree_nbytes((self.pool.k_pools, self.pool.v_pools)) // cfg.num_pages

    @property
    def idle(self) -> bool:
        return not self.active.any()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # -- the memory ledger's measured transients ------------------------------

    def measure_transients(self) -> dict:
        """{call name: stats} of one prefill at the largest prefill bucket
        and one decode at the largest slot shape, each the rise of the
        allocator's peak over what was allocated before the call (see
        obs/memory.py). Dummy operands: histories of item 0, every block-
        table entry the null page, so no live page is written."""
        eng, head, cfg = self.engine, self.head, self.cfg
        B = eng._ladder.batch_bucket(eng._max_batch)
        L = eng._ladder.history_buckets[-1]
        reqs = [Request(head=head.name, history=np.zeros(L, np.int64)) for _ in range(B)]
        batch = head.make_batch(reqs, B, L)
        bt = self._to_device(np.zeros((B, cfg.pages_per_slot), np.int32))
        prefill = head.make_prefill_paged_fn(B, L)
        out = {f"prefill/B{B}/L{L}": eng._measure(lambda: prefill(
            *head.runtime_operands(), *batch, bt, self.pool.k_pools, self.pool.v_pools))}
        S = cfg.max_slots
        state = head.paged_state_zeros(S)
        steps = self._to_device(np.full(S, head.paged_init_step, np.int64))
        bt = self._to_device(np.zeros((S, cfg.pages_per_slot), np.int32))
        seq_lens = self._to_device(np.full(S, head.paged_kv_tokens(L, L), np.int32))
        name = "spec_decode" if self.spec_topology is not None else "decode"
        out[f"{name}/S{S}"] = eng._measure(lambda: self._decode(
            *head.runtime_operands(), state, steps, bt, seq_lens,
            self.pool.k_pools, self.pool.v_pools))
        return out

    # -- admission (prefill into pages) --------------------------------------

    def admit(self) -> bool:
        """Drain the head's queue into free slots, one bucketed prefill
        micro-batch at a time. A popped request whose full history key is
        retained admits warm onto the retained pages (no prefill); the
        rest prefill. Requests that find no pages, even after the retained
        prefix pages are reclaimed, go back to the FRONT of the queue and
        retry as slots free pages; their deferral is counted once."""
        eng = self.engine
        head = self.head
        progressed = False
        while True:
            budget = min(self.pool.free_slot_count, eng._max_batch)
            if budget == 0:
                return progressed
            now = time.monotonic()
            with eng._lock:
                q = eng._queues[head.name]
                if not q:
                    return progressed
                # Coalesce trickling arrivals into bucket-sized prefills:
                # a deadline, a drain or a full group flushes.
                if (len(q) < budget and now - q[0][2] < eng._max_wait_s
                        and not eng._draining):
                    return progressed
                entries = [q.popleft() for _ in range(min(len(q), budget))]
            warm, cold, holdback = self._split_warm(entries)
            if holdback:
                # A request whose key goes cold in this group waits one
                # iteration at the front and then admits warm on the run
                # the group's prefill retains.
                with eng._lock:
                    eng._queues[head.name].extendleft(reversed(holdback))
            for e, centry, own_L in warm:  # a free slot each: popped <= budget
                self._warm_admit(e, centry, own_L, t_pop=now)
                progressed = True
            if warm:
                self._publish_prefix_gauges()
                self._sweep_finished()  # heads whose init step == total finish here
            L = eng._ladder.history_bucket(
                max(max((head.natural_len(e[0]) for e, _k, _n in cold), default=1), 1))
            t_admit = time.monotonic()
            slots, keys = [], []
            for e, key, n_tok in cold:
                try:
                    slot = self._admit_pages(n_tok)
                except PoolExhausted:
                    break
                self.entries[slot] = (*e, t_admit)
                slots.append(slot)
                keys.append(key)
            leftover = [e for e, _k, _n in cold[len(slots):]]
            if leftover:
                with eng._lock:
                    eng._queues[head.name].extendleft(reversed(leftover))
                fresh = [e for e in leftover if id(e[1]) not in self._oom_counted]
                if fresh:
                    self._oom_counted.update(id(e[1]) for e in fresh)
                    eng.metrics.record_oom_admit(len(fresh), head=head.name)
                    eng._flight.record("pool_oom_deferred", head=head.name, n=len(fresh),
                                       pages_free=self.pool.stats().get("pages_free"))
            if slots:
                self._oom_counted.difference_update(id(self.entries[s][1]) for s in slots)
                try:
                    self._run_prefill(slots, L, keys, t_pop=now)
                except Exception as exc:  # noqa: BLE001 — fail THESE futures only
                    eng._log.exception(f"serving: paged prefill on head {head.name} failed")
                    self._fail_slots(slots, exc)
                else:
                    self._sweep_finished()  # heads whose init step == total finish here
                progressed = True
            if leftover:
                return progressed

    # -- the prefix cache ------------------------------------------------------

    def _split_warm(self, entries):
        """Split popped queue entries into warm full-key hits, cold
        admissions and held-back duplicates of a key going cold in this
        group. Warm or cold is decided against the request's OWN history
        bucket, so a hit answers as a cold engine serving it alone would."""
        eng = self.engine
        head = self.head
        warm, cold, holdback = [], [], []
        group_cold_keys: set = set()
        max_hist = eng._ladder.history_buckets[-1]
        for e in entries:
            req = e[0]
            own_L = eng._ladder.history_bucket(max(head.natural_len(req), 1))
            n_tok = head.paged_kv_tokens(head.natural_len(req), own_L)
            key = head.prefix_key_tokens(req, max_hist) if self.prefix is not None else None
            if key is None:
                cold.append((e, None, n_tok))
                continue
            if key in group_cold_keys:
                holdback.append(e)
                continue
            t0 = time.monotonic()
            centry, matched = self.prefix.lookup(key)
            if centry is not None and centry.n_tokens != n_tok:
                # Same key, other KV footprint (ids the key drops that
                # natural_len counts): not this request's prefill.
                centry = None
            # A deferred request is popped and looked up on every retry:
            # its outcome is recorded once.
            if id(e[1]) not in self._oom_counted:
                outcome = "hit" if centry is not None else ("partial" if matched else "miss")
                eng.metrics.record_prefix_lookup(
                    head.name, outcome, tokens=centry.n_tokens if centry is not None else 0)
                tr = e[3]
                if tr is not None:
                    eng._tracer.record_span("prefix_lookup", tr[0], t0, time.monotonic(),
                                            parent_id=tr[1], outcome=outcome,
                                            matched_tokens=int(matched),
                                            **eng._span_ident())
            if centry is not None:
                warm.append((e, centry, own_L))
            else:
                group_cold_keys.add(key)
                cold.append((e, key, n_tok))
        return warm, cold, holdback

    def _warm_admit(self, e, centry, own_L: int, t_pop: float) -> None:
        """Admit one request onto a retained page run: share the pages,
        restore the donor's post-prefill state rows, enter decode at the
        head's init step. No prefill runs."""
        self._oom_counted.discard(id(e[1]))
        t0 = time.monotonic()
        slot = self.pool.admit_shared(centry.pages, centry.n_tokens)
        self.prefix.touch(centry.key)
        centry.hits += 1
        for v in self.state.values():
            v[slot] = 0
        if centry.init is not None:
            for key, val in self.head.paged_warm_state(centry.init, centry.n_tokens,
                                                       own_L).items():
                self.state[key][slot] = val
        t_admit = time.monotonic()
        self.steps[slot] = self.head.paged_init_step
        self.active[slot] = True
        self.entries[slot] = (*e, t_admit)
        self.buckets[slot] = centry.bucket
        tr = e[3]
        if tr is not None:
            # The cold path's tree with `warm_admit` where `prefill` is.
            tracer = self.engine._tracer
            tracer.record_span("queue_wait", tr[0], e[2], t_pop, parent_id=tr[1],
                               **self.engine._span_ident())
            tracer.record_span("admission", tr[0], t_pop, t0, parent_id=tr[1],
                               slot=int(slot), **self.engine._span_ident())
            tracer.record_span("warm_admit", tr[0], t0, t_admit, parent_id=tr[1],
                               warm_tokens=int(centry.n_tokens), **self.engine._span_ident())
        self.engine.metrics.record_admit(1)

    def _admit_pages(self, n_tok: int) -> int:
        """``pool.admit``, reclaiming retained prefix pages (LRU first) when
        the allocator is short; raises PoolExhausted only when even that
        cannot make room (pages held by live slots)."""
        try:
            return self.pool.admit(n_tok)
        except PoolExhausted:
            if self.prefix is None or not len(self.prefix):
                raise
            evicted = self.prefix.reclaim(self.cfg.pages_for(n_tok))
            if evicted:
                self.engine.metrics.record_prefix_evict(self.head.name, evicted)
                self._publish_prefix_gauges()
            return self.pool.admit(n_tok)

    def prefix_stats(self) -> dict:
        if self.prefix is None:
            return {}
        s = self.prefix.stats()
        s["retained_bytes"] = s["retained_pages"] * self._page_nbytes
        return s

    def _publish_prefix_gauges(self) -> None:
        if self.prefix is not None:
            s = self.prefix_stats()
            self.engine.metrics.set_prefix_gauges(self.head.name, s)
            # The retained pages live inside the kv_page_pool operand:
            # reclaimable bytes, not more bytes.
            self.engine.memory.record_reclaimable(self.head.name, "prefix_cache_pages",
                                                  s["retained_bytes"])

    def clear_prefix_cache(self, reason: str) -> int:
        """Drop every retained entry (params swap, catalog swap, drain): a
        prefix prefilled under an old version must never serve the new
        one. Returns the entries dropped."""
        if self.prefix is None:
            return 0
        n = self.prefix.clear()
        if n:
            eng = self.engine
            eng.metrics.record_prefix_evict(self.head.name, n, invalidation=True)
            eng._flight.record("prefix_cache_invalidated", head=self.head.name,
                               reason=reason, entries=n)
            eng.metrics.set_pool_gauges(self.head.name, self.pool.stats())
        self._publish_prefix_gauges()
        return n

    def release_scratch(self, reason: str) -> int:
        """Drop the speculative scratch reservation (drain, stop), so the
        pool accounts clean at shutdown. Idempotent."""
        n = self.pool.release_scratch()
        if n:
            self.engine._flight.record("spec_scratch_released", head=self.head.name,
                                       reason=reason, pages=n)
            self.engine.metrics.set_pool_gauges(self.head.name, self.pool.stats())
        return n

    def _fail_slots(self, slots, exc: Exception) -> None:
        """Fail the requests bound to ``slots`` with ``exc`` and free the
        slots and their pages."""
        for slot in slots:
            fut = self.entries[slot][1]
            self.pool.evict(int(slot))
            self.active[slot] = False
            self.entries[slot] = None
            self.buckets[slot] = None
            if not fut.done():
                fut.set_exception(exc)
        self.engine.metrics.record_failure(len(slots))
        self.engine.metrics.set_pool_gauges(self.head.name, self.pool.stats())

    def _run_prefill(self, slots, L: int, keys, t_pop: float) -> None:
        eng = self.engine
        head = self.head
        t_start = time.monotonic()
        reqs = [self.entries[slot][0] for slot in slots]
        n = len(slots)
        B = eng._ladder.batch_bucket(n)
        batch = head.make_batch(reqs, B, L)
        bt = np.zeros((B, self.cfg.pages_per_slot), np.int32)
        bt[:n] = self.pool.block_tables[slots]  # padded rows -> null page
        init = head.make_prefill_paged_fn(B, L)(
            *head.runtime_operands(), *batch, self._to_device(bt),
            self.pool.k_pools, self.pool.v_pools,
        ) or {}
        idx = self._to_device(np.asarray(slots, np.int64))
        for v in self.state.values():
            v[idx] = 0
        # A prefill that resolves state of its own (COBRA's codebook-0
        # beam, TIGER's step-0 draft window) returns its batch rows.
        for key, rows in init.items():
            self.state[key][idx] = rows[:n]
        t_prefilled = time.monotonic()
        if self.prefix is not None:
            # Retain each prefilled run under its key (one more reference a
            # page) with the rows the prefill set, kept on the device: the
            # run outlives its slot, and a repeat request skips prefill.
            for key, slot in zip(keys, slots):
                if key is None:
                    continue
                snapshot = {k: self.state[k][slot].clone() for k in init} if init else None
                self.prefix.insert(key, n_tokens=int(self.pool.seq_lens[slot]),
                                   pages=self.pool.slot_pages(slot), init=snapshot,
                                   bucket=(B, L))
                eng.metrics.record_prefix_insert(head.name)
            self._publish_prefix_gauges()
        self.steps[slots] = head.paged_init_step
        self.active[slots] = True
        for slot in slots:
            self.buckets[slot] = (B, L)
            _req, _fut, t_enq, tr, _t_admit = self.entries[slot]
            if tr is not None:
                # queue_wait: submit -> popped; admission: the slot and its
                # pages; prefill: the bucket call and the state rows.
                tracer = eng._tracer
                tracer.record_span("queue_wait", tr[0], t_enq, t_pop, parent_id=tr[1],
                                   **eng._span_ident())
                tracer.record_span("admission", tr[0], t_pop, t_start, parent_id=tr[1],
                                   slot=int(slot), **eng._span_ident())
                tracer.record_span("prefill", tr[0], t_start, t_prefilled, parent_id=tr[1],
                                   bucket_b=B, bucket_l=L, **eng._span_ident())
        eng.metrics.record_admit(n)
        eng.metrics.record_batch(head.name, (B, L))

    # -- decode (one step over the slot prefix holding every active slot) ----

    def step(self) -> bool:
        """Advance every active slot: one decode position through the plain
        step, or 1 .. 1 + spec_depth positions through the tree-verify
        step. Finished slots resolve their futures and free their pages
        immediately."""
        if self.idle:
            return False
        eng = self.engine
        # Slots fill lowest-index-first, so [0, hi) holds every active
        # slot; free slots inside it compute garbage harmlessly (nothing
        # in the step reduces across rows).
        S = int(np.nonzero(self.active)[0][-1]) + 1
        spec = self.spec_topology is not None
        t_stage = time.monotonic()
        try:
            args = (
                *self.head.runtime_operands(),
                {k: v[:S] for k, v in self.state.items()},
                self._to_device(np.where(self.active[:S], self.steps[:S], 0)),
                self._to_device(self.pool.block_tables[:S]),
                self._to_device(self.pool.seq_lens[:S]),
                self.pool.k_pools,
                self.pool.v_pools,
            )
            t0 = time.monotonic()
            out = self._decode(*args)
            if spec:
                out, accept = out
                accept = accept.cpu().numpy()  # the step's one host sync
        except Exception as exc:  # noqa: BLE001 — fail the step's slots, not the loop
            eng._log.exception(f"serving: paged decode on head {self.head.name} failed")
            self._fail_slots(np.nonzero(self.active)[0], exc)
            return True
        for k, v in out.items():
            self.state[k][:S] = v
        active_idx = np.nonzero(self.active)[0]
        if spec:
            # Clamped to the codes a slot has left; the root level is exact.
            adv = np.maximum(np.minimum(accept[active_idx],
                                        self.head.paged_total_steps - self.steps[active_idx]), 1)
        t1 = time.monotonic()
        tracer = eng._tracer
        if tracer.enabled:
            # One call advances every active slot: each resident request
            # gets the same interval(s), tagged with its own step.
            drafted = (self.spec_topology.n_nodes - self.spec_topology.beams) if spec else 0
            for i, slot in enumerate(active_idx):
                tr = self.entries[slot][3]
                if tr is None:
                    continue
                step = int(self.steps[slot])
                if spec:
                    tracer.record_span("draft", tr[0], t_stage, t0, parent_id=tr[1],
                                       step=step, drafted=drafted, **eng._span_ident())
                    tracer.record_span("tree_verify", tr[0], t0, t1, parent_id=tr[1],
                                       step=step, slots=S, accept_len=int(adv[i]),
                                       **eng._span_ident())
                else:
                    tracer.record_span("decode_step", tr[0], t0, t1, parent_id=tr[1],
                                       step=step, slots=S, **eng._span_ident())
        metrics = eng.metrics
        metrics.record_decode_step()
        if spec:
            self.steps[active_idx] += adv
            topo = self.spec_topology
            metrics.record_spec(self.head.name,
                                drafted=len(active_idx) * (topo.n_nodes - topo.beams),
                                accept_lens=adv)
            if tracer.enabled:
                t2 = time.monotonic()
                for i, slot in enumerate(active_idx):
                    tr = self.entries[slot][3]
                    if tr is not None:
                        tracer.record_span("accept", tr[0], t1, t2, parent_id=tr[1],
                                           accept_len=int(adv[i]), **eng._span_ident())
        else:
            self.steps[self.active] += 1
        self._sweep_finished()
        return True

    def _sweep_finished(self) -> None:
        eng = self.engine
        head = self.head
        done = np.nonzero(self.active & (self.steps >= head.paged_total_steps))[0]
        if len(done):
            idx = self._to_device(done)
            rows = {k: self.state[k][idx].cpu().numpy() for k in head.paged_output_keys}
        # Stable while any slot is active: swaps apply after the slots
        # drain, so every finished request decoded under these versions.
        cat_version = head.catalog_version
        params_step = eng._step
        for i, slot in enumerate(done):
            req, fut, t_enq, tr, t_admit = self.entries[slot]
            t_done = time.monotonic()
            try:
                payload = head.paged_finalize({k: v[i] for k, v in rows.items()}, req)
                now = time.monotonic()
                resp = Response(
                    head=head.name,
                    items=payload["items"],
                    scores=payload["scores"],
                    sem_ids=payload.get("sem_ids"),
                    catalog_version=cat_version,
                    params_step=params_step,
                    request_id=tr[0] if tr is not None else None,
                    replica_id=eng.replica_id,
                    bucket=self.buckets[slot],
                    queue_wait_s=t_admit - t_enq,
                    compute_s=now - t_admit,
                    total_s=now - t_enq,
                )
            except Exception as exc:  # noqa: BLE001 — one bad slot, not the loop
                eng._log.exception(f"serving: paged finalize failed on head {head.name}")
                if not fut.done():
                    fut.set_exception(exc)
                eng.metrics.record_failure(1)
            else:
                eng.metrics.record_response(resp.queue_wait_s, resp.compute_s, resp.total_s,
                                            head=head.name)
                if tr is not None and tr[1] is not None:
                    eng._tracer.record_span("finalize", tr[0], t_done, now, parent_id=tr[1],
                                            **eng._span_ident())
                    eng._tracer.record_span("request", tr[0], t_enq, now, span_id=tr[1],
                                            parent_id=tr[2], head=head.name, slot=int(slot),
                                            params_step=params_step, **eng._span_ident())
                    eng._maybe_exemplar(tr[0], resp)
                if not fut.done():
                    fut.set_result(resp)
            self.pool.evict(int(slot))
            self.active[slot] = False
            self.entries[slot] = None
            self.buckets[slot] = None
            eng.metrics.record_evict(1)
        eng.metrics.set_pool_gauges(head.name, self.pool.stats())
        self._publish_prefix_gauges()


class ServingEngine:
    """Serves paged generative heads and dense (retrieval) heads on one
    device, and can be operated live.

    ``heads``: heads of serving/heads.py, each holding its model (and
    weights) on ``device``; paged heads (``supports_paged``) get a
    `_PagedRunner`, the others the micro-batch path; ``paged=False``
    serves every head on the micro-batch path, the generative heads
    through their whole-generate ``make_fn``. ``device``
    defaults to the card and raises when there is none; pass
    ``device="cpu"`` to serve on the CPU. ``paged_config`` sizes every
    head's page pool (default: ``4 * max_batch`` slots, pages covering the
    largest history bucket, pages of ``kv_dtype``). ``kv_dtype`` ("float32"
    or "int8") is the default config's page type; an explicit
    ``paged_config`` carries its own, and passing both must agree.

    ``prefix_cache`` (on by default, as in JAX) retains every cold
    prefill's page run, at most ``prefix_cache_entries`` of them a head,
    so a repeated history admits without a prefill. ``spec_decode``
    (False, True, or a set of head names) serves the named paged heads
    that ``supports_spec`` through the speculative tree decode with
    ``spec_fanout`` children a node (an int, or one a level); other heads
    decode plain.

    The live planes (module docstring): ``ckpt_dir`` / ``ckpt_poll_secs``
    (the params watcher) and ``params_step`` (the step the initial
    weights carry); the params tree (`params`) is the one head's state dict,
    or ``{head name: state dict}`` with several heads, swapped atomically
    across them; ``catalog_dirs``
    ({head name: snapshot directory}) / ``catalog_poll_secs``; ``tracer``
    (off: `NULL_TRACER`); ``hbm_budget_bytes``; ``slo_targets`` (one
    `SLOTarget` for every head, or {head name: SLOTarget}) /
    ``slo_poll_secs``; ``handle_signals`` (SIGTERM / SIGINT drain) or an
    explicit ``guard``; ``replica_id`` (None: a standalone engine), the
    identity a fleet gives the engine, stamped on every `Response`, every
    flight event and every span.
    """

    def __init__(
        self,
        heads: Sequence,
        *,
        device="cuda",
        ladder: Optional[BucketLadder] = None,
        max_batch: int = 16,
        max_wait_ms: float = 4.0,
        paged: bool = True,
        paged_config: Optional[PagedConfig] = None,
        kv_dtype: str = "float32",
        prefix_cache: bool = True,
        prefix_cache_entries: int = 4096,
        spec_decode=False,
        spec_fanout=8,
        ckpt_dir: Optional[str] = None,
        ckpt_poll_secs: float = 2.0,
        catalog_dirs: Optional[dict] = None,
        catalog_poll_secs: float = 2.0,
        params_step: Optional[int] = None,
        handle_signals: bool = True,
        guard=None,
        tracer: Optional[SpanTracer] = None,
        hbm_budget_bytes: Optional[int] = None,
        slo_targets=None,
        slo_poll_secs: float = 0.05,
        replica_id: Optional[str] = None,
    ):
        # Stamped into every Response, every flight event and every span;
        # a fleet router may assign it after construction, so each of them
        # reads it when it records.
        self.replica_id = replica_id
        self.device = resolve_device(device)
        self._heads = {h.name: h for h in heads}
        if len(self._heads) != len(heads):
            raise ValueError("duplicate head names")
        for h in heads:
            if h.device != self.device:
                raise ValueError(f"head {h.name!r} lives on {h.device}, engine on {self.device}")
        self._ladder = ladder or default_ladder(max_batch=max_batch)
        if max_batch > self._ladder.max_batch:
            raise ValueError(
                f"max_batch {max_batch} exceeds largest batch bucket "
                f"{self._ladder.max_batch}"
            )
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1e3
        # paged=False serves every head, TIGER's and COBRA's too, on the
        # dense micro-batch path (``make_fn``, whole-generate calls).
        self._paged = bool(paged)
        self._paged_config = paged_config
        # A silent override would hold other bytes than the caller asked for.
        self._kv_dtype = str(kv_dtype)
        if (paged_config is not None and self._kv_dtype != "float32"
                and paged_config.kv_dtype != self._kv_dtype):
            raise ValueError(
                f"kv_dtype={self._kv_dtype!r} conflicts with "
                f"paged_config.kv_dtype={paged_config.kv_dtype!r}; set it "
                "on the PagedConfig (or drop the engine kwarg)"
            )
        self._prefix_cache = bool(prefix_cache)
        self._prefix_cache_entries = int(prefix_cache_entries)
        self._spec_decode, self._spec_fanout = normalize_spec_config(
            spec_decode, spec_fanout, self._heads)
        # One head: its state dict; several: {head name: state dict}, so a
        # swap is atomic across heads.
        self._params_by_head = len(self._heads) > 1
        self._step = params_step
        self._ckpt_dir = ckpt_dir
        self._ckpt_poll_secs = float(ckpt_poll_secs)
        self._catalog_dirs = dict(catalog_dirs or {})
        self._catalog_poll_secs = float(catalog_poll_secs)
        for name in self._catalog_dirs:
            if name not in self._heads:
                raise ValueError(f"catalog_dirs names unknown head {name!r}")
            if not self._heads[name].supports_catalog:
                raise ValueError(f"head {name!r} has no swappable catalog")
        self._catalog_watchers: list = []
        self._handle_signals = bool(handle_signals)
        self._guard = guard
        self._log = logging.getLogger("genrec_tpu_torch")
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._flight = get_flight_recorder().scoped("engine", replica_id=lambda: self.replica_id)
        self.memory = MemoryLedger()
        self._hbm_budget = int(hbm_budget_bytes) if hbm_budget_bytes is not None else None
        # {head: {call name: stats}} measured at start (the card only).
        self._transients: dict[str, dict] = {}
        if slo_targets is None:
            self._slo = None
        else:
            if isinstance(slo_targets, SLOTarget):
                targets = {name: slo_targets for name in self._heads}
            else:
                targets = dict(slo_targets)
                unknown = [n for n in targets if n not in self._heads]
                if unknown:
                    raise ValueError(f"slo_targets names unknown heads {unknown}")
            self._slo = SLOMonitor(targets, flight=self._flight)
        self._slo_poll_secs = float(slo_poll_secs)
        self._slo_next_poll = 0.0
        self.metrics = ServingMetrics()
        self._runners: dict[str, _PagedRunner] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues = {name: collections.deque() for name in self._heads}
        self._pending_params = None  # (tree, step), applied by the batcher
        self._pending_catalog: dict = {}  # head name -> staged CatalogSnapshot
        # Serialises stage_catalog callers; the batcher never takes it.
        self._stage_lock = threading.Lock()
        # Held while the models' weights are read off the batcher (a
        # catalog's tower encode on a staging thread) or written (a swap).
        self._params_lock = threading.Lock()
        self._rr = 0  # round-robin cursor over the dense heads' queues
        self._draining = False
        self._stop_watch = threading.Event()
        self._drained = threading.Event()
        self._batcher: Optional[threading.Thread] = None
        self._watcher: Optional[threading.Thread] = None
        self._ckpt_mgr = None
        self._watched_step: Optional[int] = None  # the newest step the watcher staged
        self._started = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingEngine":
        """Refresh every head's derived tables, build every paged head's page
        pool and slot state, ledger every head (raising `HBMBudgetError`
        over ``hbm_budget_bytes``), install the signal guard, and start the
        watchers and the batcher thread. Returns self."""
        if self._started:
            raise RuntimeError("engine already started")
        for head in self._heads.values():
            head.on_params()
            if self._paged and head.supports_paged:
                self._runners[head.name] = _PagedRunner(
                    self, head, self._paged_config or self._default_paged_config(head)
                )
        if self.device.type == "cuda":
            with torch.cuda.device(self.device), torch.no_grad():
                for head in self._heads.values():
                    self._transients[head.name] = self._measure_head(head)
        for head in self._heads.values():
            self._ledger_head(head)
        self._enforce_hbm_budget()
        if self._guard is None and self._handle_signals:
            from genrec_tpu_torch.core.preemption import PreemptionGuard

            self._guard = PreemptionGuard(self._log)
        if self._ckpt_dir is not None:
            from genrec_tpu_torch.core.checkpoint import CheckpointManager

            self._ckpt_mgr = CheckpointManager(self._ckpt_dir)
            self._watcher = threading.Thread(target=self._watch_loop,
                                             name="serving-ckpt-watcher", daemon=True)
            self._watcher.start()
        if self._catalog_dirs:
            from genrec_tpu_torch.serving.catalog import CatalogWatcher

            for name, directory in self._catalog_dirs.items():
                self._catalog_watchers.append(CatalogWatcher(
                    self, name, directory, poll_secs=self._catalog_poll_secs,
                    logger=self._log).start())
        self._batcher = threading.Thread(
            target=self._batch_loop, name="serving-batcher", daemon=True
        )
        self._started = True
        self.metrics.mark_warm()
        self._flight.record("serving_started", heads=sorted(self._heads),
                            paged_heads=sorted(self._runners), params_step=self._step,
                            replica_id=self.replica_id)
        self._batcher.start()
        return self

    def _default_paged_config(self, head) -> PagedConfig:
        page_size = 16
        max_kv = head.paged_kv_tokens(10**9, self._ladder.history_buckets[-1])
        return PagedConfig(
            max_slots=4 * self._max_batch,
            page_size=page_size,
            pages_per_slot=-(-max_kv // page_size),
            kv_dtype=self._kv_dtype,
        )

    def runner(self, head_name: str) -> _PagedRunner:
        """The head's runner (pool, slot state), for inspection."""
        return self._runners[head_name]

    def stop(self, timeout: float = 60.0) -> dict:
        """Drain (finish queued work, reject new) and join the threads.
        Returns the final metrics snapshot. Idempotent."""
        with self._lock:
            self._draining = True
            self._work.notify_all()
        self._flight.record("serving_stop", completed=self.metrics.completed)
        self._stop_watch.set()
        for w in self._catalog_watchers:
            w.stop(timeout)
        self._catalog_watchers = []
        if self._batcher is not None:
            self._batcher.join(timeout)
        for runner in self._runners.values():
            runner.release_scratch("stop")  # idempotent; the drain released it already
        if self._watcher is not None:
            self._watcher.join(timeout)
        if self._guard is not None:
            self._guard.close()
        self._ckpt_mgr = None
        return self.stats()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Block until the engine has drained (after SIGTERM or stop());
        True if it drained within ``timeout``."""
        return self._drained.wait(timeout)

    @property
    def params_step(self) -> Optional[int]:
        """The checkpoint step serving now (None until one is installed)."""
        return self._step

    @property
    def tracer(self) -> SpanTracer:
        return self._tracer

    def set_tracer(self, tracer: Optional[SpanTracer]) -> None:
        """Swap the tracer live. Requests submitted before keep the trace
        context minted at their submit."""
        self._tracer = tracer if tracer is not None else NULL_TRACER

    def _span_ident(self) -> dict:
        """The identity every span of this engine carries: its component
        lane, and its replica when it has one (read at record time)."""
        if self.replica_id is not None:
            return {"component": "engine", "replica": self.replica_id}
        return {"component": "engine"}

    def _maybe_exemplar(self, trace_id: str, resp: Response) -> None:
        """A p99-outlier request keeps its span tree past ring eviction."""
        thr = self.metrics.slow_threshold_s()
        if thr is not None and resp.total_s >= thr:
            self._tracer.mark_exemplar(
                trace_id, reason=f"p99 outlier: total {resp.total_s * 1e3:.1f}ms "
                                 f">= {thr * 1e3:.1f}ms ({resp.head})")

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        snap["params_step"] = self._step
        snap["draining"] = self._draining
        with self._lock:
            depths = {name: len(q) for name, q in self._queues.items()}
        snap["queue_depth"] = depths
        snap["hbm"] = self.memory.summary(budget_bytes=self._hbm_budget)
        snap["tracing"] = self._tracer.stats()
        if self._slo is not None:
            snap["slo"] = self._slo.snapshot()
        return snap

    # -- the memory ledger -----------------------------------------------------

    def _measure(self, call) -> dict:
        """The allocator's peak rise over one ``call()`` on the card, as the
        ledger's transient stats (obs/memory.py)."""
        torch.cuda.synchronize(self.device)
        base = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        out = call()
        torch.cuda.synchronize(self.device)
        rise = torch.cuda.max_memory_allocated(self.device) - base
        del out
        return {"temp": max(int(rise), 0), "output": 0, "argument": 0, "alias": 0, "code": 0}

    def _measure_head(self, head) -> dict:
        runner = self._runners.get(head.name)
        if runner is not None:
            return runner.measure_transients()
        B = self._ladder.batch_bucket(self._max_batch)
        L = self._ladder.history_buckets[-1]
        reqs = [Request(head=head.name, history=np.ones(L, np.int64)) for _ in range(B)]
        batch = (*head.runtime_operands(), *head.make_batch(reqs, B, L))
        return {f"dense/B{B}/L{L}": self._measure(lambda: head.make_fn(B, L)(*batch))}

    def _ledger_head(self, head) -> None:
        """(Re)account one head: params, catalog tensors, page pool (with
        the retained prefix pages as its reclaimable part), slot state,
        and the transients measured at start. Attribute reads only."""
        led = self.memory
        led.reset_group(head.name)
        led.record_operand(head.name, "params", tree_nbytes(head.model.state_dict()))
        ops = head.catalog_tensors()
        if ops:
            led.record_operand(head.name, "catalog_operands", tree_nbytes(ops))
        runner = self._runners.get(head.name)
        if runner is not None:
            led.record_operand(head.name, "kv_page_pool",
                               tree_nbytes((runner.pool.k_pools, runner.pool.v_pools)))
            led.record_reclaimable(head.name, "prefix_cache_pages",
                                   runner.prefix_stats().get("retained_bytes", 0))
            led.record_operand(head.name, "paged_slot_state", tree_nbytes(runner.state))
        for name, stats in self._transients.get(head.name, {}).items():
            led.record_executable(head.name, name, stats=stats)

    def _enforce_hbm_budget(self, during_swap: bool = False) -> None:
        """The start gate: raise `HBMBudgetError` (with the per-component
        breakdown) over budget, warn inside the last 10% of headroom. After
        start (a catalog swap re-ledgers) it only warns: failing the
        batcher mid-serve would be worse than running hot."""
        if self._hbm_budget is None:
            return
        summary = self.memory.summary(budget_bytes=self._hbm_budget)
        if summary["over_budget"]:
            self._flight.record("hbm_budget_exceeded", total_bytes=summary["total_bytes"],
                                budget_bytes=self._hbm_budget, during_swap=during_swap)
            msg = (f"device-memory model exceeds hbm_budget_bytes={self._hbm_budget}: "
                   f"{summary['total_bytes']} bytes resident + transient. Shrink the "
                   "bucket ladder / paged pool / catalog, or raise the budget.\n"
                   f"{self.memory.breakdown_text(self._hbm_budget)}")
            if during_swap:
                self._log.warning(f"serving: {msg}")
                return
            raise HBMBudgetError(msg)
        if summary.get("headroom_pct", 100.0) < 10.0:
            self._flight.record("hbm_budget_warning", total_bytes=summary["total_bytes"],
                                budget_bytes=self._hbm_budget,
                                headroom_pct=summary["headroom_pct"])
            self._log.warning(
                f"serving: device-memory budget headroom is {summary['headroom_pct']:.1f}% "
                f"({summary['total_bytes']} of {self._hbm_budget} bytes)")

    # -- request path --------------------------------------------------------

    def submit(self, req: Request) -> Future:
        if req.head not in self._heads:
            raise UnknownHeadError(
                f"unknown head {req.head!r}; have {sorted(self._heads)}"
            )
        # Validate BEFORE enqueueing: a malformed history raises to its own
        # caller instead of failing the micro-batch it would join.
        self._heads[req.head].validate(req)
        with self._lock:
            # Drain wins over shed: a dying engine reports the terminal
            # DrainingError ("fail over"), never the recoverable
            # OverloadError ("retry").
            if self._draining:
                self.metrics.record_reject(req.head)
                raise DrainingError(
                    "engine is draining (stop() or a shutdown signal); request "
                    "rejected — fail over to another replica"
                )
            if self._slo is not None and self._slo.is_shedding(req.head):
                self.metrics.record_overload(req.head)
                raise OverloadError(
                    f"head {req.head!r} is load-shedding ({self._slo.shed_reason(req.head)}); "
                    "back off and retry or fail over to another replica"
                )
            # Trace context: (trace id, the request span's id pre-minted so
            # children recorded before it can parent onto it, its parent).
            ctx = req.trace
            if ctx is not None:
                tr = (ctx.trace_id,
                      self._tracer.allocate_span_id() if self._tracer.enabled else None,
                      ctx.parent_span_id)
            elif self._tracer.enabled:
                tr = (self._tracer.new_trace(), self._tracer.allocate_span_id(), None)
            else:
                tr = None
            entry = (req, Future(), time.monotonic(), tr)
            self._queues[req.head].append(entry)
            self._work.notify()
        self.metrics.record_submit(req.head)
        return entry[1]

    def serve(self, req: Request, timeout: Optional[float] = 60.0) -> Response:
        """Synchronous convenience wrapper around submit()."""
        return self.submit(req).result(timeout)

    # -- dense micro-batches ---------------------------------------------------

    def _next_batch(self):
        """Pop the next flush-ready queue of a dense head: a full
        micro-batch, the oldest entry past the wait deadline, or draining.
        Heads are scanned round-robin from just past the last-flushed one,
        so a head under sustained full-batch load cannot starve the
        others."""
        now = time.monotonic()
        names = [n for n in self._queues if n not in self._runners]
        if not names:
            return None
        with self._lock:
            for i in range(len(names)):
                name = names[(self._rr + i) % len(names)]
                q = self._queues[name]
                if not q:
                    continue
                if (len(q) >= self._max_batch or self._draining
                        or now - q[0][2] >= self._max_wait_s):
                    self._rr = (self._rr + i + 1) % len(names)
                    n = min(len(q), self._max_batch)
                    return self._heads[name], [q.popleft() for _ in range(n)]
        return None

    def _run_batch(self, head, entries) -> None:
        """One micro-batch: bucket, pad, one call, one host sync, finalize,
        answer. A batch that raises fails its own futures only."""
        t_start = time.monotonic()
        reqs = [e[0] for e in entries]
        L = self._ladder.history_bucket(max(max(head.natural_len(r) for r in reqs), 1))
        B = self._ladder.batch_bucket(len(reqs))
        try:
            out = head.make_fn(B, L)(*head.runtime_operands(), *head.make_batch(reqs, B, L))
            out = tuple(o.cpu().numpy() for o in out)  # the host sync
            t_done = time.monotonic()
            payloads = head.finalize(out, reqs)
            t_final = time.monotonic()
        except Exception as exc:  # noqa: BLE001 — a bad batch must not kill the loop
            self._log.exception(f"serving: micro-batch on head {head.name} failed")
            for e in entries:
                if not e[1].done():
                    e[1].set_exception(exc)
            self.metrics.record_failure(len(entries))
            return
        self.metrics.record_batch(head.name, (B, L))
        cat_version = head.catalog_version
        step = self._step
        for (req, fut, t_enq, tr), payload in zip(entries, payloads):
            now = time.monotonic()
            resp = Response(
                head=head.name, items=payload["items"], scores=payload["scores"],
                sem_ids=payload.get("sem_ids"), catalog_version=cat_version,
                params_step=step, request_id=tr[0] if tr is not None else None,
                replica_id=self.replica_id, bucket=(B, L), queue_wait_s=t_start - t_enq,
                compute_s=t_done - t_start, total_s=now - t_enq,
            )
            self.metrics.record_response(resp.queue_wait_s, resp.compute_s, resp.total_s,
                                         head=head.name)
            if tr is not None and tr[1] is not None:
                tracer = self._tracer
                tracer.record_span("queue_wait", tr[0], t_enq, t_start, parent_id=tr[1],
                                   **self._span_ident())
                tracer.record_span("compute", tr[0], t_start, t_done, parent_id=tr[1],
                                   bucket_b=B, bucket_l=L, **self._span_ident())
                tracer.record_span("finalize", tr[0], t_done, t_final, parent_id=tr[1],
                                   **self._span_ident())
                tracer.record_span("request", tr[0], t_enq, now, span_id=tr[1],
                                   parent_id=tr[2], head=head.name, params_step=step,
                                   **self._span_ident())
                self._maybe_exemplar(tr[0], resp)
            if not fut.done():  # a cancelled future must not kill the loop
                fut.set_result(resp)

    # -- batcher -------------------------------------------------------------

    def _batch_loop(self) -> None:
        on_card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                   else contextlib.nullcontext())
        try:
            with on_card, torch.no_grad():
                while True:
                    try:
                        if self._guard is not None and self._guard.fired and not self._draining:
                            with self._lock:
                                self._draining = True
                            self._flight.record("serving_drain_started", cause="signal")
                            self._log.warning("serving: shutdown signal latched — draining "
                                              "in-flight requests, rejecting new submissions")
                        # A staged swap pauses admission until every paged
                        # slot has drained, so each request decodes under
                        # ONE params and ONE catalog version.
                        swap_pending = self._apply_pending_params()
                        swap_pending |= self._apply_pending_catalog()
                        self._poll_slo()
                        progressed = False
                        for runner in self._runners.values():
                            if not swap_pending:
                                progressed |= runner.admit()
                            progressed |= runner.step()
                        batch = self._next_batch()
                        if batch is not None:
                            self._run_batch(*batch)
                            continue
                        if progressed:
                            continue
                        with self._lock:
                            empty = all(not q for q in self._queues.values())
                            idle = all(r.idle for r in self._runners.values())
                            done = self._draining and empty and idle
                            if not done:
                                # Wake on submit/stop; with requests queued, cap
                                # the wait so deadline flushes stay responsive.
                                self._work.wait(
                                    timeout=max(self._max_wait_s / 4, 1e-3)
                                    if not (empty and idle) else 0.05
                                )
                        if done:
                            # Drained: release the retained prefix pages and the
                            # scratch reservation, so the pools account clean.
                            for runner in self._runners.values():
                                runner.clear_prefix_cache("drain")
                                runner.release_scratch("drain")
                            break
                    except Exception:  # noqa: BLE001 — the batcher must survive
                        self._log.exception("serving: batcher iteration failed")
        finally:
            self._drained.set()

    def _poll_slo(self) -> None:
        """Feed the SLO monitor (batcher thread, at most every
        ``slo_poll_secs``): each head's windowed p99, queue depth and
        cumulative deferral / submission counts. The idle loop keeps
        iterating, so recovery is evaluated when traffic stops."""
        if self._slo is None:
            return
        now = time.monotonic()
        if now < self._slo_next_poll:
            return
        self._slo_next_poll = now + self._slo_poll_secs
        with self._lock:
            depths = {name: len(q) for name, q in self._queues.items()}
        for head, target in self._slo.targets.items():
            self._slo.observe(
                head,
                p99_ms=self.metrics.recent_p99_ms(target.window_s, head=head),
                queue_depth=depths.get(head, 0),
                oom_deferred_total=self.metrics.oom_deferred_by_head[head],
                submitted_total=self.metrics.submitted_by_head[head],
                now=now,
            )

    # -- hot params reload ---------------------------------------------------

    def params(self) -> dict:
        """The serving params tree: the one head's model state dict, or
        ``{head name: state dict}`` with several heads. The tensors are the
        models' own (views of the live weights)."""
        sds = {name: head.model.state_dict() for name, head in self._heads.items()}
        return sds if self._params_by_head else next(iter(sds.values()))

    def stage_params(self, tree, step: Optional[int], *, source: str = "rollout") -> None:
        """Stage a params tree (laid out as `params`) for the swap between
        micro-batches, as the watcher does; unlike the watcher this is not
        monotonic (a rollback stages an older step). Poll `params_step` to
        observe the swap."""
        self._check_like(tree)
        tree = _tree_to(tree, self.device)
        with self._lock:
            self._pending_params = (tree, step)
            self._work.notify()
        self._flight.record("hot_reload_staged", step=step, source=source)
        self._log.info(f"serving: staged params step {step} (source={source})")

    def _watch_loop(self) -> None:
        # A failed pass counts in watcher_errors and leaves a flight event;
        # a transient filesystem error backs off (bounded), so a flapping
        # mount is not hammered at poll rate.
        backoff = 0.0
        while not self._stop_watch.wait(self._ckpt_poll_secs + backoff):
            try:
                self._check_reload()
                backoff = 0.0
            except Exception as e:  # noqa: BLE001 — keep serving on watcher errors
                transient = is_transient_fs_error(e)
                self.metrics.record_watcher_error()
                self._flight.record("watcher_error", transient=transient,
                                    error=f"{type(e).__name__}: {e}")
                if transient:
                    backoff = min(max(2 * backoff, self._ckpt_poll_secs), 30.0)
                    self._log.warning(f"serving: transient checkpoint watcher error "
                                      f"({type(e).__name__}: {e}); retrying in "
                                      f"{self._ckpt_poll_secs + backoff:.1f}s")
                else:
                    backoff = 0.0
                    self._log.exception("serving: checkpoint watcher pass failed")

    def _check_reload(self) -> None:
        mgr = self._ckpt_mgr
        if mgr is None:
            return
        mgr.reload()
        latest = mgr.latest_step()
        # The newest step served or staged by this watcher: a staged step is
        # popped by the batcher before ``_step`` moves to it.
        serving = max((s for s in (self._step, self._watched_step) if s is not None),
                      default=None)
        if latest is None or (serving is not None and latest <= serving):
            return
        # The integrity ladder: a damaged newest step is quarantined and the
        # previous valid one returned — the one serving already, so nothing
        # is staged and serving never pauses.
        restored, step = mgr.restore_latest_valid(self.params())
        if restored is None or (serving is not None and step <= serving):
            return
        self._check_like(restored)
        restored = _tree_to(restored, self.device)
        with self._lock:
            self._pending_params = (restored, step)
            self._work.notify()
        self._watched_step = step
        self._flight.record("hot_reload_staged", step=step, source="watcher")
        self._log.info(f"serving: staged hot reload to checkpoint step {step}")

    def _check_like(self, tree) -> None:
        """The staged tree must hold every serving tensor's name, shape and
        dtype: it is copied into the models in place."""
        cur, new = flatten_tree(self.params()), flatten_tree(tree)
        if cur.keys() != new.keys() or any(
                cur[k].shape != new[k].shape or cur[k].dtype != new[k].dtype for k in cur):
            raise RuntimeError("restored params tree does not match the serving tree")

    def _apply_pending_params(self) -> bool:
        """The swap, on the batcher thread between micro-batches: once every
        paged slot has drained, copy the staged tensors into the models in
        place (under no_grad, no reallocation), run every head's
        ``on_params`` and empty every prefix index. Returns True while a
        swap is still staged (the caller pauses admission on it)."""
        with self._lock:
            pending = self._pending_params
        if pending is None:
            return False
        if any(not r.idle for r in self._runners.values()):
            return True  # the barrier: drain the decode slots first
        with self._lock:
            pending, self._pending_params = self._pending_params, None
        if pending is None:
            return False
        tree, step = pending
        # Every call the batcher queued has finished reading the weights
        # before they are overwritten.
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with self._params_lock, torch.no_grad():
            for name, head in self._heads.items():
                new = tree[name] if self._params_by_head else tree
                for key, t in head.model.state_dict().items():
                    t.copy_(new[key])
        self._step = step
        self.metrics.record_swap()
        self._flight.record("hot_reload_swapped", step=step)
        for head in self._heads.values():
            head.on_params()
        # A retained prefix was prefilled by the old params.
        for runner in self._runners.values():
            runner.clear_prefix_cache("params_swap")
        self._log.info(f"serving: now serving checkpoint step {step}")
        return False

    # -- hot catalog swap ----------------------------------------------------

    def catalog_version(self, head_name: str) -> Optional[str]:
        return self._heads[head_name].catalog_version

    def staged_catalog_version(self, head_name: str) -> Optional[str]:
        with self._lock:
            staged = self._pending_catalog.get(head_name)
        return staged.version if staged is not None else None

    def stage_catalog(self, head_name: str, snapshot) -> bool:
        """Validate, prepare and stage a CatalogSnapshot for ``head_name``;
        the batcher swaps it in after the paged slots drain. Returns False
        when the snapshot is live or staged already.

        Runs on the CALLER's thread (a CatalogWatcher, a publisher): the
        head's ``prepare_snapshot`` — uploads, the item index, COBRA's
        tower encode — happens here, so the batcher's ``set_catalog`` only
        swaps pointers. The JAX engine also precompiles its executables
        here when the snapshot's trie lies on another capacity rung; eager
        PyTorch keys nothing on the trie's shape, so there is nothing to
        compile and a rung change swaps as any other snapshot does.
        """
        head = self._heads.get(head_name)
        if head is None:
            raise UnknownHeadError(f"unknown head {head_name!r}")
        if not head.supports_catalog:
            raise ValueError(f"head {head_name!r} has no swappable catalog")
        head.validate_snapshot(snapshot)
        with self._stage_lock:
            if snapshot.version == head.catalog_version:
                return False
            with self._lock:
                staged = self._pending_catalog.get(head_name)
            if staged is not None and staged.version == snapshot.version:
                return False
            t0 = time.monotonic()
            with self._params_lock, torch.no_grad():
                head.prepare_snapshot(snapshot)
            prepare_s = time.monotonic() - t0
            # The operand the snapshot installs (a trie, a bank), against
            # the live one.
            rung_changed = (_operand_rung(head.snapshot_operands(snapshot)[0])
                            != _operand_rung(head.runtime_operands()[0]))
            with self._lock:
                self._pending_catalog[head_name] = snapshot
                self._work.notify()
        self._flight.record("catalog_staged", head=head_name, version=snapshot.version,
                            n_items=snapshot.n_items, capacity=snapshot.capacity,
                            rung_changed=rung_changed, prepare_s=prepare_s)
        self._log.info(f"serving: staged catalog {snapshot.version} for head {head_name} "
                       f"({snapshot.n_items} items, capacity {snapshot.capacity}, prepared "
                       f"in {prepare_s:.3f}s)")
        return True

    def _apply_pending_catalog(self) -> bool:
        """The swap, on the batcher thread after every paged slot has
        drained: empty the head's prefix index (its runs belong to the
        outgoing version), ``set_catalog``, re-ledger the head. Returns
        True while a swap is still staged (admission pauses)."""
        with self._lock:
            if not self._pending_catalog:
                return False
        if any(not r.idle for r in self._runners.values()):
            return True  # the barrier: drain the decode slots first
        with self._lock:
            pending, self._pending_catalog = self._pending_catalog, {}
        for name, snapshot in pending.items():
            head = self._heads[name]
            runner = self._runners.get(name)
            if runner is not None:
                runner.clear_prefix_cache("catalog_swap")
            head.set_catalog(snapshot)
            self.metrics.record_catalog_swap()
            self._ledger_head(head)
            self._flight.record("catalog_swapped", head=name, version=snapshot.version)
            self._log.info(f"serving: head {name} now serving catalog {snapshot.version}")
        self._enforce_hbm_budget(during_swap=True)
        return False
