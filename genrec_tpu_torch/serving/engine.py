"""In-process online inference engine (port of
genrec_tpu/serving/engine.py: ``ServingEngine`` with ``_PagedRunner``'s
slot-level continuous batching for paged generative heads, and the dense
micro-batch path, ``_next_batch`` / ``_run_batch``, for the retrieval
heads).

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

The dense path: a head's queue is flushed as one micro-batch when it
holds ``max_batch`` requests, when its oldest request has waited
``max_wait_ms``, or when the engine drains (queues scanned round-robin, so
one busy head cannot starve another). The batch is padded to its (batch,
history) bucket, run as one call (``head.make_fn``), read back with one
host sync, and split by ``head.finalize``; a batch that raises fails its
own futures only.

Slot state (beams, log-probs, trie prefixes, suffix caches) stays on the
device between steps; the step counters, block tables and seq_lens are
host numpy and are copied to the device for each call. PyTorch runs
eagerly, so there is no AOT bucket warmup: the bucket ladder bounds the
prefill and micro-batch shapes. ``stop()`` drains: queued and in-flight
requests finish, new submissions raise `DrainingError`, and the retained
prefix pages and the speculative scratch pages are released.
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

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.serving.buckets import BucketLadder, default_ladder
from genrec_tpu_torch.ops.spec_tree import tree_topology
from genrec_tpu_torch.serving.kv_pool import KVPagePool, PagedConfig, PoolExhausted, PrefixIndex
from genrec_tpu_torch.serving.metrics import ServingMetrics
from genrec_tpu_torch.serving.types import (
    DrainingError,
    Request,
    Response,
    UnknownHeadError,
    normalize_spec_config,
)


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
        # (req, fut, t_enq, t_admit) per live slot.
        self.entries: list = [None] * cfg.max_slots
        self.buckets: list = [None] * cfg.max_slots  # prefill (B, L) per slot
        self._decode = (head.make_spec_decode_paged_fn(engine._spec_fanout)
                        if self.spec_topology is not None else head.make_decode_paged_fn())
        # Futures already counted as deferred: the counter counts requests,
        # not the batcher's retries.
        self._oom_counted: set[int] = set()
        self.prefix = (PrefixIndex(self.pool.allocator, max_entries=engine._prefix_cache_entries)
                       if engine._prefix_cache else None)
        # Device bytes a page pins over all layers' K and V pools.
        self._page_nbytes = cfg.hbm_bytes(n_layers, n_heads, head_dim) // cfg.num_pages

    @property
    def idle(self) -> bool:
        return not self.active.any()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

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
                self._warm_admit(e, centry, own_L, t_admit=now)
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
                    eng.metrics.record_oom_admit(len(fresh))
            if slots:
                self._oom_counted.difference_update(id(self.entries[s][1]) for s in slots)
                try:
                    self._run_prefill(slots, L, keys)
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
            if centry is not None:
                warm.append((e, centry, own_L))
            else:
                group_cold_keys.add(key)
                cold.append((e, key, n_tok))
        return warm, cold, holdback

    def _warm_admit(self, e, centry, own_L: int, t_admit: float) -> None:
        """Admit one request onto a retained page run: share the pages,
        restore the donor's post-prefill state rows, enter decode at the
        head's init step. No prefill runs."""
        self._oom_counted.discard(id(e[1]))
        slot = self.pool.admit_shared(centry.pages, centry.n_tokens)
        self.prefix.touch(centry.key)
        centry.hits += 1
        for v in self.state.values():
            v[slot] = 0
        if centry.init is not None:
            for key, val in self.head.paged_warm_state(centry.init, centry.n_tokens,
                                                       own_L).items():
                self.state[key][slot] = val
        self.steps[slot] = self.head.paged_init_step
        self.active[slot] = True
        self.entries[slot] = (*e, t_admit)
        self.buckets[slot] = centry.bucket
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
            self.engine.metrics.set_prefix_gauges(self.head.name, self.prefix_stats())

    def clear_prefix_cache(self) -> int:
        """Drop every retained entry (drain). Returns the entries dropped."""
        if self.prefix is None:
            return 0
        n = self.prefix.clear()
        if n:
            self.engine.metrics.record_prefix_evict(self.head.name, n, invalidation=True)
            self.engine.metrics.set_pool_gauges(self.head.name, self.pool.stats())
        self._publish_prefix_gauges()
        return n

    def release_scratch(self) -> int:
        """Drop the speculative scratch reservation (drain, stop), so the
        pool accounts clean at shutdown. Idempotent."""
        n = self.pool.release_scratch()
        if n:
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

    def _run_prefill(self, slots, L: int, keys) -> None:
        eng = self.engine
        head = self.head
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
        # Slots fill lowest-index-first, so [0, hi) holds every active
        # slot; free slots inside it compute garbage harmlessly (nothing
        # in the step reduces across rows).
        S = int(np.nonzero(self.active)[0][-1]) + 1
        spec = self.spec_topology is not None
        try:
            out = self._decode(
                *self.head.runtime_operands(),
                {k: v[:S] for k, v in self.state.items()},
                self._to_device(np.where(self.active[:S], self.steps[:S], 0)),
                self._to_device(self.pool.block_tables[:S]),
                self._to_device(self.pool.seq_lens[:S]),
                self.pool.k_pools,
                self.pool.v_pools,
            )
            if spec:
                out, accept = out
                accept = accept.cpu().numpy()  # the step's one host sync
        except Exception as exc:  # noqa: BLE001 — fail the step's slots, not the loop
            self.engine._log.exception(f"serving: paged decode on head {self.head.name} failed")
            self._fail_slots(np.nonzero(self.active)[0], exc)
            return True
        for k, v in out.items():
            self.state[k][:S] = v
        metrics = self.engine.metrics
        metrics.record_decode_step()
        if spec:
            active_idx = np.nonzero(self.active)[0]
            # Clamped to the codes a slot has left; the root level is exact.
            adv = np.maximum(np.minimum(accept[active_idx],
                                        self.head.paged_total_steps - self.steps[active_idx]), 1)
            self.steps[active_idx] += adv
            topo = self.spec_topology
            metrics.record_spec(self.head.name,
                                drafted=len(active_idx) * (topo.n_nodes - topo.beams),
                                accept_lens=adv)
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
        cat_version = head.catalog_version
        for i, slot in enumerate(done):
            req, fut, t_enq, t_admit = self.entries[slot]
            try:
                payload = head.paged_finalize({k: v[i] for k, v in rows.items()}, req)
                now = time.monotonic()
                resp = Response(
                    head=head.name,
                    items=payload["items"],
                    scores=payload["scores"],
                    sem_ids=payload.get("sem_ids"),
                    catalog_version=cat_version,
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
                eng.metrics.record_response(resp.queue_wait_s, resp.compute_s,
                                            resp.total_s)
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
    device.

    ``heads``: heads of serving/heads.py, each holding its model (and
    weights) on ``device``; paged heads (``supports_paged``) get a
    `_PagedRunner`, the others the micro-batch path. ``device``
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
    """

    def __init__(
        self,
        heads: Sequence,
        *,
        device="cuda",
        ladder: Optional[BucketLadder] = None,
        max_batch: int = 16,
        max_wait_ms: float = 4.0,
        paged_config: Optional[PagedConfig] = None,
        kv_dtype: str = "float32",
        prefix_cache: bool = True,
        prefix_cache_entries: int = 4096,
        spec_decode=False,
        spec_fanout=8,
    ):
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
        self._log = logging.getLogger("genrec_tpu_torch")
        self.metrics = ServingMetrics()
        self._runners: dict[str, _PagedRunner] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues = {name: collections.deque() for name in self._heads}
        self._rr = 0  # round-robin cursor over the dense heads' queues
        self._draining = False
        self._batcher: Optional[threading.Thread] = None
        self._started = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingEngine":
        """Refresh every head's derived tables, build every paged head's page
        pool and slot state, and start the batcher thread. Returns self."""
        if self._started:
            raise RuntimeError("engine already started")
        for head in self._heads.values():
            head.on_params()
            if head.supports_paged:
                self._runners[head.name] = _PagedRunner(
                    self, head, self._paged_config or self._default_paged_config(head)
                )
        self._batcher = threading.Thread(
            target=self._batch_loop, name="serving-batcher", daemon=True
        )
        self._started = True
        self.metrics.mark_warm()
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
        """Drain (finish queued work, reject new) and join the batcher.
        Returns the final metrics snapshot. Idempotent."""
        with self._lock:
            self._draining = True
            self._work.notify_all()
        if self._batcher is not None:
            self._batcher.join(timeout)
        for runner in self._runners.values():
            runner.release_scratch()  # idempotent; the drain released it already
        return self.stats()

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        snap["draining"] = self._draining
        with self._lock:
            snap["queue_depth"] = {name: len(q) for name, q in self._queues.items()}
        return snap

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
            if self._draining:
                self.metrics.record_reject()
                raise DrainingError(
                    "engine is draining; request rejected — fail over to "
                    "another replica"
                )
            entry = (req, Future(), time.monotonic())
            self._queues[req.head].append(entry)
            self._work.notify()
        self.metrics.record_submit()
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
            out = head.make_fn(B, L)(*head.make_batch(reqs, B, L))
            out = tuple(o.cpu().numpy() for o in out)  # the host sync
            t_done = time.monotonic()
            payloads = head.finalize(out, reqs)
        except Exception as exc:  # noqa: BLE001 — a bad batch must not kill the loop
            self._log.exception(f"serving: micro-batch on head {head.name} failed")
            for _, fut, _t in entries:
                if not fut.done():
                    fut.set_exception(exc)
            self.metrics.record_failure(len(entries))
            return
        self.metrics.record_batch(head.name, (B, L))
        cat_version = head.catalog_version
        for (req, fut, t_enq), payload in zip(entries, payloads):
            now = time.monotonic()
            resp = Response(
                head=head.name, items=payload["items"], scores=payload["scores"],
                sem_ids=payload.get("sem_ids"), catalog_version=cat_version,
                bucket=(B, L), queue_wait_s=t_start - t_enq, compute_s=t_done - t_start,
                total_s=now - t_enq,
            )
            self.metrics.record_response(resp.queue_wait_s, resp.compute_s, resp.total_s)
            if not fut.done():  # a cancelled future must not kill the loop
                fut.set_result(resp)

    # -- batcher -------------------------------------------------------------

    def _batch_loop(self) -> None:
        on_card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card, torch.no_grad():
            while True:
                try:
                    progressed = False
                    for runner in self._runners.values():
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
                            runner.clear_prefix_cache()
                            runner.release_scratch()
                        break
                except Exception:  # noqa: BLE001 — the batcher must survive
                    self._log.exception("serving: batcher iteration failed")
