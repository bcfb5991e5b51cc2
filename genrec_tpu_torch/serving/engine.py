"""In-process online inference engine with slot-level continuous batching
(port of genrec_tpu/serving/engine.py: ``ServingEngine`` and
``_PagedRunner``, for paged generative heads).

The request path:

1. `submit(Request)` validates the request, enqueues it on its head's
   queue and returns a Future.
2. The batcher thread ADMITS queued requests into free decode slots: a
   prefill micro-batch, padded up to a (batch, history) bucket of the
   `BucketLadder`, writes the requests' history K/V into the head's page
   pool (serving/kv_pool.py). Requests beyond the free slots stay queued
   and are admitted as slots finish.
3. Every batcher iteration advances ALL active slots one decode position
   in one call with per-slot step operands; the cross-attention reads
   the pool through the paged-attention kernel.
4. Finished slots resolve their futures and free their pages at once, so
   the next admission can reuse them without waiting for the requests
   they were admitted with. A prefill or decode call that raises fails
   the futures of the slots it ran for and frees those slots.

Slot state (beams, log-probs, trie prefixes, suffix caches) stays on the
device between steps; the step counters, block tables and seq_lens are
host numpy and are copied to the device for each call. PyTorch runs
eagerly, so there is no AOT bucket warmup: the bucket ladder bounds the
prefill shapes. ``stop()`` drains: queued and in-flight requests finish,
new submissions raise `DrainingError`.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.serving.buckets import BucketLadder, default_ladder
from genrec_tpu_torch.serving.kv_pool import KVPagePool, PagedConfig
from genrec_tpu_torch.serving.metrics import ServingMetrics
from genrec_tpu_torch.serving.types import (
    DrainingError,
    Request,
    Response,
    UnknownHeadError,
)


class _PagedRunner:
    """Slot-level continuous batching for ONE paged generative head. All
    methods run on the batcher thread."""

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
        self.cfg = cfg
        self.device = head.device
        n_layers, n_heads, head_dim, dtype = head.paged_layout()
        self.pool = KVPagePool(cfg, n_layers, n_heads, head_dim, dtype,
                               device=self.device)
        self.state = head.paged_state_zeros(cfg.max_slots)
        self.steps = np.zeros(cfg.max_slots, np.int64)
        self.active = np.zeros(cfg.max_slots, bool)
        # (req, fut, t_enq, t_admit) per live slot.
        self.entries: list = [None] * cfg.max_slots
        self.buckets: list = [None] * cfg.max_slots  # prefill (B, L) per slot
        self._decode = head.make_decode_paged_fn()

    @property
    def idle(self) -> bool:
        return not self.active.any()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # -- admission (prefill into pages) --------------------------------------

    def admit(self) -> bool:
        """Drain the head's queue into free slots, one bucketed prefill
        micro-batch at a time. Every slot holds ``pages_per_slot`` pages'
        worth of the pool, so a free slot always has its pages."""
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
            L = eng._ladder.history_bucket(
                max(max(head.natural_len(e[0]) for e in entries), 1)
            )
            t_admit = time.monotonic()
            slots = []
            for e in entries:
                slot = self.pool.admit(head.paged_kv_tokens(head.natural_len(e[0]), L))
                self.entries[slot] = (*e, t_admit)
                slots.append(slot)
            try:
                self._run_prefill(slots, L)
            except Exception as exc:  # noqa: BLE001 — fail THESE futures only
                eng._log.exception(f"serving: paged prefill on head {head.name} failed")
                self._fail_slots(slots, exc)
            else:
                self._sweep_finished()  # heads whose init step == total finish here
            progressed = True

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

    def _run_prefill(self, slots, L: int) -> None:
        eng = self.engine
        head = self.head
        reqs = [self.entries[slot][0] for slot in slots]
        n = len(slots)
        B = eng._ladder.batch_bucket(n)
        batch = head.make_batch(reqs, B, L)
        bt = np.zeros((B, self.cfg.pages_per_slot), np.int32)
        bt[:n] = self.pool.block_tables[slots]  # padded rows -> null page
        head.make_prefill_paged_fn(B, L)(
            *head.runtime_operands(), *batch, self._to_device(bt),
            self.pool.k_pools, self.pool.v_pools,
        )
        idx = self._to_device(np.asarray(slots, np.int64))
        for v in self.state.values():
            v[idx] = 0
        self.steps[slots] = head.paged_init_step
        self.active[slots] = True
        for slot in slots:
            self.buckets[slot] = (B, L)
        eng.metrics.record_admit(n)
        eng.metrics.record_batch(head.name, (B, L))

    # -- decode (one step over the slot prefix holding every active slot) ----

    def step(self) -> bool:
        """Advance every active slot one decode position. Finished slots
        resolve their futures and free their pages immediately."""
        if self.idle:
            return False
        # Slots fill lowest-index-first, so [0, hi) holds every active
        # slot; free slots inside it compute garbage harmlessly (nothing
        # in the step reduces across rows).
        S = int(np.nonzero(self.active)[0][-1]) + 1
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
        except Exception as exc:  # noqa: BLE001 — fail the step's slots, not the loop
            self.engine._log.exception(f"serving: paged decode on head {self.head.name} failed")
            self._fail_slots(np.nonzero(self.active)[0], exc)
            return True
        for k, v in out.items():
            self.state[k][:S] = v
        self.steps[self.active] += 1
        self.engine.metrics.record_decode_step()
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


class ServingEngine:
    """Serves paged generative heads on one device.

    ``heads``: heads implementing the paged protocol (serving/heads.py),
    each holding its model (and weights) on ``device``. ``device``
    defaults to the card and raises when there is none; pass
    ``device="cpu"`` to serve on the CPU. ``paged_config`` sizes every
    head's page pool (default: ``4 * max_batch`` slots, pages covering the
    largest history bucket).
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
    ):
        self.device = resolve_device(device)
        self._heads = {h.name: h for h in heads}
        if len(self._heads) != len(heads):
            raise ValueError("duplicate head names")
        for h in heads:
            if not getattr(h, "supports_paged", False):
                raise ValueError(f"head {h.name!r} does not implement the paged protocol")
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
        self._log = logging.getLogger("genrec_tpu_torch")
        self.metrics = ServingMetrics()
        self._runners: dict[str, _PagedRunner] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues = {name: collections.deque() for name in self._heads}
        self._draining = False
        self._batcher: Optional[threading.Thread] = None
        self._started = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingEngine":
        """Build every head's page pool and slot state and start the
        batcher thread. Returns self."""
        if self._started:
            raise RuntimeError("engine already started")
        for head in self._heads.values():
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
                        break
                except Exception:  # noqa: BLE001 — the batcher must survive
                    self._log.exception("serving: batcher iteration failed")
