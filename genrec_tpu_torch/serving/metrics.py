"""Serving instrumentation (port of genrec_tpu/serving/metrics.py, the
counters the port's engine records): latency histograms with
p50/p95/p99, lifetime and recent-window QPS, per-head windowed latency
rings (the SLO monitor's p99, the slow-request exemplar threshold),
per-(head, batch, history) bucket hits, admit/evict churn, deferred
admissions, per-head submissions / rejections / overload sheds, hot-swap
and watcher-error counts, per-head KV-pool gauges, the prefix cache's
lookups and churn, and the speculative decode's drafted and accepted
codes. The engine adds the memory ledger's gauges, the tracer's and the
SLO monitor's state to its ``stats()``.

Histograms are fixed log-spaced buckets, so recording allocates nothing;
percentiles report the upper edge of the containing bucket (<= 25%
relative error at the chosen growth factor).
"""

from __future__ import annotations

import bisect
import collections
import threading
import time


class LatencyHistogram:
    """Log-spaced latency histogram over [100us, ~15min]."""

    def __init__(self, base: float = 1e-4, factor: float = 1.25, n: int = 64):
        self.bounds = [base * factor**i for i in range(n)]  # upper edges
        self.counts = [0] * (n + 1)  # last bucket = overflow
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        seconds = max(float(seconds), 0.0)
        self.counts[bisect.bisect_left(self.bounds, seconds)] += 1
        self.count += 1
        self.total += seconds
        self.max = max(self.max, seconds)

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-quantile (0 < q <= 1)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max

    def summary(self, scale: float = 1e3) -> dict:
        """p50/p95/p99/mean/max, scaled (default: seconds -> ms)."""
        mean = self.total / self.count if self.count else 0.0
        return {
            "p50": round(self.percentile(0.50) * scale, 3),
            "p95": round(self.percentile(0.95) * scale, 3),
            "p99": round(self.percentile(0.99) * scale, 3),
            "mean": round(mean * scale, 3),
            "max": round(self.max * scale, 3),
            "count": self.count,
        }


class ServingMetrics:
    """Thread-safe counters + histograms for one engine instance."""

    def __init__(self, recent_window: int = 2048):
        self._lock = threading.Lock()
        self.queue_wait = LatencyHistogram()
        self.compute = LatencyHistogram()
        self.total = LatencyHistogram()
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.batches = 0
        self.bucket_hits: collections.Counter = collections.Counter()
        self.admits = 0
        self.evictions = 0
        self.decode_steps = 0
        self.oom_deferred_admits = 0
        # Hot params reload / catalog swap, and failed watcher passes.
        self.params_swaps = 0
        self.catalog_swaps = 0
        self.watcher_errors = 0
        # Per-head attribution: the SLO monitor differences submissions
        # and deferrals per head, so one head's pool pressure never sheds
        # a healthy co-hosted head.
        self.submitted_by_head: collections.Counter = collections.Counter()
        self.rejected_by_head: collections.Counter = collections.Counter()
        self.oom_deferred_by_head: collections.Counter = collections.Counter()
        self.overload_rejected = 0
        self.overload_by_head: collections.Counter = collections.Counter()
        self.pool_gauges: dict[str, dict] = {}
        # Prefix cache, per head: lookup outcomes (a partial hit matched a
        # shorter retained history and admitted cold), KV tokens served
        # warm (prefill not paid), index churn, and the index's gauges.
        self.prefix_lookups: collections.Counter = collections.Counter()
        self.prefix_hits: collections.Counter = collections.Counter()
        self.prefix_partial_hits: collections.Counter = collections.Counter()
        self.prefix_misses: collections.Counter = collections.Counter()
        self.prefix_warm_tokens: collections.Counter = collections.Counter()
        self.prefix_insertions: collections.Counter = collections.Counter()
        self.prefix_evictions: collections.Counter = collections.Counter()
        self.prefix_invalidations: collections.Counter = collections.Counter()
        self.prefix_gauges: dict[str, dict] = {}
        # Speculative decode, per head: ``decode_steps`` keeps counting
        # decoder invocations (a spec call is one, however many codes it
        # commits); these count the speculated tokens drafted, the codes
        # committed, the slot-steps (one an active slot a call) and the
        # accept lengths.
        self.spec_steps: collections.Counter = collections.Counter()
        self.spec_drafted: collections.Counter = collections.Counter()
        self.spec_accepted: collections.Counter = collections.Counter()
        self.spec_slot_steps: collections.Counter = collections.Counter()
        self.spec_accept_hist: dict[str, collections.Counter] = {}
        self._recent = collections.deque(maxlen=recent_window)
        self._recent_window = recent_window
        # head -> deque of (monotonic t, total latency s), the windowed p99.
        self._recent_lat: dict = {}
        self._started = time.monotonic()

    def mark_warm(self) -> None:
        """Start the QPS clock (the engine calls this when it starts)."""
        with self._lock:
            self._started = time.monotonic()

    def record_submit(self, head: str | None = None) -> None:
        with self._lock:
            self.submitted += 1
            if head is not None:
                self.submitted_by_head[head] += 1

    def record_reject(self, head: str | None = None) -> None:
        """A draining rejection (``DrainingError`` at submit)."""
        with self._lock:
            self.rejected += 1
            if head is not None:
                self.rejected_by_head[head] += 1

    def record_overload(self, head: str) -> None:
        """An SLO load-shed rejection (``OverloadError`` at submit)."""
        with self._lock:
            self.overload_rejected += 1
            self.overload_by_head[head] += 1

    def record_swap(self) -> None:
        with self._lock:
            self.params_swaps += 1

    def record_catalog_swap(self) -> None:
        with self._lock:
            self.catalog_swaps += 1

    def record_watcher_error(self) -> None:
        with self._lock:
            self.watcher_errors += 1

    def record_admit(self, n: int = 1) -> None:
        with self._lock:
            self.admits += n

    def record_evict(self, n: int = 1) -> None:
        with self._lock:
            self.evictions += n

    def record_decode_step(self) -> None:
        with self._lock:
            self.decode_steps += 1

    def record_oom_admit(self, n: int = 1, head: str | None = None) -> None:
        """Admissions deferred because the pool had no free pages even
        after reclaiming retained prefix pages; the requests stay queued."""
        with self._lock:
            self.oom_deferred_admits += n
            if head is not None:
                self.oom_deferred_by_head[head] += n

    def record_spec(self, head: str, drafted: int, accept_lens) -> None:
        """One speculative invocation: ``drafted`` tokens speculated over
        the active slots, ``accept_lens`` the codes each active slot
        committed (>= 1). The invocation itself is `record_decode_step`."""
        lens = [int(x) for x in accept_lens]
        with self._lock:
            self.spec_steps[head] += 1
            self.spec_drafted[head] += int(drafted)
            self.spec_slot_steps[head] += len(lens)
            self.spec_accepted[head] += sum(lens)
            self.spec_accept_hist.setdefault(head, collections.Counter()).update(lens)

    def record_prefix_lookup(self, head: str, outcome: str, tokens: int = 0) -> None:
        """One lookup, ``outcome`` "hit", "partial" or "miss"; ``tokens``
        the KV tokens a hit serves warm."""
        with self._lock:
            self.prefix_lookups[head] += 1
            if outcome == "hit":
                self.prefix_hits[head] += 1
                self.prefix_warm_tokens[head] += int(tokens)
            elif outcome == "partial":
                self.prefix_partial_hits[head] += 1
            else:
                self.prefix_misses[head] += 1

    def record_prefix_insert(self, head: str, n: int = 1) -> None:
        with self._lock:
            self.prefix_insertions[head] += n

    def record_prefix_evict(self, head: str, n: int = 1, invalidation: bool = False) -> None:
        """Entries dropped: by reclaim (pool pressure) or, apart, by a
        wholesale invalidation (drain)."""
        with self._lock:
            if invalidation:
                self.prefix_invalidations[head] += n
            else:
                self.prefix_evictions[head] += n

    def set_prefix_gauges(self, head: str, gauges: dict) -> None:
        with self._lock:
            self.prefix_gauges[head] = dict(gauges)

    def set_pool_gauges(self, head: str, gauges: dict) -> None:
        with self._lock:
            self.pool_gauges[head] = dict(gauges)

    def record_failure(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    def record_batch(self, head: str, bucket: tuple[int, int]) -> None:
        with self._lock:
            self.batches += 1
            self.bucket_hits[(head, *bucket)] += 1

    def record_response(self, queue_wait: float, compute: float, total: float,
                        head: str | None = None) -> None:
        now = time.monotonic()
        with self._lock:
            self.queue_wait.record(queue_wait)
            self.compute.record(compute)
            self.total.record(total)
            self.completed += 1
            self._recent.append(now)
            ring = self._recent_lat.get(head)
            if ring is None:
                ring = self._recent_lat[head] = collections.deque(maxlen=self._recent_window)
            ring.append((now, float(total)))

    def recent_p99_ms(self, window_s: float, head: str | None = None, q: float = 0.99,
                      min_count: int = 20) -> float | None:
        """Total-latency quantile over the responses completed within the
        last ``window_s`` seconds — one head's ring, or every head's
        pooled — or None below ``min_count`` samples (an empty window must
        not read as 'SLO met at 0 ms': the SLO monitor skips the
        dimension instead)."""
        cut = time.monotonic() - window_s
        with self._lock:
            if head is None:
                samples = [s for ring in self._recent_lat.values() for s in ring]
            else:
                ring = self._recent_lat.get(head)
                samples = list(ring) if ring else []
        vals = sorted(v for t, v in samples if t >= cut)
        if len(vals) < min_count:
            return None
        return vals[min(len(vals) - 1, int(q * len(vals)))] * 1e3

    def slow_threshold_s(self, q: float = 0.99, min_count: int = 64) -> float | None:
        """Latency at or above which a request is a slow outlier (the
        total-latency q-quantile), None until ``min_count`` responses: an
        empty histogram's p99 is 0 and would flag every early request."""
        with self._lock:
            if self.total.count < min_count:
                return None
            return self.total.percentile(q)

    def qps(self) -> float:
        """Lifetime QPS since the engine started."""
        with self._lock:
            dt = time.monotonic() - self._started
            return self.completed / dt if dt > 0 else 0.0

    def recent_qps(self) -> float:
        """QPS over the recent completion window (steady-state view)."""
        with self._lock:
            if len(self._recent) < 2:
                return 0.0
            dt = self._recent[-1] - self._recent[0]
            return (len(self._recent) - 1) / dt if dt > 0 else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            bucket_hits = {
                f"{h}/B{b}/L{l}": n for (h, b, l), n in sorted(self.bucket_hits.items())
            }
            counts = dict(
                submitted=self.submitted,
                completed=self.completed,
                rejected=self.rejected,
                failed=self.failed,
                batches=self.batches,
                admits=self.admits,
                evictions=self.evictions,
                decode_steps=self.decode_steps,
                oom_deferred_admits=self.oom_deferred_admits,
                params_swaps=self.params_swaps,
                catalog_swaps=self.catalog_swaps,
                watcher_errors=self.watcher_errors,
                overload_rejected=self.overload_rejected,
            )
            by_head = {name: dict(sorted(c.items())) for name, c in (
                ("submitted_by_head", self.submitted_by_head),
                ("rejected_by_head", self.rejected_by_head),
                ("overload_by_head", self.overload_by_head),
                ("oom_deferred_by_head", self.oom_deferred_by_head))}
            kv_pool = {h: dict(g) for h, g in sorted(self.pool_gauges.items())}
            prefix_cache = {
                h: {
                    "lookups": self.prefix_lookups[h],
                    "hits": self.prefix_hits[h],
                    "partial_hits": self.prefix_partial_hits[h],
                    "misses": self.prefix_misses[h],
                    "warm_tokens": self.prefix_warm_tokens[h],
                    "insertions": self.prefix_insertions[h],
                    "evictions": self.prefix_evictions[h],
                    "invalidations": self.prefix_invalidations[h],
                    **self.prefix_gauges.get(h, {}),
                }
                for h in sorted(set(self.prefix_lookups) | set(self.prefix_gauges))
            }
            spec = {}
            for h in sorted(self.spec_steps):
                slot_steps = self.spec_slot_steps[h]
                spec[h] = {
                    "spec_steps": self.spec_steps[h],
                    "drafted": self.spec_drafted[h],
                    "accepted": self.spec_accepted[h],
                    "slot_steps": slot_steps,
                    # Codes a slot commits a decoder call (plain decode: 1.0).
                    "codes_per_invocation": round(self.spec_accepted[h] / slot_steps, 4)
                    if slot_steps else 0.0,
                    "accept_len_hist": {f"accept_len_{n}": c
                                        for n, c in sorted(self.spec_accept_hist[h].items())},
                }
        return {
            **counts,
            "qps": round(self.qps(), 3),
            "recent_qps": round(self.recent_qps(), 3),
            "queue_wait_ms": self.queue_wait.summary(),
            "compute_ms": self.compute.summary(),
            "total_ms": self.total.summary(),
            "bucket_hits": bucket_hits,
            **by_head,
            "kv_pool": kv_pool,
            "prefix_cache": prefix_cache,
            "spec": spec,
        }
