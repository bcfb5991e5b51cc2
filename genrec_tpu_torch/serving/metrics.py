"""Serving instrumentation (port of genrec_tpu/serving/metrics.py, the
counters the paged engine records): latency histograms with p50/p95/p99,
lifetime and recent-window QPS, per-(head, batch, history) bucket hits,
admit/evict churn, deferred admissions, per-head KV-pool gauges, the
prefix cache's lookups and churn, and the speculative decode's drafted
and accepted codes.

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
        self._started = time.monotonic()

    def mark_warm(self) -> None:
        """Start the QPS clock (the engine calls this when it starts)."""
        with self._lock:
            self._started = time.monotonic()

    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_admit(self, n: int = 1) -> None:
        with self._lock:
            self.admits += n

    def record_evict(self, n: int = 1) -> None:
        with self._lock:
            self.evictions += n

    def record_decode_step(self) -> None:
        with self._lock:
            self.decode_steps += 1

    def record_oom_admit(self, n: int = 1) -> None:
        """Admissions deferred because the pool had no free pages even
        after reclaiming retained prefix pages; the requests stay queued."""
        with self._lock:
            self.oom_deferred_admits += n

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

    def record_response(self, queue_wait: float, compute: float, total: float) -> None:
        now = time.monotonic()
        with self._lock:
            self.queue_wait.record(queue_wait)
            self.compute.record(compute)
            self.total.record(total)
            self.completed += 1
            self._recent.append(now)

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
            )
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
            "kv_pool": kv_pool,
            "prefix_cache": prefix_cache,
            "spec": spec,
        }
