"""Serving instrumentation (port of genrec_tpu/serving/metrics.py, the
counters the paged engine records): latency histograms with p50/p95/p99,
lifetime and recent-window QPS, per-(head, batch, history) bucket hits,
admit/evict churn and per-head KV-pool gauges.

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
        self.pool_gauges: dict[str, dict] = {}
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
            )
            kv_pool = {h: dict(g) for h, g in sorted(self.pool_gauges.items())}
        return {
            **counts,
            "qps": round(self.qps(), 3),
            "recent_qps": round(self.recent_qps(), 3),
            "queue_wait_ms": self.queue_wait.summary(),
            "compute_ms": self.compute.summary(),
            "total_ms": self.total.summary(),
            "bucket_hits": bucket_hits,
            "kv_pool": kv_pool,
        }
