"""SLO monitor: declared per-head service targets, sustained-breach
detection over sliding windows, and a load-shed/recover state machine
with hysteresis (port of genrec_tpu/obs/slo.py; framework-free, as
there).

A serving replica that silently degrades — p99 creeping past the target,
queues deepening, KV-pool OOM deferrals climbing — is worse than one
that sheds: callers keep pouring traffic into a convoy instead of
failing over. The monitor turns declared targets into a typed decision
the engine can act on:

- `SLOTarget` declares the per-head objectives: p99 latency, queue
  depth, OOM-deferral rate — each optional — plus the evaluation window
  and the breach/recover hysteresis.
- `SLOMonitor.observe(head, ...)` is fed current observations by the
  owner (the serving engine's batcher polls it off the hot path).
  Latency arrives as an already-windowed p99; cumulative counters
  (deferrals, submissions) arrive as lifetime totals and are
  differenced over the target's window here.
- A breach must hold for ``breach_s`` continuously before the head
  flips to SHEDDING (one slow micro-batch is noise, a sustained queue
  is overload); recovery requires every target met for ``recover_s``
  (hysteresis, so the shed/unshed boundary cannot flap request-by-
  request). Both transitions fire structured flight-recorder events.

The monitor carries NO engine knowledge: the owner decides what
shedding means (the engine rejects new submissions with the typed
``OverloadError`` while in-flight and queued work completes — the same
discipline as drain). Thread-safe: observe() runs on the owner's
batcher thread while is_shedding()/snapshot() are read from submitter
threads; everything under the lock is dict ops, never blocking calls.

Layering: obs imports nothing from core/trainers/serving.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Declared objectives for one head. ``None`` disables a dimension.

    ``max_deferral_rate`` is OOM-deferred admissions per submitted
    request over the window — a sustained nonzero rate means the KV-pool
    budget, not the arrival rate, is the bottleneck (serving/kv_pool.py
    semantics).
    """

    p99_ms: Optional[float] = None
    max_queue_depth: Optional[int] = None
    max_deferral_rate: Optional[float] = None
    window_s: float = 5.0
    breach_s: float = 1.0   # sustained breach before shedding starts
    recover_s: float = 2.0  # sustained OK before shedding ends (hysteresis)

    def __post_init__(self):
        if self.p99_ms is None and self.max_queue_depth is None \
                and self.max_deferral_rate is None:
            raise ValueError("SLOTarget declares no objective")
        if self.window_s <= 0 or self.breach_s < 0 or self.recover_s < 0:
            raise ValueError(f"invalid SLO windows in {self}")


class _HeadState:
    __slots__ = ("shedding", "breach_since", "ok_since", "breaches",
                 "breached", "values", "margins", "counters")

    def __init__(self):
        self.shedding = False
        self.breach_since: Optional[float] = None
        self.ok_since: Optional[float] = None
        self.breaches = 0
        self.breached: list[str] = []   # dimensions currently violated
        self.values: dict = {}          # last observed values
        self.margins: dict = {}         # per-target margin (1=free, <0=over)
        # (t, oom_deferred_total, submitted_total) ring for window deltas
        self.counters: collections.deque = collections.deque(maxlen=4096)


def _margin(observed: float, target: float) -> float:
    """Fractional distance to a lower-is-better target, clamped to
    [-1, 1]: 1.0 = completely free, 0.0 = exactly at the target,
    negative = over it. The cheap scalar a fleet router ranks replicas
    by without re-deriving percentiles from nested snapshots."""
    if target <= 0:
        return 1.0 if observed <= target else -1.0
    return max(-1.0, min(1.0, (target - float(observed)) / float(target)))


def _head_headroom(st: _HeadState) -> float:
    """One scalar per head: the tightest per-target margin (1.0 when no
    dimension has an observation yet — an idle head is free capacity).
    A SHEDDING head advertises no headroom regardless of its instant
    margins: hysteresis owns the recovery decision, and a router that
    resumed traffic on the first good margin would defeat it."""
    room = min(st.margins.values()) if st.margins else 1.0
    return min(room, 0.0) if st.shedding else room


class SLOMonitor:
    """Shed/recover state machine over declared per-head SLOTargets."""

    def __init__(self, targets: Mapping[str, SLOTarget], flight=None):
        if not targets:
            raise ValueError("SLOMonitor needs at least one head target")
        self.targets = dict(targets)
        self._lock = threading.Lock()
        self._state = {name: _HeadState() for name in self.targets}
        if flight is None:
            from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder

            flight = get_flight_recorder()
        self._flight = flight

    # -- evaluation ----------------------------------------------------------

    def _deferral_rate(self, st: _HeadState, target: SLOTarget,
                       now: float) -> Optional[float]:
        """Windowed deferrals-per-submit from the cumulative counters."""
        ring = st.counters
        if len(ring) < 2:
            return None
        oldest = None
        for entry in ring:  # oldest sample still inside the window
            if entry[0] >= now - target.window_s:
                oldest = entry
                break
        if oldest is None or oldest is ring[-1]:
            return None
        newest = ring[-1]
        d_submit = newest[2] - oldest[2]
        d_defer = newest[1] - oldest[1]
        if d_submit <= 0:
            # No arrivals in the window: a deferrals-per-submit rate is
            # undefined, so the dimension is SKIPPED (None) rather than
            # compared in the wrong units — and a stale deferral count
            # cannot hold the head shed through an idle spell.
            return None
        return d_defer / d_submit

    def observe(self, head: str, *, p99_ms: Optional[float] = None,
                queue_depth: Optional[int] = None,
                oom_deferred_total: Optional[int] = None,
                submitted_total: Optional[int] = None,
                now: Optional[float] = None) -> bool:
        """Feed one observation; returns the head's (possibly updated)
        shedding state. ``p99_ms=None`` (not enough samples yet) skips
        the latency dimension rather than counting as a breach."""
        target = self.targets[head]
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            st = self._state[head]
            if oom_deferred_total is not None and submitted_total is not None:
                st.counters.append(
                    (now, int(oom_deferred_total), int(submitted_total))
                )
            breached: list[str] = []
            values: dict = {}
            margins: dict = {}
            if target.p99_ms is not None and p99_ms is not None:
                values["p99_ms"] = round(float(p99_ms), 3)
                margins["p99_ms"] = _margin(p99_ms, target.p99_ms)
                if p99_ms > target.p99_ms:
                    breached.append("p99_ms")
            if target.max_queue_depth is not None and queue_depth is not None:
                values["queue_depth"] = int(queue_depth)
                margins["queue_depth"] = _margin(
                    queue_depth, target.max_queue_depth
                )
                if queue_depth > target.max_queue_depth:
                    breached.append("queue_depth")
            if target.max_deferral_rate is not None:
                rate = self._deferral_rate(st, target, now)
                if rate is not None:
                    values["deferral_rate"] = round(rate, 4)
                    margins["deferral_rate"] = _margin(
                        rate, target.max_deferral_rate
                    )
                    if rate > target.max_deferral_rate:
                        breached.append("deferral_rate")
            st.values = values
            st.margins = margins
            st.breached = breached
            if breached:
                st.ok_since = None
                if st.breach_since is None:
                    st.breach_since = now
                if (not st.shedding
                        and now - st.breach_since >= target.breach_s):
                    st.shedding = True
                    st.breaches += 1
                    self._flight.record(
                        "slo_breach", head=head, breached=list(breached),
                        values=dict(values), breaches=st.breaches,
                    )
            else:
                st.breach_since = None
                if st.shedding:
                    if st.ok_since is None:
                        st.ok_since = now
                    if now - st.ok_since >= target.recover_s:
                        st.shedding = False
                        st.ok_since = None
                        self._flight.record(
                            "slo_recovered", head=head, values=dict(values),
                        )
            return st.shedding

    # -- the owner's read surface --------------------------------------------

    def is_shedding(self, head: str) -> bool:
        st = self._state.get(head)
        if st is None:
            return False
        with self._lock:
            return st.shedding

    def shed_reason(self, head: str) -> str:
        with self._lock:
            st = self._state[head]
            dims = ", ".join(
                f"{d}={st.values.get(d)}" for d in st.breached
            ) or "recovering"
        return f"sustained SLO breach on {head}: {dims}"

    def headroom(self) -> dict:
        """{head: scalar headroom} — the flat per-head signal a fleet
        router ranks replicas by (dict reads under the lock, no
        percentile math; see :func:`_head_headroom`)."""
        with self._lock:
            return {name: round(_head_headroom(st), 4)
                    for name, st in self._state.items()}

    def snapshot(self) -> dict:
        """Numeric per-head state for metrics/Prometheus exposition.
        Each head carries its last observed values, the per-target
        ``margins`` (1 = free, 0 = at target, negative = over), and the
        scalar ``headroom`` (tightest margin, 0-floored while shedding)."""
        with self._lock:
            heads = {}
            for name, st in self._state.items():
                heads[name] = {
                    "shedding": st.shedding,
                    "breaches": st.breaches,
                    "breached_dims": len(st.breached),
                    "headroom": round(_head_headroom(st), 4),
                    "margins": {k: round(v, 4)
                                for k, v in st.margins.items()},
                    **{k: v for k, v in st.values.items()},
                }
            any_shed = any(s.shedding for s in self._state.values())
        return {"heads": heads, "shedding": any_shed}
