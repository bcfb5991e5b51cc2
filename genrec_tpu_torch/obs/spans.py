"""Request/step-scoped span tracer: where the time goes, host-side (port
of genrec_tpu/obs/spans.py).

The serving metrics (serving/metrics.py) say *how slow* a request was;
the tracer says *where the time went* — queue, admission, prefill, which
decode step. `SpanTracer` records thread-safe begin/end spans on
monotonic clocks, with explicit trace IDs so one request's spans stay one
tree even when they are recorded from different threads (submit() on the
caller, decode on the batcher), a bounded ring so a long-lived engine
never grows without bound, and export to Chrome-trace JSON (open in
Perfetto / chrome://tracing).

Two recording APIs:

- ``with tracer.span("name")`` — nested, thread-local parenting (one
  thread, strict nesting).
- ``tracer.record_span(name, trace_id, t0, t1, parent_id=...)`` — direct
  interval recording with explicit parentage; the serving engine's shape
  (one request's spans recorded from whichever thread observed them).

`TraceContext` is the cross-component contract on top: minted once at
the outermost submit and carried on the Request, so every hop's spans
join one rooted tree.

Tracing off is the default everywhere and must stay ~free: a disabled
tracer's ``span()`` is one attribute check returning a shared no-op
context manager, and ``record_span`` returns immediately.

``bridge_profiler=True`` additionally enters
`torch.profiler.record_function` for every context-manager span, so host
spans line up with the CUDA kernels in a `torch.profiler` trace (the
JAX tracer's ``bridge_jax`` does the same with the JAX profiler).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Mapping


@dataclasses.dataclass
class Span:
    trace_id: str
    span_id: int
    parent_id: int | None
    name: str
    t0: float  # monotonic seconds
    t1: float
    thread: int
    attrs: dict

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One request's lineage, handed from component to component.

    Minted ONCE at the outermost ``submit()`` (a bare `ServingEngine`
    here; a router or front in front of engines) and carried on the
    `Request` (and across any wire header) through every hop, so the
    request's spans land in ONE rooted tree instead of N per-component
    fragments.

    ``parent_span_id`` is the attach point for the NEXT hop's spans:
    each component that handles the request records its own request-level
    span under the incoming parent and forwards ``child(own_span_id)``
    downstream. ``origin`` names the minting component (provenance for
    the exported trace and the critical-path report). Span ids are only
    meaningful within one `SpanTracer`'s id space — in-process lineage
    shares one tracer across router/front/engine/workers; a cross-host
    hop carries the ids as opaque ints back to the same collector.
    """

    trace_id: str
    parent_span_id: int | None
    origin: str

    def child(self, parent_span_id: int | None) -> "TraceContext":
        """The context the next hop sees: same trace, re-parented."""
        return dataclasses.replace(self, parent_span_id=parent_span_id)

    def to_header(self) -> dict:
        """JSON-safe dict for wire headers."""
        return {
            "trace_id": self.trace_id,
            "parent_span_id": self.parent_span_id,
            "origin": self.origin,
        }

    @classmethod
    def from_header(cls, header) -> "TraceContext | None":
        if not header or header.get("trace_id") is None:
            return None
        pid = header.get("parent_span_id")
        return cls(
            trace_id=str(header["trace_id"]),
            parent_span_id=int(pid) if pid is not None else None,
            origin=str(header.get("origin", "unknown")),
        )


class _NullCtx:
    """Shared no-op context manager: the whole cost of a disabled span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class _SpanCtx:
    __slots__ = ("_tracer", "name", "trace_id", "attrs", "_t0", "span_id",
                 "_parent", "_prof_ctx")

    def __init__(self, tracer: "SpanTracer", name: str, trace_id: str | None,
                 attrs: dict):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.attrs = attrs

    def __enter__(self):
        tracer = self._tracer
        stack = tracer._stack()
        if self.trace_id is None:
            # Inherit the enclosing span's trace; a root span with no
            # explicit trace mints a fresh one.
            self.trace_id = stack[-1][0] if stack else tracer.new_trace("span")
        self._parent = stack[-1][1] if stack else None
        self.span_id = tracer._next_span_id()
        stack.append((self.trace_id, self.span_id))
        self._prof_ctx = None
        if tracer.bridge_profiler:
            import torch

            self._prof_ctx = torch.profiler.record_function(self.name)
            self._prof_ctx.__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(*exc)
        tracer = self._tracer
        stack = tracer._stack()
        # Pop OUR frame even if an inner span leaked (exception unwound
        # past a hand-called begin): truncate to our depth.
        while stack and stack[-1][1] != self.span_id:
            stack.pop()
        if stack:
            stack.pop()
        tracer._commit(Span(
            trace_id=self.trace_id, span_id=self.span_id,
            parent_id=self._parent, name=self.name, t0=self._t0, t1=t1,
            thread=threading.get_ident(), attrs=self.attrs,
        ))
        return False


class SpanTracer:
    """Thread-safe span recorder with a bounded completed-span ring."""

    def __init__(self, capacity: int = 8192, enabled: bool = True,
                 bridge_profiler: bool = False, max_exemplars: int = 8):
        self.enabled = enabled
        self.bridge_profiler = bridge_profiler
        self.max_exemplars = max_exemplars
        self._ring: collections.deque[Span] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._span_ids = itertools.count(1)
        self._trace_ids = itertools.count(1)
        self._spans_recorded = 0
        self._traces_started = 0
        self._local = threading.local()
        # trace_id -> (reason, [Span]) — slow-request span trees copied out
        # of the ring the moment they are flagged, so ring eviction cannot
        # lose a p99 outlier's explanation.
        self._exemplars: "collections.OrderedDict[str, tuple[str, list[Span]]]" = (
            collections.OrderedDict()
        )
        # monotonic -> wall offset, so exports carry absolute timestamps.
        self._wall_offset = time.time() - time.monotonic()

    # -- recording -----------------------------------------------------------

    def new_trace(self, prefix: str = "req") -> str:
        """Mint a trace ID (itertools.count is atomic under the GIL)."""
        with self._lock:
            self._traces_started += 1
        return f"{prefix}-{next(self._trace_ids)}"

    def span(self, name: str, trace_id: str | None = None, **attrs):
        """Context manager recording one nested span (thread-local
        parenting). Disabled tracers return a shared no-op."""
        if not self.enabled:
            return _NULL_CTX
        return _SpanCtx(self, name, trace_id, attrs)

    def allocate_span_id(self) -> int:
        """Pre-mint a span id so children recorded BEFORE their parent
        completes can still reference it (a serving request's root span
        is only recordable at finalize, but its queue/prefill children
        land first). Pass it back via ``record_span(span_id=...)``."""
        return self._next_span_id()

    def record_span(self, name: str, trace_id: str, t0: float, t1: float,
                    parent_id: int | None = None, span_id: int | None = None,
                    **attrs) -> int | None:
        """Record a completed interval directly (cross-thread traces where
        begin and end were observed by different code). Times are
        `time.monotonic()` seconds. Returns the span id (parent for
        subsequent children), or None when disabled."""
        if not self.enabled:
            return None
        if span_id is None:
            span_id = self._next_span_id()
        self._commit(Span(
            trace_id=trace_id, span_id=span_id, parent_id=parent_id,
            name=name, t0=t0, t1=t1, thread=threading.get_ident(),
            attrs=attrs,
        ))
        return span_id

    def _next_span_id(self) -> int:
        return next(self._span_ids)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _commit(self, span: Span) -> None:
        with self._lock:
            self._spans_recorded += 1
            self._ring.append(span)

    def stats(self) -> dict:
        """Tracer self-metering for the stats()/Prometheus surface:
        lifetime counters (spans_recorded / traces_started) plus the
        live ring occupancy, so "is lineage actually being collected,
        and is the ring deep enough" is a scrapeable question."""
        with self._lock:
            ring_len = len(self._ring)
            recorded = self._spans_recorded
            traces = self._traces_started
        return {
            "enabled": self.enabled,
            "spans_recorded": recorded,
            "traces_started": traces,
            "ring_spans": ring_len,
            "ring_capacity": self._ring.maxlen or 0,
        }

    # -- reading -------------------------------------------------------------

    def spans(self, trace_id: str | None = None) -> list[Span]:
        with self._lock:
            out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def mark_exemplar(self, trace_id: str, reason: str = "") -> None:
        """Persist a trace's full span tree outside the ring (slow-request
        exemplars: p99 outliers keep their explanation)."""
        if not self.enabled:
            return
        spans = self.spans(trace_id)
        if not spans:
            return
        with self._lock:
            self._exemplars[trace_id] = (reason, spans)
            self._exemplars.move_to_end(trace_id)
            while len(self._exemplars) > self.max_exemplars:
                self._exemplars.popitem(last=False)

    def exemplars(self) -> dict[str, tuple[str, list[Span]]]:
        with self._lock:
            return dict(self._exemplars)

    # -- export --------------------------------------------------------------

    def _lane(self, cache: dict, key) -> int:
        # Stable small ints per (trace, component): Perfetto renders each
        # trace as its own track — and a lineage trace (spans stamped
        # with a ``component`` attr by router/front/workers) fans out
        # into one lane per component, so the cross-component life of a
        # routed request reads as parallel swimlanes instead of one
        # thread-id soup.
        return cache.setdefault(key, len(cache) + 1)

    def _event(self, span: Span, lanes: dict) -> dict:
        return {
            "name": span.name,
            "cat": "obs",
            "ph": "X",
            "ts": round((span.t0 + self._wall_offset) * 1e6, 3),
            "dur": round(span.duration * 1e6, 3),
            "pid": os.getpid(),
            "tid": self._lane(
                lanes, (span.trace_id, span.attrs.get("component", ""))
            ),
            "args": {
                "trace_id": span.trace_id,
                "span_id": span.span_id,
                "parent_id": span.parent_id,
                **span.attrs,
            },
        }

    def to_chrome_trace(self, metadata: Mapping[str, Any] | None = None) -> dict:
        """Chrome-trace/Perfetto JSON object ("X" complete events, one
        lane per trace ID, exemplar trees appended with their reason)."""
        lanes: dict[str, int] = {}
        events = [self._event(s, lanes) for s in self.spans()]
        exemplar_meta = {}
        for trace_id, (reason, spans) in self.exemplars().items():
            exemplar_meta[trace_id] = reason
            seen = {e["args"]["span_id"] for e in events}
            for s in spans:
                if s.span_id not in seen:
                    events.append(self._event(s, lanes))
        out = {
            "traceEvents": sorted(events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
            "otherData": {
                "exemplars": exemplar_meta,
                **(dict(metadata) if metadata else {}),
            },
        }
        return out

    def dump(self, path: str, metadata: Mapping[str, Any] | None = None) -> str:
        """Atomic (tmp + rename) Chrome-trace JSON dump."""
        payload = self.to_chrome_trace(metadata)
        tmp = f"{path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)
        return path


#: Shared disabled tracer: callers that take ``tracer=None`` default to
#: this so the hot path is one attribute check, never a None branch.
NULL_TRACER = SpanTracer(capacity=1, enabled=False)
