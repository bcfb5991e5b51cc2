"""Crash flight recorder: the last N structured events, dumped on death
(port of genrec_tpu/obs/flight_recorder.py; framework-free, as there).

The flight recorder keeps a bounded ring of structured events — serving
lifecycle, integrity-ladder decisions, quarantines, signal receipt, pool
OOM deferrals, hot-reload and catalog swaps — and dumps it ATOMICALLY
(tmp + rename) to one JSON file when the process is about to die:

- SIGTERM/SIGINT (`core.preemption.PreemptionGuard` records + dumps),
- any unhandled exception (a chained `sys.excepthook`).

So a dead run's last file answers "what was it doing" without log
archaeology: the final events are the explanation.

One process-wide recorder (`get_flight_recorder()`): signal handlers have
no way to thread an instance through. Recording is always on (a lock +
deque append — nanoseconds against millisecond steps); dumping needs a
destination, set by `configure()`. A rank of a ``torch.distributed``
group of more than one process gets a ``_p<rank>`` suffix, so ranks
sharing a filesystem never clobber each other's post-mortems.
"""

from __future__ import annotations

import collections
import itertools
import json
import math
import os
import sys
import threading
import time
import traceback
from typing import Any


def json_safe(value: Any, fallback_repr: bool = True) -> Any:
    """Recursively make ``value`` strict-JSON-serializable: non-finite
    floats (incl. numpy scalars) become None, dicts/lists/tuples recurse.
    Unknown objects become their repr when ``fallback_repr`` (the flight
    recorder's contract: a dump must never be unparseable); with
    ``fallback_repr=False`` they pass through untouched so the caller's
    json.dumps still raises on genuinely unserializable input (the
    Tracker's contract). The ONE sanitizer shared by the flight recorder
    and core.logging.Tracker."""
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, (str, int, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): json_safe(v, fallback_repr) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [json_safe(v, fallback_repr) for v in value]
    try:
        f = float(value)  # numpy scalars
        return f if math.isfinite(f) else None
    except Exception:
        return repr(value) if fallback_repr else value


def process_rank() -> tuple[int, int]:
    """(rank, world size) of this process in the default
    ``torch.distributed`` group, (0, 1) without one."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except Exception:  # noqa: BLE001 — naming a dump must never fail
        pass
    return 0, 1


_DUMP_IDS = itertools.count(1)  # unique tmp-file suffixes (reentrancy-safe)


class FlightRecorder:
    """Bounded ring of structured events + atomic JSON dump."""

    def __init__(self, capacity: int = 2048):
        self._lock = threading.Lock()
        self._ring: collections.deque[dict] = collections.deque(maxlen=capacity)
        self._seq = 0
        self._path: str | None = None
        self._meta: dict = {}
        self._prev_excepthook = None

    # -- configuration -------------------------------------------------------

    def configure(self, path: str, install_excepthook: bool = True,
                  **meta) -> str:
        """Set the dump destination (process-suffixed on multi-host) and
        chain the crash hook. Re-configurable: a later run in the same
        process re-points the dump. Returns the resolved path."""
        rank, world = process_rank()
        if world > 1:
            root, ext = os.path.splitext(path)
            path = f"{root}_p{rank}{ext or '.json'}"
        with self._lock:
            self._path = path
            self._meta.update(json_safe(meta) or {})
        if install_excepthook:
            self.install_excepthook()
        return path

    @property
    def path(self) -> str | None:
        return self._path

    def install_excepthook(self) -> None:
        """Dump on any unhandled exception, then chain to the previous
        hook (idempotent)."""
        if self._prev_excepthook is not None:
            return
        prev = sys.excepthook

        def hook(exc_type, exc, tb):
            try:
                self.record(
                    "unhandled_exception", error=repr(exc),
                    where="".join(traceback.format_tb(tb))[-2000:],
                )
                self.dump(reason=f"crash:{exc_type.__name__}")
            except Exception:
                pass  # the original traceback must still print
            prev(exc_type, exc, tb)

        self._prev_excepthook = prev
        sys.excepthook = hook

    def uninstall_excepthook(self) -> None:
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None

    # -- recording -----------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """Append one event. Always cheap, always safe: recording must
        never be the thing that kills the run it is documenting."""
        event = {
            "seq": 0,  # patched under the lock
            "t": time.time(),
            "mono": time.monotonic(),
            "kind": kind,
        }
        if fields:
            event.update(json_safe(fields))
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._ring.append(event)

    def events(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        return out

    def scoped(self, component: str, **identity) -> "ScopedFlightRecorder":
        """A recording view that stamps owner identity on every event.

        The recorder is a process singleton, so a multi-replica fleet or
        a per-role disagg front interleaves events with no owner unless
        each component stamps itself. ``identity`` values may be
        callables, evaluated at record time — a replica learns its
        ``replica_id`` AFTER construction (the router assigns it), so
        ``scoped("engine", replica_id=lambda: self.replica_id)`` stays
        correct without re-scoping. Explicit fields passed to ``record``
        win over the scope's."""
        return ScopedFlightRecorder(self, component, identity)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- dumping -------------------------------------------------------------

    def dump(self, path: str | None = None, reason: str = "manual") -> str | None:
        """Atomic dump (tmp + os.replace). Returns the written path, or
        None when no destination is configured. Never raises: a failed
        post-mortem write must not mask the original failure."""
        path = path or self._path
        if path is None:
            return None
        try:
            with self._lock:
                payload = {
                    "reason": reason,
                    "dumped_at": time.time(),
                    "pid": os.getpid(),
                    "meta": dict(self._meta),
                    "n_events": len(self._ring),
                    "events": list(self._ring),
                }
            # Unique per dump, not just per pid: every trigger runs on the
            # main thread, and a signal-handler dump can interleave with
            # an in-progress one (Python handlers run between bytecodes) —
            # a SHARED tmp name would let the handler truncate the inode
            # the interrupted dump still writes through, corrupting the
            # very post-mortem this file exists to protect.
            tmp = f"{path}.tmp.{os.getpid()}.{next(_DUMP_IDS)}"
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            return path
        except Exception:
            return None


class ScopedFlightRecorder:
    """Identity-stamping view over a `FlightRecorder` (see
    :meth:`FlightRecorder.scoped`). Only the recording/reading surface —
    configure/dump stay on the singleton, which owns the destination."""

    __slots__ = ("_inner", "_component", "_identity")

    def __init__(self, inner: FlightRecorder, component: str,
                 identity: dict):
        self._inner = inner
        self._component = component
        self._identity = dict(identity)

    def scoped(self, component: str, **identity) -> "ScopedFlightRecorder":
        """Narrow further (a front scopes per worker): inherited identity
        merges under the new fields."""
        return ScopedFlightRecorder(
            self._inner, component, {**self._identity, **identity}
        )

    def record(self, kind: str, **fields) -> None:
        stamp = {
            k: (v() if callable(v) else v)
            for k, v in self._identity.items()
        }
        # Explicit fields win over the scope's (incl. "component").
        self._inner.record(
            kind, **{"component": self._component, **stamp, **fields}
        )

    def events(self, kind: str | None = None) -> list[dict]:
        return self._inner.events(kind)

    def dump(self, path: str | None = None,
             reason: str = "manual") -> str | None:
        return self._inner.dump(path, reason)


_RECORDER = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    """The process-wide recorder (signal handlers reach it
    without plumbing)."""
    return _RECORDER
