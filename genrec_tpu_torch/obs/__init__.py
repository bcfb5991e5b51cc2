"""Observability layer of the port (genrec_tpu/obs): spans, flight
recorder, SLO monitor, Prometheus export, the device-memory ledger and
the trainers' goodput meter.

- `spans`           — request-scoped tracer, Chrome-trace export
- `flight_recorder` — bounded structured-event ring dumped atomically on
                      SIGTERM / crash
- `export`          — Prometheus-style text exposition of any snapshot
- `memory`          — device-memory ledger: resident operands + measured
                      call transients summed into a budget model
- `slo`             — declared per-head SLO targets, sustained-breach
                      detection, load-shed/recover hysteresis
- `goodput`         — a training run's wall time by bucket (compute,
                      checkpoint save, restore, data wait, ...)

Layering: `obs` imports nothing from core/trainers/serving (torch only,
lazily), so every layer above may use it freely.
"""

from genrec_tpu_torch.obs.export import prometheus_text, write_prometheus
from genrec_tpu_torch.obs.flight_recorder import (
    FlightRecorder,
    ScopedFlightRecorder,
    get_flight_recorder,
    json_safe,
)
from genrec_tpu_torch.obs.goodput import GoodputMeter, fleet_goodput
from genrec_tpu_torch.obs.memory import MemoryLedger, device_memory_stats, tree_nbytes
from genrec_tpu_torch.obs.slo import SLOMonitor, SLOTarget
from genrec_tpu_torch.obs.spans import NULL_TRACER, Span, SpanTracer, TraceContext

__all__ = [
    "FlightRecorder",
    "GoodputMeter",
    "MemoryLedger",
    "NULL_TRACER",
    "SLOMonitor",
    "SLOTarget",
    "ScopedFlightRecorder",
    "Span",
    "SpanTracer",
    "TraceContext",
    "device_memory_stats",
    "fleet_goodput",
    "get_flight_recorder",
    "json_safe",
    "prometheus_text",
    "tree_nbytes",
    "write_prometheus",
]
