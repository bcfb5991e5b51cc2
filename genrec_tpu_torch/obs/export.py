"""Prometheus-style text exposition of a metrics snapshot (port of
genrec_tpu/obs/export.py: the same names, types and bytes for the same
snapshot).

The engine's `stats()` and the goodput reports are nested dicts; wandb /
metrics.jsonl consumers flatten them already (`core.logging`), but a
fleet scrape wants the OpenMetrics text format. `prometheus_text` turns
any nested numeric mapping into exposition lines:

    serve/total_ms/p99 -> genrec_serve_total_ms_p99

Counters (monotonic lifetime totals — the engine's request/admit/compile
counts) get ``# TYPE ... counter``; everything else is a gauge. No
client library, no HTTP server: serving a scrape endpoint is one
`write_prometheus` per stats interval plus any static file server, which
is exactly what a sidecar-less serving host can afford.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Mapping

#: Leaf names that are monotonic lifetime totals in the engine /
#: goodput snapshots. Matched against the FINAL path component. The set is
#: the JAX package's, whole (its fleet, disaggregation, rollout and tenancy
#: leaves too), so both packages type the same snapshot the same way.
_COUNTER_LEAVES = frozenset({
    "submitted", "completed", "rejected", "failed", "batches",
    "warmup_compiles", "recompilations", "params_swaps", "admits",
    "evictions", "oom_deferred_admits", "decode_steps", "count", "steps",
    "catalog_swaps", "catalog_compiles", "overload_rejected", "breaches",
    # Prefix-cache lifetime totals (genrec_prefix_cache_<head>_*); the
    # entries/retained_pages/retained_bytes leaves stay gauges.
    "lookups", "hits", "partial_hits", "misses", "warm_tokens",
    "insertions", "invalidations",
    # Fleet-front lifetime totals (genrec_fleet_*, fleet/router.py +
    # fleet/autoscaler.py); replicas_alive / headroom leaves stay gauges.
    "routed", "rerouted", "fleet_shed_rejected", "replica_deaths",
    "replicas_added", "replicas_drained", "scale_outs", "scale_ins",
    # Disaggregated-serving lifetime totals;
    # pending_handoffs / occupancy / transfer_ms percentiles / per-role
    # headroom leaves stay gauges.
    "handoffs_sent", "handoffs_admitted", "handoffs_refused",
    "handoffs_resubmitted", "transfer_bytes", "decode_worker_deaths",
    "prefill_worker_deaths", "prefills", "deferred", "admitted",
    # Per-transport wire totals (disagg/net.py socket backend + the
    # serializing tier's stats() section); in_flight_frames and the
    # serialize_ms/network_ms percentile leaves stay gauges.
    "frames_sent", "frames_admitted", "frames_refused", "wire_bytes",
    "receipts", "connects", "connect_retries", "peer_losses",
    # Socket-tier self-healing totals (disagg/net.py reconnect machinery
    # + front.py degraded mode); the `reconnecting` / `degraded_heads`
    # leaves stay gauges.
    "reconnects", "heartbeat_misses", "incarnation_discards",
    "degraded_entered", "degraded_exited",
    # Speculative tree decode (genrec_spec_<head>_*): invocation/drafted/
    # accepted/slot-step totals; codes_per_invocation stays a gauge.
    "spec_steps", "drafted", "accepted", "slot_steps",
    # Tracer self-metering (SpanTracer.stats(), the "tracing" section of
    # engine/front stats): lifetime recording totals; ring occupancy/
    # capacity/enabled stay gauges.
    "spans_recorded", "traces_started",
    # Checkpoint-watcher robustness + guarded rollout
    # (serving/rollout.RolloutController.stats() under "rollout", and
    # the engine's watcher_errors): failed poll passes and the
    # staged/promoted/vetoed/rolled-back decision totals. The
    # last_good_step / canary_step / freshness_s / quarantined_steps
    # leaves stay gauges.
    "watcher_errors", "staged", "promotions", "vetoes", "rollbacks",
    # Multi-tenant front (stats()["tenancy"] +
    # ["experiments"]): per-tenant admission/shed/mirror and per-arm
    # routing totals. The inflight / p99_ms / shedding / split leaves
    # stay gauges.
    "shed", "shadow_mirrored", "exp_arm_a", "exp_arm_b",
    "routed_a", "routed_b", "shadow_errors", "shadow_mismatches",
}) | frozenset(
    # Accept-length histogram leaves (genrec_spec_<head>_accept_len_hist
    # _accept_len_N): one bucket per possible accept length — depth is
    # bounded by the sem-id tuple length, so 16 covers any real head.
    f"accept_len_{n}" for n in range(1, 17)
)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _flatten(prefix: str, tree: Mapping, out: dict) -> None:
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            _flatten(key, v, out)
        elif isinstance(v, bool):
            out[key] = 1.0 if v else 0.0
        elif isinstance(v, (int, float)):
            out[key] = float(v)


def _metric_name(path: str, namespace: str) -> str:
    name = _NAME_RE.sub("_", f"{namespace}_{path.replace('/', '_')}")
    if name and name[0].isdigit():
        name = f"_{name}"
    return name


def prometheus_text(snapshot: Mapping[str, Any], namespace: str = "genrec") -> str:
    """Exposition text for a nested numeric snapshot. Non-numeric leaves
    are skipped; non-finite values are skipped (Prometheus accepts NaN
    but a scraped NaN gauge only poisons dashboards)."""
    flat: dict[str, float] = {}
    _flatten("", snapshot, flat)
    lines: list[str] = []
    for path in sorted(flat):
        value = flat[path]
        if not math.isfinite(value):
            continue
        name = _metric_name(path, namespace)
        kind = "counter" if path.rsplit("/", 1)[-1] in _COUNTER_LEAVES else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        text = repr(int(value)) if value == int(value) else repr(value)
        lines.append(f"{name} {text}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str, snapshot: Mapping[str, Any],
                     namespace: str = "genrec") -> str:
    """Atomic write of the exposition text (a static-file scrape target)."""
    text = prometheus_text(snapshot, namespace)
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)
    return path
