"""Logging and experiment tracking (port of genrec_tpu/core/logging.py,
the part the trainers and the serving engine run): ``setup_logger``,
``log_occupancy``, ``log_serving_stats`` and ``Tracker``. The port's Tracker writes ``<save_dir>/metrics.jsonl`` only:
forwarding to wandb is not ported, and asking for it logs a warning."""

from __future__ import annotations

import json
import logging
import math
import os
import sys
import time
from typing import Any, Mapping


def setup_logger(save_dir: str | None = None,
                 name: str = "genrec_tpu_torch") -> logging.Logger:
    """Process-wide logger; each new ``save_dir`` gets its own train.log
    file handler, repeated calls for an attached path are no-ops."""
    logger = logging.getLogger(name)
    logger.propagate = False  # avoid duplicate lines via the root logger
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(save_dir, "train.log"))
        attached = {
            getattr(h, "baseFilename", None)
            for h in logger.handlers
            if isinstance(h, logging.FileHandler)
        }
        if path not in attached:
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def log_occupancy(logger, tracker, epoch: int, real_tokens: float,
                  slot_tokens: float) -> float:
    """Per-epoch packed-batch occupancy (real tokens / padded slots).
    Returns the occupancy fraction."""
    occ = float(real_tokens) / max(float(slot_tokens), 1.0)
    logger.info(
        f"epoch {epoch} batch occupancy {occ:.1%} "
        f"({int(real_tokens)} real tokens / {int(slot_tokens)} slots)"
    )
    tracker.log({
        "epoch": epoch,
        "perf/occupancy": occ,
        "perf/real_tokens": float(real_tokens),
        "perf/slot_tokens": float(slot_tokens),
    })
    return occ


def log_serving_stats(logger, tracker, stats: Mapping[str, Any]) -> None:
    """Per-interval serving health line + tracker forwarding.

    ``stats`` is a ServingEngine.stats() snapshot. One human-readable
    line (QPS + the three latency percentiles + recompile count — the
    fields an operator scans first) goes to the logger; the full flattened
    snapshot goes to the tracker under the ``serve/`` namespace so wandb /
    metrics.jsonl dashboards get every counter."""
    t = stats.get("total_ms", {})
    logger.info(
        f"serving: qps={stats.get('qps', 0):.1f} "
        f"p50={t.get('p50', 0):.1f}ms p95={t.get('p95', 0):.1f}ms "
        f"p99={t.get('p99', 0):.1f}ms completed={stats.get('completed', 0)} "
        f"rejected={stats.get('rejected', 0)} "
        f"recompilations={stats.get('recompilations', 0)} "
        f"step={stats.get('params_step')}"
    )
    # Admit/evict/OOM-deferral counters are ENGINE totals (the metrics
    # layer does not attribute them per head): one engine-level line, so
    # they can never read as belonging to whichever head's pool line they
    # used to be printed inside.
    if stats.get("kv_pool"):
        logger.info(
            f"serving paged engine totals: admits={stats.get('admits', 0)} "
            f"evictions={stats.get('evictions', 0)} "
            f"oom_deferred={stats.get('oom_deferred_admits', 0)} "
            f"decode_steps={stats.get('decode_steps', 0)}"
        )
    # Paged decode heads: one pool-pressure line per head (pages + slot
    # occupancy + churn), so an operator sees "pool-bound" vs "idle" at a
    # glance — the day-one gauges the paged KV cache ships with.
    for head, g in (stats.get("kv_pool") or {}).items():
        logger.info(
            f"serving kv-pool[{head}]: pages {g.get('pages_in_use', 0)}/"
            f"{g.get('pages_in_use', 0) + g.get('pages_free', 0)} in use, "
            f"slots {g.get('slots_active', 0)}/{g.get('slots_total', 0)}, "
            f"kv_tokens={g.get('kv_tokens_resident', 0)}"
        )
    # Cross-request prefix cache: one line per head — warm-hit rate, KV
    # tokens served without prefill, index size, and retained-page HBM —
    # so "is repeat traffic actually landing warm" reads off the same
    # interval line as the pool gauges.
    for head, g in (stats.get("prefix_cache") or {}).items():
        lookups = g.get("lookups", 0)
        hits = g.get("hits", 0)
        rate = 100.0 * hits / lookups if lookups else 0.0
        logger.info(
            f"serving prefix-cache[{head}]: {hits}/{lookups} warm hits "
            f"({rate:.1f}%), warm_tokens={g.get('warm_tokens', 0)}, "
            f"entries={g.get('entries', 0)}, retained "
            f"{g.get('retained_pages', 0)} pages "
            f"({g.get('retained_bytes', 0) / 2**20:.2f} MB), "
            f"evictions={g.get('evictions', 0)} "
            f"invalidations={g.get('invalidations', 0)}"
        )
    # Speculative tree decode: one line per spec head — codes committed
    # per target invocation (1.0 == plain decode), draft acceptance, and
    # the accept-length histogram — so "is speculation actually paying"
    # reads off the same interval line as the pool gauges.
    for head, g in (stats.get("spec") or {}).items():
        slot_steps = g.get("slot_steps", 0)
        accepted = g.get("accepted", 0)
        hist = ",".join(
            f"{k.rsplit('_', 1)[-1]}:{v}"
            for k, v in sorted((g.get("accept_len_hist") or {}).items())
        )
        logger.info(
            f"serving spec[{head}]: {g.get('codes_per_invocation', 0.0):.2f} "
            f"codes/invocation ({accepted} codes over {slot_steps} "
            f"slot-steps in {g.get('spec_steps', 0)} invocations; "
            f"{accepted - slot_steps} speculated codes accepted, "
            f"{g.get('drafted', 0)} tree tokens drafted), "
            f"accept_len[{hist}]"
        )
    # Device-memory ledger (obs/memory.py): one HBM line per head —
    # ledger total vs the declared budget with headroom %, so "how close
    # to OOM is this replica" reads off the same interval line as the
    # pool gauges.
    hbm = stats.get("hbm") or {}
    budget = hbm.get("budget_bytes")
    for head, h in (hbm.get("heads") or {}).items():
        total = h.get("total_bytes", 0)
        line = (
            f"serving hbm[{head}]: {total / 2**20:.2f} MB "
            f"(operands {h.get('operand_bytes', 0) / 2**20:.2f} MB + "
            f"transient peak {h.get('transient_peak_bytes', 0) / 2**20:.2f} MB"
            f" across {h.get('n_executables', 0)} executables)"
        )
        if budget:
            line += (
                f", budget {budget / 2**20:.1f} MB, "
                f"headroom {hbm.get('headroom_pct', 0.0):.1f}%"
            )
        logger.info(line)
    # SLO shed state: one line while any head is ACTIVELY shedding
    # (gating on the lifetime overload counter would log forever after
    # the first episode; the counter still reaches dashboards via the
    # tracker flatten below).
    slo = stats.get("slo")
    if slo:
        shed = [h for h, s in (slo.get("heads") or {}).items()
                if s.get("shedding")]
        if shed:
            logger.info(
                f"serving slo: shedding={sorted(shed)} "
                f"overload_rejected={stats.get('overload_rejected', 0)}"
            )

    def _flatten(prefix: str, tree: Mapping, out: dict) -> None:
        for k, v in tree.items():
            if isinstance(v, Mapping):
                _flatten(f"{prefix}{k}/", v, out)
            elif isinstance(v, (int, float)):
                out[f"{prefix}{k}"] = v

    flat: dict[str, Any] = {}
    _flatten("serve/", stats, flat)
    tracker.log(flat)


def _json_value(v):
    """Floats as JSON allows them: NaN and infinities become null."""
    if hasattr(v, "__float__") and not isinstance(v, (bool, int, str)):
        v = float(v)
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class Tracker:
    """Metric tracker writing ``<save_dir>/metrics.jsonl`` (one JSON object
    per ``log`` call, non-finite floats as null)."""

    def __init__(self, enabled: bool = False, project: str = "genrec_tpu_torch",
                 save_dir: str | None = None, logger: logging.Logger | None = None):
        self._file = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self._file = open(os.path.join(save_dir, "metrics.jsonl"), "a")
        if enabled and logger is not None:
            logger.warning(f"wandb forwarding (project {project!r}) is not ported; "
                           "metrics go to metrics.jsonl only")

    def log(self, metrics: Mapping[str, Any]) -> None:
        if self._file:
            line = {"t": time.time(), **{k: _json_value(v) for k, v in metrics.items()}}
            self._file.write(json.dumps(line, allow_nan=False) + "\n")
            self._file.flush()

    def finish(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
