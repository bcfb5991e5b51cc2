"""Typed request/response surface of the serving engine (port of
genrec_tpu/serving/types.py without the disaggregation fields, and
``normalize_spec_config``).

A `Request` names a head and carries the user's item-id history (oldest
first); the engine answers with a `Response` holding the top-k items,
their scores, the params step and catalog version that served them, the
bucket, the request id its spans are keyed by, the replica that
answered, and the per-request latency breakdown (queue wait / compute /
total).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def normalize_spec_config(spec_decode, spec_fanout, head_names):
    """The speculative-decode opt-in of `ServingEngine`: ``spec_decode``
    is True/False or a set of head names (checked against
    ``head_names``), ``spec_fanout`` one int or a per-level tuple. Returns
    (spec_decode, spec_fanout) as (bool | frozenset, int | tuple[int,
    ...])."""
    spec = (
        frozenset(spec_decode)
        if isinstance(spec_decode, (set, frozenset, list, tuple))
        else bool(spec_decode)
    )
    if isinstance(spec, frozenset):
        unknown = [n for n in spec if n not in head_names]
        if unknown:
            raise ValueError(f"spec_decode names unknown heads {unknown}")
    fanout = (
        tuple(int(f) for f in spec_fanout)
        if isinstance(spec_fanout, (tuple, list))
        else int(spec_fanout)
    )
    return spec, fanout


class ServingError(RuntimeError):
    """Base class for engine-surface errors."""


class DrainingError(ServingError):
    """The engine caught SIGTERM/SIGINT (or `stop()` was called) and is
    draining: every accepted request completes, new submissions are
    rejected with this error so callers can fail over."""


class OverloadError(ServingError):
    """The head's SLO monitor is load-shedding (a sustained breach of a
    declared target — p99 latency, queue depth or OOM-deferral rate): new
    submissions are rejected with this error while in-flight and queued
    work completes — the drain discipline, but recoverable: hysteresis
    un-sheds once the targets hold again, so callers back off and retry
    or fail over."""


class HBMBudgetError(ServingError):
    """The memory ledger's model at ``start()`` (the resident operands +
    the largest measured call transient) exceeds the declared
    ``hbm_budget_bytes``: the engine refuses to start instead of letting
    the device discover the OOM under load. The message carries the
    per-component breakdown."""


class UnknownHeadError(ServingError, KeyError):
    """Request names a head the engine was not built with."""


@dataclasses.dataclass
class Request:
    """One user query. ``history``: (n,) int item ids, oldest -> newest;
    histories longer than the largest history bucket keep their NEWEST
    items. ``timestamps``: (n,) int seconds aligned with ``history``, read
    by heads with ``use_timestamps`` (HSTU's temporal bias). ``trace``: an
    upstream component's `obs.TraceContext` (None from a caller): the
    engine adopts its trace id, so the request's spans join one tree."""

    head: str
    history: np.ndarray
    user_id: int = 0
    timestamps: Optional[np.ndarray] = None
    trace: Optional[object] = None


@dataclasses.dataclass
class Response:
    head: str
    items: np.ndarray  # (k,) item ids; -1 for a generative tuple not in corpus
    scores: np.ndarray  # (k,) fp32
    sem_ids: Optional[np.ndarray]  # (k, D) for generative heads
    bucket: tuple[int, int]  # (batch, history) bucket of the prefill
    queue_wait_s: float
    compute_s: float
    total_s: float
    #: Content-hash version of the CatalogSnapshot that answered. Swaps
    #: apply between micro-batches, after the paged slots drain, so ONE
    #: version answers a request.
    catalog_version: Optional[str] = None
    #: Checkpoint step of the params that answered (None until a
    #: versioned params tree is installed); one per request, as above.
    params_step: Optional[int] = None
    #: Trace id minted at submit() when the engine traces (or adopted from
    #: ``Request.trace``): the key of the request's span tree.
    request_id: Optional[str] = None
    #: The answering engine's ``replica_id`` (provenance beside
    #: params_step and catalog_version: A/B across replicas, blame for a
    #: degraded one); None for an engine built without one.
    replica_id: Optional[str] = None
