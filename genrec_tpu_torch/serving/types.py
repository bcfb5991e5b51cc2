"""Typed request/response surface of the serving engine (port of
genrec_tpu/serving/types.py, the fields the paged TIGER path and the
retrieval heads fill).

A `Request` names a head and carries the user's item-id history (oldest
first); the engine answers with a `Response` holding the top-k items,
their scores, the catalog version and bucket that served them, and the
per-request latency breakdown (queue wait / compute / total).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class ServingError(RuntimeError):
    """Base class for engine-surface errors."""


class DrainingError(ServingError):
    """The engine is draining (`stop()` was called): every accepted
    request completes, new submissions are rejected with this error so
    callers can fail over."""


class UnknownHeadError(ServingError, KeyError):
    """Request names a head the engine was not built with."""


@dataclasses.dataclass
class Request:
    """One user query. ``history``: (n,) int item ids, oldest -> newest;
    histories longer than the largest history bucket keep their NEWEST
    items. ``timestamps``: (n,) int seconds aligned with ``history``, read
    by heads with ``use_timestamps`` (HSTU's temporal bias)."""

    head: str
    history: np.ndarray
    user_id: int = 0
    timestamps: Optional[np.ndarray] = None


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
    #: Content-hash version of the CatalogSnapshot that answered.
    catalog_version: Optional[str] = None
