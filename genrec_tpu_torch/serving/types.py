"""Typed request/response surface of the serving engine (port of
genrec_tpu/serving/types.py, the fields the paged heads and the
retrieval heads fill, and ``normalize_spec_config``).

A `Request` names a head and carries the user's item-id history (oldest
first); the engine answers with a `Response` holding the top-k items,
their scores, the catalog version and bucket that served them, and the
per-request latency breakdown (queue wait / compute / total).
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
