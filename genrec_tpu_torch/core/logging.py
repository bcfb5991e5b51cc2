"""Logging and experiment tracking (port of genrec_tpu/core/logging.py,
the part the trainers run): ``setup_logger``, ``log_occupancy`` and
``Tracker``. The port's Tracker writes ``<save_dir>/metrics.jsonl`` only:
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
