"""CatalogWatcher: hot catalog swap for the serving engine (port of
genrec_tpu/serving/catalog.py).

The catalog-side twin of the params hot-reload watcher in engine.py: a
daemon thread polls a snapshot directory for new
``catalog-<version>.npz`` files (written atomically by
`catalog.CatalogSnapshot.save` — a half-written file never appears under
the final name), loads + integrity-verifies the newest one, and stages
it through `ServingEngine.stage_catalog`. From there the engine's
batcher applies it BETWEEN micro-batches, after paged decode slots
drain, so a new catalog becomes visible to constrained decode within a
poll interval, without any request ever mixing two catalog versions.

Failure containment mirrors the checkpoint integrity ladder: a file that
fails to load or whose content hash does not match its recorded version
is QUARANTINED (moved to ``<dir>/quarantine/``) with a flight-recorder
event, and the engine keeps serving the previous catalog. A snapshot the
head rejects (wrong depth/codebook/tower dim — the model cannot decode
against it) is quarantined the same way: it can never become
servable by retrying. Snapshot files are the JAX package's format, so
either package's watcher reads the other's publications.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from genrec_tpu_torch.catalog.snapshot import (
    CatalogIntegrityError,
    CatalogSnapshot,
    list_snapshots,
)
from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder


class CatalogWatcher:
    """Polls one snapshot directory for one catalog head."""

    def __init__(self, engine, head_name: str, directory: str, *,
                 poll_secs: float = 2.0,
                 logger: Optional[logging.Logger] = None):
        self.engine = engine
        self.head_name = head_name
        self.directory = directory
        self.poll_secs = poll_secs
        self._log = logger or logging.getLogger("genrec_tpu_torch")
        self._flight = get_flight_recorder()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Files already handled (staged, rejected, or quarantined-and-
        # moved-back-by-an-operator): basename -> outcome, so one bad file
        # is reported once, not once per poll.
        self._seen: dict[str, str] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "CatalogWatcher":
        if self._thread is not None:
            raise RuntimeError("catalog watcher already started")
        self._thread = threading.Thread(
            target=self._loop,
            name=f"serving-catalog-watcher-{self.head_name}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- polling -------------------------------------------------------------

    def _loop(self) -> None:
        # One immediate pass (a snapshot published before start() should
        # not wait a full poll interval), then the poll cadence.
        while True:
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — keep serving on watcher errors
                self._log.exception(
                    f"serving: catalog watcher pass failed ({self.head_name})"
                )
            if self._stop.wait(self.poll_secs):
                return

    def check_once(self) -> bool:
        """One poll pass: stage the newest STAGEABLE snapshot. Walks
        newest-first past files already handled (staged, quarantined, or
        unmovable-bad) so one bad newest file — even one that cannot be
        moved out of a read-only directory — never blocks an older valid
        snapshot. Returns True when a snapshot was staged."""
        live = self.engine.catalog_version(self.head_name)
        staged = self.engine.staged_catalog_version(self.head_name)
        for path in reversed(list_snapshots(self.directory)):
            name = os.path.basename(path)
            status = self._seen.get(name)
            if status in ("staged", "current"):
                # The newest GOOD file is already in effect; anything
                # older would regress the catalog backwards.
                return False
            if status:  # quarantined/bad: keep looking at older files
                continue
            try:
                snapshot = CatalogSnapshot.load(path)
            except CatalogIntegrityError as e:
                self._quarantine(path, str(e))
                continue
            if snapshot.version in (live, staged):
                self._seen[name] = "current"
                return False
            try:
                staged_now = self.engine.stage_catalog(self.head_name, snapshot)
            except ValueError as e:
                # Head rejected the snapshot (depth/codebook/tower-dim
                # mismatch): retrying can never fix it — quarantine.
                self._quarantine(path, f"rejected by head: {e}")
                continue
            self._seen[name] = "staged"
            return staged_now
        return False

    def _quarantine(self, path: str, reason: str) -> None:
        qdir = os.path.join(self.directory, "quarantine")
        dest = os.path.join(qdir, os.path.basename(path))
        try:
            os.makedirs(qdir, exist_ok=True)
            os.replace(path, dest)
            moved = True
        except OSError:
            # Move race (another process got it) or read-only dir: mark
            # seen so the bad file is not re-reported every poll.
            moved = False
        self._seen[os.path.basename(path)] = "quarantined"
        self._flight.record(
            "catalog_quarantined", head=self.head_name,
            file=os.path.basename(path), reason=reason[:200], moved=moved,
        )
        self._log.warning(
            f"serving: catalog snapshot {os.path.basename(path)} for head "
            f"{self.head_name} quarantined ({reason}); serving continues on "
            f"catalog {self.engine.catalog_version(self.head_name)}"
        )
