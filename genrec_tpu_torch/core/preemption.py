"""Catch SIGTERM/SIGINT once and let the owner finish cleanly (port of
genrec_tpu/core/preemption.py: ``PreemptionGuard``).

Fleets preempt: maintenance events and spot reclaims deliver SIGTERM
with a grace window. The guard latches that signal so the owner can end
at its next poll point instead of dying mid-work: the serving engine
(serving/engine.py, ``handle_signals=True``) drains — every accepted
request is answered, new submissions raise ``DrainingError`` — and a
trainer would checkpoint and exit (its resume points are ROADMAP A12).

Polling `fired` is a lock-free Event read — cheap enough for per-step
checks even at millisecond step times.
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Latches the first SIGTERM/SIGINT; restores prior handlers on close.

    Both signals latch by default: fleets deliver SIGTERM for
    maintenance/spot reclaims, and an operator ^C (SIGINT) deserves the
    same clean ending instead of a stack trace mid-write.

    The latch is ONE-SHOT: the first signal restores the previous
    handlers immediately, so a second ^C / SIGTERM falls through to them
    (default: KeyboardInterrupt / terminate) — a run hung between poll
    points, or a guard left installed by an aborted run, can always be
    escalated without SIGKILL. Checkpoint commits are atomic (a step
    directory is renamed into place after its commit marker is written),
    so an escalated kill mid-save never leaves a committed corrupt step.

    Installs only in the main thread (signal.signal raises elsewhere —
    e.g. when an engine starts inside a worker thread); off the main
    thread the guard is inert and `fired` stays False.
    """

    def __init__(self, logger=None, signals=(signal.SIGTERM, signal.SIGINT)):
        self._fired = threading.Event()
        self._logger = logger
        self._prev = {}
        if threading.current_thread() is threading.main_thread():
            for sig in signals:
                self._prev[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum, frame):
        if self._logger is not None:
            self._logger.warning(
                f"signal {signal.Signals(signum).name}: finishing at the "
                "next poll point, then exiting cleanly (send again to "
                "force the previous handler)"
            )
        self._fired.set()
        self.close()  # one-shot: next signal falls through
        # Flight recorder: the signal is the event every post-mortem
        # starts from, so record + dump NOW — the grace window may not
        # reach another dump point. Python runs handlers in the main
        # bytecode loop, so the file write here is ordinary code.
        try:
            from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder

            rec = get_flight_recorder()
            name = signal.Signals(signum).name
            rec.record("signal", signum=int(signum), name=name)
            rec.dump(reason=f"signal:{name}")
        except Exception:
            pass  # the latch must survive any recorder failure

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    def close(self) -> None:
        """Restore the previous handlers (tests / nested trainers)."""
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}
