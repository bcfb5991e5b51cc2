"""Throughput metering and the profiling window (port of
genrec_tpu/core/profiling.py: ``StepTimer``, ``log_epoch_perf`` and
``ProfileWindow``). One device, so the per-chip rates equal the totals
and are not repeated. ``ProfileWindow`` is a ``torch.profiler`` window
where the JAX one is a ``jax.profiler`` trace: the host's activity and,
with a card, its kernels, written as a Chrome trace."""

from __future__ import annotations

import os
import time

import torch


def synchronize(device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Throughput meter that starts after ``skip_first`` ticks (the first
    step pays for kernel builds and allocator warm-up). Ticks do not
    block: the caller synchronises before reading ``summary``."""

    def __init__(self, batch_size: float, skip_first: int = 1):
        self.batch_size = batch_size
        self.skip_first = skip_first
        self._count = 0
        # skip_first=0 means "time from construction".
        self._t0 = time.perf_counter() if skip_first == 0 else None

    def tick(self) -> None:
        self._count += 1
        if self._count == self.skip_first:
            self._t0 = time.perf_counter()

    def summary(self) -> dict:
        timed = self._count - self.skip_first
        if self._t0 is None or timed <= 0:
            return {"steps_per_sec": 0.0, "seq_per_sec": 0.0}
        dt = time.perf_counter() - self._t0
        return {
            "steps_per_sec": timed / dt,
            "seq_per_sec": timed * self.batch_size / dt,
        }


def log_epoch_perf(logger, tracker, epoch, epoch_loss, n_batches, timer, device,
                   tokens_per_step: float | None = None) -> float:
    """Epoch-end summary: wait for the device once (closing the timing
    window), log loss and throughput, feed the Tracker. ``epoch_loss`` is
    the device scalar summed over the epoch's steps. Returns the mean
    loss."""
    synchronize(device)
    perf = timer.summary()
    if tokens_per_step is not None:
        perf["tokens_per_sec"] = perf["steps_per_sec"] * tokens_per_step
    mean_loss = float(epoch_loss) / n_batches if n_batches else 0.0
    extra = f", {perf['tokens_per_sec']:.0f} tok/s" if "tokens_per_sec" in perf else ""
    logger.info(f"epoch {epoch} loss {mean_loss:.4f} [{perf['seq_per_sec']:.1f} seq/s{extra}]")
    tracker.log({
        "epoch": epoch, "train/loss": mean_loss,
        **{f"perf/{k}": v for k, v in perf.items()},
    })
    return mean_loss


class ProfileWindow:
    """Profile ``n_steps`` training steps with ``torch.profiler``, starting
    after ``start`` steps have finished (default 1: skip the first step,
    which builds kernels and warms the allocator), and write the Chrome
    trace to ``<logdir>/trace.json``.

    Trainers construct one unconditionally (``n_steps=0`` or an empty
    logdir disables) and call ``tick(n_finished)`` after each optimizer
    step with the running count of finished steps; ``close()`` stops and
    writes a window still open when the run ends early."""

    def __init__(self, logdir: str, n_steps: int = 0, start: int = 1):
        self.logdir = logdir
        self.n_steps = n_steps
        self.start = start
        self._state = "idle" if (n_steps > 0 and logdir) else "done"
        self._prof = None

    @property
    def trace_path(self) -> str:
        return os.path.join(self.logdir, "trace.json")

    def tick(self, n_finished: int) -> None:
        """Call after each step with the 1-based count of finished steps."""
        if self._state == "idle" and n_finished >= self.start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self._state = "on"
        elif self._state == "on" and n_finished >= self.start + self.n_steps:
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self._state = "done"

    def close(self) -> None:
        if self._state == "on":
            self._stop()
        self._state = "done"
