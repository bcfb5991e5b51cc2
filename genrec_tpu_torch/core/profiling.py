"""Throughput metering (port of genrec_tpu/core/profiling.py:
``StepTimer`` and ``log_epoch_perf``). One device, so the per-chip rates
equal the totals and are not repeated."""

from __future__ import annotations

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
