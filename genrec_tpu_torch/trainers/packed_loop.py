"""The step-granular train loop (port of genrec_tpu/trainers/packed_loop.py,
the part the HSTU slice runs): the per-epoch repack, the shuffled batch
iterator prefetched to the device, device-scalar loss and real-token
sums (read once per epoch), ``max_steps``, the examples-per-step timer
and the occupancy line.

Not ported yet (ROADMAP A12): preemption polling and resume points
(``resume`` and ``save`` raise), chaos hooks, ``NonFiniteMonitor``,
goodput buckets and the flight recorder.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from genrec_tpu_torch.core.logging import log_occupancy
from genrec_tpu_torch.core.profiling import StepTimer, log_epoch_perf
from genrec_tpu_torch.data.batching import batch_iterator, prefetch_to_device

_NOT_PORTED = ("resume points (exact resume, checkpoint save) are not ported yet: "
               "ROADMAP A12, fault tolerance of the trainers")


@dataclasses.dataclass
class EpochResult:
    state: Any
    global_step: int
    n_batches: int


class PackedTrainLoop:
    """Owns epoch execution for one trainer; the trainer keeps eval and
    best-model tracking.

    ``repack(epoch) -> (arrays, PackingReport)`` is called lazily per
    epoch when ``pack_sequences``; otherwise ``train_arrays`` is the fixed
    padded layout. ``rows_per_step`` is the batch rows consumed per
    optimizer step. ``step_hook(state, metrics, global_step)`` runs after
    every step (the caller's own timing or logging)."""

    def __init__(self, *, logger, tracker, device, rows_per_step: int, row_len: int,
                 seed: int, pack_sequences: bool,
                 repack: Callable[[int], tuple[dict, Any]] | None = None,
                 train_arrays: dict | None = None, wandb_log_interval: int = 100,
                 step_hook: Callable[[Any, dict, int], None] | None = None):
        if pack_sequences and repack is None:
            raise ValueError("pack_sequences=True needs a repack closure")
        if not pack_sequences and train_arrays is None:
            raise ValueError("pack_sequences=False needs train_arrays")
        self.logger = logger
        self.tracker = tracker
        self.device = torch.device(device)
        self.rows_per_step = rows_per_step
        self.row_len = row_len
        self.seed = seed
        self.pack_sequences = pack_sequences
        self._repack = repack
        self.wandb_log_interval = wandb_log_interval
        self.step_hook = step_hook
        self._ran_epoch = False
        self._arrays = train_arrays
        self._arrays_epoch: int | None = None
        self._report = None

    def _arrays_for(self, epoch: int) -> dict:
        if self.pack_sequences and self._arrays_epoch != epoch:
            self._arrays, rep = self._repack(epoch)
            self._arrays_epoch = epoch
            if self._report is None:
                # Rates only: the example multiset is epoch-invariant.
                self._report = rep
                self.logger.info(str(rep))
        return self._arrays

    @property
    def pack_report(self):
        if self.pack_sequences and self._report is None:
            self._arrays_for(0)
        return self._report

    @property
    def examples_per_step(self) -> float:
        """Mean examples per optimizer step: packed rows hold several
        examples, so seq/s keeps meaning sequences, not rows."""
        if self.pack_sequences:
            rep = self.pack_report
            return self.rows_per_step * rep.n_examples / rep.n_rows
        return float(self.rows_per_step)

    def resume(self, state_like, place_fn=None):
        raise NotImplementedError(_NOT_PORTED)

    def save(self, state, *, epoch: int, next_batch: int, global_step: int,
             wait: bool = False) -> None:
        raise NotImplementedError(_NOT_PORTED)

    def shutdown(self) -> None:
        self.tracker.finish()

    def run_epoch(self, state, step_fn, epoch: int, global_step: int,
                  start_batch: int = 0, max_steps: int | None = None) -> EpochResult:
        """One epoch (or its remainder from ``start_batch``). ``max_steps``
        stops before the batch that would push ``global_step`` past it."""
        arrays = self._arrays_for(epoch)
        timer = StepTimer(self.examples_per_step, skip_first=0 if self._ran_epoch else 1)
        self._ran_epoch = True
        epoch_loss, epoch_tokens, n_batches = None, None, 0
        batches = prefetch_to_device(
            batch_iterator(arrays, self.rows_per_step, shuffle=True, seed=self.seed,
                           epoch=epoch, drop_last=True, start_batch=start_batch),
            self.device,
        )
        for batch, _ in batches:
            if max_steps is not None and global_step >= max_steps:
                break
            state, m = step_fn(state, batch)
            # Guard-skipped steps add 0 to the epoch sum: one NaN batch
            # must not turn the epoch summary NaN (select, don't scale).
            loss = m["loss"]
            if "nonfinite" in m:
                loss = torch.where(m["nonfinite"] > 0, 0.0, loss)
            epoch_loss = loss if epoch_loss is None else epoch_loss + loss
            if "real_tokens" in m:
                tok = m["real_tokens"]
                epoch_tokens = tok if epoch_tokens is None else epoch_tokens + tok
            timer.tick()
            n_batches += 1
            global_step += 1
            if global_step % self.wandb_log_interval == 0:
                self.tracker.log({"global_step": global_step, "train/loss": float(m["loss"])})
            if self.step_hook is not None:
                self.step_hook(state, m, global_step)
        if n_batches:
            log_epoch_perf(
                self.logger, self.tracker, epoch, epoch_loss, n_batches, timer, self.device,
                tokens_per_step=(float(epoch_tokens) / n_batches
                                 if epoch_tokens is not None else None),
            )
            if epoch_tokens is not None:
                log_occupancy(self.logger, self.tracker, epoch, float(epoch_tokens),
                              n_batches * self.rows_per_step * self.row_len)
        return EpochResult(state, global_step, n_batches)
