"""The step-granular train loop (port of genrec_tpu/trainers/packed_loop.py):
one implementation of the per-epoch plumbing every trainer runs —

- the per-epoch repack closure (epoch-seeded `pack_examples`, so example
  co-location re-mixes as the padded layout's per-epoch permutation does);
- the shuffled batch iterator prefetched to the device, device-scalar
  loss and real-token sums (read once per epoch), ``max_steps``;
- the examples-per-step timer and the occupancy line;
- step logging at the tracker's interval and the ProfileWindow ticks —

plus the step-granular fault tolerance:

- the PreemptionGuard is polled after every optimizer step; on fire, a
  resume point (the whole TrainState + the data-iterator cursor,
  `core.fault_tolerance.save_resume_point`) is written durably and the
  epoch returns ``preempted=True`` — a resumed run continues at the
  exact next batch with identical losses and parameters;
- `core.chaos` hooks (signal injection, NaN batch poisoning) run inside
  the same loop that trains, so chaos tests exercise the real code path;
- the `NonFiniteMonitor` consumes the step's non-finite guard metrics
  (one step deferred — no stall), dumps offending batches, and aborts
  after N consecutive skipped steps;
- agreement across the ranks of a process group (tensor parallelism):
  each rank polls its own PreemptionGuard, but the loop acts on the OR
  over the group (`parallel.mesh.any_across_processes`), so every rank
  writes its resume point at the SAME global step — one rank saving
  step N while another runs on to N+1 would deadlock the next
  collective and fork the shards. A single process reads the local flag
  (no collective); a group polls the OR every ``preempt_poll_interval``
  steps (in lockstep on every rank), so the hot loop never waits on an
  every-step allgather.

The cursor counts CONSUMED batches: the prefetcher's read-ahead holds
batches that a preempted run never runs, and the resumed run regenerates
them from ``(seed, epoch, start_batch)``.

Epoch-granularity trainers plug in through three knobs:
``pack_sequences=False`` + ``train_arrays`` (fixed padded layout),
``step_log`` (trainer-specific metric dicts), and ``step_hook`` +
``run_epoch(max_steps=...)`` (the RQ-VAE's iteration-gated eval/save
cadence and iteration-count stop).

Data parallelism (``data_group``, the mesh's data axis): every rank
builds the same global batch from the ``(seed, epoch)`` shuffle and keeps
its contiguous block of rows (``parallel.mesh.shard_batch``; with
``accum_steps`` microbatches, its block of each), so the cursor, the
resume point and the chaos hooks are the global batch's on every rank.
The harness sums the step's metrics over the data group; the preemption
OR and the goodput sums run over the whole world.

Observability (genrec_tpu_torch/obs): every epoch's wall time is
classified into goodput buckets (compute / compile / checkpoint-save /
restore / data-wait / nonfinite-skipped / preemption-drain / other) and
reported per epoch, summed over the process group too; and the crash
flight recorder is pointed at ``<save_dir_root>/flight_recorder.json``
so a SIGTERM'd or crashed run leaves a structured post-mortem. Eager
PyTorch has no compile event to tap, so the ``compile`` bucket stays at
0 s (obs/goodput.py says why) and the JAX loop's recompile warning has
no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable

import torch

from genrec_tpu_torch.core import chaos
from genrec_tpu_torch.core.fault_tolerance import (
    NonFiniteMonitor,
    resume_exact,
    save_resume_point,
)
from genrec_tpu_torch.core.logging import log_goodput, log_occupancy
from genrec_tpu_torch.core.profiling import ProfileWindow, StepTimer, log_epoch_perf
from genrec_tpu_torch.data.batching import batch_iterator, prefetch_to_device
from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder, process_rank
from genrec_tpu_torch.obs.goodput import GoodputMeter, fleet_goodput
from genrec_tpu_torch.obs.memory import device_memory_stats
from genrec_tpu_torch.parallel.mesh import allgather_host_ints, any_across_processes, shard_batch

# Consecutive guard-skipped steps after which the run aborts.
MAX_CONSECUTIVE_NONFINITE = 3


@dataclasses.dataclass
class EpochResult:
    state: Any
    global_step: int
    preempted: bool
    n_batches: int


class PackedTrainLoop:
    """Owns epoch execution for one trainer; the trainer keeps eval,
    best-model tracking and the periodic checkpoint CADENCE.

    ``repack(epoch) -> (arrays, PackingReport)`` is called lazily per
    epoch when ``pack_sequences``; otherwise ``train_arrays`` is the fixed
    padded layout. ``rows_per_step`` is the batch rows consumed per
    optimizer step (batch_size, times the accumulation for TIGER);
    ``tokens_scale`` rescales the step's mean ``real_tokens`` metric back
    to whole-step tokens under accumulation. ``step_log(metrics,
    global_step) -> dict`` replaces the default payload logged every
    ``wandb_log_interval`` steps; ``step_hook(state, metrics, global_step,
    epoch, next_batch)`` runs after every step (the RQ-VAE's
    iteration-gated eval/save, a caller's timing). ``guard`` (a
    PreemptionGuard), ``ckpt`` (a CheckpointManager) and ``prof`` (a
    ProfileWindow) are optional."""

    def __init__(self, *, logger, tracker, device, rows_per_step: int, row_len: int,
                 seed: int, pack_sequences: bool, prof: ProfileWindow | None = None,
                 guard=None, ckpt=None,
                 repack: Callable[[int], tuple[dict, Any]] | None = None,
                 train_arrays: dict | None = None, tokens_scale: float = 1.0,
                 wandb_log_interval: int = 100, save_dir_root: str | None = None,
                 step_log: Callable[[dict, int], dict] | None = None,
                 step_hook: Callable[[Any, dict, int, int, int], None] | None = None,
                 preempt_poll_interval: int = 8, data_group=None, accum_steps: int = 1):
        if pack_sequences and repack is None:
            raise ValueError("pack_sequences=True needs a repack closure")
        if not pack_sequences and train_arrays is None:
            raise ValueError("pack_sequences=False needs train_arrays")
        self.logger = logger
        self.tracker = tracker
        self.device = torch.device(device)
        self.prof = prof if prof is not None else ProfileWindow("", 0)
        self.guard = guard
        self.ckpt = ckpt
        self.rows_per_step = rows_per_step
        self.row_len = row_len
        self.seed = seed
        self.pack_sequences = pack_sequences
        self._repack = repack
        self.tokens_scale = tokens_scale
        self.wandb_log_interval = wandb_log_interval
        self.step_log = step_log
        self.step_hook = step_hook
        self.preempt_poll_interval = max(1, int(preempt_poll_interval))
        self.data_group = data_group
        self.accum_steps = int(accum_steps)
        self.monitor = NonFiniteMonitor.for_run(save_dir_root, logger,
                                                MAX_CONSECUTIVE_NONFINITE)
        self.goodput = GoodputMeter()
        self._steps_run = 0
        self._in_preempt = False
        self._flight = get_flight_recorder()
        if save_dir_root:
            self._flight.configure(os.path.join(save_dir_root, "flight_recorder.json"),
                                   run_dir=save_dir_root)
        self._ran_epoch = False
        self._arrays = train_arrays
        self._arrays_epoch: int | None = None
        self._report = None

    # -- layout ------------------------------------------------------------

    def _arrays_for(self, epoch: int) -> dict:
        # Lazy: a run resumed at epoch E packs once (for E), not
        # epoch-0-then-E.
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
        # An unpacked row of (..., L) token ids holds prod(...) sequences
        # (NoteLLM's (P, 2, L) pair rows hold 2).
        ids = self._arrays.get("input_ids")
        return float(self.rows_per_step * (1 if ids is None else math.prod(ids.shape[1:-1])))

    def fleet_preempted(self, global_step: int | None = None) -> bool:
        """True iff ANY rank's guard latched. A single process: the local
        flag, no collective. A process group: with a ``global_step`` the
        collective only runs every ``preempt_poll_interval`` steps
        (global_step advances in lockstep on every rank, so all ranks poll
        — and agree — at the same steps, and a latched signal is acted on
        within the interval); callers without a step (epoch boundaries)
        always poll."""
        if self.guard is None:
            return False
        if process_rank()[1] == 1:
            return bool(self.guard.fired)
        if global_step is not None and global_step % self.preempt_poll_interval != 0:
            return False
        return any_across_processes(self.guard.fired)

    # -- resume + checkpoint -----------------------------------------------

    def resume(self, state) -> tuple[Any, int, int, int]:
        """(state, start_epoch, start_batch, global_step): the exact cursor
        through the integrity ladder (the state loaded in place), or
        fresh-start values."""
        with self.goodput.measure("restore"):
            point = resume_exact(self.ckpt, state, data_seed=self.seed, logger=self.logger)
        if point is None:
            return state, 0, 0, 0
        self._flight.record("resume", epoch=point.epoch, next_batch=point.next_batch,
                            global_step=point.global_step)
        return point.state, point.epoch, point.next_batch, point.global_step

    def save(self, state, *, epoch: int, next_batch: int, global_step: int,
             wait: bool = False) -> None:
        """Write a resume point (no-op without a checkpoint manager)."""
        if self.ckpt is not None:
            # A preemption save is drain work, not the periodic cadence:
            # classify by WHY it is written.
            bucket = "preemption_drain" if self._in_preempt else "checkpoint_save"
            with self.goodput.measure(bucket):
                save_resume_point(self.ckpt, state, epoch=epoch, next_batch=next_batch,
                                  global_step=global_step, data_seed=self.seed, wait=wait)

    def shutdown(self, preempted_epoch: int | None = None) -> None:
        """Close everything the loop owns (the checkpoint manager joins its
        in-flight save, the guard restores the signal handlers, the
        profiler and the tracker flush) — the one exit sequence of both
        the preempted and the normal return of every trainer."""
        if self.ckpt is not None:
            self.ckpt.close()
        if self.guard is not None:
            self.guard.close()
        self.prof.close()
        run = self.goodput.run_report()
        if run["wall_s"] > 0 and self._steps_run:
            peak = device_memory_stats(self.device).get("allocated_bytes.all.peak")
            self.logger.info(
                f"run goodput {run['goodput_pct']:.1f}% over {run['wall_s']:.1f}s wall "
                "(see goodput/* metrics)"
                + (f"; peak device memory {peak / 2**20:.1f} MB" if peak else ""))
        self.tracker.finish()
        self._flight.record("run_shutdown", preempted_epoch=preempted_epoch,
                            steps_run=self._steps_run)
        if preempted_epoch is not None:
            self.logger.info(f"preempted: exiting during epoch {preempted_epoch}")

    def _preempt(self, state, epoch: int, next_batch: int, global_step: int) -> None:
        # Durable save FIRST: the monitor's deferred check may abort the run
        # (NonFiniteLossError), and a preemption on top of a non-finite
        # streak must still leave a resume point — the streak is inside the
        # saved state (nonfinite_count), so the resumed run keeps counting.
        self._flight.record("preempt", epoch=epoch, next_batch=next_batch,
                            global_step=global_step)
        self._in_preempt = True
        try:
            self.save(state, epoch=epoch, next_batch=next_batch, global_step=global_step,
                      wait=True)
            self.logger.info(f"preempted: resume point at epoch {epoch} batch {next_batch} "
                             f"(global step {global_step})")
            with self.goodput.measure("preemption_drain"):
                self.monitor.flush()
        finally:
            self._in_preempt = False
            # The guard's dump at signal receipt predates the resume point;
            # re-dump so that the post-mortem ends with the drain.
            self._flight.dump(reason="preemption_drain")

    # -- the epoch ---------------------------------------------------------

    def run_epoch(self, state, step_fn, epoch: int, global_step: int, start_batch: int = 0,
                  max_steps: int | None = None) -> EpochResult:
        """One epoch (or its remainder from ``start_batch``), polling the
        guard after every step (the OR over the group in a process group).
        Returns with ``preempted=True`` after writing a durable mid-epoch
        resume point. ``max_steps`` stops before the batch that would push
        ``global_step`` past it (the RQ-VAE's iteration mode)."""
        if self.fleet_preempted():
            # Fired between epochs (the eval/checkpoint window): the cursor
            # is simply "this epoch, batch start_batch".
            self._preempt(state, epoch, start_batch, global_step)
            return EpochResult(state, global_step, True, 0)
        arrays = self._arrays_for(epoch)
        timer = StepTimer(self.examples_per_step, skip_first=0 if self._ran_epoch else 1)
        self._ran_epoch = True
        self._flight.record("epoch_start", epoch=epoch, global_step=global_step,
                            start_batch=start_batch)
        skipped_before = self.monitor.skipped_steps
        epoch_loss, epoch_tokens, n_batches = None, None, 0
        consumed = start_batch
        batches = prefetch_to_device(
            ((shard_batch(b, self.data_group, self.accum_steps), v)
             for b, v in chaos.poison_batches(
                 batch_iterator(arrays, self.rows_per_step, shuffle=True, seed=self.seed,
                                epoch=epoch, drop_last=True, start_batch=start_batch),
                 start_step=global_step)),
            self.device)
        try:
            while True:
                # Goodput: time blocked on the input pipeline (data_wait) is
                # measured apart from the step section, whose residual after
                # the skipped-step attribution is the compute bucket.
                t_wait = time.perf_counter()
                try:
                    batch, _ = next(batches)
                except StopIteration:
                    break
                self.goodput.add("data_wait", time.perf_counter() - t_wait)
                if max_steps is not None and global_step >= max_steps:
                    break
                t_step = time.perf_counter()
                state, m = step_fn(state, batch)
                # Guard-skipped steps add 0 to the epoch sum: one NaN batch
                # must not turn the epoch summary NaN (select, don't scale;
                # the per-step log still reports the raw loss).
                loss = m["loss"]
                if "nonfinite" in m:
                    loss = torch.where(m["nonfinite"] > 0, 0.0, loss)
                epoch_loss = loss if epoch_loss is None else epoch_loss + loss
                if "real_tokens" in m:
                    tok = m["real_tokens"] * self.tokens_scale
                    epoch_tokens = tok if epoch_tokens is None else epoch_tokens + tok
                timer.tick()
                n_batches += 1
                consumed += 1
                global_step += 1
                self.prof.tick(global_step)
                if global_step % self.wandb_log_interval == 0:
                    self.tracker.log(self.step_log(m, global_step) if self.step_log is not None
                                     else {"global_step": global_step,
                                           "train/loss": float(m["loss"])})
                # Deferred non-finite policy: checks the PREVIOUS step's flag.
                self.monitor.observe(global_step, epoch, m, batch)
                # The step section closes here: observe() waited on the
                # previous step's flag, so this interval holds device work.
                # The hook and the preemption poll land in `other`.
                self.goodput.note_step(time.perf_counter() - t_step)
                self._steps_run += 1
                self._flight.record("step", step=global_step, epoch=epoch)
                if self.step_hook is not None:
                    self.step_hook(state, m, global_step, epoch, consumed)
                chaos.maybe_kill(step=global_step)
                if self.fleet_preempted(global_step):
                    self._preempt(state, epoch, consumed, global_step)
                    return EpochResult(state, global_step, True, n_batches)
        finally:
            batches.close()  # retires the prefetch thread and its read-ahead
        self.monitor.flush()
        # Fault injection (core.chaos): a real signal in the between-epoch
        # eval/checkpoint window — the top-of-epoch preemption branch above
        # catches it on the NEXT call. No-op outside a plan.
        chaos.maybe_kill(epoch=epoch)
        if n_batches:
            # Zero batches = an epoch resumed exactly at its end: nothing
            # ran, and a fabricated 0.0 epoch loss would be a lie.
            log_epoch_perf(
                self.logger, self.tracker, epoch, epoch_loss, n_batches, timer, self.device,
                tokens_per_step=(float(epoch_tokens) / n_batches
                                 if epoch_tokens is not None else None))
            if epoch_tokens is not None:
                log_occupancy(self.logger, self.tracker, epoch, float(epoch_tokens),
                              n_batches * self.rows_per_step * self.row_len)
            self.goodput.note_skipped(self.monitor.skipped_steps - skipped_before)
            report = self.goodput.end_epoch()
            peak = device_memory_stats(self.device).get("allocated_bytes.all.peak")
            if peak:
                report["peak_device_bytes"] = peak
            log_goodput(self.logger, self.tracker, epoch, report)
            if process_rank()[1] > 1:
                # Collective: epochs end in lockstep, so every rank is here.
                log_goodput(self.logger, self.tracker, epoch,
                            fleet_goodput(report, allgather_host_ints), fleet=True)
        self._flight.record("epoch_end", epoch=epoch, global_step=global_step,
                            n_batches=n_batches)
        return EpochResult(state, global_step, False, n_batches)
