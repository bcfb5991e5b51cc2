"""Streaming trainer (port of genrec_tpu/trainers/stream_trainer.py): tail
the interaction log, repack incrementally, commit and publish on a
cadence — the training half of the continuous pipeline.

The trainer owns NO new training machinery: it maps the append-only
`data.stream_log` onto `PackedTrainLoop`'s epoch/cursor contract and lets
the loop's step-granular fault tolerance do the rest.

- **Chunk-as-epoch**: fixed-size chunks of ``chunk_records`` consecutive
  records; chunk *k* IS epoch *k*. ``make_arrays(payloads, epoch)``
  turns a chunk into the loop's static-shape arrays deterministically,
  so the loop's ``{epoch, next_batch, data_seed}`` resume point names an
  exact position in the RECORD stream: a trainer killed anywhere (by
  SIGTERM, SIGKILL mid-commit, or SIGKILL mid-publish) resumes at the
  exact record with per-step loss parity (tests/test_torch_pipeline.py).
- **Commit cadence**: every ``commit_every_steps`` optimizer steps (and
  at every chunk boundary) a resume point goes through the loop's
  `CheckpointManager` (core/checkpoint.py). The log cursor
  (`stream_log.CursorStore`) commits beside it, carrying the SAME
  ``{epoch, next_batch, global_step, data_seed}`` coordinates, so log
  position and train position can never disagree by more than one
  in-flight commit.
- **Publish**: at every chunk boundary and on its own cadence
  (``publish_every_steps``) the model's state dict is saved to a SEPARATE
  publish directory (its own `CheckpointManager`, the same commit
  marker), which is the only directory serving ever watches. A publish
  is written synchronously and ``chaos.maybe_die_in_publish`` fires
  between its tensor file and its commit marker, so a publish killed in
  flight (``ChaosPlan.die_in_publish_at_step``) never gains a marker: it
  leaves a temporary directory that discovery never lists. A step
  directory without a marker (a marker lost to a bad disk,
  ``chaos.drop_commit_marker``) is quarantined at the next trainer start,
  invisible to the rollout guard (serving/rollout.py) forever.

There is no mesh: the state lives on the device of its model, which the
caller chose when it built the state.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

from genrec_tpu_torch.core import chaos
from genrec_tpu_torch.core.checkpoint import COMMIT_MARKER, CheckpointManager
from genrec_tpu_torch.core.logging import Tracker, setup_logger
from genrec_tpu_torch.core.preemption import PreemptionGuard
from genrec_tpu_torch.core.profiling import ProfileWindow
from genrec_tpu_torch.data.stream_log import CursorStore, StreamLogReader
from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop


class _ChunkReport:
    """PackingReport stand-in for one log chunk (the loop only reads
    ``n_examples``/``n_rows`` for its rate math)."""

    def __init__(self, n_examples: int, n_rows: int, epoch: int):
        self.n_examples = n_examples
        self.n_rows = n_rows
        self.epoch = epoch

    def __str__(self) -> str:
        return (f"stream chunk {self.epoch}: {self.n_examples} records "
                f"packed into {self.n_rows} rows")


class StreamTrainer:
    """Drives one model's incremental training off an interaction log.

    ``state`` is a `core.state.TrainState` on its model's device.
    ``make_arrays(payloads, epoch) -> dict[str, np.ndarray]`` must be
    DETERMINISTIC in its inputs (any shuffling keyed off ``epoch``): the
    exactness of crash resume rests on chunk *k* repacking to identical
    arrays on every attempt. ``step_fn(state, batch) -> (state, metrics)``
    is any train step (`core.harness.make_train_step`) whose metrics carry
    ``"loss"``. ``publish_params(state)`` is the published tree (default:
    the model's state dict, the tree a `ServingEngine` serves).
    """

    def __init__(
        self,
        *,
        log_dir: str,
        save_dir_root: str,
        state,
        step_fn: Callable,
        make_arrays: Callable[[list, int], dict],
        chunk_records: int,
        rows_per_step: int,
        row_len: int = 1,
        seed: int = 0,
        publish_dir: str | None = None,
        commit_every_steps: int = 0,
        publish_every_steps: int = 0,
        publish_params: Callable[[Any], Any] | None = None,
        max_to_keep: int = 5,
        logger=None,
        guard: PreemptionGuard | None = None,
        handle_signals: bool = True,
        wandb_log_interval: int = 1,
    ):
        if chunk_records % rows_per_step:
            raise ValueError(
                f"chunk_records={chunk_records} must be a multiple of "
                f"rows_per_step={rows_per_step} (drop_last would strand "
                "records at every chunk tail)"
            )
        self.log_dir = log_dir
        self.save_dir_root = save_dir_root
        self.publish_dir = publish_dir
        self.chunk_records = int(chunk_records)
        self.commit_every_steps = int(commit_every_steps)
        self.publish_every_steps = int(publish_every_steps)
        self.publish_params = publish_params or (lambda s: s.model.state_dict())
        self.step_fn = step_fn
        self.make_arrays = make_arrays
        self.reader = StreamLogReader(log_dir)
        self.cursor = CursorStore(os.path.join(save_dir_root, "stream_cursor.json"))
        self.logger = logger or setup_logger(save_dir_root)
        self.tracker = Tracker(save_dir=save_dir_root)
        self.state_like = state
        self.ckpt = CheckpointManager(
            os.path.join(save_dir_root, "checkpoints"), max_to_keep=max_to_keep
        )
        self._publish_mgr = (
            CheckpointManager(publish_dir, max_to_keep=max_to_keep)
            if publish_dir else None
        )
        self.published_steps: list[int] = []
        if self._publish_mgr is not None:
            self._quarantine_torn_publishes()
        self.guard = guard if guard is not None else (
            PreemptionGuard(self.logger) if handle_signals else None
        )
        self.loop = PackedTrainLoop(
            logger=self.logger, tracker=self.tracker, device=state.step.device,
            prof=ProfileWindow("", 0), guard=self.guard, ckpt=self.ckpt,
            rows_per_step=rows_per_step, row_len=row_len, seed=seed,
            pack_sequences=True, repack=self._repack,
            wandb_log_interval=wandb_log_interval, save_dir_root=save_dir_root,
            step_hook=self._step_hook if commit_every_steps else None,
        )

    # -- log → arrays -------------------------------------------------------

    def _repack(self, epoch: int):
        start = epoch * self.chunk_records
        payloads = self.reader.read(start, self.chunk_records)
        if len(payloads) < self.chunk_records:
            raise RuntimeError(
                f"chunk {epoch} not fully committed: wanted "
                f"{self.chunk_records} records from {start}, log has "
                f"{len(payloads)} (run() waits before repacking)"
            )
        arrays = self.make_arrays(payloads, epoch)
        n_rows = len(next(iter(arrays.values())))
        return arrays, _ChunkReport(self.chunk_records, n_rows, epoch)

    # -- commit + publish ---------------------------------------------------

    def _commit(self, state, epoch: int, next_batch: int, global_step: int,
                wait: bool = False) -> None:
        """One coordinated commit: resume point through the checkpoint
        manager, then the log cursor with the SAME coordinates. The
        cursor's ``record`` is the stream position every record BEFORE
        which is fully consumed (chunk granularity; the meta names the
        exact mid-chunk batch)."""
        self.loop.save(state, epoch=epoch, next_batch=next_batch,
                       global_step=global_step, wait=wait)
        self.cursor.save(epoch * self.chunk_records, meta={
            "epoch": epoch, "next_batch": next_batch,
            "global_step": global_step, "data_seed": self.loop.seed,
        })

    def _quarantine_torn_publishes(self) -> None:
        """A step directory of the publish directory without its commit
        marker would collide with the re-publish after resume: quarantine
        it (the discipline the restore ladder applies on read)."""
        for name in os.listdir(self.publish_dir):
            if not name.isdigit():
                continue
            if not os.path.exists(
                os.path.join(self.publish_dir, name, COMMIT_MARKER)
            ):
                self.logger.warning(
                    f"stream trainer: quarantining torn publish step {name}"
                )
                self._publish_mgr.quarantine(int(name))

    def _publish(self, state, global_step: int) -> None:
        if self._publish_mgr is None:
            return
        latest = self._publish_mgr.latest_step()
        if latest is not None and global_step <= latest:
            # Already durably published (a crash after publish but before
            # the NEXT commit replays this step on resume): exact resume
            # makes the params identical, so skipping is correct.
            return
        # Chaos: a SIGKILL between the tensor file and the commit marker
        # leaves the publish in flight — the step never gains a marker.
        self._publish_mgr.save(global_step, self.publish_params(state),
                               before_commit=lambda: chaos.maybe_die_in_publish(global_step))
        self.published_steps.append(global_step)
        self.logger.info(f"stream trainer: published params step {global_step}")

    def _step_hook(self, state, metrics, global_step: int, epoch: int, consumed: int):
        del metrics
        if self.commit_every_steps and global_step % self.commit_every_steps == 0:
            self._commit(state, epoch, consumed, global_step)
        if self.publish_every_steps and global_step % self.publish_every_steps == 0:
            self._publish(state, global_step)

    # -- the tail loop ------------------------------------------------------

    def run(self, *, max_chunks: int | None = None, poll_secs: float = 0.05,
            idle_timeout_s: float | None = 5.0) -> dict:
        """Tail the log until ``max_chunks`` chunks are trained (or the
        log stops growing for ``idle_timeout_s``). Returns a summary;
        ``preempted=True`` means a durable resume point was written and
        a rerun continues exactly where this one stopped."""
        state, epoch, start_batch, global_step = self.loop.resume(self.state_like)
        preempted = False
        chunks_done = 0
        idle_since = None
        try:
            while max_chunks is None or epoch < max_chunks:
                need = (epoch + 1) * self.chunk_records
                if self.reader.count() < need:
                    if self.loop.fleet_preempted():
                        self._commit(state, epoch, start_batch, global_step,
                                     wait=True)
                        preempted = True
                        break
                    idle_since = idle_since or time.monotonic()
                    if (idle_timeout_s is not None
                            and time.monotonic() - idle_since > idle_timeout_s):
                        break
                    time.sleep(poll_secs)
                    continue
                idle_since = None
                res = self.loop.run_epoch(
                    state, self.step_fn, epoch, global_step,
                    start_batch=start_batch,
                )
                state, global_step = res.state, res.global_step
                if res.preempted:
                    preempted = True
                    break
                chunks_done += 1
                epoch += 1
                start_batch = 0
                # Chunk-boundary commit + publish regardless of cadence:
                # the boundary is where the cursor is simplest (next
                # chunk, batch 0) and where freshness is accounted.
                self._commit(state, epoch, 0, global_step)
                self._publish(state, global_step)
        finally:
            self.loop.shutdown(preempted_epoch=epoch if preempted else None)
            if self._publish_mgr is not None:
                self._publish_mgr.close()
        return {
            "global_step": global_step,
            "epoch": epoch,
            "chunks_done": chunks_done,
            "records_consumed": epoch * self.chunk_records,
            "preempted": preempted,
            "published_steps": list(self.published_steps),
        }
