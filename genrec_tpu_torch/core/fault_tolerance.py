"""Step-granular fault tolerance: interrupt anywhere, resume exactly (port
of genrec_tpu/core/fault_tolerance.py).

Three pieces, composed by `trainers.packed_loop.PackedTrainLoop`:

1. **Resume points** — one checkpoint record keyed by GLOBAL STEP holding
   the whole ``TrainState`` (``TrainState.as_tree``: the model's state
   dict, every optimizer tensor, ``step``, ``nonfinite_count`` and the
   generator's state) *plus the data-iterator cursor* (epoch, next batch
   index, data seed, prefetch depth). The input pipeline is deterministic
   in ``(seed, epoch)`` — the per-epoch packer permutation
   (`data.batching.pack_examples(seed=(seed, epoch))`), the shuffle
   (`batch_iterator(seed=..., epoch=...)`) and the prefetcher (a pure
   read-ahead whose unconsumed batches are regenerated on resume) — and
   dropout draws from the saved generator, so the cursor (epoch,
   next_batch) pins the exact next batch: a resumed run replays nothing
   and skips nothing, and its per-step losses and final parameters equal
   an uninterrupted run's bit for bit on one device.

2. **Integrity-ladder restore** — `resume_exact` walks retained resume
   points newest-first through `CheckpointManager.restore_latest_valid`
   (its consensus form across the ranks of a process group),
   quarantining damaged steps instead of crashing.

3. **`NonFiniteMonitor`** — host-side policy for the non-finite guard of
   `core.harness.make_train_step`: dump the offending batch to disk with
   step metadata, abort after N CONSECUTIVE skipped steps (the streak
   itself lives on the device in ``TrainState.nonfinite_count``, so it is
   checkpointed and survives resume). The check is deferred by one step
   so that reading the flag never stalls the host: step N's flag is read
   only after step N+1 has been issued.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np

from genrec_tpu_torch.core.checkpoint import (
    CheckpointManager,
    CheckpointMismatchError,
    _refuse_resume_below_stale_steps,
    stale_refusal_message,
)
from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder, process_rank

# Version tag of the resume-point record; bump on a layout change. The
# check runs as a rung of the integrity ladder: a record with a foreign
# tag is skipped IN PLACE (left on disk for the code version that wrote
# it). Foreign records BELOW the chosen restore point are harmless; if
# any remain ABOVE it, resume refuses loudly — every later save below
# them would be refused, so continuing would checkpoint nothing.
_FORMAT = 1


@dataclasses.dataclass
class ResumePoint:
    """Deserialized cursor: continue ``epoch`` at batch ``next_batch``."""

    state: Any
    epoch: int
    next_batch: int
    global_step: int


def _cursor_arrays(epoch: int, next_batch: int, global_step: int, data_seed: int,
                   prefetch_depth: int) -> dict[str, np.ndarray]:
    return {
        "format": np.asarray(_FORMAT, np.int32),
        "epoch": np.asarray(epoch, np.int32),
        # Batches CONSUMED this epoch == index of the next batch to run.
        "next_batch": np.asarray(next_batch, np.int32),
        # Loop-iteration counter (can exceed state.step when the
        # non-finite guard skipped updates).
        "global_step": np.asarray(global_step, np.int64),
        # The base data seed; (data_seed, epoch) derives the packer
        # permutation and the shuffle. Stored to detect a resume launched
        # with a different seed (which would silently break exactness).
        "data_seed": np.asarray(data_seed, np.int64),
        # Unconsumed read-ahead at save time. Always 0 in the record: the
        # prefetcher is stateless read-ahead, so those batches are simply
        # regenerated — recorded for format completeness.
        "prefetch_depth": np.asarray(prefetch_depth, np.int32),
    }


def _composite_like(state) -> dict[str, Any]:
    return {"state": state.as_tree(), "cursor": _cursor_arrays(0, 0, 0, 0, 0)}


def save_resume_point(ckpt: CheckpointManager, state, *, epoch: int, next_batch: int,
                      global_step: int, data_seed: int, wait: bool = False) -> None:
    """Write a step-keyed resume point (the whole TrainState + the cursor).

    Periodic saves are asynchronous (the state goes to host memory before
    the call returns; the write and commit run on a background thread); a
    preemption save passes ``wait=True`` so that the record is durable
    before the process leaves its grace window."""
    ckpt.save(global_step, {
        "state": state.as_tree(),
        "cursor": _cursor_arrays(epoch, next_batch, global_step, data_seed, 0),
    }, wait=wait)


def _multi_process() -> bool:
    return process_rank()[1] > 1


def resume_exact(ckpt: CheckpointManager | None, state, *, data_seed: int,
                 logger=None) -> ResumePoint | None:
    """Restore the newest VALID resume point into ``state`` (a live
    ``TrainState``, loaded in place), or None for a fresh start.

    Damaged steps are quarantined by the integrity ladder. A stored data
    seed that differs from the configured one is an error: the shuffle and
    packer permutations would diverge and the 'exact' resume would
    silently replay different data.

    In a process group the restore runs through
    `CheckpointManager.restore_latest_valid_consensus`: every rank
    restores the SAME step (or the job aborts with a per-rank report), so
    a record damaged on one rank can never fork the model's shards."""
    if ckpt is None:
        return None
    if not _multi_process() and ckpt.latest_step() is None:
        # A process group must NOT take this shortcut: one rank with an
        # empty directory returning early while another enters the
        # consensus collectives would deadlock — the mixed case is the
        # consensus pass's to report.
        return None

    restored, step = _restore_resume_point_consensus(ckpt, state)
    # Foreign records retained ABOVE the restore point would refuse every
    # later save: refuse loudly before burning compute. In a group the
    # decision is collective (one rank raising while its peers train would
    # strand them at their next collective), so any rank's stale steps
    # abort every rank.
    if _multi_process():
        from genrec_tpu_torch.parallel.mesh import allgather_host_ints

        stale = [s for s in ckpt.all_steps() if step is None or s > step]
        counts = allgather_host_ints([len(stale)])[:, 0]
        if counts.max() > 0:
            report = ", ".join(f"p{i}={int(c)}" for i, c in enumerate(counts))
            raise RuntimeError(stale_refusal_message(
                ckpt.directory, f"stale-step counts per rank: {report}; local stale steps "
                f"{stale}", "resume on any rank"))
    else:
        _refuse_resume_below_stale_steps(ckpt, step)
    if restored is None:
        if logger is not None:
            logger.warning("no valid resume point survived the integrity ladder")
        return None
    cursor = restored["cursor"]
    if int(cursor["data_seed"]) != int(data_seed):
        raise ValueError(
            f"resume point was written with data seed {int(cursor['data_seed'])} "
            f"but this run uses {int(data_seed)}: refusing an inexact resume")
    state.load_tree(restored["state"])
    point = ResumePoint(state=state, epoch=int(cursor["epoch"]),
                        next_batch=int(cursor["next_batch"]),
                        global_step=int(cursor["global_step"]))
    if logger is not None:
        logger.info(f"resumed at epoch {point.epoch} batch {point.next_batch} "
                    f"(global step {point.global_step}, checkpoint step {step})")
    return point


def _restore_resume_point_consensus(ckpt: CheckpointManager, state):
    """Walk the integrity ladder over COMPOSITE resume-point records
    (consensus in a process group), rejecting any whose cursor format this
    code cannot interpret. The one restore preamble shared by
    `resume_exact` and `restore_for_eval`."""

    def check_format(restored, step):
        got = int(restored["cursor"]["format"])
        if got != _FORMAT:
            raise CheckpointMismatchError(
                f"step {step}: resume-point format {got} != {_FORMAT} "
                "(written by a different code version)")

    return ckpt.restore_latest_valid_consensus(_composite_like(state),
                                               extra_validate=check_format)


def restore_for_eval(ckpt: CheckpointManager | None, state, *,
                     logger=None) -> tuple[Any, int | None]:
    """Restore the newest valid model state for a PURE EVALUATION run.

    eval_only consumes no training data, so none of `resume_exact`'s
    exactness preconditions apply: the stored data seed is ignored and
    stale foreign records above the restore point do not refuse. Walks the
    resume points through the integrity ladder first (consensus in a
    process group, so every rank evaluates the same step); a single
    process falls back to bare ``TrainState.as_tree()`` records. Returns
    ``(state, step)`` with ``state`` loaded in place, or ``(state, None)``
    when nothing restores."""
    if ckpt is None:
        return state, None
    if not _multi_process() and ckpt.latest_step() is None:
        return state, None

    restored, step = _restore_resume_point_consensus(ckpt, state)
    if restored is not None:
        tree = restored["state"]
    elif not _multi_process():
        tree, step = ckpt.restore_latest_valid(state.as_tree())
        if tree is None:
            return state, None
    else:
        return state, None
    state.load_tree(tree)
    if logger is not None:
        logger.info(f"eval_only: restored checkpoint step {step}")
    return state, step


class NonFiniteLossError(RuntimeError):
    """Raised after max_consecutive non-finite steps: the run is diverging
    structurally, not hitting a one-off bad batch."""


class NonFiniteMonitor:
    """Host policy for the non-finite guard (core.harness).

    `observe` is called once per step with the step's metrics and the
    on-device batch; it CHECKS the PREVIOUS step's flag (deferred by one
    step, so the device scalar it reads is already computed and the read
    never stalls the host). On a flagged step the batch is dumped to
    ``<dump_dir>/nonfinite_step<g>.npz`` with step metadata, and once the
    device-side consecutive streak (``metrics["nonfinite_count"]``)
    reaches ``max_consecutive`` the run aborts with `NonFiniteLossError`.
    Call `flush()` at epoch end / before a preemption save to check the
    last in-flight step."""

    def __init__(self, dump_dir: str | None, max_consecutive: int = 3, logger=None):
        self.dump_dir = dump_dir
        self.max_consecutive = max_consecutive
        self.logger = logger
        self.dumped: list[str] = []
        # Skipped-step tally for goodput accounting (obs/goodput.py): flags
        # are read one step late, so the LOOP cannot count them without a
        # stall — the monitor is where they surface.
        self.skipped_steps = 0
        self._pending: tuple[int, int, dict, Any] | None = None

    @classmethod
    def for_run(cls, save_dir_root: str | None, logger=None,
                max_consecutive: int = 3) -> "NonFiniteMonitor":
        """Monitor with the standard dump location for a trainer run
        (``<save_dir_root>/nonfinite/``; no dumps without a save dir)."""
        return cls(os.path.join(save_dir_root, "nonfinite") if save_dir_root else None,
                   max_consecutive, logger)

    def observe(self, global_step: int, epoch: int, metrics: dict, batch) -> None:
        prev, self._pending = self._pending, (global_step, epoch, metrics, batch)
        if prev is not None:
            self._check(*prev)

    def flush(self) -> None:
        prev, self._pending = self._pending, None
        if prev is not None:
            self._check(*prev)

    def _check(self, global_step: int, epoch: int, metrics: dict, batch) -> None:
        if "nonfinite" not in metrics or not float(metrics["nonfinite"]):
            return
        streak = int(float(metrics.get("nonfinite_count", 1.0)))
        self.skipped_steps += 1
        path = self._dump(global_step, epoch, metrics, batch)
        recorder = get_flight_recorder()
        recorder.record("nonfinite_step", step=global_step, epoch=epoch, streak=streak,
                        loss=float(metrics["loss"]), dump=path)
        if self.logger is not None:
            self.logger.warning(
                f"non-finite loss/grad at step {global_step} (epoch {epoch}): optimizer "
                f"update skipped (streak {streak}/{self.max_consecutive})"
                + (f", batch dumped to {path}" if path else ""))
        if streak >= self.max_consecutive:
            recorder.record("nonfinite_abort", step=global_step, epoch=epoch, streak=streak,
                            max_consecutive=self.max_consecutive)
            recorder.dump(reason="nonfinite_abort")
            raise NonFiniteLossError(
                f"{streak} consecutive non-finite steps (last: step {global_step}, epoch "
                f"{epoch})"
                + (f"; offending batches dumped under {self.dump_dir}" if path else ""))

    def _dump(self, global_step: int, epoch: int, metrics: dict, batch) -> str | None:
        if self.dump_dir is None:
            return None
        # Rank-suffixed file name: ranks sharing a filesystem dump the same
        # flagged step and must not clobber each other's post-mortems.
        rank, world = process_rank()
        suffix = f"_p{rank}" if world > 1 else ""
        os.makedirs(self.dump_dir, exist_ok=True)
        payload: dict[str, np.ndarray] = {
            "global_step": np.asarray(global_step, np.int64),
            "epoch": np.asarray(epoch, np.int64),
            "loss": np.asarray(float(metrics["loss"]), np.float64),
            "grad_norm": np.asarray(float(metrics["grad_norm"]), np.float64),
        }
        for key, leaf in batch.items():
            payload[f"batch/{key}"] = (leaf.detach().cpu().numpy() if hasattr(leaf, "detach")
                                       else np.asarray(leaf))
        path = os.path.join(self.dump_dir, f"nonfinite_step{global_step}{suffix}.npz")
        np.savez(path, **payload)
        self.dumped.append(path)
        return path
