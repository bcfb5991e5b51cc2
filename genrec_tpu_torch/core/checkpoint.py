"""Step-numbered checkpoints with an integrity ladder, resume helpers and
best-model tracking (port of genrec_tpu/core/checkpoint.py:
``CheckpointManager`` with its consensus restore, ``save_params`` /
``load_params``, ``maybe_resume``, ``BestTracker``, the stale-record
refusal, ``CheckpointCorruptError`` / ``CheckpointMismatchError``).

The JAX package writes orbax records, which PyTorch cannot read, so the
port keeps a format of its own. A record is one directory:

- ``tensors.pt`` — ``torch.save`` of a flat name -> tensor dict, read back
  with ``weights_only=True``. A nested tree (a multi-head engine's
  ``{head: state_dict}``, a resume point's ``{state, cursor}``) is
  flattened with ``/`` between the levels;
- ``manifest.json`` — for every tensor its name, shape, dtype and the
  CRC32 of its bytes, and the CRC32 of ``tensors.pt`` as a whole (damage
  anywhere in the file, its container bytes included);
- ``COMMITTED`` — the commit marker, written last.

A step is written into a temporary directory beside the others and
renamed to ``<directory>/<step>`` once its marker is in, so a step that
discovery lists was written whole. ``CheckpointManager.save(...,
wait=False)`` is asynchronous, as orbax's saves are: the state is copied
to host memory before the call returns (the trainers' steps then update
parameters and moments in place), and the write and commit run on a
background thread; `wait` joins it, and every read of the manager joins
it first.

The manifest decides the ladder's verdicts, which the JAX ladder takes
from orbax's metadata read:

- a missing marker, an unreadable manifest or tensor file, a tensor the
  manifest does not list (or the other way round), a checksum mismatch
  (the file's or a tensor's) or a non-finite float tensor is CORRUPT (`CheckpointCorruptError`): the
  ladder quarantines the step to ``<directory>/quarantine/p<rank>/<step>``
  (``<directory>/quarantine/<step>`` in a per-rank tree, whose directory
  names its rank already) and walks to the next one;
- names, shapes or dtypes that differ from the live state are a MISMATCH
  (`CheckpointMismatchError`): the record is intact but not this state's
  (another model, an older layout), so it stays on disk for a rollback and
  the ladder walks on.

The layout is compared against the manifest before any tensor bytes are
read, so damaged bytes are told from a foreign layout whatever the
damage: the JAX ladder reads garbled orbax array bytes behind intact
metadata as a mismatch and leaves them in discovery (ROADMAP C3).

Ranks of a tensor-parallel group each hold a shard: ``per_host=True``
gives each rank its own record tree ``<directory>/p<rank>/`` (the JAX
per-host layout), and `restore_latest_valid_consensus` makes every rank
restore the same step or abort with a per-rank report.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
import zlib
from typing import Mapping

import torch

from genrec_tpu_torch.core import chaos
from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder, process_rank

logger = logging.getLogger("genrec_tpu_torch")

TENSORS = "tensors.pt"
MANIFEST = "manifest.json"
#: Written last: a step directory without it was interrupted mid-commit.
COMMIT_MARKER = "COMMITTED"
FORMAT = "genrec_tpu_torch.checkpoint/1"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint step failed integrity validation (missing commit
    marker, unreadable files, a checksum mismatch or a non-finite float
    tensor)."""


class CheckpointMismatchError(RuntimeError):
    """A checkpoint step is intact but its names, shapes or dtypes differ
    from the live state's — e.g. a record of another model or layout. The
    ladder skips these in place (a rollback could still use them) instead
    of quarantining."""


# -- trees <-> flat name -> tensor dicts -----------------------------------------


def flatten_tree(tree: Mapping) -> dict[str, torch.Tensor]:
    """A nested mapping of tensors (or numpy arrays) -> one flat dict, the
    levels joined by ``/``. A flat state dict comes back unchanged."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        for k, v in node.items():
            key = f"{prefix}{k}"
            if isinstance(v, Mapping):
                walk(key + "/", v)
            else:
                out[key] = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)

    walk("", tree)
    return out


def unflatten_like(flat: Mapping[str, torch.Tensor], like: Mapping) -> dict:
    """``flat`` laid out as the nested ``like`` (the inverse of
    `flatten_tree` for a tree of ``like``'s structure)."""
    def build(prefix: str, node) -> dict:
        return {k: build(f"{prefix}{k}/", v) if isinstance(v, Mapping) else flat[f"{prefix}{k}"]
                for k, v in node.items()}

    return build("", like)


def _crc32(t: torch.Tensor) -> int:
    flat = t.detach().reshape(-1)
    if flat.numel() == 0:
        return 0
    return zlib.crc32(flat.view(torch.uint8).numpy()) & 0xFFFFFFFF


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _describe(flat: Mapping[str, torch.Tensor]) -> list[dict]:
    return [{"name": n, "shape": list(t.shape), "dtype": str(t.dtype).removeprefix("torch.")}
            for n, t in flat.items()]


def host_copy(tree: Mapping) -> dict[str, torch.Tensor]:
    """A flat copy of ``tree`` in host memory that no later in-place update
    of the tree's tensors reaches (a CPU tensor is cloned too)."""
    return {n: t.detach().to("cpu", copy=True).contiguous()
            for n, t in flatten_tree(tree).items()}


def write_record(path: str, tree: Mapping, before_commit=None) -> None:
    """Write ``tree`` as one committed record directory at ``path``:
    tensors and manifest into a temporary directory beside it, the commit
    marker last, then one rename into place (an existing ``path`` is
    replaced). ``before_commit()`` runs between the tensor file and the
    marker (the chaos hook of a process lost mid-save)."""
    flat = {n: t.detach().to("cpu").contiguous() for n, t in flatten_tree(tree).items()}
    manifest = {"format": FORMAT, "tensors": [
        {**d, "crc32": _crc32(flat[d["name"]])} for d in _describe(flat)]}
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.tmp.", dir=parent)
    try:
        torch.save(flat, os.path.join(tmp, TENSORS))
        manifest["file_crc32"] = _file_crc32(os.path.join(tmp, TENSORS))
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if before_commit is not None:
            before_commit()
        with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
            f.write(FORMAT + "\n")
        for name in (TENSORS, MANIFEST, COMMIT_MARKER):
            with open(os.path.join(tmp, name), "rb") as f:
                os.fsync(f.fileno())
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def read_record(path: str, like: Mapping | None = None) -> dict:
    """Validate and load one record directory. With ``like`` (the live
    state: a nested mapping of tensors), the manifest's layout must equal
    ``like``'s and the result is laid out as ``like``; without it the
    flat dict is returned. Raises CheckpointCorruptError /
    CheckpointMismatchError (see the module docstring)."""
    if not os.path.exists(os.path.join(path, COMMIT_MARKER)):
        raise CheckpointCorruptError(
            f"{path}: missing commit marker {COMMIT_MARKER} (interrupted mid-commit?)")
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        entries = {e["name"]: e for e in manifest["tensors"]}
    except Exception as e:  # noqa: BLE001 — any failure to read is damage
        raise CheckpointCorruptError(f"{path}: unreadable manifest ({e!r})") from e
    if like is not None:
        want = {d["name"]: d for d in _describe(flatten_tree(like))}
        got = {n: {k: e.get(k) for k in ("name", "shape", "dtype")} for n, e in entries.items()}
        if want != got:
            missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
            differ = sorted(n for n in set(want) & set(got) if want[n] != got[n])
            raise CheckpointMismatchError(
                f"{path}: intact but its layout is not the live state's (missing "
                f"{missing[:5]}, extra {extra[:5]}, other shape or dtype {differ[:5]})")
    try:
        if _file_crc32(os.path.join(path, TENSORS)) != manifest["file_crc32"]:
            raise CheckpointCorruptError(f"{path}: checksum mismatch in {TENSORS}")
        flat = torch.load(os.path.join(path, TENSORS), map_location="cpu", weights_only=True)
    except CheckpointCorruptError:
        raise
    except Exception as e:  # noqa: BLE001
        raise CheckpointCorruptError(f"{path}: unreadable tensors ({e!r})") from e
    if not isinstance(flat, dict) or set(flat) != set(entries):
        raise CheckpointCorruptError(f"{path}: the tensor file does not hold the manifest's "
                                     "tensors")
    for name, t in flat.items():
        e = entries[name]
        if (not isinstance(t, torch.Tensor) or list(t.shape) != e["shape"]
                or str(t.dtype).removeprefix("torch.") != e["dtype"]):
            raise CheckpointCorruptError(f"{path}: tensor {name!r} is not as the manifest "
                                         "describes it")
        if _crc32(t) != e["crc32"]:
            raise CheckpointCorruptError(f"{path}: checksum mismatch in tensor {name!r}")
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise CheckpointCorruptError(f"{path}: non-finite tensor {name!r}")
    return flat if like is None else unflatten_like(flat, like)


def save_params(path: str, params: Mapping, wait: bool = True) -> None:
    """Save a params tree (a state dict, or a nested mapping of them) as
    one record. Writes are synchronous: ``wait`` is accepted for the JAX
    signature."""
    del wait
    write_record(os.path.abspath(path), params)


def load_params(path: str, like: Mapping | None = None) -> dict:
    """Load a record written by `save_params` (laid out as ``like`` when
    given, after the same checks as the ladder's)."""
    return read_record(os.path.abspath(path), like)


def _flight():
    return get_flight_recorder()


class CheckpointManager:
    """Step-numbered checkpoints in ``directory`` (``<directory>/<step>``,
    one record each) keeping the newest ``max_to_keep``, with the
    integrity ladder `restore_latest_valid`: newest step first; a corrupt
    step is quarantined and a mismatched one left in place, and the ladder
    falls through to the previous step.

    ``per_host=True`` in a process group of more than one rank keeps this
    rank's records under ``<directory>/p<rank>/`` (each rank the sole
    writer of its own tree); restores then go through
    `restore_latest_valid_consensus`. Discovery lists the step
    directories on disk when asked (`all_steps`), so a manager sees steps
    another process published; `reload` is kept for the JAX manager's API
    and rescans nothing extra."""

    def __init__(self, directory: str, max_to_keep: int = 3, *, per_host: bool = False):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        rank, world = process_rank()
        self.per_host = bool(per_host and world > 1)
        root = os.path.abspath(directory)
        self.directory = os.path.join(root, f"p{rank}") if self.per_host else root
        self.max_to_keep = int(max_to_keep)
        self._writer: threading.Thread | None = None
        self._write_error: BaseException | None = None
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> list[int]:
        """Every step directory under ``directory``, ascending (quarantined
        and in-flight temporary directories are not steps). Joins an
        in-flight save first."""
        self.wait()
        if not os.path.isdir(self.directory):
            return []
        return self._listed_steps()

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def reload(self) -> None:
        """Discovery reads the directory on every call: nothing to refresh."""

    def wait(self) -> None:
        """Join the in-flight asynchronous save (the durability barrier);
        a failure of its write is raised here."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise RuntimeError(f"asynchronous checkpoint save in {self.directory} "
                               f"failed: {err!r}") from err

    def close(self) -> None:
        """Join the in-flight save; nothing else is held open."""
        self.wait()

    def save(self, step: int, state: Mapping, *, wait: bool = True,
             before_commit=None) -> None:
        """Write ``state`` as step ``step``, then drop the oldest steps past
        ``max_to_keep``. With ``wait=False`` the call returns once the
        state is copied to host memory and the write and commit run on a
        background thread (one save in flight: a new save joins the last).
        ``before_commit()`` runs after the tensor file, before the commit
        marker (the streaming trainer's publish kill point).
        Re-saving the latest step is a no-op and a step below it is
        refused (as orbax's ``should_save`` refuses it; here loudly)."""
        step = int(step)
        latest = self.latest_step()  # joins the previous save
        if latest is not None and step <= latest:
            if step == latest:
                return
            raise RuntimeError(
                f"refusing to save checkpoint step {step} below the latest retained step "
                f"{latest} in {self.directory}")
        _flight().record("checkpoint_save", step=step, directory=self.directory)
        if wait:
            self._write(step, state, before_commit)
            return
        flat = host_copy(state)
        self._writer = threading.Thread(target=self._write_async,
                                        args=(step, flat, before_commit),
                                        name=f"ckpt-save-{step}")
        self._writer.start()

    def _write(self, step: int, state: Mapping, before_commit=None) -> None:
        def hook():
            chaos.maybe_die_in_save(step)
            if before_commit is not None:
                before_commit()

        write_record(self._step_dir(step), state, before_commit=hook)
        for old in self._listed_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _write_async(self, step: int, flat: dict, before_commit) -> None:
        try:
            self._write(step, flat, before_commit)
        except BaseException as e:  # noqa: BLE001 — raised by wait()
            self._write_error = e

    def _listed_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def restore(self, state_like: Mapping | None = None, step: int | None = None):
        """The record of ``step`` (default: the latest), laid out as
        ``state_like``; None when there is no step. Raises as
        `validate_and_restore` does."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return read_record(self._step_dir(step), state_like)

    def validate_and_restore(self, state_like: Mapping | None, step: int):
        """One ladder rung: restore ``step`` or raise CheckpointCorruptError
        (damaged) / CheckpointMismatchError (intact, foreign layout)."""
        self.wait()
        return read_record(self._step_dir(step), state_like)

    def quarantine(self, step: int) -> None:
        """Move a corrupt step out of discovery, keeping it on disk under
        ``quarantine/p<rank>/`` of a shared directory, ``quarantine/`` of a
        per-rank one (``<step>.<n>`` if that name is taken). A step another
        process moved first is out of discovery already."""
        _flight().record("checkpoint_quarantine", step=step, directory=self.directory)
        qdir = os.path.join(self.directory, "quarantine",
                            *(() if self.per_host else (f"p{process_rank()[0]}",)))
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, str(step))
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(qdir, f"{step}.{n}")
        try:
            shutil.move(self._step_dir(step), dst)
        except (FileNotFoundError, shutil.Error) as e:
            logger.warning(f"quarantine of step {step} lost a move race ({e})")

    def restore_latest_valid(self, state_like: Mapping | None, extra_validate=None):
        """Walk the steps newest-first; quarantine every CORRUPT one, skip
        every MISMATCHED one in place; return ``(restored, step)`` for the
        first valid, or ``(None, None)``. ``extra_validate(restored,
        step)`` adds a rung (raise CheckpointMismatchError from it to skip
        the step in place)."""
        for step in reversed(self.all_steps()):
            try:
                restored = self.validate_and_restore(state_like, step)
                if extra_validate is not None:
                    extra_validate(restored, step)
                _flight().record("integrity_ladder", step=step, verdict="valid")
                return restored, step
            except CheckpointCorruptError as e:
                logger.warning(f"checkpoint integrity: {e} — quarantining and falling back "
                               "to the previous retained step")
                _flight().record("integrity_ladder", step=step, verdict="corrupt",
                                 error=str(e)[:500])
                self.quarantine(step)
            except CheckpointMismatchError as e:
                logger.warning(f"checkpoint integrity: {e} — leaving it on disk and falling "
                               "back to the previous retained step")
                _flight().record("integrity_ladder", step=step, verdict="mismatch",
                                 error=str(e)[:500])
        _flight().record("integrity_ladder", step=None, verdict="nothing_valid")
        return None, None

    def restore_latest_valid_consensus(self, state_like: Mapping | None, extra_validate=None):
        """`restore_latest_valid` that every rank of the process group
        agrees on: every rank restores the SAME step, or the job aborts.

        Each rank first runs the ladder locally (quarantining its corrupt
        steps), then the ranks agree through `parallel.mesh`:

        1. allgather each rank's newest-valid step (-1 = nothing valid);
        2. all equal -> done (all -1 = every rank starts fresh);
        3. some ranks valid, some with nothing -> abort with a per-rank
           validity report (restored-vs-fresh shards would fork the model);
        4. disagreeing steps -> every rank re-validates the minimum (ranks
           whose local newest is newer fall back and quarantine the
           abandoned newer steps), a second allgather confirms every rank
           holds it, and any failure aborts with the report.

        A final `barrier` pins the agreement. A single process: identical
        to `restore_latest_valid`."""
        restored, step = self.restore_latest_valid(state_like, extra_validate)
        if process_rank()[1] == 1:
            return restored, step
        from genrec_tpu_torch.parallel.mesh import allgather_host_ints, barrier

        steps = allgather_host_ints([-1 if step is None else step])[:, 0]
        report = ", ".join(f"p{i}={'none' if s < 0 else int(s)}" for i, s in enumerate(steps))
        if (steps < 0).all():
            barrier("ckpt-consensus-fresh")
            return None, None
        if (steps < 0).any():
            raise RuntimeError(
                "checkpoint consensus: some ranks have NO valid checkpoint while others do "
                f"(newest-valid per rank: {report}). Restoring would fork the model's "
                "shards; restore or clear the affected ranks' checkpoint directories and "
                "relaunch.")
        target = int(steps.min())
        ok = 1
        if step != target:
            logger.warning(f"checkpoint consensus: local newest-valid step {step} != group "
                           f"minimum {target} (per rank: {report}) — falling back to step "
                           f"{target}")
            try:
                restored = self.validate_and_restore(state_like, target)
                if extra_validate is not None:
                    extra_validate(restored, target)
                step = target
                # Valid here but abandoned by the agreed restore: retained,
                # they would refuse every later save below them. Quarantine
                # them (on disk for a rollback, out of discovery).
                for s in [s for s in self.all_steps() if s > target]:
                    logger.warning(f"checkpoint consensus: quarantining locally-valid step {s} "
                                   f"abandoned by the agreed restore at step {target}")
                    self.quarantine(s)
            except (CheckpointCorruptError, CheckpointMismatchError) as e:
                logger.error(f"checkpoint consensus: cannot restore the agreed step {target} "
                             f"locally: {e}")
                ok = 0
        all_ok = allgather_host_ints([ok])[:, 0]
        if not (all_ok > 0).all():
            failed = [f"p{i}" for i, o in enumerate(all_ok) if not o]
            raise RuntimeError(
                f"checkpoint consensus: ranks {failed} cannot restore the agreed step {target} "
                f"(newest-valid per rank: {report}). No step is valid on every rank — "
                "refusing a forked restore; inspect the per-rank quarantine dirs.")
        barrier("ckpt-consensus")
        return restored, step


def stale_refusal_message(directory: str, what: str, at: str) -> str:
    """The one stale-record refusal narrative, shared by the one-process
    refusal below and the collective one in
    `core.fault_tolerance.resume_exact`."""
    return (
        f"checkpoint directory {directory} holds records this run cannot resume ({what}). "
        f"Refusing to {at} — CheckpointManager.save refuses every step at or below the "
        "stale latest one, so the run would checkpoint nothing. Move or delete those step "
        "dirs (the records are intact; epoch-keyed bare records can still be restored from "
        "a script via genrec_tpu_torch.core.checkpoint.maybe_resume) and relaunch.")


def _refuse_resume_below_stale_steps(ckpt: CheckpointManager, resumed_step: int | None) -> None:
    """Intact foreign records retained ABOVE the restore point (or with
    nothing restorable at all) are a trap: every later save keyed at or
    below the stale latest is refused, so the run would checkpoint
    nothing and every relaunch would restore the same old step. Fail
    loudly instead. Foreign records BELOW the restore point are harmless
    (later saves key above them) and stay on disk for rollbacks."""
    stale = [s for s in ckpt.all_steps() if resumed_step is None or s > resumed_step]
    if stale:
        at = ("start fresh on top of them" if resumed_step is None
              else f"resume below them (at step {resumed_step})")
        raise RuntimeError(stale_refusal_message(
            ckpt.directory, f"steps {stale}: written by a different code version or trainer",
            at))


def maybe_resume(ckpt: CheckpointManager | None, state: Mapping):
    """Epoch-keyed resume of bare state records (``TrainState.as_tree()``
    saved at step = epoch), a migration helper: no trainer calls it, every
    trainer resumes step-exactly through `core.fault_tolerance.resume_exact`.

    Returns ``(state, start_epoch, global_step)``: the restored tree (laid
    out as ``state``), epoch + 1 and its ``step``, or ``state`` and fresh
    values when nothing valid is there. Goes through the integrity ladder
    (a damaged latest step is quarantined and the previous one restored)
    and the stale-record refusal."""
    if ckpt is None or ckpt.latest_step() is None:
        return state, 0, 0
    restored, step = ckpt.restore_latest_valid(state)
    _refuse_resume_below_stale_steps(ckpt, step)
    if restored is None:
        return state, 0, 0
    return restored, step + 1, int(restored["step"])


class BestTracker:
    """Best-metric parameter snapshots that survive resume.

    The best parameters are written to ``<save_dir>/<name>`` (one record,
    `save_params`) the moment a new best appears, with the metric value in
    a sidecar ``<name>.json``, so an interrupted run never loses an
    earlier, better model and a resumed run competes against the true
    best so far. Ranks of a tensor-parallel group each keep their shard
    under a name of their own (and a sidecar of their own)."""

    def __init__(self, save_dir: str | None, metric: str = "Recall@10",
                 name: str = "best_model"):
        self.dir = os.path.join(save_dir, name) if save_dir else None
        self.meta = self.dir + ".json" if self.dir else None
        self.metric = metric
        self.value = -1.0
        if self.meta and os.path.exists(self.meta):
            try:
                with open(self.meta) as f:
                    self.value = float(json.load(f)["value"])
            except (ValueError, KeyError, TypeError, OSError) as e:
                # A sidecar truncated by a crash mid-write must not break
                # resume: forget the best-so-far value (the next
                # improvement re-saves model and sidecar).
                logger.warning(f"corrupt best-model sidecar {self.meta} ({e}): resetting "
                               "best-metric tracking")
                self.value = -1.0

    def update(self, value: float, params: Mapping) -> bool:
        if value <= self.value:
            return False
        self.value = value
        if self.dir:
            # Synchronous on purpose: the sidecar must only ever describe a
            # durable record (an asynchronous write could leave value=X on
            # disk with no params after a crash, and nothing below X would
            # ever be saved again).
            save_params(self.dir, params)
            tmp = self.meta + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"metric": self.metric, "value": value}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.meta)
        return True

    def best_params(self, like: Mapping):
        """The best parameters seen across all runs (from disk), laid out
        as ``like``, or None if none were saved."""
        if self.dir and os.path.exists(self.dir) and self.value > -1.0:
            return load_params(self.dir, like=like)
        return None
