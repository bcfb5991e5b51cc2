"""Step-numbered params checkpoints with an integrity ladder (port of the
params half of genrec_tpu/core/checkpoint.py: ``CheckpointManager``,
``save_params`` / ``load_params``, ``CheckpointCorruptError`` /
``CheckpointMismatchError``).

The JAX package writes orbax records, which PyTorch cannot read, so the
port keeps a format of its own. A record is one directory:

- ``tensors.pt`` — ``torch.save`` of a flat name -> tensor dict, read back
  with ``weights_only=True``. A nested tree (a multi-head engine's
  ``{head: state_dict}``) is flattened with ``/`` between the levels;
- ``manifest.json`` — for every tensor its name, shape, dtype and the
  CRC32 of its bytes, and the CRC32 of ``tensors.pt`` as a whole (damage
  anywhere in the file, its container bytes included);
- ``COMMITTED`` — the commit marker, written last.

A step is written into a temporary directory beside the others and
renamed to ``<directory>/<step>`` once its marker is in, so a step that
discovery lists was written whole.

The manifest decides the ladder's verdicts, which the JAX ladder takes
from orbax's metadata read:

- a missing marker, an unreadable manifest or tensor file, a tensor the
  manifest does not list (or the other way round), a checksum mismatch
  (the file's or a tensor's) or a non-finite float tensor is CORRUPT (`CheckpointCorruptError`): the
  ladder quarantines the step to ``<directory>/quarantine/p<rank>/<step>``
  and walks to the next one;
- names, shapes or dtypes that differ from the live state are a MISMATCH
  (`CheckpointMismatchError`): the record is intact but not this state's
  (another model, an older layout), so it stays on disk for a rollback and
  the ladder walks on.

The layout is compared against the manifest before any tensor bytes are
read, so damaged bytes are told from a foreign layout whatever the
damage: the JAX ladder reads garbled orbax array bytes behind intact
metadata as a mismatch and leaves them in discovery (ROADMAP C).

Not ported here (ROADMAP A12): resume points, ``maybe_resume``,
``BestTracker``, the per-host and consensus restores and the chaos hooks.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import zlib
from typing import Mapping

import torch

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


def write_record(path: str, tree: Mapping) -> None:
    """Write ``tree`` as one committed record directory at ``path``:
    tensors and manifest into a temporary directory beside it, the commit
    marker last, then one rename into place (an existing ``path`` is
    replaced)."""
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

    Discovery lists the step directories on disk when asked (`all_steps`),
    so a manager sees steps another process published; `reload` is kept
    for the JAX manager's API and rescans nothing extra."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> list[int]:
        """Every step directory under ``directory``, ascending (quarantined
        and in-flight temporary directories are not steps)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def reload(self) -> None:
        """Discovery reads the directory on every call: nothing to refresh."""

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing is held open."""

    def save(self, step: int, state: Mapping) -> None:
        """Write ``state`` as step ``step``, then drop the oldest steps past
        ``max_to_keep``. Re-saving the latest step is a no-op and a step
        below it is refused (as orbax's ``should_save`` refuses it; here
        loudly)."""
        step = int(step)
        latest = self.latest_step()
        if latest is not None and step <= latest:
            if step == latest:
                return
            raise RuntimeError(
                f"refusing to save checkpoint step {step} below the latest retained step "
                f"{latest} in {self.directory}")
        _flight().record("checkpoint_save", step=step, directory=self.directory)
        write_record(self._step_dir(step), state)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

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
        return read_record(self._step_dir(step), state_like)

    def quarantine(self, step: int) -> None:
        """Move a corrupt step out of discovery, keeping it on disk under
        ``quarantine/p<rank>/`` (``<step>.<n>`` if that name is taken). A
        step another process moved first is out of discovery already."""
        _flight().record("checkpoint_quarantine", step=step, directory=self.directory)
        qdir = os.path.join(self.directory, "quarantine", f"p{process_rank()[0]}")
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
