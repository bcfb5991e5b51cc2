"""Fault-injection harness: kill, corrupt, and poison a live training run
(port of genrec_tpu/core/chaos.py; framework-free, as there).

Chaos engineering for the fault-tolerance layer (core.fault_tolerance):
tests install a `ChaosPlan` and the training loops fire it at the exact
step/epoch it names —

- ``kill_at_step`` / ``kill_at_epoch``: deliver a real signal (SIGTERM by
  default, the fleet preemption signal) to this process mid-run, exactly
  like a spot reclaim. The PreemptionGuard latches it and the loop takes
  its normal checkpoint-and-exit path — the chaos test then resumes and
  asserts exact parity with an uninterrupted run.
- ``nan_at_steps``: overwrite every FLOAT array of the host batch with
  NaN before it ships to the device (integer token batches pass through
  untouched), driving the non-finite guard in core.harness.
- ``die_in_save_at_step``: SIGKILL inside `CheckpointManager.save`'s
  writer, after the tensor file is written and before the commit marker.
- `truncate_checkpoint` / `garble_checkpoint` / `drop_commit_marker`:
  damage an on-disk step record (``tensors.pt``, ``manifest.json``,
  ``COMMITTED``; core/checkpoint.py) the way a crashed writer or a bad
  disk would, driving the integrity ladder.
- ``net_faults``: a seeded schedule of NETWORK faults at the frame
  boundary of a cross-host serving tier, and the stream and rollout
  hooks (``die_in_append``, ``die_in_publish``, ``crash_rollout_at``):
  copied as they are; their consumers come with the serving planes and
  the streaming trainer (ROADMAP A24/A25).

``only_process`` names a rank of the ``torch.distributed`` group
(`obs.flight_recorder.process_rank`): a tensor-parallel rank, where the
JAX package names a host.

The hooks are no-ops (one module attribute read) unless a plan is
installed, so they stay in the production loops permanently — the same
code path that trains is the one chaos-tested.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
from typing import Iterable, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class NetFault:
    """One scheduled network fault at the socket tier's frame boundary.

    Matched per wrapped endpoint by ``role`` (``"front"`` — the proxy's
    socket; ``"host"`` — a decode host's accepted connection; ``"*"``)
    and ``side`` (``"send"`` / ``"recv"``), armed for the half-open
    frame-index window ``[at_frame, at_frame + n_frames)`` counted
    per endpoint+side. Every probabilistic choice (``p``, corruption
    positions) draws from the plan's seeded RNG, so a fault sequence is
    bit-reproducible per ``net_seed``."""

    kind: str          # latency|drop|corrupt|truncate|slow_loris|reset|hang
    role: str = "*"    # which endpoint's socket ("front"|"host"|"*")
    side: str = "send"  # "send" | "recv"
    at_frame: int = 0  # first frame index the rule arms at
    n_frames: int = 1  # window length in frames
    delay_s: float = 0.0  # latency/hang sleep; slow-loris per-chunk delay
    p: float = 1.0     # per-frame firing probability (seeded)
    # Connection window: each wrap of a role's socket gets the next
    # ordinal (0, 1, ... per process+role, reconnects included), and
    # the fault only arms for ordinals in [at_conn, at_conn + n_conns).
    # n_conns=0 means every connection. This is how a schedule says
    # "blackhole the FIRST connection" and still lets the reconnect
    # that recovers from it come up clean — the property that makes a
    # zero-lost-requests chaos run deterministic instead of a race.
    at_conn: int = 0
    n_conns: int = 0


@dataclasses.dataclass
class ChaosPlan:
    kill_at_step: int | None = None  # global step (post-increment) to signal at
    kill_at_epoch: int | None = None  # epoch index to signal at (end of epoch)
    kill_signal: int = signal.SIGTERM
    nan_at_steps: frozenset[int] = frozenset()  # global steps to poison
    # Step at which CheckpointManager.save dies HARD (SIGKILL) after the
    # tensor file is written but before the commit marker — a process
    # vanishing mid-save. The step must never end up with a commit marker.
    die_in_save_at_step: int | None = None
    # Streaming-pipeline chaos (docs/training.md "Streaming training"):
    # record index at which StreamLogWriter.append dies HARD with a REAL
    # torn frame on disk (header + partial payload, fsync'd, then
    # SIGKILL) — drives torn-tail recovery against actual torn bytes.
    die_in_append_at_record: int | None = None
    # Step at which the streaming trainer dies HARD while its params
    # PUBLISH (the serving-facing checkpoint, distinct from the trainer's
    # own resume commit above) is still in flight — the published step
    # must never gain a commit marker, so the rollout guard never sees it.
    die_in_publish_at_step: int | None = None
    # Rollout-controller chaos: name a stage boundary ("canary" |
    # "promote") at which `maybe_crash` raises ChaosCrashError, killing
    # the controller's poll thread exactly where a process crash would —
    # its durable rollout state file is all a restarted controller gets.
    crash_rollout_at: str | None = None
    # Multi-process chaos: restrict every injection above to ONE rank of
    # the torch.distributed group. None = fire on every process (the
    # single-process default, where the rank is 0).
    only_process: int | None = None
    # Serving chaos: the scheduled network faults disagg.chaosnet
    # injects at the socket tier's frame boundary, plus the seed that
    # makes the whole sequence reproducible.
    net_faults: tuple[NetFault, ...] = ()
    net_seed: int = 0


def _this_process_targeted(plan: ChaosPlan) -> bool:
    if plan.only_process is None:
        return True
    from genrec_tpu_torch.obs.flight_recorder import process_rank

    return process_rank()[0] == plan.only_process


_ACTIVE: ChaosPlan | None = None


class inject:
    """Context manager installing a plan for the duration of a test."""

    def __init__(self, plan: ChaosPlan):
        self._plan = plan

    def __enter__(self) -> ChaosPlan:
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self._plan
        return self._plan

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return False


def active() -> ChaosPlan | None:
    return _ACTIVE


def install(plan: ChaosPlan | None) -> None:
    """Process-lifetime install (no context manager to unwind): a child
    process — a spawned decode host — installs its plan once at startup
    and keeps it until exit."""
    global _ACTIVE
    _ACTIVE = plan


#: Env var carrying a net-fault schedule into a CHILD process (a
#: spawned decode host cannot enter the parent's `inject` block).
NET_PLAN_ENV = "GENREC_CHAOS_NET_PLAN"


def net_plan_to_env(plan: ChaosPlan) -> str:
    """Serialize the plan's NETWORK schedule for `NET_PLAN_ENV` (the
    process-kill/NaN fields stay parent-side — a child that should die
    gets its own plan)."""
    return json.dumps({
        "net_seed": plan.net_seed,
        "net_faults": [dataclasses.asdict(f) for f in plan.net_faults],
    })


def install_net_plan_from_env() -> ChaosPlan | None:
    """Child-process hook: install the schedule `NET_PLAN_ENV` carries
    (no-op without it). Returns the installed plan."""
    raw = os.environ.get(NET_PLAN_ENV)
    if not raw:
        return None
    spec = json.loads(raw)
    plan = ChaosPlan(
        net_seed=int(spec.get("net_seed", 0)),
        net_faults=tuple(NetFault(**f) for f in spec.get("net_faults", ())),
    )
    install(plan)
    return plan


def maybe_kill(step: int | None = None, epoch: int | None = None) -> None:
    """Fire the plan's signal when the loop reaches the named point.

    The signal goes through the real OS delivery path (os.kill to self),
    so whatever handler the trainer installed — the PreemptionGuard —
    latches it exactly as it would a fleet preemption."""
    plan = _ACTIVE
    if plan is None or not _this_process_targeted(plan):
        return
    fire = (step is not None and plan.kill_at_step == step) or (
        epoch is not None and plan.kill_at_epoch == epoch
    )
    if fire:
        # Flight-record BEFORE delivery: the handler (or default action)
        # may end the process, and a chaos post-mortem should show the
        # injection as its own event ahead of the signal receipt.
        _flight_record_and_dump(
            "chaos_kill", reason="chaos_kill",
            step=step, epoch=epoch, signum=int(plan.kill_signal),
        )
        os.kill(os.getpid(), plan.kill_signal)


def maybe_die_in_save(step: int) -> None:
    """Die HARD (SIGKILL — no handlers, no atexit, no cleanup) when the
    plan names this checkpoint step, simulating a process lost mid-save.
    Called by `CheckpointManager.save`'s writer between the tensor file
    and the commit marker."""
    plan = _ACTIVE
    if plan is None or not _this_process_targeted(plan):
        return
    if plan.die_in_save_at_step == step:
        # SIGKILL runs no handlers: this dump is the ONLY post-mortem.
        _flight_record_and_dump(
            "chaos_die_in_save", reason="chaos_die_in_save", step=step,
        )
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_die_in_append(record: int, partial_write=None) -> None:
    """Die HARD (SIGKILL) when the plan names this log record, leaving a
    REAL torn tail: ``partial_write`` (the caller's torn-frame writer —
    StreamLogWriter passes one that puts the header plus half the
    payload durably on disk) runs first, then the process is killed with
    the frame incomplete. Called by `StreamLogWriter.append` BEFORE the
    full frame write."""
    plan = _ACTIVE
    if plan is None or not _this_process_targeted(plan):
        return
    if plan.die_in_append_at_record == record:
        if partial_write is not None:
            partial_write()
        _flight_record_and_dump(
            "chaos_die_in_append", reason="chaos_die_in_append",
            record=record,
        )
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_die_in_publish(step: int) -> None:
    """Die HARD (SIGKILL) when the plan names this PUBLISHED step, while
    the publish checkpoint's async write is still in flight — the
    serving-facing step must never end up committed. Called by the
    streaming trainer between starting the publish save and waiting on
    it."""
    plan = _ACTIVE
    if plan is None or not _this_process_targeted(plan):
        return
    if plan.die_in_publish_at_step == step:
        _flight_record_and_dump(
            "chaos_die_in_publish", reason="chaos_die_in_publish", step=step,
        )
        os.kill(os.getpid(), signal.SIGKILL)


class ChaosCrashError(RuntimeError):
    """Raised by `maybe_crash` to kill a component's thread in place —
    the in-process analogue of SIGKILL for components (the rollout
    controller) whose crash-consistency contract is a durable state
    file, not a checkpoint."""


def maybe_crash(stage: str) -> None:
    """Raise ChaosCrashError when the plan's ``crash_rollout_at`` names
    this stage boundary. The caller must NOT catch it — the owning
    thread dies, and recovery is exercised by constructing a fresh
    component over the same durable state."""
    plan = _ACTIVE
    if plan is None or not _this_process_targeted(plan):
        return
    if plan.crash_rollout_at == stage:
        _flight_record_and_dump(
            "chaos_crash", reason="chaos_crash", stage=stage,
        )
        raise ChaosCrashError(f"chaos crash at rollout stage {stage!r}")


def _flight_record_and_dump(kind: str, reason: str, **fields) -> None:
    try:
        from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder

        rec = get_flight_recorder()
        rec.record(kind, **fields)
        rec.dump(reason=reason)
    except Exception:
        pass  # chaos injection must fire even if the recorder cannot


def poison_batches(iterator: Iterable, start_step: int) -> Iterator:
    """Wrap a (batch, valid) iterator of numpy batches, NaN-ing float arrays
    at the plan's steps. ``start_step`` is the global step BEFORE the first yielded
    batch (batch i lands as global step start_step + 1 + i)."""
    for i, (batch, valid) in enumerate(iterator):
        plan = _ACTIVE
        if (
            plan is not None
            and _this_process_targeted(plan)
            and (start_step + 1 + i) in plan.nan_at_steps
        ):
            batch = {
                k: (np.full_like(v, np.nan)
                    if np.issubdtype(np.asarray(v).dtype, np.floating) else v)
                for k, v in batch.items()
            }
        yield batch, valid


# -- on-disk checkpoint damage (test fixtures) ------------------------------
#
# A step record is <ckpt_dir>/<step>/{tensors.pt, manifest.json, COMMITTED}
# (core/checkpoint.py). Truncation and noise hit the tensor file and leave
# the manifest and the marker intact: damage of DATA behind intact
# metadata must be caught too.

_TENSORS = "tensors.pt"


def _tensor_file(ckpt_dir: str, step: int) -> str:
    path = os.path.join(ckpt_dir, str(step), _TENSORS)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no tensor file in checkpoint step dir {os.path.dirname(path)}")
    return path


def truncate_checkpoint(ckpt_dir: str, step: int, keep_bytes: int = 8) -> None:
    """Truncate a step's tensor file — a writer killed mid-flush."""
    f = _tensor_file(ckpt_dir, step)
    with open(f, "r+b") as fh:
        fh.truncate(min(keep_bytes, os.path.getsize(f)))


def garble_checkpoint(ckpt_dir: str, step: int, seed: int = 0) -> None:
    """Overwrite a step's tensor bytes with noise — silent media corruption."""
    rng = np.random.default_rng(seed)
    f = _tensor_file(ckpt_dir, step)
    size = os.path.getsize(f)
    with open(f, "r+b") as fh:
        fh.write(rng.integers(0, 256, size=max(size, 1), dtype=np.uint8).tobytes())


def drop_commit_marker(ckpt_dir: str, step: int) -> None:
    """Delete a step's commit marker — a save interrupted mid-commit."""
    from genrec_tpu_torch.core.checkpoint import COMMIT_MARKER

    os.remove(os.path.join(ckpt_dir, str(step), COMMIT_MARKER))
