"""Guarded rollout: vet → canary → promote/rollback for published params
(port of genrec_tpu/serving/rollout.py).

The engine's own checkpoint watcher hot-swaps any structurally-valid
newer step — fine for a trusted directory, fatal for a continuous
pipeline where a half-trained or numerically-plausible-but-garbage step
can be published every few seconds. `RolloutController` is the guard
that stands between the streaming trainer's publish directory
(trainers/stream_trainer.py) and a fleet of serving replicas:

1. **Vet** (off the hot path): the candidate tree is scored on a PINNED
   vet batch by the head's dense serving function (``make_fn``) run
   under the candidate's weights through ``torch.func.functional_call``
   (`core.lora.call_merged`) on the controller's own head and module —
   no replica's weights are read or written — checking finite outputs,
   trie-valid sem-ids (every answer resolves to a real corpus item), and
   bounded score-distribution drift against the last-good step's scores
   on the SAME batch. A garbage tree that passes finite checks (scaled
   weights) fails the drift bound here.
2. **Canary**: the candidate is staged to ONE replica
   (`ServingEngine.stage_params` via the router's ``engine()`` accessor)
   and probed for a window against a baseline replica — failure rate,
   trie validity, `Response.params_step` provenance, and a bounded
   canary/baseline latency ratio.
3. **Promote or roll back**: fleet-wide staging on success; on failure
   the canary is re-staged to the PINNED last-good tree (a host copy held
   in memory — retention in the publish directory cannot remove it from
   under a rollback) and the candidate step is QUARANTINED in the
   controller's state file — vetoed or rolled-back steps are never
   retried.

Judged steps (quarantined, or at or below last-good) are skipped IN PLACE
on the integrity ladder: ``_skip_judged`` raises
`CheckpointMismatchError`, which the ladder leaves on disk, while bytes
that fail their checks are quarantined by the ladder itself
(core/checkpoint.py).

Crash consistency: every transition writes the atomic state file BEFORE
acting (intent logging). A controller killed mid-canary comes back,
rolls any replica still serving the candidate back to last-good, and
lets the candidate re-enter vetting (it never received a verdict); one
killed mid-promote finishes the promote (the verdict was already
durable). `ChaosPlan.crash_rollout_at` kills the poll thread at exactly
these boundaries; tests/test_torch_pipeline.py pins both recoveries.

The router is DUCK-TYPED (``replica_ids()`` / ``engine(rid)``), never
imported.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from genrec_tpu_torch.core import chaos
from genrec_tpu_torch.core.checkpoint import (
    COMMIT_MARKER,
    CheckpointManager,
    CheckpointMismatchError,
    host_copy,
    unflatten_like,
)
from genrec_tpu_torch.core.lora import call_merged
from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder
from genrec_tpu_torch.serving.engine import is_transient_fs_error

_STATE_FORMAT = 1


@dataclasses.dataclass
class RolloutConfig:
    """Canary policy knobs."""

    poll_secs: float = 0.5
    #: Max absolute per-score log-prob drift of the candidate's vet-batch
    #: scores vs the last-good step's (same batch, same function).
    vet_max_score_drift: float = 10.0
    #: Canary observation window and the minimum probe responses it must
    #: gather before a verdict (whichever is LATER).
    canary_window_s: float = 1.0
    canary_min_responses: int = 4
    #: Probe failure-rate bound over the window (exceptions / probes).
    canary_max_failure_rate: float = 0.0
    #: Canary median probe latency may be at most this multiple of the
    #: baseline replica's over the same window.
    canary_latency_ratio_max: float = 10.0
    #: Per-probe completion timeout.
    probe_timeout_s: float = 30.0
    #: How long to wait for a staged swap to apply on a replica.
    swap_timeout_s: float = 30.0


class RolloutError(RuntimeError):
    pass


class _RolloutState:
    """Durable controller state: atomic (tmp+fsync+rename) JSON with the
    checkpoint layer's commit discipline — a crash between any two
    syscalls leaves the previous state, never a torn file."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self.last_good_step: Optional[int] = None
        self.quarantined: set[int] = set()
        self.canary: Optional[dict] = None
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except FileNotFoundError:
            return
        if raw.get("format") != _STATE_FORMAT:
            raise RolloutError(
                f"rollout state format {raw.get('format')!r} != {_STATE_FORMAT}"
            )
        self.last_good_step = raw.get("last_good_step")
        self.quarantined = set(raw.get("quarantined", []))
        self.canary = raw.get("canary")

    def save(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "format": _STATE_FORMAT,
                "last_good_step": self.last_good_step,
                "quarantined": sorted(self.quarantined),
                "canary": self.canary,
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


def _pinned(tree):
    """A host copy of ``tree`` (laid out as it is) that no later in-place
    update of the serving weights reaches."""
    return unflatten_like(host_copy(tree), tree)


class RolloutController:
    """Watches a publish directory and guards every swap into a fleet.

    ``router`` is duck-typed: ``replica_ids() -> list[str]`` and
    ``engine(rid) -> ServingEngine``. The replicas' engines must NOT run
    their own checkpoint watcher on the same directory (build them
    without ``ckpt_dir``) — the controller owns all staging.

    ``head`` is the controller's OWN head, over a module no replica
    serves: the vet runs the head's ``make_fn`` under each candidate's
    weights (``functional_call`` swaps them in for the call), which a
    replica's batcher must never see. A head whose model shares tensors
    with a replica's served params is refused.

    ``params_like`` is the tree the engines currently serve (laid out as
    `ServingEngine.params`: the one head's state dict, or {head name:
    state dict}; used for integrity-ladder restores and, as a host copy,
    as the ultimate rollback fallback); ``initial_step`` its provenance
    step; ``params_select(tree)`` picks the vetted head's state dict out of
    a multi-head tree. ``vet_requests`` is the pinned vet batch — it
    doubles as the canary probe set unless ``probe_requests`` is given.
    """

    def __init__(self, router, head, publish_dir: str, *,
                 params_like, vet_requests: Sequence,
                 state_path: str, initial_step: Optional[int] = None,
                 probe_requests: Optional[Sequence] = None,
                 config: Optional[RolloutConfig] = None,
                 params_select=None, logger=None):
        self._router = router
        self._head = head
        self._check_owns_module(router, head)
        self._mgr = CheckpointManager(publish_dir)
        self._publish_dir = publish_dir
        self._params_like = params_like
        self._select = params_select or (lambda tree: tree)
        self.vet_requests = list(vet_requests)
        self.probe_requests = list(probe_requests or vet_requests)
        if not self.vet_requests:
            raise ValueError("rollout needs a non-empty pinned vet batch")
        self.cfg = config or RolloutConfig()
        self._log = logger or logging.getLogger("genrec_tpu_torch.rollout")
        self._flight = get_flight_recorder()
        self._state = _RolloutState(state_path)
        if self._state.last_good_step is None:
            self._state.last_good_step = initial_step
        # The PINNED last-good tree: rollback never depends on the
        # publish dir still retaining the step.
        self._last_good_tree = _pinned(params_like)
        self._vet_fn = None
        self._vet_args = None
        self._baseline_scores: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        self._counters = {"staged": 0, "promotions": 0, "vetoes": 0,
                          "rollbacks": 0, "watcher_errors": 0}
        self._freshness_s = 0.0
        self._canary_step: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _check_owns_module(router, head) -> None:
        """Refuse a vet head whose module a replica serves: the vet's
        parameter swap would reach that replica's calls."""
        own = {t.data_ptr() for t in head.model.state_dict().values() if t.numel()}
        for rid in router.replica_ids():
            served = getattr(router.engine(rid), "params", None)
            if served is None:
                continue
            tree = served()
            sds = tree.values() if all(isinstance(v, dict) for v in tree.values()) else [tree]
            if any(t.data_ptr() in own for sd in sds for t in sd.values() if t.numel()):
                raise ValueError(
                    f"rollout: the vet head's model is replica {rid!r}'s; give the "
                    "controller a head over a module of its own")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "RolloutController":
        self._recover()
        self._thread = threading.Thread(
            target=self._poll_loop, name="rollout-controller", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> dict:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None
        self._mgr.close()
        return self.stats()

    @property
    def alive(self) -> bool:
        """False once the poll thread died (e.g. a chaos crash)."""
        return self._thread is not None and self._thread.is_alive()

    def stats(self) -> dict:
        """The ``stats()["rollout"]`` payload: counters
        staged/promotions/vetoes/rollbacks/watcher_errors, gauges
        last_good_step/canary_step (-1 when unset) and the last promote's
        commit→serving ``freshness_s``."""
        with self._lock:
            lg = self._state.last_good_step
            return {
                **self._counters,
                "last_good_step": -1 if lg is None else int(lg),
                "canary_step": (-1 if self._canary_step is None
                                else int(self._canary_step)),
                "quarantined_steps": len(self._state.quarantined),
                "freshness_s": round(self._freshness_s, 6),
            }

    # -- poll loop ----------------------------------------------------------

    def _poll_loop(self) -> None:
        # The engine's checkpoint watcher's transient-vs-bug classification
        # and bounded backoff: a network-mount blip is not "no new step".
        # ChaosCrashError propagates — the thread dies where a process
        # crash would.
        backoff = 0.0
        while not self._stop.wait(self.cfg.poll_secs + backoff):
            try:
                self._poll_once()
                backoff = 0.0
            except chaos.ChaosCrashError:
                raise
            except Exception as e:  # noqa: BLE001 — keep guarding
                transient = is_transient_fs_error(e)
                with self._lock:
                    self._counters["watcher_errors"] += 1
                self._flight.record(
                    "watcher_error", component="rollout",
                    transient=transient, error=f"{type(e).__name__}: {e}",
                )
                if transient:
                    backoff = min(max(2 * backoff, self.cfg.poll_secs), 30.0)
                    self._log.warning(
                        f"rollout: transient publish-dir error "
                        f"({type(e).__name__}: {e}); backing off"
                    )
                else:
                    backoff = 0.0
                    self._log.exception("rollout: poll pass failed")

    def _skip_judged(self, restored, step: int) -> None:
        """extra_validate rung: quarantined (vetoed/rolled-back) and
        already-serving steps are skipped IN PLACE on the integrity
        ladder — never restored, never retried."""
        del restored
        lg = self._state.last_good_step
        if step in self._state.quarantined or (lg is not None and step <= lg):
            raise CheckpointMismatchError(
                f"rollout: step {step} already judged (quarantined or <= "
                f"last-good {lg})"
            )

    def _poll_once(self) -> None:
        self._mgr.reload()
        latest = self._mgr.latest_step()
        lg = self._state.last_good_step
        if latest is None or (lg is not None and latest <= lg):
            return
        if latest in self._state.quarantined:
            return
        restored, step = self._mgr.restore_latest_valid(
            self._params_like, extra_validate=self._skip_judged
        )
        if restored is None:
            return
        self._consider(restored, step)

    # -- vet ----------------------------------------------------------------

    def _ensure_vet_fn(self) -> None:
        if self._vet_fn is not None:
            return
        reqs = self.vet_requests
        B = len(reqs)
        L = max(1, max(self._head.natural_len(r) for r in reqs))
        self._vet_fn = self._head.make_fn(B, L)
        self._vet_args = self._head.make_batch(reqs, B, L)

    def _vet_scores(self, tree) -> tuple[list[dict], np.ndarray]:
        self._ensure_vet_fn()
        head = self._head
        weights = {k: v.to(head.device) for k, v in self._select(tree).items()}
        with torch.no_grad():
            out = call_merged(head.model, weights, lambda _model, *a: self._vet_fn(*a),
                              *head.runtime_operands(), *self._vet_args)
        payloads = head.finalize(tuple(o.cpu().numpy() for o in out), self.vet_requests)
        scores = np.concatenate(
            [np.ravel(np.asarray(p["scores"], np.float64)) for p in payloads]
        )
        return payloads, scores

    def _vet(self, tree, step: int) -> dict:
        """Score the candidate on the pinned vet batch, OFF the serving
        hot path (the controller's own head). The drift bound compares
        the full score distribution against the pinned last-good tree's
        scores on the SAME batch — a scaled-weights tree passes finite
        checks but not this."""
        if self._baseline_scores is None:
            _, self._baseline_scores = self._vet_scores(self._last_good_tree)
        payloads, scores = self._vet_scores(tree)
        finite = all(bool(np.isfinite(p["scores"]).all()) for p in payloads)
        trie_valid = all(
            bool((np.asarray(p["items"]) >= 0).all()) for p in payloads
        )
        drift = (float(np.max(np.abs(scores - self._baseline_scores)))
                 if finite else float("inf"))
        ok = finite and trie_valid and drift <= self.cfg.vet_max_score_drift
        return {"ok": ok, "finite": finite, "trie_valid": trie_valid,
                "drift": drift, "step": step}

    # -- canary / promote / rollback ----------------------------------------

    def _commit_mtime(self, step: int) -> float:
        try:
            return os.path.getmtime(
                os.path.join(self._publish_dir, str(step), COMMIT_MARKER)
            )
        except OSError:
            return time.time()

    def _wait_swap(self, engine, step: Optional[int]) -> None:
        deadline = time.monotonic() + self.cfg.swap_timeout_s
        while engine.params_step != step:
            if time.monotonic() > deadline:
                raise RolloutError(
                    f"swap to step {step} did not apply within "
                    f"{self.cfg.swap_timeout_s}s"
                )
            time.sleep(0.005)

    def _quarantine(self, step: int, verdict: dict, *, kind: str,
                    counter: str) -> None:
        with self._lock:
            self._state.quarantined.add(step)
            self._state.canary = None
            self._state.save()
            self._counters[counter] += 1
            self._canary_step = None
        self._flight.record(kind, step=step, **{
            k: v for k, v in verdict.items() if k != "step"
        })
        self._log.warning(f"rollout: step {step} {kind} ({verdict})")

    def _consider(self, tree, step: int) -> None:
        commit_t = self._commit_mtime(step)
        verdict = self._vet(tree, step)
        if not verdict["ok"]:
            self._quarantine(step, verdict, kind="rollout_vetoed",
                             counter="vetoes")
            return
        rids = list(self._router.replica_ids())
        if not rids:
            raise RolloutError("rollout: no live replicas to canary on")
        canary_rid = rids[-1]
        # Intent BEFORE action: a crash from here on finds the canary
        # record and rolls the replica back on recovery.
        with self._lock:
            self._state.canary = {"step": step, "replica": canary_rid,
                                  "stage": "canary"}
            self._state.save()
            self._counters["staged"] += 1
            self._canary_step = step
        engine = self._router.engine(canary_rid)
        engine.stage_params(tree, step, source="rollout_canary")
        self._flight.record("rollout_staged", step=step, replica=canary_rid)
        self._log.info(
            f"rollout: step {step} staged to canary {canary_rid}"
        )
        chaos.maybe_crash("canary")
        self._wait_swap(engine, step)
        window = self._canary_window(canary_rid, step)
        if not window["ok"]:
            self._rollback(step, window)
            return
        with self._lock:
            self._state.canary["stage"] = "promote"
            self._state.save()
        chaos.maybe_crash("promote")
        self._promote(tree, step, commit_t, window)

    def _probe(self, engine, timeout: float):
        results = []
        for req in self.probe_requests:
            try:
                req = dataclasses.replace(req)
            except TypeError:
                pass
            t0 = time.monotonic()
            fut = engine.submit(req)
            resp = fut.result(timeout=timeout)
            results.append((resp, time.monotonic() - t0))
        return results

    def _canary_window(self, canary_rid: str, step: int) -> dict:
        """Windowed SLO/quality comparison: probe the canary and a
        baseline replica with the same pinned requests until the window
        AND the minimum response count are both satisfied."""
        cfg = self.cfg
        engine = self._router.engine(canary_rid)
        base_rid = next(
            (r for r in self._router.replica_ids() if r != canary_rid), None
        )
        base_engine = self._router.engine(base_rid) if base_rid else None
        deadline = time.monotonic() + cfg.canary_window_s
        n = failures = invalid = provenance = 0
        canary_lat: list[float] = []
        base_lat: list[float] = []
        while time.monotonic() < deadline or n < cfg.canary_min_responses:
            try:
                for resp, dt in self._probe(engine, cfg.probe_timeout_s):
                    n += 1
                    canary_lat.append(dt)
                    if resp.params_step != step:
                        provenance += 1
                    items = np.asarray(resp.items)
                    scores = np.asarray(resp.scores, np.float64)
                    if items.size and not bool((items >= 0).all()):
                        invalid += 1
                    if not bool(np.isfinite(scores).all()):
                        invalid += 1
            except Exception:  # noqa: BLE001 — a failed probe IS the signal
                n += 1
                failures += 1
            if base_engine is not None:
                try:
                    for _, dt in self._probe(base_engine, cfg.probe_timeout_s):
                        base_lat.append(dt)
                except Exception:  # noqa: BLE001
                    pass  # baseline trouble must not veto the candidate
        failure_rate = failures / n if n else 1.0
        ratio = 1.0
        if canary_lat and base_lat:
            ratio = float(np.median(canary_lat) / max(np.median(base_lat),
                                                      1e-9))
        ok = (failure_rate <= cfg.canary_max_failure_rate
              and invalid == 0 and provenance == 0
              and ratio <= cfg.canary_latency_ratio_max)
        return {"ok": ok, "probes": n, "failures": failures,
                "invalid": invalid, "provenance_mismatches": provenance,
                "latency_ratio": round(ratio, 3)}

    def _promote(self, tree, step: int, commit_t: float, window: dict,
                 recovered: bool = False) -> None:
        for rid in self._router.replica_ids():
            engine = self._router.engine(rid)
            if engine.params_step == step:
                continue
            engine.stage_params(tree, step, source="rollout_promote")
            self._wait_swap(engine, step)
        _, self._baseline_scores = self._vet_scores(tree)
        with self._lock:
            self._last_good_tree = tree
            self._state.last_good_step = step
            self._state.canary = None
            self._state.save()
            self._counters["promotions"] += 1
            self._canary_step = None
            self._freshness_s = max(0.0, time.time() - commit_t)
        self._flight.record("rollout_promoted", step=step,
                            freshness_s=self._freshness_s,
                            recovered=recovered, **window)
        self._log.info(
            f"rollout: step {step} promoted fleet-wide "
            f"(freshness {self._freshness_s:.3f}s)"
        )

    def _rollback(self, step: int, window: dict) -> None:
        """Canary failed: re-stage the pinned last-good tree on every
        replica serving the candidate, then quarantine the step."""
        lg = self._state.last_good_step
        for rid in self._router.replica_ids():
            engine = self._router.engine(rid)
            if engine.params_step == step:
                engine.stage_params(self._last_good_tree, lg,
                                    source="rollout_rollback")
                self._wait_swap(engine, lg)
        self._quarantine(step, window, kind="rollout_rolled_back",
                         counter="rollbacks")

    # -- crash recovery -----------------------------------------------------

    def _restore_step(self, step: int):
        try:
            return self._mgr.validate_and_restore(self._params_like, step)
        except Exception as e:  # noqa: BLE001
            self._log.warning(
                f"rollout recovery: cannot restore step {step}: {e}"
            )
            return None

    def _recover(self) -> None:
        """Resolve a canary record left by a crashed controller.

        - stage "canary": no verdict was reached — roll every replica
          serving the candidate back to last-good; the candidate is NOT
          quarantined and legitimately re-enters vetting on the next
          poll.
        - stage "promote": the verdict was durable before the crash —
          finish the promote (restoring the candidate from the publish
          dir; if it vanished, quarantine it instead).
        """
        canary = self._state.canary
        if canary is None:
            return
        step, stage = int(canary["step"]), canary["stage"]
        self._log.warning(
            f"rollout recovery: found in-flight canary step {step} "
            f"(stage={stage!r})"
        )
        if stage == "promote":
            tree = self._restore_step(step)
            if tree is not None:
                self._promote(tree, step, self._commit_mtime(step),
                              {"recovery": True}, recovered=True)
                return
            self._quarantine(step, {"recovery": "candidate unrestorable"},
                             kind="rollout_rolled_back", counter="rollbacks")
            return
        lg = self._state.last_good_step
        for rid in self._router.replica_ids():
            engine = self._router.engine(rid)
            # The recorded canary replica gets re-staged UNCONDITIONALLY:
            # the crash may have landed between staging and the swap, so
            # the candidate could still be pending there without showing
            # in params_step yet.
            if rid == canary.get("replica") or engine.params_step == step:
                engine.stage_params(self._last_good_tree, lg,
                                    source="rollout_recovery")
                self._wait_swap(engine, lg)
        with self._lock:
            self._state.canary = None
            self._state.save()
            self._canary_step = None
        self._flight.record("rollout_rolled_back", step=step, recovery=True,
                            requeued=True)
