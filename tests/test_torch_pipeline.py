"""The continuous pipeline in the port: append-only log -> StreamTrainer ->
publish dir -> guarded rollout (genrec_tpu_torch/trainers/stream_trainer.py
and serving/rollout.py against tests/test_pipeline.py's cases), held to the
JAX package where the two compute the same numbers.

Kill points, as tests/test_pipeline.py has them: a REAL SIGKILL of the
appender with a torn frame on disk, of the trainer mid-commit and
mid-publish (subprocesses: tests/_torch_pipeline_worker.py), an in-process
SIGTERM mid-chunk, and the rollout controller's thread crashing mid-canary
and mid-promote (``crash_rollout_at``). Every one asserts EXACTNESS: zero
lost or duplicated records, per-step loss parity, durable quarantine.

Against JAX, on scripts/check_pipeline.py's tiny TIGER (AdamW 1e-3,
weight decay 0.01, clip 1.0) with the JAX initialisation carried over by
``convert.tiger_params_from_flax``: the port's per-step stream losses
equal JAX's StreamTrainer's within 1e-5 (over a log the port wrote and
both read), and the controller's vet scores equal JAX
``TigerGenerativeHead.make_fn``'s within 1e-4 at T 0.2, sem-ids equal.
On real paged engines a vetoed garbage tree leaves both replicas' state
dicts bit-unchanged.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import Future
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch import nn

from genrec_tpu.serving.heads import TigerGenerativeHead as JaxTigerHead
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.core import chaos
from genrec_tpu_torch.core.checkpoint import COMMIT_MARKER, CheckpointManager
from genrec_tpu_torch.data.stream_log import StreamLogReader, StreamLogWriter
from genrec_tpu_torch.models.tiger import Tiger
from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder
from genrec_tpu_torch.serving.buckets import BucketLadder
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import TigerGenerativeHead
from genrec_tpu_torch.serving.kv_pool import PagedConfig
from genrec_tpu_torch.serving.rollout import RolloutConfig, RolloutController
from genrec_tpu_torch.serving.types import Request
from tests._torch_pipeline_worker import toy_stream_trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(REPO, "tests", "_torch_pipeline_worker.py")


def _check_pipeline():
    """scripts/check_pipeline.py as a module: its TIGER fixture, record
    stream and JAX StreamTrainer."""
    spec = importlib.util.spec_from_file_location(
        "check_pipeline", os.path.join(REPO, "scripts", "check_pipeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CP = _check_pipeline()


def _run_worker(mode, cfg, expect_sigkill=False):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, _WORKER, mode, json.dumps(cfg)],
        capture_output=True, text=True, cwd=REPO, timeout=600, env=env,
    )
    if expect_sigkill:
        assert proc.returncode == -9, (proc.returncode, proc.stderr[-2000:])
        return None
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("WORKER ")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[-1][len("WORKER "):])


def _expected_rows(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 6)).astype(np.float32)


# ---------------------------------------------------------------------------
# stage: log append (SIGKILL with a torn frame on disk)
# ---------------------------------------------------------------------------


def test_append_sigkill_resumes_with_zero_loss_zero_duplication(tmp_path):
    log_dir = str(tmp_path / "log")
    cfg = {"log_dir": log_dir, "n": 20, "seed": 3}
    _run_worker("append", {**cfg, "die_at": 7}, expect_sigkill=True)
    # Records 0..6 committed; record 7 is a REAL torn frame on disk.
    reader = StreamLogReader(log_dir)
    assert reader.count() == 7
    # Restarted producer: resumes at the committed index, replays nothing.
    out = _run_worker("append", cfg)
    assert out == {"resumed_from": 7, "committed": 20}
    got = [np.frombuffer(p, np.float32) for p in reader.read()]
    np.testing.assert_array_equal(np.stack(got), _expected_rows(20, 3))


# ---------------------------------------------------------------------------
# stage: trainer (SIGTERM mid-chunk, in-process)
# ---------------------------------------------------------------------------


def _fill_log(log_dir, n, seed=0):
    with StreamLogWriter(log_dir) as w:
        for row in _expected_rows(n, seed):
            w.append(row.tobytes())


def _losses_by_step(save_dir, allow_replay=False):
    """Step -> loss from metrics.jsonl. A SIGTERM'd+resumed run may not
    log any step twice; a SIGKILL'd run replays the steps after its last
    durable commit — then every replayed value must agree with the
    original to 1e-5 (that agreement IS the exactness claim)."""
    out = {}
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "train/loss" in rec and "global_step" in rec:
                step = int(rec["global_step"])
                if step in out:
                    assert allow_replay, f"step {step} logged twice"
                    assert out[step] == pytest.approx(
                        rec["train/loss"], abs=1e-5
                    ), f"replayed step {step} diverged"
                out[step] = rec["train/loss"]
    return out


def _trainer_cfg(tmp_path, name, **kw):
    return {
        "log_dir": str(tmp_path / "log"), "save_dir": str(tmp_path / name),
        "publish_dir": str(tmp_path / name / "publish"), "max_chunks": 3,
        **kw,
    }


def _restore_published(publish_dir, step):
    return CheckpointManager(publish_dir).validate_and_restore(
        {"w": torch.zeros((4, 2))}, step)


def test_stream_trainer_sigterm_midchunk_resumes_exactly(tmp_path):
    _fill_log(str(tmp_path / "log"), 48)
    cfg_a = _trainer_cfg(tmp_path, "uninterrupted")
    summary = toy_stream_trainer(cfg_a).run(max_chunks=3, idle_timeout_s=1.0)
    assert summary["chunks_done"] == 3 and summary["global_step"] == 6
    assert summary["published_steps"] == [2, 4, 6]

    cfg_b = _trainer_cfg(tmp_path, "interrupted")
    with chaos.inject(chaos.ChaosPlan(kill_at_step=3)):
        out = toy_stream_trainer(cfg_b).run(max_chunks=3, idle_timeout_s=1.0)
    assert out["preempted"] and out["global_step"] == 3
    out = toy_stream_trainer(cfg_b).run(max_chunks=3, idle_timeout_s=1.0)
    assert not out["preempted"] and out["global_step"] == 6
    assert out["records_consumed"] == 48

    la = _losses_by_step(cfg_a["save_dir"])
    lb = _losses_by_step(cfg_b["save_dir"])
    assert sorted(la) == sorted(lb) == [1, 2, 3, 4, 5, 6]
    for s in la:
        assert la[s] == pytest.approx(lb[s], abs=1e-5), f"diverged at {s}"
    # The published param trees match step for step.
    for step in (2, 4, 6):
        torch.testing.assert_close(_restore_published(cfg_a["publish_dir"], step)["w"],
                                   _restore_published(cfg_b["publish_dir"], step)["w"],
                                   atol=1e-5, rtol=0)
    # The durable cursor names the fully-consumed stream position.
    with open(os.path.join(cfg_b["save_dir"], "stream_cursor.json")) as f:
        cur = json.load(f)
    assert cur["record"] == 48 and cur["meta"]["global_step"] == 6


def test_stream_trainer_waits_for_records_then_consumes(tmp_path):
    """The tail loop blocks on chunk availability — a half-written chunk
    is never repacked — and picks up records appended while idle."""
    log_dir = str(tmp_path / "log")
    _fill_log(log_dir, 8)  # half a chunk
    cfg = _trainer_cfg(tmp_path, "run", max_chunks=1)
    summary = toy_stream_trainer(cfg).run(max_chunks=1, idle_timeout_s=0.5)
    assert summary["chunks_done"] == 0 and summary["global_step"] == 0
    with StreamLogWriter(log_dir) as w:
        for row in _expected_rows(16, 0)[8:]:
            w.append(row.tobytes())
    summary = toy_stream_trainer(cfg).run(max_chunks=1, idle_timeout_s=0.5)
    assert summary["chunks_done"] == 1 and summary["global_step"] == 2


# ---------------------------------------------------------------------------
# stage: trainer mid-commit / publish (SIGKILL, subprocess)
# ---------------------------------------------------------------------------


def test_trainer_sigkill_mid_commit_resumes_exactly(tmp_path):
    _fill_log(str(tmp_path / "log"), 48)
    cfg_a = _trainer_cfg(tmp_path, "uninterrupted")
    toy_stream_trainer(cfg_a).run(max_chunks=3, idle_timeout_s=1.0)

    cfg_b = _trainer_cfg(tmp_path, "interrupted")
    _run_worker("train", {**cfg_b, "die_in_save": 3}, expect_sigkill=True)
    out = _run_worker("train", cfg_b)
    assert out["global_step"] == 6 and not out["preempted"]

    la = _losses_by_step(cfg_a["save_dir"])
    lb = _losses_by_step(cfg_b["save_dir"], allow_replay=True)
    assert sorted(la) == sorted(lb) == [1, 2, 3, 4, 5, 6]
    for s in la:
        assert la[s] == pytest.approx(lb[s], abs=1e-5), f"diverged at {s}"
    torch.testing.assert_close(_restore_published(cfg_a["publish_dir"], 6)["w"],
                               _restore_published(cfg_b["publish_dir"], 6)["w"],
                               atol=1e-5, rtol=0)


def test_trainer_sigkill_mid_publish_never_commits_torn_step(tmp_path):
    """SIGKILL between the publish's tensor file and its commit marker:
    step 2 must never become a COMMITTED publish, and the restarted
    trainer must carry on exactly with later publishes."""
    _fill_log(str(tmp_path / "log"), 48)
    cfg = _trainer_cfg(tmp_path, "run")
    _run_worker("train", {**cfg, "die_in_publish": 2}, expect_sigkill=True)
    assert not os.path.exists(
        os.path.join(cfg["publish_dir"], "2", COMMIT_MARKER)
    )
    assert CheckpointManager(cfg["publish_dir"]).all_steps() == []

    out = _run_worker("train", cfg)
    assert out["global_step"] == 6
    # Exact resume lands BEFORE the interrupted boundary publish, so the
    # restarted run re-publishes step 2 properly (identical params —
    # that's what exact resume means) and carries on: every published
    # step is now committed with a marker and restorable.
    for step in (2, 4, 6):
        assert os.path.exists(
            os.path.join(cfg["publish_dir"], str(step), COMMIT_MARKER)
        )
        assert torch.isfinite(_restore_published(cfg["publish_dir"], step)["w"]).all()
    losses = _losses_by_step(cfg["save_dir"], allow_replay=True)
    assert sorted(losses) == [1, 2, 3, 4, 5, 6]


def test_trainer_quarantines_marker_less_publish_on_start(tmp_path):
    """A step directory without its commit marker is quarantined at the
    next trainer start — it can never collide with a re-publish or reach
    the rollout guard."""
    _fill_log(str(tmp_path / "log"), 48)
    cfg = _trainer_cfg(tmp_path, "run")
    summary = toy_stream_trainer(cfg).run(max_chunks=1, idle_timeout_s=1.0)
    assert summary["published_steps"] == [2]
    chaos.drop_commit_marker(cfg["publish_dir"], 2)

    out = toy_stream_trainer(cfg).run(max_chunks=3, idle_timeout_s=1.0)
    assert out["global_step"] == 6
    # The torn dir went out of discovery (quarantine nests per process:
    # quarantine/p0/2) — and exact resume then RE-published step 2
    # properly, marker and all, into the now-free slot.
    quarantined = [
        name for _, dirs, _ in os.walk(
            os.path.join(cfg["publish_dir"], "quarantine")
        ) for name in dirs
    ]
    assert "2" in quarantined
    for step in (2, 4, 6):
        assert os.path.exists(
            os.path.join(cfg["publish_dir"], str(step), COMMIT_MARKER)
        )


# ---------------------------------------------------------------------------
# stage: guarded rollout (fake fleet — the state machine, not the engines)
# ---------------------------------------------------------------------------


class FakeHead:
    """Duck-typed serving head over a module of its own: scores are an
    affine function of the weights, so score drift tracks weight damage
    exactly."""

    name = "fake"

    def __init__(self):
        self.model = nn.Module()
        self.model.w = nn.Parameter(torch.zeros((4, 2)))

    @property
    def device(self):
        return self.model.w.device

    def natural_len(self, req):
        return 4

    def make_fn(self, B, L):
        def fn(x):
            return (x @ self.model.w,)

        return fn

    def make_batch(self, reqs, B, L):
        return (torch.ones((B, 4)),)

    def runtime_operands(self):
        return ()

    def finalize(self, outputs, reqs):
        (scores,) = outputs
        return [{"items": np.zeros(2, np.int64), "scores": scores[i]}
                for i in range(len(reqs))]


class FakeEngine:
    """Duck-typed replica: staged params apply instantly (the real
    engine's swap barrier is held by tests/test_torch_hot_reload.py)."""

    def __init__(self, rid, params, step=0):
        self.replica_id = rid
        self._params = params
        self._step = step
        self.staged_log = []
        self.bad_serving_steps = set()

    @property
    def params_step(self):
        return self._step

    def stage_params(self, tree, step, *, source="rollout"):
        self.staged_log.append((step, source))
        self._params, self._step = tree, step

    def submit(self, req):
        fut = Future()
        bad = self._step in self.bad_serving_steps
        fut.set_result(SimpleNamespace(
            params_step=self._step,
            items=np.full(2, -1 if bad else 1, np.int64),
            scores=float(self._params["w"].sum()) * np.ones(2),
        ))
        return fut


class FakeRouter:
    def __init__(self, params, rids=("r0", "r1")):
        self.engines = {r: FakeEngine(r, params) for r in rids}

    def replica_ids(self):
        return list(self.engines)

    def engine(self, rid):
        return self.engines[rid]


def _params(scale=1.0):
    return {"w": torch.full((4, 2), scale)}


def _rollout(tmp_path, router, **kw):
    cfg = RolloutConfig(poll_secs=0.02, canary_window_s=0.05,
                        canary_min_responses=1, vet_max_score_drift=1.0,
                        swap_timeout_s=5.0, probe_timeout_s=5.0)
    return RolloutController(
        router, FakeHead(), str(tmp_path / "publish"),
        params_like=_params(1.0),
        vet_requests=[Request(head="fake", history=np.array([1, 2]))],
        state_path=str(tmp_path / "rollout_state.json"),
        initial_step=0, config=cfg, **kw,
    )


def _publish(tmp_path, step, tree):
    CheckpointManager(str(tmp_path / "publish")).save(step, tree)


def _wait(pred, secs=20.0):
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError("condition not reached")


def test_rollout_vets_canary_promotes_with_provenance(tmp_path):
    router = FakeRouter(_params(1.0))
    ctrl = _rollout(tmp_path, router).start()
    try:
        _publish(tmp_path, 1, _params(1.001))
        _wait(lambda: ctrl.stats()["last_good_step"] == 1)
        s = ctrl.stats()
        assert s["staged"] == 1 and s["promotions"] == 1
        assert s["vetoes"] == 0 and s["rollbacks"] == 0
        assert s["canary_step"] == -1 and s["freshness_s"] >= 0.0
        for e in router.engines.values():
            assert e.params_step == 1
            assert e.submit(None).result().params_step == 1
        # The canary replica saw the candidate BEFORE the fleet did.
        canary = router.engines["r1"]
        assert canary.staged_log[0] == (1, "rollout_canary")
        fr = get_flight_recorder()
        assert fr.events("rollout_staged") and fr.events("rollout_promoted")
    finally:
        ctrl.stop()


def test_rollout_vetoes_garbage_and_quarantines_forever(tmp_path):
    router = FakeRouter(_params(1.0))
    ctrl = _rollout(tmp_path, router).start()
    try:
        _publish(tmp_path, 1, _params(50.0))  # finite but wildly drifted
        _wait(lambda: ctrl.stats()["vetoes"] == 1)
        s = ctrl.stats()
        assert s["last_good_step"] == 0 and s["quarantined_steps"] == 1
        # The garbage NEVER touched a replica.
        for e in router.engines.values():
            assert e.params_step == 0 and e.staged_log == []
        assert get_flight_recorder().events("rollout_vetoed")
    finally:
        ctrl.stop()
    # The judged step stays on disk (skipped in place, not moved), and the
    # quarantine is durable: a fresh controller never retries the step.
    assert CheckpointManager(str(tmp_path / "publish")).all_steps() == [1]
    ctrl2 = _rollout(tmp_path, router).start()
    try:
        time.sleep(0.3)
        s = ctrl2.stats()
        assert s["vetoes"] == 0 and s["staged"] == 0
        assert s["quarantined_steps"] == 1 and s["last_good_step"] == 0
    finally:
        ctrl2.stop()


def test_rollout_rolls_back_bad_canary_window(tmp_path):
    """A candidate that passes the vet but misbehaves under live probes
    (trie-invalid answers) is rolled back: the canary replica returns to
    last-good, the step is quarantined, the fleet never saw it."""
    router = FakeRouter(_params(1.0))
    router.engines["r1"].bad_serving_steps.add(1)
    ctrl = _rollout(tmp_path, router).start()
    try:
        _publish(tmp_path, 1, _params(1.0004))
        _wait(lambda: ctrl.stats()["rollbacks"] == 1)
        s = ctrl.stats()
        assert s["promotions"] == 0 and s["quarantined_steps"] == 1
        assert s["last_good_step"] == 0
        canary = router.engines["r1"]
        assert canary.params_step == 0
        assert canary.staged_log[-1][1] == "rollout_rollback"
        assert router.engines["r0"].staged_log == []
        assert get_flight_recorder().events("rollout_rolled_back")
    finally:
        ctrl.stop()


def test_rollout_crash_mid_canary_rolls_back_and_requeues(tmp_path):
    router = FakeRouter(_params(1.0))
    ctrl = _rollout(tmp_path, router).start()
    try:
        with chaos.inject(chaos.ChaosPlan(crash_rollout_at="canary")):
            _publish(tmp_path, 1, _params(1.001))
            _wait(lambda: not ctrl.alive)
        # Died with the candidate on the canary replica and the durable
        # intent record pointing at it.
        assert router.engines["r1"].params_step == 1
        assert ctrl.stats()["canary_step"] == 1
    finally:
        ctrl.stop()
    ctrl2 = _rollout(tmp_path, router)
    ctrl2.start()
    try:
        # Recovery rolled the canary back to last-good, then the poll
        # loop legitimately re-vetted the (unjudged) candidate and
        # promoted it.
        assert (0, "rollout_recovery") in router.engines["r1"].staged_log
        _wait(lambda: ctrl2.stats()["last_good_step"] == 1)
        assert ctrl2.stats()["promotions"] == 1
        assert router.engines["r0"].params_step == 1
    finally:
        ctrl2.stop()


def test_rollout_crash_mid_promote_finishes_promote(tmp_path):
    router = FakeRouter(_params(1.0))
    ctrl = _rollout(tmp_path, router).start()
    try:
        with chaos.inject(chaos.ChaosPlan(crash_rollout_at="promote")):
            _publish(tmp_path, 1, _params(1.001))
            _wait(lambda: not ctrl.alive)
    finally:
        ctrl.stop()
    # The canary verdict was durable: recovery completes the promote
    # during start(), before the poll loop runs.
    ctrl2 = _rollout(tmp_path, router)
    ctrl2.start()
    try:
        s = ctrl2.stats()
        assert s["last_good_step"] == 1 and s["promotions"] == 1
        for e in router.engines.values():
            assert e.params_step == 1
    finally:
        ctrl2.stop()


def test_rollout_transient_poll_errors_back_off_then_recover(tmp_path):
    """A network-mount blip on the publish dir is not 'no new step':
    classified transient, counted, narrated, retried with backoff — and
    the candidate still lands once the dir heals."""
    router = FakeRouter(_params(1.0))
    ctrl = _rollout(tmp_path, router)
    real_reload, blips = ctrl._mgr.reload, [0]

    def flaky_reload():
        if blips[0] < 2:
            blips[0] += 1
            raise OSError("stale file handle")
        return real_reload()

    ctrl._mgr.reload = flaky_reload
    fr = get_flight_recorder()
    before = len(fr.events("watcher_error"))
    ctrl.start()
    try:
        _publish(tmp_path, 1, _params(1.001))
        _wait(lambda: ctrl.stats()["last_good_step"] == 1)
        assert ctrl.stats()["watcher_errors"] == 2
        events = fr.events("watcher_error")[before:]
        assert len(events) == 2
        assert all(e["transient"] and e["component"] == "rollout" for e in events)
    finally:
        ctrl.stop()


def test_is_transient_fs_error_classification():
    from genrec_tpu_torch.serving.engine import is_transient_fs_error

    assert is_transient_fs_error(OSError("stale file handle"))
    assert is_transient_fs_error(FileNotFoundError("gone"))
    assert is_transient_fs_error(TimeoutError("nfs"))  # OSError subclass
    assert not is_transient_fs_error(ValueError("a bug"))
    assert not is_transient_fs_error(KeyError("a bug"))


def test_serving_metrics_watcher_errors_counter():
    from genrec_tpu_torch.serving.metrics import ServingMetrics

    m = ServingMetrics()
    assert m.snapshot()["watcher_errors"] == 0
    m.record_watcher_error()
    m.record_watcher_error()
    assert m.snapshot()["watcher_errors"] == 2


def test_rollout_probe_requests_are_copied():
    """_probe must not mutate or share the pinned request objects."""
    req = Request(head="fake", history=np.array([1, 2]))
    router = FakeRouter(_params(1.0))
    eng = router.engines["r0"]
    seen = []
    orig = eng.submit

    def submit(r):
        seen.append(r)
        return orig(r)

    eng.submit = submit
    with tempfile.TemporaryDirectory() as d:
        ctrl = RolloutController(
            router, FakeHead(), os.path.join(d, "pub"),
            params_like=_params(0.0), vet_requests=[req],
            state_path=os.path.join(d, "s.json"), initial_step=0,
            config=RolloutConfig(probe_timeout_s=5.0),
        )
        ctrl._probe(eng, 5.0)
        ctrl._mgr.close()
    assert seen and all(s is not req for s in seen)
    assert dataclasses.asdict(req)["head"] == "fake"


# ---------------------------------------------------------------------------
# held to JAX: scripts/check_pipeline.py's TIGER
# ---------------------------------------------------------------------------


def _port_tiger(params=None):
    """check_pipeline's TIGER in the port (the JAX init carried over)."""
    if params is None:
        _, params = CP._model_and_params()
    model = Tiger(device="cpu", **CP.ARCH).eval()
    model.load_state_dict(tiger_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), model))
    return model


def _port_stream_trainer(log_dir, save_dir, publish_dir):
    """check_pipeline's _build_trainer, in the port."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.trainers.stream_trainer import StreamTrainer
    from genrec_tpu_torch.trainers.tiger_trainer import make_loss_fn

    model = _port_tiger()
    optimizer = Adam(1e-3, weight_decay=0.01)
    step_fn = make_train_step(make_loss_fn(CP.D, pack_sequences=False), optimizer,
                              clip_norm=1.0)
    return StreamTrainer(
        log_dir=log_dir, save_dir_root=save_dir,
        state=TrainState.create(model, optimizer, 1), step_fn=step_fn,
        make_arrays=CP._make_arrays, chunk_records=CP.CHUNK_RECORDS,
        rows_per_step=CP.ROWS_PER_STEP, row_len=CP.ROW_INTS, seed=0,
        publish_dir=publish_dir, commit_every_steps=1, handle_signals=False,
    )


def test_stream_losses_match_jax_stream_trainer(tmp_path):
    """The port's StreamTrainer and JAX's, over one log the port wrote
    (the framing is byte-compatible), give the same loss at every step
    (1e-5), and the port's published trees are the state dicts its model
    trained to."""
    log_dir = str(tmp_path / "log")
    with StreamLogWriter(log_dir) as w:
        for rec in CP._gen_records(3 * CP.CHUNK_RECORDS, seed=7):
            w.append(rec)
    jsum = CP._build_trainer({"log_dir": log_dir, "save_dir": str(tmp_path / "jax"),
                              "publish_dir": str(tmp_path / "jax_publish")},
                             handle_signals=False).run(max_chunks=3, idle_timeout_s=1.0)
    trainer = _port_stream_trainer(log_dir, str(tmp_path / "port"),
                                   str(tmp_path / "port_publish"))
    psum = trainer.run(max_chunks=3, idle_timeout_s=1.0)
    assert psum["global_step"] == jsum["global_step"] == 6
    assert psum["published_steps"] == jsum["published_steps"] == [2, 4, 6]
    jl = CP._losses_by_step(str(tmp_path / "jax"))[0]
    pl = _losses_by_step(str(tmp_path / "port"))
    assert sorted(jl) == sorted(pl) == [1, 2, 3, 4, 5, 6]
    for s in jl:
        assert abs(jl[s] - pl[s]) <= 1e-5, (s, jl[s], pl[s])
    final = CheckpointManager(str(tmp_path / "port_publish")).validate_and_restore(
        trainer.state_like.model.state_dict(), 6)
    for k, v in trainer.state_like.model.state_dict().items():
        assert torch.equal(final[k], v), k


def _vet_requests():
    return [Request(head="tiger", history=np.array([1, 2, 3])),
            Request(head="tiger", history=np.array([4, 5]))]


def _valid_ids():
    rng = np.random.default_rng(0)
    return np.unique(rng.integers(0, CP.ARCH["num_item_embeddings"], (50, CP.D)), axis=0)


@pytest.mark.parametrize("scale", [1.0, 1.3])
def test_vet_scores_match_jax_make_fn(tmp_path, scale):
    """The controller's vet (the port head's dense function under the
    candidate's weights) against JAX's (``jax.jit(head.make_fn(B, L))``
    on the same tree): sem-ids equal, scores within 1e-4."""
    jmodel, params = CP._model_and_params()
    params = jax.tree_util.tree_map(lambda x: x * scale, params)
    tree = tiger_params_from_flax(jax.tree_util.tree_map(np.asarray, params), _port_tiger())
    valid = _valid_ids()
    vet = _vet_requests()
    router = FakeRouter(_params(1.0))
    ctrl = RolloutController(
        router, TigerGenerativeHead(_port_tiger(), valid, top_k=5),
        str(tmp_path / "publish"), params_like=tree, vet_requests=vet,
        state_path=str(tmp_path / "s.json"), initial_step=0)
    payloads, scores = ctrl._vet_scores(tree)
    ctrl._mgr.close()

    jh = JaxTigerHead(jmodel, valid, top_k=5)
    B, L = len(vet), max(jh.natural_len(r) for r in vet)
    out = jax.jit(jh.make_fn(B, L))(params, *jh.runtime_operands(), *jh.make_batch(vet, B, L))
    want = jh.finalize(tuple(np.asarray(o) for o in out), vet)
    for got, ref in zip(payloads, want):
        np.testing.assert_array_equal(got["sem_ids"], ref["sem_ids"])
        np.testing.assert_array_equal(got["items"], ref["items"])
        np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-4, rtol=0)
    assert scores.shape == (len(vet) * 5,)


def _tiger_engine(model, valid, rid):
    ladder = BucketLadder((1, 2), (8,))
    n_tok = 1 + ladder.history_buckets[-1] * CP.D
    return ServingEngine(
        [TigerGenerativeHead(model, valid, top_k=5)], device="cpu", ladder=ladder,
        max_batch=2, max_wait_ms=2.0, handle_signals=False, replica_id=rid,
        paged_config=PagedConfig(max_slots=4, page_size=8, pages_per_slot=-(-n_tok // 8)),
    ).start()


class _Router:
    def __init__(self, engines):
        self._eng = engines

    def replica_ids(self):
        return list(self._eng)

    def engine(self, rid):
        return self._eng[rid]


def test_rollout_on_paged_engines_promotes_and_vetoes_garbage_bit_unchanged(tmp_path):
    """Two paged replicas of check_pipeline's TIGER: a close candidate is
    vetted, canaried and promoted (every probe answered under its step),
    then a x60 garbage tree is vetoed and quarantined while both
    replicas' state dicts and the vet head's module stay bit-unchanged."""
    valid = _valid_ids()
    router = _Router({rid: _tiger_engine(_port_tiger(), valid, rid) for rid in ("r0", "r1")})
    vet_head = TigerGenerativeHead(_port_tiger(), valid, top_k=5)
    init = {k: v.clone() for k, v in router.engine("r0").params().items()}
    publish = str(tmp_path / "publish")
    ctrl = RolloutController(
        router, vet_head, publish, params_like=router.engine("r0").params(),
        vet_requests=_vet_requests(), state_path=str(tmp_path / "s.json"), initial_step=0,
        config=RolloutConfig(poll_secs=0.05, canary_window_s=0.1, canary_min_responses=2,
                             vet_max_score_drift=1e3)).start()
    mgr = CheckpointManager(publish)
    try:
        candidate = {k: v * 1.01 if v.is_floating_point() else v for k, v in init.items()}
        mgr.save(1, candidate)
        _wait(lambda: ctrl.stats()["last_good_step"] == 1, secs=120)
        for rid in ("r0", "r1"):
            eng = router.engine(rid)
            assert eng.params_step == 1
            resp = eng.serve(Request(head="tiger", history=np.array([6, 7])), timeout=60)
            assert resp.params_step == 1 and resp.replica_id == rid
            for k, v in eng.params().items():
                assert torch.equal(v, candidate[k]), k
        served = {rid: {k: v.clone() for k, v in router.engine(rid).params().items()}
                  for rid in ("r0", "r1")}
        vet_before = {k: v.clone() for k, v in vet_head.model.state_dict().items()}
        mgr.save(2, {k: v * 60.0 if v.is_floating_point() else v for k, v in init.items()})
        _wait(lambda: ctrl.stats()["vetoes"] == 1, secs=120)
        s = ctrl.stats()
        assert s["last_good_step"] == 1 and s["quarantined_steps"] == 1 and s["staged"] == 1
        for rid in ("r0", "r1"):
            eng = router.engine(rid)
            assert eng.params_step == 1
            for k, v in eng.params().items():
                assert torch.equal(v, served[rid][k]), (rid, k)
        for k, v in vet_head.model.state_dict().items():
            assert torch.equal(v, vet_before[k]), k
    finally:
        ctrl.stop()
        for rid in ("r0", "r1"):
            eng = router.engine(rid)
            eng.stop()
            pool = eng.runner("tiger").pool
            assert pool.allocator.pages_in_use == 0


def test_rollout_refuses_a_vet_head_over_a_replicas_module(tmp_path):
    """The vet swaps the candidate's weights into its head's module for
    the call: a head over a replica's module would let that replica
    serve them. The controller refuses it."""
    model = _port_tiger()
    router = _Router({"r0": _tiger_engine(model, _valid_ids(), "r0")})
    try:
        with pytest.raises(ValueError, match="module of its own"):
            RolloutController(router, TigerGenerativeHead(model, _valid_ids(), top_k=5),
                              str(tmp_path / "p"), params_like=router.engine("r0").params(),
                              vet_requests=_vet_requests(), state_path=str(tmp_path / "s.json"))
    finally:
        router.engine("r0").stop()
