"""The port's fault-tolerance units on the CPU, held to the JAX package.

genrec_tpu_torch/core/{fault_tolerance,chaos,checkpoint}.py, obs/goodput.py
and trainers/packed_loop.py pair with the same paths under genrec_tpu/.
Where both run on the same inputs they are compared: the NonFiniteMonitor's
dumps (file names, npz keys), skipped steps and abort step; the poisoned
steps and leaves of ``poison_batches``; the goodput reports of the same
injected durations (exact, 1e-12 on the derived floats); the packed loop on
one toy model and one set of arrays (the kill cursor and the consumed
batches exact, losses within 1e-6); the resume cursors and refusals.

The JAX ladder's C3 fault (ROADMAP §C: garbled orbax bytes read as a
mismatch, so ``test_fault_tolerance.py::test_maybe_resume_epoch_arithmetic``
fails there) is not copied: the port is held to that test's invariant,
quarantine and fall back (5, 42). A child process SIGKILLed inside a save
leaves no committed step, and the consensus restore runs over two gloo
ranks in its four cases.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genrec_tpu.core import chaos as jchaos
from genrec_tpu.core import fault_tolerance as jft
from genrec_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from genrec_tpu.core.harness import make_train_step as jax_make_train_step
from genrec_tpu.core.state import TrainState as JaxTrainState
from genrec_tpu.obs import goodput as jgoodput
from genrec_tpu_torch.core import chaos
from genrec_tpu_torch.core import fault_tolerance as ft
from genrec_tpu_torch.core.checkpoint import (
    COMMIT_MARKER,
    BestTracker,
    CheckpointManager,
    maybe_resume,
)
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.logging import Tracker, setup_logger
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.preemption import PreemptionGuard
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.obs import goodput
from genrec_tpu_torch.parallel.mesh import spawn
from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop

REPO = Path(__file__).resolve().parents[1]
LR = 1e-2
LOSS_TOL = 1e-6  # fp32 Adam on both sides, the same operations in the same order


# ---------------------------------------------------------------------------
# toy model: float batches so NaN injection can reach the loss
# ---------------------------------------------------------------------------


class Toy(torch.nn.Module):
    def __init__(self, w: np.ndarray):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(w))


def _toy_w(seed=0):
    return np.random.default_rng(seed).standard_normal((4, 2)).astype(np.float32)


def _port_toy(seed=0):
    def loss_fn(model, batch, gen):
        return torch.mean((batch["x"] @ model.w - batch["y"]) ** 2), {}

    opt = Adam(LR)
    state = TrainState.create(Toy(_toy_w(seed)), opt, seed + 1)
    return make_train_step(loss_fn, opt, clip_norm=1.0), state


def _jax_toy(seed=0):
    def loss_fn(params, batch, rng):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}

    opt = optax.adam(LR)
    state = JaxTrainState.create({"w": jnp.asarray(_toy_w(seed))}, opt, jax.random.key(seed + 1))
    return jax.jit(jax_make_train_step(loss_fn, opt, clip_norm=1.0)), state


def _arrays(n=64):
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((n, 4)).astype(np.float32),
            "y": rng.standard_normal((n, 2)).astype(np.float32),
            "idx": np.arange(n, dtype=np.int32)}


def _tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# NonFiniteMonitor and poison_batches against JAX
# ---------------------------------------------------------------------------


def _metric_seq():
    # (flag, streak) per step: a lone bad step, a recovery, then a streak
    # that reaches max_consecutive=3 at step 7.
    return [(0, 0), (1, 1), (0, 0), (0, 0), (1, 1), (1, 2), (1, 3), (0, 0)]


def _run_monitor(mon, as_metric, batch):
    aborted = None
    try:
        for g, (flag, streak) in enumerate(_metric_seq(), start=1):
            m = {"loss": float("nan") if flag else 1.0 + g, "grad_norm": 0.5 * g,
                 "nonfinite": float(flag), "nonfinite_count": float(streak)}
            mon.observe(g, 0, {k: as_metric(v) for k, v in m.items()}, batch)
        mon.flush()
    except (jft.NonFiniteLossError, ft.NonFiniteLossError) as e:
        aborted = str(e)
    return aborted


def test_nonfinite_monitor_matches_jax(tmp_path):
    """Exact: the same dumps (names, keys, values), skipped steps and abort."""
    host = {"x": np.arange(6, dtype=np.float32).reshape(3, 2), "ids": np.arange(3)}
    jmon = jft.NonFiniteMonitor(str(tmp_path / "jax"), max_consecutive=3)
    pmon = ft.NonFiniteMonitor(str(tmp_path / "port"), max_consecutive=3)
    j_abort = _run_monitor(jmon, np.float32, host)
    p_abort = _run_monitor(pmon, lambda v: torch.tensor(v, dtype=torch.float32),
                           {k: torch.as_tensor(v) for k, v in host.items()})
    assert j_abort is not None  # aborted at step 7, the same words but the dump dir
    assert p_abort.replace(pmon.dump_dir, "<dir>") == j_abort.replace(jmon.dump_dir, "<dir>")
    assert pmon.skipped_steps == jmon.skipped_steps == 4
    assert [os.path.basename(p) for p in pmon.dumped] == [
        os.path.basename(p) for p in jmon.dumped] == [
        "nonfinite_step2.npz", "nonfinite_step5.npz", "nonfinite_step6.npz",
        "nonfinite_step7.npz"]
    for jp, pp in zip(jmon.dumped, pmon.dumped):
        jd, pd = np.load(jp), np.load(pp)
        assert sorted(jd.files) == sorted(pd.files)
        for k in jd.files:
            np.testing.assert_array_equal(pd[k], jd[k])


def test_poison_batches_matches_jax():
    """Exact: the same steps and float leaves poisoned, ints untouched."""
    rng = np.random.default_rng(0)
    batches = [({"ids": np.arange(4) + i, "x": rng.standard_normal(4).astype(np.float32),
                 "t": rng.standard_normal((2, 2))}, np.ones(4, bool)) for i in range(6)]
    plans = (chaos.ChaosPlan(nan_at_steps=frozenset({3, 5, 6})),
             jchaos.ChaosPlan(nan_at_steps=frozenset({3, 5, 6})))
    with chaos.inject(plans[0]):
        got = list(chaos.poison_batches(iter(batches), start_step=1))
    with jchaos.inject(plans[1]):
        want = list(jchaos.poison_batches(iter(batches), start_step=1))
    for (g, gv), (w, wv) in zip(got, want, strict=True):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(gv, wv)
    assert [bool(np.isnan(b["x"]).all()) for b, _ in got] == [False, True, False, True, True,
                                                               False]


# ---------------------------------------------------------------------------
# goodput against JAX
# ---------------------------------------------------------------------------


def _drive_meter(meter, clock):
    """One epoch of injected durations (data waits, steps with compile
    time, skipped steps, saves), then a second with a restore."""
    reports = []
    for epoch in range(2):
        meter.add("data_wait", 0.25 + epoch)
        for i in range(5):
            meter.note_step(0.5 + 0.1 * i, compile_seconds=0.2 if i == 0 else 0.0)
        meter.note_skipped(2 - epoch)
        with meter.measure("checkpoint_save" if epoch == 0 else "restore"):
            clock[0] += 0.75
        clock[0] += 10.0
        reports.append(meter.end_epoch())
    return reports, meter.run_report()


def test_goodput_meter_and_fleet_match_jax(monkeypatch):
    """The same injected durations give the same reports (1e-12)."""
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    got = _drive_meter(goodput.GoodputMeter(), clock)
    clock[0] = 100.0
    want = _drive_meter(jgoodput.GoodputMeter(), clock)
    assert goodput.BUCKETS == jgoodput.BUCKETS
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    report = got[0][0]
    assert abs(sum(report["buckets"].values()) - report["wall_s"]) < 1e-12

    # Two ranks: the injected allgather returns this report and another.
    other = [7_000_000, 0, 1_000, 2_000, 3_000, 4_000, 5_000, 6_000, 20_000_000]

    def gather(local):
        return np.asarray([local, other], np.int64)

    assert goodput.fleet_goodput(report, gather) == report  # one process: no collective
    monkeypatch.setattr(goodput, "process_rank", lambda: (0, 2))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    assert goodput.fleet_goodput(report, gather) == jgoodput.fleet_goodput(report, gather)
    with pytest.raises(ValueError, match="allgather"):
        goodput.fleet_goodput(report)


# ---------------------------------------------------------------------------
# the packed loop against JAX: kill cursor, consumed batches, losses
# ---------------------------------------------------------------------------


def _recording(step_fn, seen, to_np):
    def step(state, batch):
        seen.append(to_np(batch["idx"]).tolist())
        return step_fn(state, batch)

    return step


def _jax_loop_run(tmp_path, kill_at_step):
    from genrec_tpu.core.checkpoint import CheckpointManager as JCM
    from genrec_tpu.core.logging import Tracker as JTracker
    from genrec_tpu.core.preemption import PreemptionGuard as JGuard
    from genrec_tpu.core.profiling import ProfileWindow as JProfileWindow
    from genrec_tpu.parallel import get_mesh, replicate
    from genrec_tpu.trainers.packed_loop import PackedTrainLoop as JLoop

    mesh = get_mesh()
    step_fn, state = _jax_toy()
    state = replicate(mesh, state)
    seen, losses = [], {}

    def make_loop():
        return JLoop(logger=setup_logger(None), tracker=JTracker(), prof=JProfileWindow("", 0),
                     mesh=mesh, guard=JGuard(), ckpt=JCM(str(tmp_path / "jax")),
                     rows_per_step=8, row_len=1, seed=3, pack_sequences=False,
                     train_arrays=_arrays(), wandb_log_interval=1,
                     step_log=lambda m, g: losses.__setitem__(g, float(m["loss"])) or {})

    step = _recording(step_fn, seen, np.asarray)
    loop = make_loop()
    g, killed_at = 0, None
    with jchaos.inject(jchaos.ChaosPlan(kill_at_step=kill_at_step)):
        for epoch in range(2):
            res = loop.run_epoch(state, step, epoch, g)
            state, g = res.state, res.global_step
            if res.preempted:
                killed_at = (epoch, g)
                break
    loop.shutdown()
    killed = list(seen)
    loop = make_loop()
    point = jft.resume_exact(loop.ckpt, state, lambda s: replicate(mesh, s), data_seed=3)
    cursor = (point.epoch, point.next_batch, point.global_step)
    state, g = point.state, point.global_step
    for epoch in range(point.epoch, 2):
        res = loop.run_epoch(state, step, epoch, g,
                             start_batch=point.next_batch if epoch == point.epoch else 0)
        state, g = res.state, res.global_step
    loop.shutdown()
    return killed_at, cursor, killed, seen, losses, np.asarray(state.params["w"])


def _port_loop_run(tmp_path, kill_at_step):
    step_fn, state = _port_toy()
    seen, losses = [], {}

    def make_loop():
        return PackedTrainLoop(
            logger=setup_logger(None), tracker=Tracker(), device="cpu", guard=PreemptionGuard(),
            ckpt=CheckpointManager(str(tmp_path / "port")), rows_per_step=8, row_len=1,
            seed=3, pack_sequences=False, train_arrays=_arrays(), wandb_log_interval=1,
            step_log=lambda m, g: losses.__setitem__(g, float(m["loss"])) or {})

    step = _recording(step_fn, seen, lambda t: t.numpy())
    loop = make_loop()
    g, killed_at = 0, None
    with chaos.inject(chaos.ChaosPlan(kill_at_step=kill_at_step)):
        for epoch in range(2):
            res = loop.run_epoch(state, step, epoch, g)
            state, g = res.state, res.global_step
            if res.preempted:
                killed_at = (epoch, g)
                break
    loop.shutdown()
    killed = list(seen)
    step_fn, fresh = _port_toy(seed=5)  # other weights: the resume must overwrite them
    step = _recording(step_fn, seen, lambda t: t.numpy())
    loop = make_loop()
    state, epoch0, batch0, g = loop.resume(fresh)
    cursor = (epoch0, batch0, g)
    for epoch in range(epoch0, 2):
        res = loop.run_epoch(state, step, epoch, g, start_batch=batch0 if epoch == epoch0 else 0)
        state, g = res.state, res.global_step
    loop.shutdown()
    return killed_at, cursor, killed, seen, losses, state.model.w.detach().numpy()


def test_packed_loop_kill_and_resume_match_jax(tmp_path):
    """A kill at step 11 (epoch 1, 8 steps an epoch): the same cursor and
    consumed batches (exact) as the JAX loop, losses within 1e-6."""
    j = _jax_loop_run(tmp_path, 11)
    p = _port_loop_run(tmp_path, 11)
    assert p[0] == j[0] == (1, 11)
    assert p[1] == j[1] == (1, 3, 11)
    assert p[2][:11] == j[2][:11]  # the killed run consumed the same batches
    assert p[3] == j[3] and len(p[3]) == 16  # and the resumed run the rest, once each
    assert sorted(p[4]) == sorted(j[4]) == list(range(1, 17))
    for g in j[4]:
        assert abs(p[4][g] - j[4][g]) <= LOSS_TOL, g
    np.testing.assert_allclose(p[5], j[5], atol=LOSS_TOL)


def test_packed_loop_nan_injection_skips_dumps_and_aborts(tmp_path):
    """NaN batches through the port's loop: the guard skips (parameters
    unchanged), the monitor dumps, and three in a row abort — as in the
    JAX loop's test."""
    step_fn, state = _port_toy()

    def make_loop():
        return PackedTrainLoop(
            logger=setup_logger(None), tracker=Tracker(), device="cpu", rows_per_step=8,
            row_len=1, seed=0, pack_sequences=False, train_arrays=_arrays(),
            wandb_log_interval=1000, save_dir_root=str(tmp_path))

    loop = make_loop()
    with chaos.inject(chaos.ChaosPlan(nan_at_steps=frozenset({3}))):
        res = loop.run_epoch(state, step_fn, epoch=0, global_step=0)
    assert not res.preempted and res.n_batches == 8
    assert torch.isfinite(state.model.w).all() and int(state.step) == 7
    assert len(loop.monitor.dumped) == 1 and "batch/x" in np.load(loop.monitor.dumped[0])

    step_fn, state = _port_toy()
    loop = make_loop()
    with chaos.inject(chaos.ChaosPlan(nan_at_steps=frozenset({2, 3, 4}))):
        with pytest.raises(ft.NonFiniteLossError):
            loop.run_epoch(state, step_fn, epoch=0, global_step=0)
    # Deferred by one step: step 5 ran (and applied) before step 4 was read.
    assert int(state.step) == 2 and len(loop.monitor.dumped) == 3


# ---------------------------------------------------------------------------
# resume points, refusals, maybe_resume, BestTracker
# ---------------------------------------------------------------------------


def test_resume_exact_roundtrip_and_seed_check(tmp_path):
    _, state = _port_toy()
    _, jstate = _jax_toy()
    mgr, jmgr = CheckpointManager(str(tmp_path / "ck")), JaxCheckpointManager(str(tmp_path / "j"))
    ft.save_resume_point(mgr, state, epoch=2, next_batch=5, global_step=17, data_seed=7,
                         wait=True)
    jft.save_resume_point(jmgr, jstate, epoch=2, next_batch=5, global_step=17, data_seed=7,
                          wait=True)
    _, other = _port_toy(seed=9)
    point = ft.resume_exact(mgr, other, data_seed=7)
    jpoint = jft.resume_exact(jmgr, jstate, data_seed=7)
    assert ((point.epoch, point.next_batch, point.global_step)
            == (jpoint.epoch, jpoint.next_batch, jpoint.global_step) == (2, 5, 17))
    assert point.state is other
    _tree_equal(other.as_tree(), state.as_tree())  # generator state included
    for resume, m in ((ft.resume_exact, mgr), (jft.resume_exact, jmgr)):
        with pytest.raises(ValueError, match="data seed"):
            resume(m, other if m is mgr else jstate, data_seed=8)
    jmgr.close()


def _foreign(state, global_step):
    return {"state": state.as_tree(),
            "cursor": dict(ft._cursor_arrays(3, 0, global_step, 7, 0),
                           format=np.asarray(99, np.int32))}


def test_restore_for_eval_skips_exactness_preconditions(tmp_path):
    _, state = _port_toy()
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=4)
    ft.save_resume_point(mgr, state, epoch=2, next_batch=5, global_step=17, data_seed=7,
                         wait=True)
    mgr.save(20, _foreign(state, 20))
    _, other = _port_toy(seed=9)
    with pytest.raises(RuntimeError, match="Refusing to resume below"):
        ft.resume_exact(mgr, other, data_seed=8)
    got, step = ft.restore_for_eval(mgr, other)
    assert step == 17 and got is other
    _tree_equal(other.as_tree()["model"], state.as_tree()["model"])

    # A bare TrainState record (no cursor): the composite ladder mismatches
    # everything, the bare fallback restores it.
    mgr = CheckpointManager(str(tmp_path / "bare"))
    mgr.save(3, state.as_tree())
    _, other = _port_toy(seed=9)
    got, step = ft.restore_for_eval(mgr, other)
    assert step == 3
    _tree_equal(other.as_tree(), state.as_tree())

    # Nothing on disk: the initial state comes back with step None.
    got, step = ft.restore_for_eval(CheckpointManager(str(tmp_path / "empty")), state)
    assert step is None and got is state


def test_resume_with_foreign_records(tmp_path):
    """Foreign-format records below the restore point stay on disk and the
    resume proceeds; above it they refuse the resume loudly (JAX's test)."""
    _, state = _port_toy()
    mgr = CheckpointManager(str(tmp_path / "below"), max_to_keep=4)
    mgr.save(2, _foreign(state, 2))
    ft.save_resume_point(mgr, state, epoch=1, next_batch=2, global_step=5, data_seed=7,
                         wait=True)
    point = ft.resume_exact(mgr, state, data_seed=7)
    assert (point.epoch, point.next_batch, point.global_step) == (1, 2, 5)
    assert 2 in mgr.all_steps()
    mgr.save(6, {"state": point.state.as_tree(), "cursor": ft._cursor_arrays(1, 3, 6, 7, 0)})

    mgr = CheckpointManager(str(tmp_path / "above"), max_to_keep=4)
    ft.save_resume_point(mgr, state, epoch=1, next_batch=2, global_step=5, data_seed=7,
                         wait=True)
    mgr.save(9, _foreign(state, 9))
    with pytest.raises(RuntimeError, match="Refusing to resume below"):
        ft.resume_exact(mgr, state, data_seed=7)


def test_fresh_start_over_stale_records_is_refused(tmp_path):
    _, state = _port_toy()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(5000, {"other_layout": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="Refusing to start fresh"):
        ft.resume_exact(mgr, state, data_seed=0)
    with pytest.raises(RuntimeError, match="Refusing to start fresh"):
        maybe_resume(mgr, state.as_tree())
    with pytest.raises(RuntimeError, match="refusing to save"):
        mgr.save(7, {"other_layout": torch.zeros(2)})


def test_best_tracker_corrupt_sidecar_recovers(tmp_path):
    p = {"w": torch.ones(2, 2)}
    t = BestTracker(str(tmp_path))
    assert t.update(0.5, p)
    with open(t.meta, "w") as f:  # crash mid-write: truncated json
        f.write('{"metric": "Recall@10", "va')
    assert BestTracker(str(tmp_path)).value == -1.0
    for garbage in ("[1]", '{"value": null}'):
        with open(t.meta, "w") as f:
            f.write(garbage)
        assert BestTracker(str(tmp_path)).value == -1.0
    t2 = BestTracker(str(tmp_path))
    assert t2.update(0.3, p)  # tracking restarts and re-saves
    assert json.load(open(t2.meta))["value"] == 0.3
    assert torch.equal(t2.best_params(like=p)["w"], p["w"])


def test_maybe_resume_epoch_arithmetic(tmp_path):
    """JAX's test, held to its invariant (ROADMAP C3): the garbled step 7
    is quarantined and the epoch-keyed resume falls back to (5, 42)."""
    _, state = _port_toy()
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d)
    assert maybe_resume(mgr, state.as_tree())[1:] == (0, 0)
    tree = state.as_tree()
    mgr.save(4, {**tree, "step": torch.tensor(42, dtype=torch.int32)})
    restored, start_epoch, global_step = maybe_resume(mgr, tree)
    assert (start_epoch, global_step) == (5, 42)
    mgr.save(7, {**tree, "step": torch.tensor(99, dtype=torch.int32)})
    chaos.garble_checkpoint(d, 7)
    restored, start_epoch, global_step = maybe_resume(mgr, tree)
    assert (start_epoch, global_step) == (5, 42)
    assert mgr.all_steps() == [4] and os.path.isdir(os.path.join(d, "quarantine", "p0", "7"))


@pytest.mark.parametrize("damage", ["truncate", "garble", "marker"])
def test_integrity_ladder_falls_back(tmp_path, damage):
    """JAX's ladder test on the port's records and chaos helpers: the
    damaged step is quarantined and the previous one restored."""
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, max_to_keep=3)
    state = lambda v: {"w": torch.full((8, 8), v), "step": torch.tensor(int(v))}  # noqa: E731
    for s in (1, 2, 3):
        mgr.save(s, state(float(s)), wait=False)
    mgr.wait()
    {"truncate": chaos.truncate_checkpoint, "garble": chaos.garble_checkpoint,
     "marker": chaos.drop_commit_marker}[damage](d, 3)
    restored, step = mgr.restore_latest_valid(state(0.0))
    assert step == 2 and float(restored["w"][0, 0]) == 2.0
    assert 3 not in mgr.all_steps() and os.path.isdir(os.path.join(d, "quarantine"))


# ---------------------------------------------------------------------------
# asynchronous saves
# ---------------------------------------------------------------------------


def test_async_save_snapshots_before_returning(tmp_path):
    """The step updates tensors in place: an asynchronous save must hold the
    values of the call, not of a later step."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.zeros(256, 256)
    mgr.save(1, {"w": w}, wait=False)
    w.add_(1.0)  # the next step, in place, while the write may be in flight
    mgr.wait()
    assert float(mgr.restore({"w": w})["w"].abs().max()) == 0.0
    mgr.save(2, {"w": w}, wait=False)
    assert mgr.all_steps() == [1, 2]  # reads join the in-flight save


_DIE_IN_SAVE = """
import sys, torch
sys.path.insert(0, {repo!r})
from genrec_tpu_torch.core import chaos
from genrec_tpu_torch.core.checkpoint import CheckpointManager
mgr = CheckpointManager({d!r})
mgr.save(1, {{"w": torch.ones(4)}})
chaos.install(chaos.ChaosPlan(die_in_save_at_step=2))
mgr.save(2, {{"w": torch.ones(4)}}, wait=False)
mgr.wait()
print("survived")
"""


def test_die_in_save_leaves_no_committed_step(tmp_path):
    d = str(tmp_path / "ck")
    proc = subprocess.run([sys.executable, "-c", _DIE_IN_SAVE.format(repo=str(REPO), d=d)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert "survived" not in proc.stdout
    mgr = CheckpointManager(d)
    assert mgr.all_steps() == [1]
    leftovers = [n for n in os.listdir(d) if n.startswith(".2.tmp.")]
    assert leftovers  # the write got as far as the tensor file ...
    for n in leftovers:  # ... and never gained the commit marker
        assert os.path.exists(os.path.join(d, n, "tensors.pt"))
        assert not os.path.exists(os.path.join(d, n, COMMIT_MARKER))


# ---------------------------------------------------------------------------
# consensus restore over two gloo ranks
# ---------------------------------------------------------------------------


def _consensus_rank(group, root):
    """Rank side: the four cases of `restore_latest_valid_consensus`, each
    in a directory of its own with per-rank record trees."""
    def state(v):
        return {"w": torch.full((4,), float(v))}

    out = {}
    for case in ("equal", "fresh", "some_fresh", "disagree"):
        mgr = CheckpointManager(os.path.join(root, case), per_host=True)
        if case == "equal" or (case == "some_fresh" and group.rank == 0):
            mgr.save(1, state(1))
            mgr.save(2, state(2))
        if case == "disagree":
            mgr.save(1, state(1))
            mgr.save(2, state(2))
            if group.rank == 1:
                chaos.garble_checkpoint(mgr.directory, 2)
        try:
            restored, step = mgr.restore_latest_valid_consensus(state(0))
            out[case] = (step, None if restored is None else float(restored["w"][0]),
                         mgr.all_steps())
        except RuntimeError as e:
            out[case] = str(e)
    return out


def test_consensus_restore_over_two_ranks(tmp_path):
    r0, r1 = spawn(_consensus_rank, 2, (str(tmp_path / "ck"),), device="cpu", threads=1,
                   timeout_s=120, store_dir=str(tmp_path))
    assert r0["equal"] == r1["equal"] == (2, 2.0, [1, 2])
    assert r0["fresh"] == r1["fresh"] == (None, None, [])
    for r in (r0, r1):
        assert "some ranks have NO valid checkpoint" in r["some_fresh"]
        assert "p0=2, p1=none" in r["some_fresh"]
    # Rank 1 quarantined its garbled step 2; rank 0 falls back to the
    # agreed step 1 and quarantines its own (valid, abandoned) step 2.
    assert r0["disagree"] == r1["disagree"] == (1, 1.0, [1])
    for rank in (0, 1):
        q = tmp_path / "ck" / "disagree" / f"p{rank}" / "quarantine" / "2"
        assert q.is_dir(), q


def test_profile_window_and_train_step_spans(tmp_path):
    """``profile_steps``' window writes a Chrome trace of its steps, and the
    flight recorder holds one ``step`` event a train step, in order."""
    from genrec_tpu_torch.core.profiling import ProfileWindow
    from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder

    step_fn, state = _port_toy()
    prof = ProfileWindow(str(tmp_path / "profile"), n_steps=2)
    loop = PackedTrainLoop(logger=setup_logger(None), tracker=Tracker(), device="cpu", prof=prof,
                           rows_per_step=8, row_len=1, seed=0, pack_sequences=False,
                           train_arrays=_arrays())
    get_flight_recorder().clear()
    loop.run_epoch(state, step_fn, 0, 0)
    loop.shutdown()
    with open(prof.trace_path) as f:
        assert json.load(f)["traceEvents"]
    steps = [e["step"] for e in get_flight_recorder().events("step")]
    assert steps == list(range(1, 9))
