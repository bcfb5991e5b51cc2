"""Training goodput accounting: classify every wall-second of a run (port
of genrec_tpu/obs/goodput.py).

"Goodput" here is the fraction of wall time the accelerator spends doing
useful training compute — the number a fleet operator watches, because
everything else (checkpoint saves, restores, host data stalls, skipped
non-finite steps, preemption drains) is overhead that checkpoints, chaos
events, and input pipelines silently eat.

`GoodputMeter` splits an epoch's wall time into the buckets below. The
measured buckets come from explicit ``measure()`` scopes in
`trainers.packed_loop.PackedTrainLoop`; the derived ones come out of the
step-section time:

- ``data_wait``      — blocked in the input iterator (host pipeline stall)
- ``checkpoint_save``— inside `loop.save` (the host snapshot of an
                       asynchronous save, or a whole synchronous one)
- ``restore``        — inside `loop.resume` (integrity ladder + copy in)
- ``preemption_drain``— inside the preemption save + monitor flush
- ``compile``        — kept so that the report's keys are the JAX
                       package's, and always 0 s here: eager PyTorch has
                       no compile event to tap (JAX's ``CompileEvents``
                       listens to XLA's backend compiles; the port's
                       kernels are built once per process, outside the
                       step, by ``kernels/build.py``)
- ``nonfinite_skipped``— the step time attributed to steps the guard
                       skipped (streak steps * mean step time — the flag
                       read is deferred one step, so per-step attribution
                       would stall the host)
- ``compute``        — step-section time minus compile minus skipped
- ``other``          — the residual (logging, eval between epochs, hooks)

Buckets sum to the epoch wall time EXACTLY (``other`` is the residual;
tests pin the arithmetic), and ``goodput_pct = compute / wall``.

Process-group view: `fleet_goodput` allgathers every rank's bucket
microseconds through an INJECTED allgather callable (the packed loop
passes `parallel.mesh.allgather_host_ints`) and reports the sums.
Collective: every rank must call it at the same point (the packed loop
calls it in the epoch epilogue, which runs in lockstep). obs imports
nothing from the layers above it, so the callable is injected.
"""

from __future__ import annotations

import contextlib
import time
from typing import Mapping

from genrec_tpu_torch.obs.flight_recorder import process_rank

#: Reporting order. compute/other are derived; the rest are measured.
BUCKETS = (
    "compute",
    "compile",
    "checkpoint_save",
    "restore",
    "data_wait",
    "nonfinite_skipped",
    "preemption_drain",
    "other",
)

_MEASURED = ("checkpoint_save", "restore", "data_wait", "preemption_drain")


class GoodputMeter:
    """Wall-time bucket accounting for one training run.

    The epoch window is "since the last ``end_epoch``" (or construction),
    so between-epoch work — eval, periodic saves, the next epoch's repack
    — is charged to the NEXT report's wall and lands in its measured
    buckets or ``other``. Thread-compatible, not thread-safe: one loop
    owns one meter (the packed loop's single-writer discipline).
    """

    def __init__(self):
        self._buckets: dict[str, float] = {b: 0.0 for b in _MEASURED}
        self._step_time = 0.0
        self._compile_time = 0.0
        self._steps = 0
        self._skipped = 0
        self._t_last = time.perf_counter()
        self._run_totals: dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._run_wall = 0.0

    # -- recording -----------------------------------------------------------

    def add(self, bucket: str, seconds: float) -> None:
        if bucket not in self._buckets:
            raise KeyError(f"unknown goodput bucket {bucket!r}; have {_MEASURED}")
        self._buckets[bucket] += max(float(seconds), 0.0)

    @contextlib.contextmanager
    def measure(self, bucket: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(bucket, time.perf_counter() - t0)

    def note_step(self, seconds: float, compile_seconds: float = 0.0,
                  skipped: bool = False) -> None:
        """One optimizer-step section: its wall time, the compile seconds
        observed inside it (always 0 in the port: see the module
        docstring) and (deferred) whether the guard skipped it."""
        self._step_time += max(float(seconds), 0.0)
        self._compile_time += max(float(compile_seconds), 0.0)
        self._steps += 1
        if skipped:
            self._skipped += 1

    def note_skipped(self, n: int = 1) -> None:
        """Deferred non-finite attribution (the monitor learns about step
        N while step N+1 runs)."""
        self._skipped += int(n)

    # -- reporting -----------------------------------------------------------

    def end_epoch(self) -> dict:
        """Close the window: derive compute/nonfinite/other, reset the
        epoch accumulators, fold into the run totals. Returns
        ``{"wall_s", "goodput_pct", "steps", "buckets": {...}}``."""
        now = time.perf_counter()
        wall = max(now - self._t_last, 1e-9)
        self._t_last = now

        compile_t = min(self._compile_time, self._step_time)
        # The guard's skip flag is read one step late, so skipped time is
        # attributed at the mean step rate rather than per offending step.
        post_compile = max(self._step_time - compile_t, 0.0)
        skipped_t = (
            post_compile * min(self._skipped, self._steps) / self._steps
            if self._steps else 0.0
        )
        compute = max(post_compile - skipped_t, 0.0)
        buckets = {
            "compute": compute,
            "compile": compile_t,
            "nonfinite_skipped": skipped_t,
            **{b: self._buckets[b] for b in _MEASURED},
        }
        accounted = sum(buckets.values())
        buckets["other"] = max(wall - accounted, 0.0)
        # Exactness contract: buckets sum to wall. Over-accounting (timer
        # overlap) is squeezed out of `other` first, then proportionally.
        overflow = accounted + buckets["other"] - wall
        if overflow > 0 and accounted > 0:
            scale = wall / accounted
            buckets = {k: v * scale for k, v in buckets.items()}
        report = {
            "wall_s": wall,
            "steps": self._steps,
            "goodput_pct": 100.0 * buckets["compute"] / wall,
            "buckets": {b: buckets[b] for b in BUCKETS},
        }
        for b in BUCKETS:
            self._run_totals[b] += buckets[b]
        self._run_wall += wall
        self._buckets = {b: 0.0 for b in _MEASURED}
        self._step_time = self._compile_time = 0.0
        self._steps = self._skipped = 0
        return report

    def run_report(self) -> dict:
        """Cumulative over every closed epoch window."""
        wall = max(self._run_wall, 1e-9)
        return {
            "wall_s": self._run_wall,
            "goodput_pct": 100.0 * self._run_totals["compute"] / wall,
            "buckets": dict(self._run_totals),
        }


def fleet_goodput(report: Mapping, allgather=None) -> dict:
    """Aggregate one epoch report over the process group (sums over
    ranks; ``n_hosts`` keeps the JAX report's key and counts ranks).

    ``allgather`` takes a list of ints and returns an (n_ranks, n_ints)
    array — the caller injects `parallel.mesh.allgather_host_ints` (obs
    imports nothing upward). COLLECTIVE on a multi-process run: call at
    the same loop point on every rank. A single process returns the local
    report unchanged without touching ``allgather``."""
    if process_rank()[1] == 1:
        return dict(report)
    if allgather is None:
        raise ValueError(
            "fleet_goodput on a multi-process run needs an allgather "
            "callable (pass parallel.mesh.allgather_host_ints); obs does "
            "not import the runtime layer itself"
        )

    keys = list(BUCKETS)
    local_us = [int(report["buckets"][b] * 1e6) for b in keys]
    local_us.append(int(report["wall_s"] * 1e6))
    gathered = allgather(local_us)  # (n_hosts, len(keys)+1)
    sums = gathered.sum(axis=0)
    buckets = {b: float(sums[i]) / 1e6 for i, b in enumerate(keys)}
    wall = max(float(sums[-1]) / 1e6, 1e-9)
    return {
        "wall_s": wall,
        "n_hosts": int(gathered.shape[0]),
        "goodput_pct": 100.0 * buckets["compute"] / wall,
        "buckets": buckets,
    }
