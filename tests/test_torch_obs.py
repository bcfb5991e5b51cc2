"""The port's observability layer on the CPU, held to the JAX package.

genrec_tpu_torch/obs/{spans,flight_recorder,slo,export,memory}.py and
core/preemption.py pair with the same paths under genrec_tpu/. The
tests/test_obs.py cases run here on the port's modules with the same
inputs: span nesting, concurrent traces, exemplars, the Chrome export,
the flight recorder's ring bound, atomic dump and excepthook chain, SLO
hysteresis, the deferral window and target validation. Where the two
produce data, they are compared: the SLO monitors' verdict sequences,
the ledgers' summaries and breakdown text, ``prometheus_text`` (the same
bytes for the same snapshot), the ``log_serving_stats`` lines, and
``tree_nbytes`` of the port's TIGER state dict against JAX
``tree_nbytes`` of the Flax params it was converted from (exact).

The engine cases (tests/test_obs.py's engine tests, on the port's
engine): the over-budget refusal at ``start()``, shedding and recovery
under a sustained queue breach, the complete span tree of every request
(dense, paged, and speculative with its draft / tree_verify / accept
spans), and the SIGTERM drain through ``handle_signals``, run on the
pytest main thread where signal handlers install.
"""

import json
import logging
import os
import signal
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu import obs as jobs
from genrec_tpu.core.logging import log_serving_stats as jax_log_serving_stats
from genrec_tpu.models import tiger as jtiger
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.core.logging import Tracker, log_serving_stats, setup_logger
from genrec_tpu_torch.core.preemption import PreemptionGuard
from genrec_tpu_torch.models.sasrec import SASRec
from genrec_tpu_torch.models.tiger import Tiger
from genrec_tpu_torch.obs import (
    NULL_TRACER,
    FlightRecorder,
    MemoryLedger,
    SLOMonitor,
    SLOTarget,
    SpanTracer,
    TraceContext,
    device_memory_stats,
    get_flight_recorder,
    json_safe,
    prometheus_text,
    tree_nbytes,
    write_prometheus,
)
from genrec_tpu_torch.serving.buckets import BucketLadder
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import RetrievalHead, TigerGenerativeHead
from genrec_tpu_torch.serving.kv_pool import PagedConfig
from genrec_tpu_torch.serving.types import (
    DrainingError,
    HBMBudgetError,
    OverloadError,
    Request,
)

torch.set_num_threads(1)

K_CB, D = 8, 3
TIGER_CFG = dict(embedding_dim=16, attn_dim=32, num_heads=4, n_layers=2,
                 num_item_embeddings=K_CB, num_user_embeddings=20, sem_id_dim=D, max_pos=64)


def _strict_loads(text: str):
    """json.loads that rejects the bare NaN / Infinity tokens."""
    def _reject(tok):
        raise ValueError(f"non-strict JSON constant {tok!r}")

    return json.loads(text, parse_constant=_reject)


# ---- span tracer -------------------------------------------------------------


def test_span_nesting_and_parenting():
    t = SpanTracer()
    with t.span("outer", trace_id="req-a", kind="root"):
        with t.span("mid"):
            with t.span("inner"):
                pass
    spans = {s.name: s for s in t.spans("req-a")}
    assert set(spans) == {"outer", "mid", "inner"}
    assert spans["outer"].parent_id is None
    assert spans["mid"].parent_id == spans["outer"].span_id
    assert spans["inner"].parent_id == spans["mid"].span_id
    assert spans["inner"].t0 >= spans["mid"].t0
    assert spans["inner"].t1 <= spans["mid"].t1 <= spans["outer"].t1
    assert spans["outer"].attrs == {"kind": "root"}


def test_span_concurrent_traces_well_nested():
    """Parallel threads give well-nested span trees, one a trace id: no
    parent across traces, every child interval inside its parent's."""
    t = SpanTracer(capacity=4096)
    n_threads, depth, reps = 8, 4, 10
    errs = []

    def worker(i: int) -> None:
        try:
            for r in range(reps):
                with t.span("l0", trace_id=f"req-{i}-{r}"):
                    for d in range(1, depth):
                        with t.span(f"l{d}"):
                            time.sleep(0.0002)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs
    by_trace = {}
    for s in t.spans():
        by_trace.setdefault(s.trace_id, []).append(s)
    assert len(by_trace) == n_threads * reps
    for tid, spans in by_trace.items():
        assert len(spans) == depth
        ids = {s.span_id: s for s in spans}
        roots = [s for s in spans if s.parent_id is None]
        assert len(roots) == 1 and roots[0].name == "l0"
        for s in spans:
            if s.parent_id is not None:
                p = ids[s.parent_id]  # KeyError: a parent in another trace
                assert p.t0 <= s.t0 and s.t1 <= p.t1


def test_disabled_tracer_records_nothing():
    t = SpanTracer(enabled=False)
    with t.span("x") as s:
        assert s is None
    assert t.record_span("y", "tr", 0.0, 1.0) is None
    assert t.spans() == [] and NULL_TRACER.spans() == []


def test_record_span_preallocated_root_and_exemplars():
    t = SpanTracer(max_exemplars=2)
    root = t.allocate_span_id()
    t.record_span("child", "req-1", 1.0, 2.0, parent_id=root)
    t.record_span("request", "req-1", 0.5, 2.5, span_id=root)
    spans = {s.name: s for s in t.spans("req-1")}
    assert spans["request"].span_id == root and spans["child"].parent_id == root
    t.mark_exemplar("req-1", reason="p99 outlier")
    for i in range(2, 5):  # the exemplar store is bounded, oldest evicted
        t.record_span("request", f"req-{i}", 0.0, 1.0)
        t.mark_exemplar(f"req-{i}", reason="r")
    ex = t.exemplars()
    assert len(ex) == 2 and "req-1" not in ex
    small = SpanTracer(capacity=4)
    for i in range(10):
        small.record_span("s", "tr", i, i + 1)
    assert len(small.spans()) == 4
    st = small.stats()
    assert st["spans_recorded"] == 10 and st["ring_spans"] == 4 and st["ring_capacity"] == 4


def test_chrome_trace_export_and_dump(tmp_path):
    t = SpanTracer()
    with t.span("phase", trace_id="req-1", step=3):
        pass
    t.mark_exemplar("req-1", reason="kept")
    data = json.load(open(t.dump(str(tmp_path / "trace.json"), metadata={"run": "test"})))
    assert data["displayTimeUnit"] == "ms"
    ev = data["traceEvents"][0]
    for key in ("name", "cat", "ph", "ts", "dur", "pid", "tid", "args"):
        assert key in ev
    assert ev["ph"] == "X" and ev["args"]["trace_id"] == "req-1" and ev["args"]["step"] == 3
    assert data["otherData"]["exemplars"] == {"req-1": "kept"}
    assert data["otherData"]["run"] == "test"


def test_trace_context_header_roundtrip_and_child():
    ctx = TraceContext("req-9", 4, "router")
    back = TraceContext.from_header(json.loads(json.dumps(ctx.to_header())))
    assert back == ctx and back.child(7).parent_span_id == 7
    assert TraceContext.from_header(None) is None and TraceContext.from_header({}) is None
    assert back.to_header() == jobs.TraceContext("req-9", 4, "router").to_header()


def test_span_bridges_to_the_torch_profiler():
    t = SpanTracer(bridge_profiler=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("bridged", trace_id="req-b"):
            torch.ones(4).sum()
    assert any(e.key == "bridged" for e in prof.key_averages())
    assert [s.name for s in t.spans("req-b")] == ["bridged"]


# ---- flight recorder and preemption guard ---------------------------------------


def test_flight_recorder_ring_bound_and_atomic_dump(tmp_path):
    fr = FlightRecorder(capacity=8)
    for i in range(20):
        fr.record("step", step=i, loss=float("nan") if i == 5 else 1.0)
    events = fr.events()
    assert len(events) == 8 and events[-1]["step"] == 19 and events[0]["step"] == 12
    assert fr.dump(reason="nowhere") is None  # no destination: a no-op
    path = fr.configure(str(tmp_path / "fr.json"), install_excepthook=False, run="test")
    assert fr.dump(reason="unit") == path
    payload = _strict_loads(open(path).read())  # the NaN field became null
    assert payload["reason"] == "unit" and payload["meta"]["run"] == "test"
    assert [e["kind"] for e in payload["events"]] == ["step"] * 8
    assert payload["events"][-1]["seq"] == 20
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_flight_recorder_excepthook_chains(tmp_path):
    fr = FlightRecorder()
    fr.configure(str(tmp_path / "crash.json"), install_excepthook=False)
    seen = []
    prev, sys.excepthook = sys.excepthook, lambda *a: seen.append(a)
    try:
        fr.install_excepthook()
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        assert len(seen) == 1  # chained to the previous hook
        dump = json.load(open(tmp_path / "crash.json"))
        assert dump["reason"] == "crash:RuntimeError"
        assert dump["events"][-1]["kind"] == "unhandled_exception"
        assert "boom" in dump["events"][-1]["error"]
    finally:
        fr.uninstall_excepthook()
        sys.excepthook = prev


def test_scoped_flight_recorder_stamps_identity_and_json_safe_matches_jax():
    fr = FlightRecorder()
    rid = {"v": None}
    scoped = fr.scoped("engine", replica_id=lambda: rid["v"])
    scoped.record("a", x=1)
    rid["v"] = "r1"
    scoped.scoped("worker", worker=3).record("b", component="override")
    a, b = fr.events()
    assert a["component"] == "engine" and a["replica_id"] is None
    assert b["component"] == "override" and b["replica_id"] == "r1" and b["worker"] == 3
    value = {"f": float("inf"), "n": np.float32(2.5), "l": [1, float("nan")], 3: object}
    assert json_safe(value) == jobs.json_safe(value)


def test_sigterm_latches_dumps_and_restores_handlers(tmp_path):
    """The guard latches a real SIGTERM, the flight recorder dumps with the
    signal as its last event, and the one-shot guard has restored the
    previous handler."""
    fr = get_flight_recorder()
    fr.clear()
    path = fr.configure(str(tmp_path / "flight_recorder.json"), install_excepthook=False)
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard(setup_logger(None))
    try:
        assert signal.getsignal(signal.SIGTERM) != prev
        fr.record("step", step=1)
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 10
        while not guard.fired:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert signal.getsignal(signal.SIGTERM) == prev  # one-shot
        dump = _strict_loads(open(path).read())
        assert dump["reason"] == "signal:SIGTERM"
        assert [e["kind"] for e in dump["events"]][-2:] == ["step", "signal"]
    finally:
        guard.close()
        fr._path = None


# ---- memory ledger -----------------------------------------------------------


def test_tree_nbytes_counts_leaves():
    lin = torch.nn.Linear(3, 2)
    tree = {"a": np.zeros((4, 8), np.float32), "b": (torch.zeros(16, dtype=torch.int32),
                                                      torch.zeros(2, 2)),
            "c": "not an array", "m": lin, "tied": [lin.weight, lin.weight]}
    assert tree_nbytes(tree) == 4 * 8 * 4 + 16 * 4 + 2 * 2 * 4 + (6 + 2) * 4


def test_tree_nbytes_of_tiger_state_dict_equals_jax_params():
    jm = jtiger.Tiger(dropout=0.0, **TIGER_CFG)
    z = jnp.zeros((2, 4 * D), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2,), jnp.int32), z, z,
                              jnp.zeros((2, D), jnp.int32), jnp.zeros((2, D), jnp.int32),
                              z)["params"]
    model = Tiger(device="cpu", **TIGER_CFG)
    model.load_state_dict(tiger_params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                 model))
    assert tree_nbytes(model.state_dict()) == jobs.tree_nbytes(params) > 0
    assert tree_nbytes(model) == jobs.tree_nbytes(params)


def _fill_ledger(led):
    led.record_operand("tiger", "params", 1000)
    led.record_operand("tiger", "kv_page_pool", 4000)
    led.record_reclaimable("tiger", "prefix_cache_pages", 700)
    led.record_executable("tiger", "decode/S8", stats={"temp": 300, "output": 200,
                                                       "argument": 5000, "alias": 0, "code": 50})
    led.record_executable("tiger", "prefill/B2/L8", stats={"temp": 100, "output": 100,
                                                           "argument": 5000, "alias": 0,
                                                           "code": 40})
    led.record_executable("tiger", "broken", stats=None)  # still counted
    led.record_operand("cobra", "params", 2000)
    led.record_executable("cobra", "decode/S4", stats={"temp": 100, "output": 50,
                                                       "argument": 0, "alias": 0, "code": 0})


def test_memory_ledger_budget_model_matches_jax():
    led, jled = MemoryLedger(), jobs.MemoryLedger()
    _fill_ledger(led)
    _fill_ledger(jled)
    h = led.group_summary("tiger")
    assert h["operand_bytes"] == 5000 and h["reclaimable_bytes"] == 700
    assert h["n_executables"] == 3 and h["n_executables_analyzed"] == 2
    assert h["transient_peak_bytes"] == 500 and h["transient_peak_executable"] == "decode/S8"
    assert h["total_bytes"] == 5500
    # All operands together, plus the one largest transient.
    assert led.summary()["total_bytes"] == 5000 + 2000 + 500
    for budget in (None, 10_000, 5000):
        assert led.summary(budget) == jled.summary(budget)
        assert led.breakdown_text(budget) == jled.breakdown_text(budget)
    assert led.summary(5000)["over_budget"] and not led.summary(10_000)["over_budget"]
    assert led.summary(10_000)["headroom_pct"] == pytest.approx(25.0)
    led.reset_group("cobra")
    led.reset_group("tiger")
    assert led.summary()["total_bytes"] == 0


def test_device_memory_stats_is_empty_on_the_cpu():
    assert device_memory_stats() == {} or all(isinstance(v, int)
                                              for v in device_memory_stats().values())
    assert device_memory_stats("cpu") == {}


# ---- SLO monitor -------------------------------------------------------------


P99_SEQUENCE = [(0.0, 20.0, 1), (0.1, 80.0, 1), (0.5, 20.0, 0), (1.0, 80.0, 1),
                (2.1, 80.0, 1), (3.0, 10.0, 0), (4.0, 10.0, 0), (4.5, 90.0, 0),
                (5.0, 10.0, 0), (7.1, 10.0, 0), (8.0, None, 0)]


def test_slo_monitor_breach_hysteresis_and_recovery():
    """tests/test_obs.py's sequence: a breach must be sustained breach_s to
    shed, recovery needs recover_s of targets met, a breach inside the
    recovery window resets it; the JAX monitor gives the same verdicts."""
    fr = FlightRecorder()
    target = dict(p99_ms=50.0, max_queue_depth=4, window_s=10.0, breach_s=1.0, recover_s=2.0)
    mon = SLOMonitor({"tiger": SLOTarget(**target)}, flight=fr)
    jmon = jobs.SLOMonitor({"tiger": jobs.SLOTarget(**target)}, flight=jobs.FlightRecorder())
    got = [mon.observe("tiger", p99_ms=p, queue_depth=q, now=100 + t)
           for t, p, q in P99_SEQUENCE]
    want = [jmon.observe("tiger", p99_ms=p, queue_depth=q, now=100 + t)
            for t, p, q in P99_SEQUENCE]
    assert got == want == [False, False, False, False, True, True, True, True, True, False,
                           False]
    assert [e["head"] for e in fr.events("slo_breach")] == ["tiger"]
    assert len(fr.events("slo_recovered")) == 1
    assert mon.snapshot() == jmon.snapshot()
    assert mon.snapshot()["heads"]["tiger"]["breaches"] == 1
    assert mon.headroom() == jmon.headroom()


def test_slo_monitor_deferral_rate_window():
    kw = dict(max_deferral_rate=0.25, window_s=5.0, breach_s=0.0, recover_s=0.0)
    mon = SLOMonitor({"h": SLOTarget(**kw)}, flight=FlightRecorder())
    jmon = jobs.SLOMonitor({"h": jobs.SLOTarget(**kw)}, flight=jobs.FlightRecorder())
    seq = [(0, 0, 0), (1, 1, 10), (2, 10, 20), (20, 10, 20)]
    got = [mon.observe("h", oom_deferred_total=d, submitted_total=s, now=10 + t)
           for t, d, s in seq]
    want = [jmon.observe("h", oom_deferred_total=d, submitted_total=s, now=10 + t)
            for t, d, s in seq]
    assert got == want == [False, False, True, False]


def test_recent_p99_is_per_head_windowed():
    from genrec_tpu_torch.serving.metrics import ServingMetrics

    m = ServingMetrics()
    for _ in range(30):
        m.record_response(0.0, 0.0, 0.001, head="fast")
        m.record_response(0.0, 0.0, 0.5, head="slow")
    assert m.recent_p99_ms(60.0, head="fast") < 10.0
    assert m.recent_p99_ms(60.0, head="slow") > 400.0
    assert m.recent_p99_ms(60.0) > 400.0
    assert m.recent_p99_ms(60.0, head="absent") is None


def test_slo_target_validation():
    with pytest.raises(ValueError):
        SLOTarget()
    with pytest.raises(ValueError):
        SLOTarget(p99_ms=10.0, window_s=0.0)
    with pytest.raises(ValueError):
        SLOMonitor({})


# ---- export and logging --------------------------------------------------------


SNAPSHOT = {
    "completed": 12, "qps": 3.25, "params_step": 2, "draining": False,
    "total_ms": {"p99": 8.5, "count": 12}, "skip_nan": float("nan"), "name": "text",
    "kv_pool": {"tiger": {"pages_in_use": 3, "pages_free": 5}},
    "params_swaps": 1, "catalog_swaps": 1, "watcher_errors": 0, "overload_rejected": 2,
    "prefix_cache": {"tiger": {"hits": 4, "lookups": 9, "entries": 2, "invalidations": 3}},
    "spec": {"tiger": {"accepted": 7, "codes_per_invocation": 1.5,
                       "accept_len_hist": {"accept_len_1": 3, "accept_len_2": 2}}},
    "hbm": {"heads": {"tiger": {"operands": {"params": 2 * 2**20, "kv_page_pool": 2**20},
                                "operand_bytes": 3 * 2**20, "transient_peak_bytes": 2**19,
                                "n_executables": 2, "total_bytes": 3 * 2**20 + 2**19}},
            "total_bytes": 3 * 2**20 + 2**19, "budget_bytes": 6 * 2**20,
            "headroom_pct": 41.67, "over_budget": False},
    "slo": {"heads": {"tiger": {"shedding": True, "breaches": 1, "headroom": 0.0}},
            "shedding": True},
    "tracing": {"enabled": True, "spans_recorded": 40, "ring_spans": 40},
}


def test_prometheus_text_is_jax_bytes(tmp_path):
    text = prometheus_text(SNAPSHOT)
    assert text == jobs.prometheus_text(SNAPSHOT)
    lines = text.splitlines()
    assert "# TYPE genrec_params_swaps counter" in lines and "genrec_params_swaps 1" in lines
    assert "# TYPE genrec_catalog_swaps counter" in lines
    assert "# TYPE genrec_hbm_heads_tiger_total_bytes gauge" in lines
    assert "genrec_draining 0" in lines and "genrec_qps 3.25" in lines
    assert not any("nan" in ln.lower() for ln in lines)
    path = write_prometheus(str(tmp_path / "m.prom"), SNAPSHOT)
    assert open(path).read() == text
    assert prometheus_text({}) == jobs.prometheus_text({}) == ""


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _logged(fn, name):
    logger = logging.getLogger(name)
    logger.propagate = False
    logger.setLevel(logging.INFO)
    cap = _Capture()
    logger.addHandler(cap)
    try:
        fn(logger)
    finally:
        logger.removeHandler(cap)
    return cap.messages


def test_log_serving_stats_lines_match_jax(tmp_path):
    from genrec_tpu.core.logging import Tracker as JaxTracker

    got = _logged(lambda lg: log_serving_stats(lg, Tracker(save_dir=str(tmp_path / "p")),
                                               SNAPSHOT), "obs-test-port")
    want = _logged(lambda lg: jax_log_serving_stats(lg, JaxTracker(save_dir=str(tmp_path / "j")),
                                                    SNAPSHOT), "obs-test-jax")
    assert got == want
    assert any("hbm[tiger]" in m and "budget 6.0 MB" in m for m in got)
    assert any("shedding=['tiger']" in m for m in got)
    line = _strict_loads((tmp_path / "p" / "metrics.jsonl").read_text().splitlines()[0])
    assert line["serve/params_swaps"] == 1 and line["serve/hbm/total_bytes"] > 0


# ---- the engine ----------------------------------------------------------------


def _tiger_engine(**kw):
    """A paged TIGER engine at a small size (one history bucket, 2 slots)."""
    rng = np.random.default_rng(7)
    valid = np.unique(rng.integers(0, K_CB, (20, D)), axis=0)
    model = Tiger(device="cpu", seed=0, **TIGER_CFG).eval()
    head = TigerGenerativeHead(model, item_sem_ids=valid, top_k=4)
    kw.setdefault("handle_signals", False)
    eng = ServingEngine([head], device="cpu", ladder=BucketLadder((1, 2), (8,)), max_batch=2,
                        max_wait_ms=1.0,
                        paged_config=PagedConfig(max_slots=2, page_size=8, pages_per_slot=4),
                        **kw)
    return eng, valid


def _sasrec_engine(**kw):
    model = SASRec(num_items=30, max_seq_len=8, embed_dim=16, num_heads=2, num_blocks=1,
                   ffn_dim=32, dropout=0.0, device="cpu").eval()
    kw.setdefault("handle_signals", False)
    return ServingEngine([RetrievalHead("sasrec", model, top_k=5)], device="cpu",
                         ladder=BucketLadder((1, 2), (8,)), max_batch=2, max_wait_ms=1.0, **kw)


def test_engine_refuses_over_budget_and_exports_the_ledger(tmp_path):
    eng, _ = _tiger_engine(hbm_budget_bytes=10_000)
    with pytest.raises(HBMBudgetError) as exc:
        eng.start()
    for component in ("params", "kv_page_pool", "paged_slot_state", "catalog_operands",
                      "budget"):
        assert component in str(exc.value), component

    eng, valid = _tiger_engine(hbm_budget_bytes=10**10)
    eng.start()
    try:
        for _ in range(3):
            eng.serve(Request(head="tiger", history=np.arange(5) % len(valid)), timeout=120)
        st = eng.stats()
    finally:
        eng.stop()
    h = st["hbm"]["heads"]["tiger"]
    head, runner = eng._heads["tiger"], eng.runner("tiger")
    assert h["operands"] == {
        "params": sum(t.numel() * t.element_size() for t in head.model.state_dict().values()),
        "catalog_operands": sum(t.numel() * t.element_size() for t in (
            head.trie.keys, head.trie.offsets, head.trie.weights, head._item_sem_ids_dev)),
        "kv_page_pool": sum(t.numel() * t.element_size()
                            for t in (*runner.pool.k_pools, *runner.pool.v_pools)),
        "paged_slot_state": sum(t.numel() * t.element_size() for t in runner.state.values()),
    }
    assert h["n_executables"] == 0  # the transients are measured on the card only
    assert h["total_bytes"] == h["operand_bytes"] and not st["hbm"]["over_budget"]
    metrics = {}
    lines = open(write_prometheus(str(tmp_path / "m.prom"), st)).read().splitlines()
    for i in range(0, len(lines), 2):
        _, _, name, kind = lines[i].split()
        val_name, val = lines[i + 1].split()
        assert val_name == name and kind in ("counter", "gauge")
        metrics[name] = float(val)
    assert metrics["genrec_completed"] == 3 and metrics["genrec_catalog_swaps"] == 0
    assert metrics["genrec_hbm_heads_tiger_operands_kv_page_pool"] > 0
    assert metrics["genrec_hbm_total_bytes"] == h["total_bytes"]


def test_engine_sheds_under_a_sustained_breach_and_recovers():
    eng = _sasrec_engine(slo_targets=SLOTarget(max_queue_depth=2, window_s=1.0, breach_s=0.0,
                                               recover_s=0.05),
                         slo_poll_secs=0.005).start()
    rng = np.random.default_rng(0)
    try:
        accepted, shed = [], False
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                accepted.append(eng.submit(Request(head="sasrec",
                                                   history=rng.integers(1, 31, 5))))
            except OverloadError as e:
                shed = True
                assert "sasrec" in str(e) and "queue_depth" in str(e)
                break
        assert shed, "a sustained queue breach never shed"
        assert len([f.result(120) for f in accepted]) == len(accepted)
        recovered = False
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not recovered:
            try:
                eng.submit(Request(head="sasrec", history=rng.integers(1, 31, 5))).result(60)
                recovered = True
            except OverloadError:
                time.sleep(0.01)
        assert recovered, "shedding never recovered"
        st = eng.stats()
        assert st["overload_rejected"] >= 1 and st["overload_by_head"]["sasrec"] >= 1
        assert st["slo"]["heads"]["sasrec"]["breaches"] >= 1
        assert st["rejected"] == 0 and st["failed"] == 0  # sheds are not drain rejections
    finally:
        eng.stop()


PAGED_TREE = {"request", "queue_wait", "admission", "prefix_lookup", "finalize"}


def _check_tree(tracer, resp, children, steps=None, spec=False):
    spans = tracer.spans(resp.request_id)
    roots = [s for s in spans if s.name == "request"]
    assert len(roots) == 1 and roots[0].parent_id is None
    root = roots[0]
    assert root.attrs["head"] == resp.head and root.attrs["params_step"] == resp.params_step
    names = [s.name for s in spans]
    for name in children:
        assert name in names, (name, names)
    for s in spans:
        if s is not root:
            assert s.parent_id == root.span_id
            assert root.t0 - 1e-6 <= s.t0 <= s.t1 <= root.t1 + 1e-6
    if steps is not None:
        kind = "tree_verify" if spec else "decode_step"
        assert names.count(kind) >= 1 if spec else names.count(kind) == steps
        if spec:
            assert names.count("draft") == names.count(kind) == names.count("accept")
    return names


def test_every_request_gets_a_complete_span_tree():
    """Dense: request -> queue_wait, compute, finalize, with the Response's
    latency split; paged: request -> queue_wait, admission, prefix_lookup,
    prefill (or warm_admit for a repeat), one decode_step a step,
    finalize; tracing off mints no ids."""
    tracer = SpanTracer()
    eng = _sasrec_engine(tracer=tracer).start()
    rng = np.random.default_rng(1)
    try:
        resps = [f.result(60) for f in [eng.submit(Request(head="sasrec",
                                                           history=rng.integers(1, 31, 5)))
                                        for _ in range(3)]]
        assert len({r.request_id for r in resps}) == 3 and all(r.request_id for r in resps)
        for r in resps:
            _check_tree(tracer, r, ("queue_wait", "compute", "finalize"))
            by = {s.name: s for s in tracer.spans(r.request_id)}
            assert by["queue_wait"].duration == pytest.approx(r.queue_wait_s, abs=5e-3)
            assert by["compute"].duration == pytest.approx(r.compute_s, abs=5e-3)
        eng.set_tracer(None)
        assert eng.serve(Request(head="sasrec", history=[1, 2]), timeout=60).request_id is None
    finally:
        eng.stop()

    tracer = SpanTracer()
    eng, valid = _tiger_engine(tracer=tracer)
    eng.start()
    try:
        reqs = [Request(head="tiger", history=rng.integers(0, len(valid), 4), user_id=i)
                for i in range(5)]
        first = [f.result(60) for f in [eng.submit(r) for r in reqs]]
        again = eng.serve(reqs[-1], timeout=60)  # the newest retained run
    finally:
        eng.stop()
    for r in first:
        _check_tree(tracer, r, PAGED_TREE | {"prefill"}, steps=D)
    names = _check_tree(tracer, again, PAGED_TREE | {"warm_admit"}, steps=D)
    assert "prefill" not in names
    assert tracer.stats()["traces_started"] == 6


def test_spec_decode_requests_get_draft_verify_accept_spans():
    tracer = SpanTracer()
    eng, valid = _tiger_engine(tracer=tracer, spec_decode=True, spec_fanout=4)
    eng.start()
    rng = np.random.default_rng(2)
    try:
        resps = [f.result(60) for f in [eng.submit(Request(
            head="tiger", history=rng.integers(0, len(valid), 4), user_id=i)) for i in range(3)]]
    finally:
        eng.stop()
    for r in resps:
        names = _check_tree(tracer, r, PAGED_TREE | {"prefill", "draft", "tree_verify",
                                                    "accept"}, steps=D, spec=True)
        assert "decode_step" not in names


def test_sigterm_drains_the_engine_and_restores_the_handlers():
    """handle_signals=True: start() installs the guard on this (main)
    thread; a real SIGTERM mid-burst drains — every accepted request is
    answered, a later submit raises DrainingError — and the guard restores
    the previous handler, so the test process goes on."""
    assert threading.current_thread() is threading.main_thread()
    prev = signal.getsignal(signal.SIGTERM)
    eng, valid = _tiger_engine(handle_signals=True)
    eng.start()
    rng = np.random.default_rng(3)
    try:
        assert signal.getsignal(signal.SIGTERM) != prev
        futures = [eng.submit(Request(head="tiger", history=rng.integers(0, len(valid), 4)))
                   for _ in range(12)]
        os.kill(os.getpid(), signal.SIGTERM)
        assert eng.join(60), "the engine never drained"
        assert all(f.result(60).sem_ids.shape == (4, D) for f in futures)
        with pytest.raises(DrainingError):
            eng.submit(Request(head="tiger", history=[0]))
        assert signal.getsignal(signal.SIGTERM) == prev
        kinds = [e["kind"] for e in get_flight_recorder().events()]
        assert "signal" in kinds and "serving_drain_started" in kinds
    finally:
        st = eng.stop()
    assert st["completed"] == 12 and st["failed"] == 0 and st["rejected"] == 1
    assert signal.getsignal(signal.SIGTERM) == prev
