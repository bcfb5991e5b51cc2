"""The engine's dense route for generative heads and its replica identity
(genrec_tpu_torch/serving/engine.py ``paged`` and ``replica_id``, and the
TIGER and COBRA heads' ``make_fn`` / ``finalize``), held to the JAX
package.

An engine built with ``paged=False`` builds no page pool and serves TIGER
and COBRA through one whole-generate call a micro-batch, as JAX's
``paged=False`` engine does (tests/test_serving.py's dense-vs-paged
pattern). Its answers must equal the JAX dense engine's on the same
weights (sem-ids and items equal, scores within 1e-4) and the port's paged
engine's. ``replica_id`` must reach every Response, the flight recorder's
events (read when each is recorded) and every span. On the CPU the
paged route's attention runs B1's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.serving import BucketLadder as JaxBucketLadder
from genrec_tpu.serving import ServingEngine as JaxServingEngine
from genrec_tpu.serving.heads import CobraGenerativeHead as JaxCobraHead
from genrec_tpu.serving.heads import TigerGenerativeHead as JaxTigerHead
from genrec_tpu.models import cobra as jcobra
from genrec_tpu_torch.convert import cobra_params_from_flax
from genrec_tpu_torch.models import cobra as tcobra
from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder
from genrec_tpu_torch.obs.spans import SpanTracer
from genrec_tpu_torch.serving.buckets import BucketLadder
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import CobraGenerativeHead, TigerGenerativeHead
from genrec_tpu_torch.serving.kv_pool import PagedConfig
from genrec_tpu_torch.serving.types import Request
from tests._torch_live import BEAMS, L_BUCKET, PAGED, corpus, jax_tiger, port_tiger, requests

torch.set_num_threads(1)

#: Scores of the two routes, and of the port against JAX.
SCORE_ATOL = 1e-4

K_CB, C, LTXT = 8, 3, 5
COBRA_CFG = dict(encoder_n_layers=1, encoder_hidden_dim=16, encoder_num_heads=2,
                 encoder_vocab_size=50, id_vocab_size=K_CB, n_codebooks=C, d_model=16,
                 max_len=64, temperature=0.2, decoder_n_layers=2, decoder_num_heads=2,
                 decoder_dropout=0.0)
COBRA_LADDER = ((1, 2), (2, 4))
COBRA_PAGED = dict(max_slots=3, page_size=8, pages_per_slot=2)  # 16 >= 4 items x (C + 1)


@pytest.fixture(scope="module")
def tiger():
    jm, params = jax_tiger(0)
    catalog = corpus(np.random.default_rng(3), n=40)
    return jm, params, port_tiger(params), catalog


@pytest.fixture(scope="module")
def cobra():
    jmodel = jcobra.Cobra(**COBRA_CFG)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((2, 4 * C), jnp.int32),
                                  jnp.ones((2, 4, LTXT), jnp.int32))["params"]
    tmodel = tcobra.Cobra(device="cpu", **COBRA_CFG).eval()
    tmodel.load_state_dict(cobra_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tmodel))
    rng = np.random.default_rng(7)
    catalog = np.unique(rng.integers(0, K_CB, (60, C)), axis=0)
    text = rng.integers(1, 50, (len(catalog), LTXT)).astype(np.int32)
    return jmodel, params, tmodel, catalog, text


def _serve_each(engine, reqs):
    """One request at a time, so both engines run every request at the
    same (1, L) bucket."""
    try:
        return [engine.serve(r, timeout=120) for r in reqs]
    finally:
        engine.stop()


def _assert_same(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.sem_ids, b.sem_ids, err_msg=f"{what} {i}")
        np.testing.assert_array_equal(a.items, b.items, err_msg=f"{what} {i}")
        np.testing.assert_allclose(a.scores, b.scores, atol=SCORE_ATOL, rtol=0,
                                   err_msg=f"{what} {i}")
        assert a.bucket == b.bucket, (what, i, a.bucket, b.bucket)


def test_tiger_dense_route_matches_jax_dense_engine_and_paged_route(tiger):
    jm, params, model, catalog = tiger
    reqs = requests(np.random.default_rng(5), 6, len(catalog))

    def port_engine(paged):
        return ServingEngine(
            [TigerGenerativeHead(model, catalog, top_k=BEAMS)], device="cpu",
            ladder=BucketLadder((1, 2), (L_BUCKET,)), max_batch=2, max_wait_ms=1.0,
            handle_signals=False, paged=paged, paged_config=PagedConfig(**PAGED)).start()

    dense_engine = port_engine(False)
    with pytest.raises(KeyError):  # no page pool, no slot state
        dense_engine.runner("tiger")
    dense = _serve_each(dense_engine, reqs)
    assert dense_engine.stats()["admits"] == 0 and dense_engine.stats()["decode_steps"] == 0
    paged = _serve_each(port_engine(True), reqs)
    jax_dense = _serve_each(JaxServingEngine(
        [JaxTigerHead(jm, catalog, top_k=BEAMS)], params,
        ladder=JaxBucketLadder((1, 2), (L_BUCKET,)), max_batch=2, max_wait_ms=1.0,
        handle_signals=False, paged=False).start(), reqs)
    _assert_same(dense, jax_dense, "port dense vs JAX dense")
    _assert_same(dense, paged, "port dense vs port paged")
    assert all((r.items >= 0).all() for r in dense)


def test_cobra_dense_route_matches_jax_dense_engine_and_paged_route(cobra):
    jmodel, params, tmodel, catalog, text = cobra
    rng = np.random.default_rng(11)
    reqs = [Request(head="cobra", history=rng.integers(0, len(catalog), int(k)))
            for k in rng.integers(1, 5, 6)]  # 1..4 items: buckets 2 and 4

    def port_engine(paged):
        head = CobraGenerativeHead(tmodel, item_sem_ids=catalog, item_text_tokens=text,
                                   top_k=BEAMS)
        return ServingEngine([head], device="cpu", ladder=BucketLadder(*COBRA_LADDER),
                             max_batch=2, max_wait_ms=1.0, handle_signals=False, paged=paged,
                             paged_config=PagedConfig(**COBRA_PAGED)).start()

    dense = _serve_each(port_engine(False), reqs)
    paged = _serve_each(port_engine(True), reqs)
    jax_dense = _serve_each(JaxServingEngine(
        [JaxCobraHead(jmodel, item_sem_ids=catalog, item_text_tokens=text, top_k=BEAMS)],
        params, ladder=JaxBucketLadder(*COBRA_LADDER), max_batch=2, max_wait_ms=1.0,
        handle_signals=False, paged=False).start(), reqs)
    _assert_same(dense, jax_dense, "port dense vs JAX dense")
    _assert_same(dense, paged, "port dense vs port paged")


def test_dense_route_batches_several_requests_in_one_call(tiger):
    """Requests co-batched on the dense route answer as they do alone (the
    whole-generate call is row-independent; padded rows are dropped)."""
    _, _, model, catalog = tiger
    reqs = requests(np.random.default_rng(9), 8, len(catalog))

    def engine():
        return ServingEngine([TigerGenerativeHead(model, catalog, top_k=BEAMS)],
                             device="cpu", ladder=BucketLadder((1, 2), (L_BUCKET,)),
                             max_batch=2, max_wait_ms=50.0, handle_signals=False,
                             paged=False).start()

    eng = engine()
    try:
        together = [f.result(timeout=120) for f in [eng.submit(r) for r in reqs]]
        stats = eng.stats()
    finally:
        eng.stop()
    assert stats["bucket_hits"].get(f"tiger/B2/L{L_BUCKET}", 0) > 0, stats["bucket_hits"]
    alone = _serve_each(engine(), reqs)
    for a, b in zip(together, alone):
        np.testing.assert_array_equal(a.sem_ids, b.sem_ids)
        np.testing.assert_allclose(a.scores, b.scores, atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_replica_id_on_every_response_flight_event_and_span(tiger, paged):
    _, _, model, catalog = tiger
    tracer = SpanTracer()
    eng = ServingEngine([TigerGenerativeHead(model, catalog, top_k=BEAMS)], device="cpu",
                        ladder=BucketLadder((1, 2), (L_BUCKET,)), max_batch=2,
                        max_wait_ms=1.0, handle_signals=False, paged=paged,
                        paged_config=PagedConfig(**PAGED), tracer=tracer,
                        replica_id="r-early")
    # A fleet assigns the identity after construction: every record
    # reads it when it is made.
    eng.replica_id = "r7"
    fr = get_flight_recorder()
    before = len(fr.events())
    eng.start()
    reqs = requests(np.random.default_rng(4), 5, len(catalog))
    try:
        responses = [f.result(timeout=120) for f in [eng.submit(r) for r in reqs]]
    finally:
        eng.stop()
    assert [r.replica_id for r in responses] == ["r7"] * len(reqs)
    events = [e for e in fr.events()[before:] if e.get("component") == "engine"]
    kinds = {e["kind"] for e in events}
    assert {"serving_started", "serving_stop"} <= kinds, kinds
    assert all(e.get("replica_id") == "r7" for e in events), events
    spans = [s for r in responses for s in tracer.spans(r.request_id)]
    names = {s.name for s in spans}
    assert {"request", "queue_wait", "finalize"} <= names, names
    assert all(s.attrs.get("replica") == "r7" and s.attrs.get("component") == "engine"
               for s in spans)


def test_engine_without_replica_id_stamps_none(tiger):
    _, _, model, catalog = tiger
    eng = ServingEngine([TigerGenerativeHead(model, catalog, top_k=BEAMS)], device="cpu",
                        ladder=BucketLadder((1, 2), (L_BUCKET,)), max_batch=2,
                        max_wait_ms=1.0, handle_signals=False, paged=False,
                        tracer=SpanTracer()).start()
    try:
        resp = eng.serve(requests(np.random.default_rng(1), 1, len(catalog))[0], timeout=120)
    finally:
        eng.stop()
    assert resp.replica_id is None
    spans = eng.tracer.spans(resp.request_id)
    assert spans and all("replica" not in s.attrs for s in spans)
