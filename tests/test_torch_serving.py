"""The port's serving slice on the CPU, held to the JAX package.

genrec_tpu_torch/serving/{engine,heads,kv_pool,buckets,metrics,types}.py
pair with the same paths under genrec_tpu/serving/. The engine test
serves a tiny TIGER head with more requests than slots, so slots are
evicted and reused mid-stream, and holds every answer to the JAX
``tiger_generate_paged`` on that request: equal sem-ids and items,
scores within 1e-5 / T (see tests/test_torch_tiger_paged.py for why the
log-prob tolerance scales with 1 / T; the head decodes at T = 0.2). The
allocator and pool properties mirror tests/test_kv_pool.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.catalog.tensor_trie import TensorTrie as JaxTensorTrie
from genrec_tpu.models import tiger as jtiger
from genrec_tpu.serving import buckets as jbuckets
from genrec_tpu.serving import metrics as jmetrics
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.models.tiger import Tiger
from genrec_tpu_torch.serving import buckets as tbuckets
from genrec_tpu_torch.serving import metrics as tmetrics
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import TigerGenerativeHead
from genrec_tpu_torch.serving.kv_pool import (
    KVPagePool,
    PageAllocator,
    PagedConfig,
    PoolExhausted,
)
from genrec_tpu_torch.serving.types import DrainingError, Request, UnknownHeadError

torch.set_num_threads(1)

K_CB, D, N_USERS, BEAMS, TEMPERATURE = 32, 3, 50, 10, 0.2
CFG = dict(embedding_dim=32, attn_dim=64, num_heads=4, n_layers=4,
           num_item_embeddings=K_CB, num_user_embeddings=N_USERS,
           sem_id_dim=D, max_pos=64)
LADDER = dict(batch_buckets=(1, 2), history_buckets=(4, 8))
PAGED = dict(max_slots=4, page_size=8, pages_per_slot=4)


@pytest.fixture(scope="module")
def served():
    """JAX model + params, the port's model with the same weights, and a
    12-item catalog: beams (10) outnumber the legal children of most
    prefixes, so illegal candidates tie at -1e32 at every step."""
    jmodel = jtiger.Tiger(dropout=0.0, **CFG)
    z = jnp.zeros((2, 4 * D), jnp.int32)
    params = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((2,), jnp.int32), z, z,
        jnp.zeros((2, D), jnp.int32), jnp.zeros((2, D), jnp.int32), z,
    )["params"]
    tmodel = Tiger(device="cpu", **CFG)
    tmodel.load_state_dict(
        tiger_params_from_flax(jax.tree_util.tree_map(np.asarray, params), tmodel))
    catalog = np.unique(np.random.default_rng(7).integers(0, K_CB, (12, D)), axis=0)
    return jmodel, params, tmodel, catalog


def _jax_answer(jmodel, params, catalog, req, L):
    """JAX tiger_generate_paged on one request, laid out as the engine's
    prefill laid it out (history bucket L, newest items last)."""
    h = np.asarray(req.history)[-L:]
    ids = np.zeros((1, L * D), np.int32)
    mask = np.zeros((1, L * D), np.int32)
    ids[0, : len(h) * D] = catalog[h].reshape(-1)
    mask[0, : len(h) * D] = 1
    out = _jax_generate(jmodel)(
        params, JaxTensorTrie.build(catalog, K_CB).device(),
        jnp.asarray([req.user_id % N_USERS], jnp.int32), jnp.asarray(ids),
        jnp.asarray(np.tile(np.arange(D, dtype=np.int32), (1, L))), jnp.asarray(mask),
        jax.random.key(0), temperature=TEMPERATURE,
    )
    return np.asarray(out.sem_ids[0]), np.asarray(out.log_probas[0])


@functools.cache
def _jax_generate(jmodel):
    return jax.jit(functools.partial(
        jtiger.tiger_generate_paged, jmodel, n_top_k_candidates=BEAMS,
        deterministic=True,
    ))


def test_engine_answers_match_jax_generate(served):
    jmodel, params, tmodel, catalog = served
    rng = np.random.default_rng(11)
    reqs = [
        Request(head="tiger", history=rng.integers(0, len(catalog), int(n)),
                user_id=int(rng.integers(0, 10**6)))
        for n in rng.integers(1, 8, 13)  # 1..7 items: buckets 4 and 8
    ]
    head = TigerGenerativeHead(tmodel, item_sem_ids=catalog, top_k=BEAMS)
    engine = ServingEngine(
        [head], device="cpu", ladder=tbuckets.BucketLadder(**LADDER), max_batch=2,
        max_wait_ms=1.0, paged_config=PagedConfig(**PAGED),
    ).start()
    futures = [engine.submit(r) for r in reqs]
    responses = [f.result(timeout=120) for f in futures]
    stats = engine.stop()

    index = {tuple(int(c) for c in row): i for i, row in enumerate(catalog)}
    for req, resp in zip(reqs, responses):
        sem, logp = _jax_answer(jmodel, params, catalog, req, resp.bucket[1])
        np.testing.assert_array_equal(resp.sem_ids, sem)
        np.testing.assert_allclose(resp.scores, logp, atol=1e-5 / TEMPERATURE)
        np.testing.assert_array_equal(
            resp.items, [index.get(tuple(int(c) for c in t), -1) for t in sem])
        assert resp.catalog_version == head.catalog_version
        live = resp.scores > -1e30
        assert live.any() and (resp.items[live] >= 0).all()

    # More requests than slots: slots were evicted and reused.
    assert stats["completed"] == stats["admits"] == stats["evictions"] == len(reqs)
    assert stats["failed"] == 0 and stats["decode_steps"] >= len(reqs) * D // PAGED["max_slots"]
    pool = engine.runner("tiger").pool
    pool.check_invariants()
    assert pool.active_slot_count == 0 and pool.allocator.pages_in_use == 0
    assert pool.allocator.pages_free == pool.cfg.num_pages - 1
    assert stats["kv_pool"]["tiger"]["slots_active"] == 0


def test_engine_submit_surface(served):
    _, _, tmodel, catalog = served
    head = TigerGenerativeHead(tmodel, item_sem_ids=catalog, top_k=4)
    engine = ServingEngine(
        [head], device="cpu", ladder=tbuckets.BucketLadder(**LADDER), max_batch=2,
        paged_config=PagedConfig(**PAGED),
    ).start()
    with pytest.raises(UnknownHeadError):
        engine.submit(Request(head="nope", history=np.asarray([0])))
    with pytest.raises(ValueError, match="negative"):
        engine.submit(Request(head="tiger", history=np.asarray([1, -2])))
    with pytest.raises(ValueError, match="exceed the corpus"):
        engine.submit(Request(head="tiger", history=np.asarray([len(catalog)])))
    resp = engine.serve(Request(head="tiger", history=np.asarray([0, 1]), user_id=3))
    assert resp.sem_ids.shape == (4, D) and resp.scores.shape == (4,)
    engine.stop()
    with pytest.raises(DrainingError):
        engine.submit(Request(head="tiger", history=np.asarray([0])))
    assert engine.stats()["rejected"] == 1


def test_engine_fails_the_slots_of_a_decode_call_that_raises(served):
    """A decode call that raises (as a failed kernel launch does) fails the
    futures of the slots it ran for and frees them; the batcher goes on
    serving."""
    _, _, tmodel, catalog = served
    head = TigerGenerativeHead(tmodel, item_sem_ids=catalog, top_k=4)
    engine = ServingEngine(
        [head], device="cpu", ladder=tbuckets.BucketLadder(**LADDER), max_batch=2,
        max_wait_ms=1.0, paged_config=PagedConfig(**PAGED),
    ).start()
    runner = engine.runner("tiger")
    decode, calls = runner._decode, []

    def broken(*args):
        calls.append(len(args))
        raise RuntimeError("paged_attention_stats kernel launch failed")

    runner._decode = broken
    futures = [engine.submit(Request(head="tiger", history=np.asarray([i, i + 1]),
                                     user_id=i)) for i in range(3)]
    for f in futures:
        with pytest.raises(RuntimeError, match="launch failed"):
            f.result(timeout=60)
    assert calls and engine.stats()["failed"] == 3
    runner.pool.check_invariants()
    assert runner.idle and runner.pool.active_slot_count == 0
    # The failed slots' pages are free; only the prefix cache's retained
    # runs of the three prefills (which succeeded) still hold pages.
    assert runner.pool.allocator.pages_in_use == runner.prefix.retained_pages == 3

    runner._decode = decode
    resp = engine.serve(Request(head="tiger", history=np.asarray([0, 1]), user_id=3))
    assert resp.sem_ids.shape == (4, D)
    stats = engine.stop()
    assert stats["completed"] == 1 and stats["failed"] == 3
    assert stats["kv_pool"]["tiger"]["slots_active"] == 0
    assert runner.pool.allocator.pages_in_use == 0  # the drain released the retained runs


def test_engine_refuses_a_pool_smaller_than_the_largest_bucket(served):
    _, _, tmodel, catalog = served
    head = TigerGenerativeHead(tmodel, item_sem_ids=catalog)
    engine = ServingEngine(
        [head], device="cpu", ladder=tbuckets.BucketLadder(**LADDER), max_batch=2,
        paged_config=PagedConfig(max_slots=2, page_size=8, pages_per_slot=2),
    )
    with pytest.raises(ValueError, match="pages_per_slot"):
        engine.start()  # 1 + 8 * 3 = 25 KV tokens > 2 * 8


# ---- buckets and metrics ------------------------------------------------------


@pytest.mark.parametrize("max_batch,max_history", [(16, 64), (6, 20), (1, 8)])
def test_bucket_ladder_matches_jax(max_batch, max_history):
    j = jbuckets.default_ladder(max_batch, max_history)
    t = tbuckets.default_ladder(max_batch, max_history)
    assert t.batch_buckets == j.batch_buckets
    assert t.history_buckets == j.history_buckets
    for n in range(1, max_batch + 1):
        assert t.batch_bucket(n) == j.batch_bucket(n)
    for n in range(0, max_history + 5):
        assert t.history_bucket(n) == j.history_bucket(n)
    with pytest.raises(ValueError):
        t.batch_bucket(max_batch + 1)
    with pytest.raises(ValueError):
        tbuckets.BucketLadder((2, 1), (8,))


def test_latency_histogram_matches_jax():
    samples = np.random.default_rng(3).lognormal(-5, 1.5, 500)
    j, t = jmetrics.LatencyHistogram(), tmetrics.LatencyHistogram()
    for s in samples:
        j.record(s)
        t.record(s)
    for q in (0.5, 0.95, 0.99, 1.0):
        assert t.percentile(q) == j.percentile(q)
    assert t.summary() == j.summary()


# ---- PagedConfig, PageAllocator, KVPagePool (mirrors tests/test_kv_pool.py) ---


def test_paged_config_defaults_and_validation():
    cfg = PagedConfig(max_slots=4, page_size=16, pages_per_slot=3)
    assert cfg.num_pages == 1 + 4 * 3
    assert cfg.max_kv_tokens == 48
    assert cfg.pages_for(0) == 1 and cfg.pages_for(16) == 1 and cfg.pages_for(17) == 2
    with pytest.raises(ValueError):
        cfg.pages_for(49)
    with pytest.raises(ValueError):
        PagedConfig(max_slots=0)
    with pytest.raises(ValueError):
        PagedConfig(max_slots=4, page_size=0, pages_per_slot=3)
    with pytest.raises(ValueError):
        PagedConfig(max_slots=4, page_size=16, pages_per_slot=0)
    assert PagedConfig(kv_dtype="int8").kv_dtype == "int8"
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedConfig(kv_dtype="bf16")
    assert cfg.hbm_bytes(n_layers=2, n_heads=4, head_dim=8) == 2 * 2 * 13 * 16 * 4 * 8 * 4


def test_allocator_alloc_free_refcounts():
    a = PageAllocator(6)
    p1 = a.alloc(2)
    p2 = a.alloc(3)
    assert a.pages_free == 0 and a.pages_in_use == 5
    with pytest.raises(PoolExhausted):
        a.alloc(1)
    a.check_invariants()
    a.free(p1)
    assert a.pages_free == 2
    with pytest.raises(ValueError):
        a.free(p1)
    with pytest.raises(ValueError):
        a.free([0])
    with pytest.raises(ValueError):
        a.free([6])
    assert a.alloc(2) == p1[::-1]  # LIFO: the freed pages come back first
    a.free(p1)
    a.free(p2)
    assert a.pages_free == 5 and a.pages_in_use == 0
    a.check_invariants()


def test_pool_admit_evict_and_exhaustion():
    cfg = PagedConfig(max_slots=2, page_size=8, pages_per_slot=2)
    pool = KVPagePool(cfg, n_layers=1, n_heads=2, head_dim=4, device="cpu")
    assert pool.k_pools[0].shape == (5, 8, 2, 4) and pool.k_pools[0].device.type == "cpu"
    s0 = pool.admit(13)
    s1 = pool.admit(3)
    assert (s0, s1) == (0, 1)  # lowest slot first
    assert pool.seq_lens[s0] == 13 and (pool.block_tables[s0] > 0).sum() == 2
    assert pool.seq_lens[s1] == 3 and (pool.block_tables[s1] > 0).sum() == 1
    before = pool.block_tables.copy()
    with pytest.raises(PoolExhausted):  # out of slots
        pool.admit(16)
    np.testing.assert_array_equal(pool.block_tables, before)
    assert pool.allocator.pages_in_use == 3
    pool.evict(s0)
    assert pool.seq_lens[s0] == 0 and (pool.block_tables[s0] == 0).all()
    with pytest.raises(ValueError):
        pool.evict(s0)
    assert pool.admit(16) == s0  # the freed slot is the lowest again
    pool.check_invariants()


def test_allocator_random_churn_never_leaks_or_aliases(rng):
    cfg = PagedConfig(max_slots=6, page_size=8, pages_per_slot=3)
    pool = KVPagePool(cfg, n_layers=1, n_heads=2, head_dim=4, device="cpu")
    live: list[int] = []
    admitted = evicted = deferred = 0
    for _ in range(600):
        try:
            if rng.random() < 0.55:
                live.append(pool.admit(int(rng.integers(0, cfg.max_kv_tokens + 1))))
                admitted += 1
            elif live:
                pool.evict(live.pop(int(rng.integers(len(live)))))
                evicted += 1
        except PoolExhausted:
            deferred += 1
        pool.check_invariants()
        assert pool.active_slot_count == len(live)
        assert pool.allocator.pages_in_use == sum(
            cfg.pages_for(pool.seq_lens[s]) for s in live)
    assert admitted > 100 and evicted > 100 and deferred > 10
    for slot in live:
        pool.evict(slot)
    pool.check_invariants()
    assert pool.allocator.pages_in_use == 0
    assert pool.allocator.pages_free == cfg.num_pages - 1
