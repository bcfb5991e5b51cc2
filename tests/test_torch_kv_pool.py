"""The refcounted page pool and the prefix index, held to the JAX package.

genrec_tpu_torch/serving/kv_pool.py (``PagedConfig``, ``PageAllocator``,
``KVPagePool``, ``PrefixIndex``) pairs with genrec_tpu/serving/kv_pool.py.
The same seeded sequence of operations (admit, share, warm admit, evict,
scratch reserve and release, insert, lookup, touch, remove, reclaim,
clear) runs on both, and after every operation the refcounts, the free
list, the block tables, seq_lens, the gauges and the index's state must
be equal, and an operation that raises on one side must raise the same
error on the other. The engine tests pin the reclaim-before-defer and the
deferral of a request whose pages are held by live slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.serving import kv_pool as jkv
from genrec_tpu_torch.serving import kv_pool as tkv
from genrec_tpu_torch.serving.buckets import BucketLadder
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import TigerGenerativeHead
from genrec_tpu_torch.serving.types import Request

torch.set_num_threads(1)


def _pools(cfg_kwargs):
    j = jkv.KVPagePool(jkv.PagedConfig(**cfg_kwargs), 1, 2, 4, jnp.float32)
    t = tkv.KVPagePool(tkv.PagedConfig(**cfg_kwargs), 1, 2, 4, device="cpu")
    return j, t


def _same_state(j, t, jix, tix):
    np.testing.assert_array_equal(t.allocator._refs, j.allocator._refs)
    assert t.allocator._free == j.allocator._free
    np.testing.assert_array_equal(t.block_tables, j.block_tables)
    np.testing.assert_array_equal(t.seq_lens, j.seq_lens)
    assert t.stats() == j.stats()
    assert t.live_slots() == j.live_slots() and t.scratch_page_count == j.scratch_page_count
    assert tix.stats() == jix.stats() and list(tix._lru) == list(jix._lru)
    assert [e.pages for e in tix._lru.values()] == [e.pages for e in jix._lru.values()]
    t.check_invariants()
    j.check_invariants()


def _both(fj, ft):
    """Run an operation on both sides: equal results, or the same error."""
    try:
        rj = fj()
    except (jkv.PoolExhausted, ValueError) as e:
        with pytest.raises(tkv.PoolExhausted if isinstance(e, jkv.PoolExhausted)
                           else ValueError):
            ft()
        return None
    rt = ft()
    return rj, rt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_prefix_index_track_jax_over_one_op_sequence(seed):
    cfg = dict(max_slots=5, page_size=8, pages_per_slot=3, num_pages=14)
    j, t = _pools(cfg)
    jix, tix = jkv.PrefixIndex(j.allocator, max_entries=4), tkv.PrefixIndex(t.allocator,
                                                                             max_entries=4)
    rng = np.random.default_rng(seed)
    keys = [tuple(int(x) for x in rng.integers(0, 3, int(n))) for n in rng.integers(1, 4, 8)]
    ops = ("admit", "admit", "evict", "share", "admit_shared", "insert", "insert", "lookup",
           "touch", "remove", "reclaim", "scratch", "release", "clear")
    seen = {op: 0 for op in ops}
    for _ in range(400):
        op = ops[int(rng.integers(len(ops)))]
        live = j.live_slots()
        if op == "admit":
            n = int(rng.integers(0, cfg["pages_per_slot"] * 8 + 1))
            r = _both(lambda: j.admit(n), lambda: t.admit(n))
        elif op == "evict" and live:
            s = int(rng.choice(live))
            r = _both(lambda: j.evict(s), lambda: t.evict(s))
        elif op == "share" and live:
            s = int(rng.choice(live))
            n = int(rng.integers(1, 30))
            r = _both(lambda: j.share_into(s, n), lambda: t.share_into(s, n))
        elif op == "admit_shared" and len(jix):
            k = list(jix._lru)[int(rng.integers(len(jix)))]
            r = _both(lambda: j.admit_shared(jix._lru[k].pages, jix._lru[k].n_tokens),
                      lambda: t.admit_shared(tix._lru[k].pages, tix._lru[k].n_tokens))
        elif op == "insert" and live:
            s = int(rng.choice(live))
            k = keys[int(rng.integers(len(keys)))]
            r = _both(lambda: jix.insert(k, int(j.seq_lens[s]), j.slot_pages(s), bucket=(1, 8)),
                      lambda: tix.insert(k, int(t.seq_lens[s]), t.slot_pages(s), bucket=(1, 8)))
            r = None if r is None else (r[0].key, r[1].key)
        elif op == "lookup":
            k = keys[int(rng.integers(len(keys)))]
            (je, jd), (te, td) = jix.lookup(k), tix.lookup(k)
            assert (jd, None if je is None else je.key) == (td, None if te is None else te.key)
            r = (jd, td)
        elif op == "touch" and len(jix):
            k = list(jix._lru)[int(rng.integers(len(jix)))]
            r = _both(lambda: jix.touch(k), lambda: tix.touch(k))
        elif op == "remove":
            k = keys[int(rng.integers(len(keys)))]
            r = _both(lambda: jix.remove(k), lambda: tix.remove(k))
            r = None if r is None else tuple(None if e is None else e.key for e in r)
        elif op == "reclaim":
            n = int(rng.integers(0, 8))
            r = _both(lambda: jix.reclaim(n), lambda: tix.reclaim(n))
        elif op == "scratch":
            n = int(rng.integers(0, 3))
            r = _both(lambda: j.reserve_scratch(n), lambda: t.reserve_scratch(n))
            r = None if r is None else tuple(np.asarray(x).tolist() for x in r)
        elif op == "release":
            r = _both(j.release_scratch, t.release_scratch)
        elif op == "clear":
            r = _both(jix.clear, tix.clear)
        else:
            continue
        seen[op] += 1
        if r is not None:
            assert r[0] == r[1], (op, r)
        _same_state(j, t, jix, tix)
    assert all(seen[op] > 5 for op in ops), seen
    # Wind down on both: every reference dropped, nothing leaked.
    for s in j.live_slots():
        j.evict(s)
        t.evict(s)
    assert jix.clear() == tix.clear()
    assert j.release_scratch() == t.release_scratch()
    _same_state(j, t, jix, tix)
    assert t.allocator.pages_in_use == 0 and t.allocator.pages_free == cfg["num_pages"] - 1


def test_allocator_refcounts_match_jax():
    ja, ta = jkv.PageAllocator(6), tkv.PageAllocator(6)
    assert ja.alloc(3) == ta.alloc(3) == [1, 2, 3]
    ja.addref([1, 2])
    ta.addref([1, 2])
    np.testing.assert_array_equal(ta._refs, ja._refs)
    assert ta.refcount(1) == 2 and ta.is_live([1, 3]) and not ta.is_live([4])
    ta.free([1, 2, 3])
    ja.free([1, 2, 3])
    assert ta.pages_in_use == ja.pages_in_use == 2 and ta._free == ja._free
    with pytest.raises(ValueError, match="not live"):
        ta.addref([3])
    ta.free([1, 2])
    with pytest.raises(ValueError, match="double free"):
        ta.free([1])
    with pytest.raises(ValueError, match="invalid page"):
        ta.free([0])
    ta.check_invariants()
    assert ta.pages_in_use == 0


@pytest.mark.parametrize("kwargs", [
    dict(max_slots=4, page_size=8, pages_per_slot=3),
    dict(max_slots=4, page_size=16, pages_per_slot=3, num_pages=7),
    dict(max_slots=2, page_size=8, pages_per_slot=4, num_pages=5),
])
def test_paged_config_num_pages_matches_jax(kwargs):
    assert tkv.PagedConfig(**kwargs).num_pages == jkv.PagedConfig(**kwargs).num_pages
    cfg = tkv.PagedConfig(**kwargs)
    assert (cfg.hbm_bytes(2, 4, 8) == jkv.PagedConfig(**kwargs).hbm_bytes(2, 4, 8))
    with pytest.raises(ValueError, match="one full slot"):
        tkv.PagedConfig(**{**kwargs, "num_pages": kwargs["pages_per_slot"]})


def test_share_refs_only_the_pages_the_view_covers():
    pool = tkv.KVPagePool(tkv.PagedConfig(max_slots=3, page_size=8, pages_per_slot=3), 1, 2, 4,
                          device="cpu")
    s0 = pool.admit(24)
    s1 = pool.share_into(s0, 9)  # two of the donor's three pages
    assert pool.slot_pages(s1) == pool.slot_pages(s0)[:2]
    assert [pool.allocator.refcount(p) for p in pool.slot_pages(s0)] == [2, 2, 1]
    pool.evict(s0)
    assert pool.allocator.pages_in_use == 2  # the shared pages outlive the donor
    pool.evict(s1)
    pool.check_invariants()
    assert pool.allocator.pages_in_use == 0


# ---- the engine: reclaim before defer, deferral under live slots ---------------


K_CB, D = 8, 3


@pytest.fixture(scope="module")
def tiger_head_parts():
    from genrec_tpu_torch.models.tiger import Tiger

    model = Tiger(embedding_dim=16, attn_dim=32, num_heads=4, n_layers=2,
                  num_item_embeddings=K_CB, num_user_embeddings=20, sem_id_dim=D, max_pos=64,
                  device="cpu", seed=1).eval()
    valid = np.unique(np.random.default_rng(7).integers(0, K_CB, (20, D)), axis=0)
    return model, valid


def _engine(parts, cfg, max_batch=2):
    model, valid = parts
    head = TigerGenerativeHead(model, item_sem_ids=valid, top_k=4)
    return ServingEngine([head], device="cpu", ladder=BucketLadder((1, 2), (8,)),
                         max_batch=max_batch, max_wait_ms=1.0, paged_config=cfg).start()


def test_retained_pages_are_reclaimed_before_an_admission_defers(tiger_head_parts):
    """8 allocatable pages, 4 an 8-item history: two retained runs fill the
    pool, and a third history reclaims the LRU run instead of deferring."""
    valid = tiger_head_parts[1]
    eng = _engine(tiger_head_parts, tkv.PagedConfig(max_slots=2, page_size=8,
                                                    pages_per_slot=4, num_pages=9))
    hists = [np.full(8, i, np.int64) % len(valid) for i in range(3)]
    eng.serve(Request(head="tiger", history=hists[0]), timeout=120)
    eng.serve(Request(head="tiger", history=hists[1]), timeout=120)
    assert eng.stats()["prefix_cache"]["tiger"]["retained_pages"] == 8
    eng.serve(Request(head="tiger", history=hists[2]), timeout=120)
    st = eng.stats()
    assert st["oom_deferred_admits"] == 0 and st["prefix_cache"]["tiger"]["evictions"] >= 1
    eng.serve(Request(head="tiger", history=hists[1]), timeout=120)  # survived the LRU
    assert eng.stats()["prefix_cache"]["tiger"]["hits"] == 1
    final = eng.stop()
    assert final["kv_pool"]["tiger"]["pages_in_use"] == 0


def test_an_admission_that_finds_no_pages_waits_at_the_front(tiger_head_parts):
    """Two slots but pages for one full history: the second request is
    deferred (counted once), stays at the front of the queue and is
    answered when the first slot frees its pages, before the third."""
    valid = tiger_head_parts[1]
    eng = _engine(tiger_head_parts, tkv.PagedConfig(max_slots=2, page_size=8,
                                                    pages_per_slot=4, num_pages=6),
                  max_batch=1)
    reqs = [Request(head="tiger", history=np.arange(8) % len(valid), user_id=i)
            for i in range(3)]
    futs = [eng.submit(r) for r in reqs]
    resps = [f.result(120) for f in futs]
    st = eng.stop()
    assert st["completed"] == 3 and st["failed"] == 0
    assert st["oom_deferred_admits"] >= 1
    assert all(r.sem_ids.shape == (4, D) for r in resps)
    runner = eng.runner("tiger")
    runner.pool.check_invariants()
    assert runner.pool.allocator.pages_in_use == 0
