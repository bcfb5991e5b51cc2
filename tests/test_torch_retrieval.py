"""The retrieval serving path on the CPU, port against the JAX package.

Pairs: genrec_tpu_torch/parallel/shardings.py ``item_topk`` with JAX
``item_topk`` (ids equal, the lower id first among tied scores; scores
within 1e-6), ops/quant.py ``QuantizedTable`` with its JAX twin (data and
scale bit-equal; the int8 top-10 recall floor of tests/test_quantized.py),
serving/heads.py ``RetrievalHead.make_batch`` with the JAX head's (equal
arrays, with timestamps and with the clamp to ``max_seq_len``), and the
engine's micro-batch path: a CPU ``ServingEngine`` serving SASRec and HSTU
heads, whose fp32 answers must equal JAX ``last_hidden`` + ``item_topk``
on the same bucket batch (ids equal, scores within 1e-5), whose int8
answers keep a per-request recall of 0.8 against fp32 (the floor of
tests/test_quantized.py::test_engine_quantized_retrieval_heads), beside a
paged TIGER head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.models.hstu import HSTU as JaxHSTU
from genrec_tpu.models.sasrec import SASRec as JaxSASRec
from genrec_tpu.ops.quant import QuantizedTable as JaxQuantizedTable
from genrec_tpu.parallel.shardings import item_topk as jax_item_topk
from genrec_tpu.serving.heads import RetrievalHead as JaxRetrievalHead
from genrec_tpu.serving.types import Request as JaxRequest
from genrec_tpu_torch.convert import hstu_params_from_flax, sasrec_params_from_flax
from genrec_tpu_torch.models.embeddings import quantize_item_table
from genrec_tpu_torch.models.hstu import HSTU
from genrec_tpu_torch.models.sasrec import SASRec
from genrec_tpu_torch.models.tiger import Tiger
from genrec_tpu_torch.ops.quant import QuantizedTable
from genrec_tpu_torch.parallel.shardings import item_topk
from genrec_tpu_torch.serving.buckets import BucketLadder
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import RetrievalHead, TigerGenerativeHead
from genrec_tpu_torch.serving.kv_pool import PagedConfig
from genrec_tpu_torch.serving.types import Request

torch.set_num_threads(1)

N_ITEMS, MAX_LEN, TOP_K = 50, 12, 5
LADDER = dict(batch_buckets=(1, 2, 4), history_buckets=(4, 8, 16))


def _tied_scores(rng, B=6, V=40, d=8):
    """Integer-valued h and table (every product and sum exact in fp32 in
    both packages), with rows 3, 7 and 11 equal and rows 20 and 21 equal,
    so that scores tie exactly."""
    table = rng.integers(-3, 4, (V, d)).astype(np.float32)
    table[[7, 11]] = table[3]
    table[21] = table[20]
    h = rng.integers(-3, 4, (B, d)).astype(np.float32)
    h[0] = 0  # every score of row 0 ties
    return h, table


@pytest.mark.parametrize("k", [1, 5, 12, 40, 64])
def test_item_topk_matches_jax_with_ties(rng, k):
    h, table = _tied_scores(rng)
    w_scores, w_ids = jax_item_topk(jnp.asarray(h), jnp.asarray(table), k)
    scores, ids = item_topk(torch.as_tensor(h), torch.as_tensor(table), k)
    assert ids.dtype == torch.int64 and scores.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(w_ids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(w_scores), atol=1e-6, rtol=0)
    if k >= table.shape[0]:  # k clipped to V; the pad row ranks last
        assert ids.shape[1] == table.shape[0] and (ids[:, -1] == 0).all()
    else:
        assert (ids != 0).all()


def test_item_topk_quantized_matches_jax(rng):
    table = rng.normal(size=(60, 16)).astype(np.float32)
    h = rng.normal(size=(5, 16)).astype(np.float32)
    w_scores, w_ids = jax_item_topk(jnp.asarray(h),
                                    JaxQuantizedTable.from_array(jnp.asarray(table)), 10)
    scores, ids = item_topk(torch.as_tensor(h), QuantizedTable.from_array(
        torch.as_tensor(table)), 10)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(w_ids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(w_scores), atol=1e-6, rtol=1e-6)


def test_quantized_table_is_bit_equal_to_jax(rng):
    table = rng.normal(size=(37, 24)).astype(np.float32)
    table[5] = 0  # an all-zero row: the smallest scale, zeros back
    want = JaxQuantizedTable.from_array(jnp.asarray(table))
    got = quantize_item_table(torch.as_tensor(table))
    assert got.data.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))
    assert got.shape == want.shape and got.nbytes == want.nbytes
    assert not got.dequantize()[5].any()


def test_item_topk_quantized_recall_floor(rng):
    """The floor of tests/test_quantized.py::test_item_topk_quantized_recall_floor
    on the same sizes: int8 top-10 against fp32, recall >= 0.9."""
    V, d, B, k = 200, 32, 16, 10
    table = torch.as_tensor(rng.normal(size=(V, d)).astype(np.float32))
    h = torch.as_tensor(rng.normal(size=(B, d)).astype(np.float32))
    _, ids_fp = item_topk(h, table, k)
    _, ids_q8 = item_topk(h, QuantizedTable.from_array(table), k)
    recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                      for a, b in zip(ids_fp, ids_q8)])
    assert recall >= 0.9, recall


@pytest.fixture(scope="module")
def models():
    """(JAX SASRec, its params, the port's; JAX HSTU, its params, the
    port's), the port's carrying the JAX init."""
    js = JaxSASRec(num_items=N_ITEMS, max_seq_len=MAX_LEN, embed_dim=16, num_heads=2,
                   num_blocks=2, ffn_dim=32, dropout=0.0)
    sp = js.init(jax.random.key(0), jnp.zeros((1, MAX_LEN), jnp.int32))["params"]
    ts = SASRec(num_items=N_ITEMS, max_seq_len=MAX_LEN, embed_dim=16, num_heads=2,
                num_blocks=2, ffn_dim=32, dropout=0.0, device="cpu").eval()
    ts.load_state_dict(sasrec_params_from_flax(jax.device_get(sp), ts))
    jh = JaxHSTU(num_items=N_ITEMS, max_seq_len=MAX_LEN, embed_dim=16, num_heads=2,
                 num_blocks=2, dropout=0.0)
    hp = jh.init(jax.random.key(1), jnp.zeros((1, MAX_LEN), jnp.int32),
                 jnp.zeros((1, MAX_LEN), jnp.int32))["params"]
    th = HSTU(num_items=N_ITEMS, max_seq_len=MAX_LEN, embed_dim=16, num_heads=2,
              num_blocks=2, dropout=0.0, use_pallas=True, device="cpu").eval()
    th.load_state_dict(hstu_params_from_flax(jax.device_get(hp), th))
    return dict(sasrec=(js, sp, ts), hstu=(jh, hp, th))


def _requests(rng, n, heads=("sasrec", "hstu")):
    """Histories of 1 to 20 items (longer than max_seq_len, so some are
    clipped), ~1 event a day from 1.5e9 s; a third of the HSTU requests
    carry no timestamps."""
    out = []
    for i in range(n):
        for head in heads:
            m = int(rng.integers(1, 21))
            t = (np.cumsum(rng.integers(3600, 172800, m)) + 1_500_000_000
                 if head != "hstu" or i % 3 else None)
            out.append(Request(head=head, history=rng.integers(1, N_ITEMS + 1, m),
                               user_id=i, timestamps=t))
    return out


def _jax_request(r):
    return JaxRequest(head=r.head, history=r.history, user_id=r.user_id,
                      timestamps=r.timestamps)


@pytest.mark.parametrize("use_timestamps", [False, True], ids=["ids", "timestamps"])
@pytest.mark.parametrize("B,L", [(4, 8), (2, 16), (1, 4)])
def test_make_batch_matches_jax(models, rng, use_timestamps, B, L):
    """Right-aligned ids (and timestamps), rows past the requests zero, the
    history bucket clamped to max_seq_len (16 -> 12)."""
    jh, _, th = models["hstu"]
    reqs = _requests(rng, B, heads=("hstu",))
    want = JaxRetrievalHead("hstu", jh, use_timestamps=use_timestamps).make_batch(
        [_jax_request(r) for r in reqs[:max(B - 1, 1)]], B, L)
    got = RetrievalHead("hstu", th, use_timestamps=use_timestamps).make_batch(
        reqs[:max(B - 1, 1)], B, L)
    assert len(got) == len(want) == 1 + use_timestamps
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (B, min(L, MAX_LEN))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_answer(models, head, req, bucket, quantized=False):
    """JAX last_hidden + item_topk of one request, laid out in its bucket
    (B, L) as the JAX head lays it out, row 0."""
    jmodel, params, _ = models[head.name]
    jhead = JaxRetrievalHead(head.name, jmodel, top_k=TOP_K,
                             use_timestamps=head.use_timestamps)
    batch = jhead.make_batch([_jax_request(req)], *bucket)
    h = jmodel.apply({"params": params}, *batch, method=type(jmodel).last_hidden)
    table = params["item_embedding"]
    if quantized:
        table = JaxQuantizedTable.from_array(table)
    scores, ids = jax_item_topk(h.astype(jnp.float32), table, TOP_K)
    return np.asarray(scores[0]), np.asarray(ids[0])


def _serve(heads, reqs, **kw):
    engine = ServingEngine(heads, device="cpu", ladder=BucketLadder(**LADDER), max_batch=4,
                           max_wait_ms=1.0, **kw).start()
    try:
        responses = [f.result(timeout=120) for f in [engine.submit(r) for r in reqs]]
    finally:
        stats = engine.stop()
    return responses, stats


def test_engine_serves_sasrec_and_hstu_as_jax_scores_them(models):
    rng = np.random.default_rng(3)
    reqs = _requests(rng, 9)
    heads = [RetrievalHead("sasrec", models["sasrec"][2], top_k=TOP_K),
             RetrievalHead("hstu", models["hstu"][2], top_k=TOP_K, use_timestamps=True)]
    responses, stats = _serve(heads, reqs)
    assert stats["completed"] == len(reqs) and stats["failed"] == 0
    by_name = {h.name: h for h in heads}
    for req, resp in zip(reqs, responses):
        assert resp.head == req.head and resp.sem_ids is None
        assert resp.bucket[0] in LADDER["batch_buckets"]
        assert resp.bucket[1] in LADDER["history_buckets"]
        scores, ids = _jax_answer(models, by_name[req.head], req, resp.bucket)
        np.testing.assert_array_equal(resp.items, ids)
        np.testing.assert_allclose(resp.scores, scores, atol=1e-5, rtol=0)
        assert ((resp.items >= 1) & (resp.items <= N_ITEMS)).all()
    # Both heads ran micro-batches, in more than one bucket.
    assert {k.split("/")[0] for k in stats["bucket_hits"]} == {"sasrec", "hstu"}
    assert len(stats["bucket_hits"]) > 2


def test_engine_int8_heads_keep_recall_against_fp32(models):
    """Per-request recall of the int8 heads' top-k against the fp32 heads'
    >= 0.8; the int8 scores are JAX's int8 scoring's within 1e-5."""
    rng = np.random.default_rng(4)
    reqs = _requests(rng, 8)

    def heads(quantized):
        return [RetrievalHead("sasrec", models["sasrec"][2], top_k=TOP_K, quantized=quantized),
                RetrievalHead("hstu", models["hstu"][2], top_k=TOP_K, use_timestamps=True,
                              quantized=quantized)]

    fp32, _ = _serve(heads(False), reqs)
    q_heads = heads(True)
    int8, _ = _serve(q_heads, reqs)
    assert all(isinstance(h.table, QuantizedTable) for h in q_heads)
    for a, b in zip(fp32, int8):
        assert len(set(a.items.tolist()) & set(b.items.tolist())) / TOP_K >= 0.8
    by_name = {h.name: h for h in q_heads}
    for req, resp in zip(reqs[:4], int8[:4]):
        scores, ids = _jax_answer(models, by_name[req.head], req, resp.bucket, quantized=True)
        np.testing.assert_array_equal(resp.items, ids)
        np.testing.assert_allclose(resp.scores, scores, atol=1e-5, rtol=0)


def test_quantized_head_builds_its_table_once(models, monkeypatch):
    head = RetrievalHead("sasrec", models["sasrec"][2], top_k=TOP_K, quantized=True)
    with pytest.raises(RuntimeError, match="on_params"):
        head.table
    built = []
    import genrec_tpu_torch.serving.heads as heads_mod

    def counting(table):
        built.append(1)
        return quantize_item_table(table)

    monkeypatch.setattr(heads_mod, "quantize_item_table", counting)
    _serve([head], _requests(np.random.default_rng(5), 6, heads=("sasrec",)))
    assert built == [1]


def test_retrieval_and_paged_tiger_heads_share_one_engine(models):
    cfg = dict(embedding_dim=16, attn_dim=32, num_heads=2, n_layers=2, num_item_embeddings=8,
               num_user_embeddings=10, sem_id_dim=2, max_pos=64)
    catalog = np.unique(np.random.default_rng(7).integers(0, 8, (12, 2)), axis=0)
    tiger = TigerGenerativeHead(Tiger(device="cpu", **cfg).eval(), item_sem_ids=catalog,
                                top_k=3)
    rng = np.random.default_rng(6)
    reqs = _requests(rng, 4) + [
        Request(head="tiger", history=rng.integers(0, len(catalog), int(n)), user_id=i)
        for i, n in enumerate(rng.integers(1, 8, 5))]
    heads = [RetrievalHead("sasrec", models["sasrec"][2], top_k=TOP_K),
             RetrievalHead("hstu", models["hstu"][2], top_k=TOP_K, use_timestamps=True),
             tiger]
    responses, stats = _serve(heads, reqs, paged_config=PagedConfig(
        max_slots=4, page_size=8, pages_per_slot=5))
    assert stats["completed"] == len(reqs) and stats["failed"] == 0
    for req, resp in zip(reqs, responses):
        assert resp.head == req.head
        if req.head == "tiger":
            assert resp.sem_ids.shape == (3, 2)
        else:
            assert resp.sem_ids is None and resp.items.shape == (TOP_K,)
    assert stats["decode_steps"] > 0 and stats["kv_pool"]["tiger"]["slots_active"] == 0


def test_a_batch_that_raises_fails_only_its_own_futures(models):
    """The first SASRec micro-batch raises (as a failed kernel launch
    does): its requests fail, the HSTU head's and every later SASRec
    batch's are answered, and the batcher lives on."""
    sas = RetrievalHead("sasrec", models["sasrec"][2], top_k=TOP_K)
    hstu = RetrievalHead("hstu", models["hstu"][2], top_k=TOP_K, use_timestamps=True)
    make_fn, calls = sas.make_fn, []

    def flaky(B, L):
        fn = make_fn(B, L)

        def run(*args):
            calls.append(B)
            if len(calls) == 1:
                raise RuntimeError("hstu_attention_fwd kernel launch failed")
            return fn(*args)

        return run

    sas.make_fn = flaky
    engine = ServingEngine([sas, hstu], device="cpu", ladder=BucketLadder(**LADDER),
                           max_batch=4, max_wait_ms=1.0).start()
    rng = np.random.default_rng(8)
    first = [engine.submit(r) for r in _requests(rng, 4, heads=("sasrec",))]
    for f in first:
        with pytest.raises(RuntimeError, match="launch failed"):
            f.result(timeout=60)
    later = [engine.submit(r) for r in _requests(rng, 3)]
    assert all(f.result(timeout=60).items.shape == (TOP_K,) for f in later)
    stats = engine.stop()
    assert stats["failed"] == 4 and stats["completed"] == 6 and len(calls) >= 2


def test_hstu_predict_matches_jax(models):
    jh, hp, th = models["hstu"]
    rng = np.random.default_rng(9)
    ids = np.zeros((3, MAX_LEN), np.int32)
    for b, n in enumerate((1, 7, MAX_LEN)):
        ids[b, MAX_LEN - n:] = rng.integers(1, N_ITEMS + 1, n)
    ts = (np.cumsum(rng.integers(3600, 172800, (3, MAX_LEN)), axis=1)
          + 1_500_000_000).astype(np.int32)
    want = jh.apply({"params": hp}, jnp.asarray(ids), jnp.asarray(ts), method=JaxHSTU.predict,
                    top_k=7)
    got = th.predict(torch.as_tensor(ids), torch.as_tensor(ts), top_k=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
