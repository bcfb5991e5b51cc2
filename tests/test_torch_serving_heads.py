"""LCRec (generative, trie-constrained beam) and NoteLLM (retrieval,
[EMB] hidden -> item_topk) serving heads, port against the JAX package
(tests/test_serving_heads.py on the CPU).

One ServingEngine serves both heads on its dense micro-batch path, from
the JAX fixtures' weights (``convert.qwen_params_from_flax``):

- LCRec's served answer equals the offline constrained beam on the same
  bucket exactly, every tuple is a corpus item, and it equals JAX's
  offline beam (sem-ids exactly, log-probs 1e-5);
- NoteLLM's served answer equals the offline embedding -> top-k of the
  port, and JAX's at 1e-5;
- same-rung and rung-growing catalog swaps answer from the new version
  (eager PyTorch compiles nothing, so there is no recompile count to pin);
- both heads' validation errors are JAX's, message for message.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.catalog import CatalogSnapshot as JaxCatalogSnapshot
from genrec_tpu.models.backbones.qwen import QwenConfig as JaxQwenConfig
from genrec_tpu.models.backbones.qwen import QwenLM as JaxQwenLM
from genrec_tpu.models.lcrec import extend_vocab as jax_extend_vocab
from genrec_tpu.models.lcrec import generate_topk_constrained as jax_generate
from genrec_tpu.models.notellm import add_emb_token as jax_add_emb_token
from genrec_tpu.models.notellm import query2embedding_forward as jax_q2e
from genrec_tpu.serving import LCRecGenerativeHead as JaxLCRecHead
from genrec_tpu.serving import NoteLLMRetrievalHead as JaxNoteLLMHead
from genrec_tpu_torch.catalog.snapshot import CatalogSnapshot
from genrec_tpu_torch.convert import qwen_params_from_flax
from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM
from genrec_tpu_torch.models.lcrec import generate_topk_constrained
from genrec_tpu_torch.models.notellm import query2embedding_forward
from genrec_tpu_torch.parallel.shardings import item_topk
from genrec_tpu_torch.serving.buckets import BucketLadder
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import LCRecGenerativeHead, NoteLLMRetrievalHead
from genrec_tpu_torch.serving.types import Request

torch.set_num_threads(1)

C, K = 3, 8
N_ITEMS = 12
CFG = dict(vocab_size=40, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
           rope_theta=10000.0, tie_word_embeddings=False)


def _port(cfg, params):
    pcfg = QwenConfig(**{**CFG, "vocab_size": cfg.vocab_size})
    model = QwenLM(pcfg, device="cpu")
    model.load_state_dict(qwen_params_from_flax(jax.device_get(params), pcfg))
    return model.eval()


@pytest.fixture(scope="module")
def qwen():
    cfg = JaxQwenConfig(**CFG)
    params = JaxQwenLM(cfg).init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    lc_cfg, lc_params, base = jax_extend_vocab(cfg, params, C, K, jax.random.key(1))
    nl_cfg, nl_params, emb_id = jax_add_emb_token(cfg, params, jax.random.key(2))
    return dict(lc=(lc_cfg, lc_params, base), nl=(nl_cfg, nl_params, emb_id))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    valid = np.unique(rng.integers(0, K, (20, C)), axis=0)
    vecs = rng.standard_normal((N_ITEMS, 32)).astype(np.float32)
    nl_sem = rng.integers(0, 8, (N_ITEMS, 2))
    return valid, vecs, nl_sem


@pytest.fixture(scope="module")
def served(qwen, corpus):
    """One engine serving both heads (module-scoped)."""
    valid, vecs, nl_sem = corpus
    lc_cfg, lc_params, base = qwen["lc"]
    nl_cfg, nl_params, emb_id = qwen["nl"]
    lc_head = LCRecGenerativeHead(_port(lc_cfg, lc_params), base, C, K, item_sem_ids=valid,
                                  top_k=4, name="lcrec")
    nl_head = NoteLLMRetrievalHead(_port(nl_cfg, nl_params), emb_id, item_sem_ids=nl_sem,
                                   item_vecs=vecs, top_k=5, name="notellm")
    eng = ServingEngine([lc_head, nl_head], device="cpu", ladder=BucketLadder((1, 2), (4,)),
                        max_batch=2, max_wait_ms=1.0, handle_signals=False)
    eng.start()
    yield eng, lc_head, nl_head
    eng.stop()


def _wait_version(eng, head, version, timeout=30.0):
    deadline = time.monotonic() + timeout
    while eng.catalog_version(head) != version:
        assert time.monotonic() < deadline, "catalog swap never applied"
        time.sleep(0.02)


def test_lcrec_served_matches_offline_constrained_beam(served, qwen):
    eng, lc_head, _ = served
    req = Request(head="lcrec", history=np.array([1, 3, 5]))
    r = eng.submit(req).result(30)
    assert (r.items >= 0).all() and r.sem_ids.shape == (4, C)
    corpus_set = {tuple(row) for row in lc_head.item_sem_ids}
    assert all(tuple(row) in corpus_set for row in r.sem_ids)
    assert r.bucket == (1, 4)
    ids, mask = lc_head.make_batch([req], 1, 4)
    with torch.no_grad():
        out = generate_topk_constrained(lc_head.model, ids, mask, lc_head.base_vocab, C, K,
                                        beam_width=4, max_cache=4 * C + C, trie=lc_head.trie)
    np.testing.assert_array_equal(out.sem_ids[0].numpy(), r.sem_ids)
    np.testing.assert_array_equal(out.log_probas[0].numpy(), r.scores)
    np.testing.assert_array_equal(lc_head.lookup(r.sem_ids), r.items)
    # JAX's offline beam on the same weights and catalog.
    lc_cfg, lc_params, base = qwen["lc"]
    trie = JaxCatalogSnapshot.build(lc_head.item_sem_ids, K).device_trie()
    want = jax_generate(JaxQwenLM(lc_cfg), lc_params, jnp.asarray(ids.numpy()),
                        jnp.asarray(mask.numpy()), base, C, K, beam_width=4,
                        max_cache=4 * C + C, trie=trie)
    np.testing.assert_array_equal(np.asarray(want.sem_ids[0]), r.sem_ids)
    np.testing.assert_allclose(np.asarray(want.log_probas[0]), r.scores, atol=1e-5, rtol=0)


def test_notellm_served_matches_offline_embedding_topk(served, qwen):
    eng, _, nl_head = served
    req = Request(head="notellm", history=np.array([4, 9, 2, 7]))
    r = eng.submit(req).result(30)
    assert (r.items >= 0).all() and (r.items < N_ITEMS).all()
    ids, mask, emb_idx = nl_head.make_batch([req], 1, 4)
    with torch.no_grad():
        emb = query2embedding_forward(nl_head.model, ids, mask, emb_idx, torch.tensor(0.0),
                                      return_loss=False).sentence_embedding
    scores, rows = item_topk(torch.cat([emb, torch.ones(1, 1)], 1), nl_head._bank, 5)
    np.testing.assert_array_equal(rows[0].numpy() - 1, r.items)
    np.testing.assert_array_equal(scores[0].numpy(), r.scores)
    # JAX: the [EMB] embedding against the raw item vectors.
    nl_cfg, nl_params, _ = qwen["nl"]
    jemb = jax_q2e(JaxQwenLM(nl_cfg), nl_params, jnp.asarray(ids.numpy()),
                   jnp.asarray(mask.numpy()), jnp.asarray(emb_idx.numpy()), tau=jnp.float32(0.0),
                   return_loss=False).sentence_embedding
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=1e-5, rtol=1e-5)
    want = np.asarray(jemb @ nl_head.catalog.item_vecs.T)[0]
    top = np.argsort(-want, kind="stable")[:5]
    np.testing.assert_array_equal(r.items, top)
    np.testing.assert_allclose(r.scores, want[top], atol=1e-5, rtol=0)


def test_catalog_swaps_same_rung(served):
    eng, lc_head, nl_head = served
    rng = np.random.default_rng(7)
    valid2 = np.unique(rng.integers(0, K, (25, C)), axis=0)
    snap_lc = CatalogSnapshot.build(valid2, K)
    assert snap_lc.capacity == lc_head.catalog.capacity  # the same trie rung
    assert eng.stage_catalog("lcrec", snap_lc)
    vecs2 = rng.standard_normal((N_ITEMS, 32)).astype(np.float32)
    snap_nl = CatalogSnapshot.build(nl_head.catalog.item_sem_ids, 8, item_vecs=vecs2)
    bank0 = tuple(nl_head._bank.shape)
    assert eng.stage_catalog("notellm", snap_nl)
    assert not eng.stage_catalog("notellm", snap_nl)  # staged already
    _wait_version(eng, "lcrec", snap_lc.version)
    _wait_version(eng, "notellm", snap_nl.version)
    assert tuple(nl_head._bank.shape) == bank0  # the same bank rung
    r_lc = eng.submit(Request(head="lcrec", history=np.array([0, 2]))).result(30)
    r_nl = eng.submit(Request(head="notellm", history=np.array([1]))).result(30)
    assert r_lc.catalog_version == snap_lc.version
    assert r_nl.catalog_version == snap_nl.version
    corpus2 = {tuple(row) for row in valid2}
    assert all(tuple(row) in corpus2 for row in r_lc.sem_ids)
    np.testing.assert_array_equal(r_lc.items, [np.flatnonzero((valid2 == t).all(1))[0]
                                               for t in r_lc.sem_ids])
    # The new vectors answer.
    ids, mask, emb_idx = nl_head.make_batch([Request(head="notellm", history=[1])], 1, 1)
    with torch.no_grad():
        emb = query2embedding_forward(nl_head.model, ids, mask, emb_idx, torch.tensor(0.0),
                                      return_loss=False).sentence_embedding.numpy()
    top = np.argsort(-(emb @ vecs2.T)[0], kind="stable")[:5]
    np.testing.assert_array_equal(r_nl.items, top)


def test_notellm_bank_rung_growth(served):
    eng, _, nl_head = served
    rng = np.random.default_rng(8)
    big_n = 80  # crosses the 64-row rung
    vecs = rng.standard_normal((big_n, 32)).astype(np.float32)
    snap = CatalogSnapshot.build(rng.integers(0, 8, (big_n, 2)), 8, item_vecs=vecs)
    rows0 = nl_head._bank.shape[0]
    swaps = eng.stats()["catalog_swaps"]
    assert eng.stage_catalog("notellm", snap)
    _wait_version(eng, "notellm", snap.version)
    assert nl_head._bank.shape[0] > rows0 >= 64
    assert float(nl_head._bank[big_n + 1:, -1].max()) == NoteLLMRetrievalHead._PAD_BIAS
    r = eng.submit(Request(head="notellm", history=np.array([6, 3]))).result(30)
    assert r.catalog_version == snap.version
    assert (r.items >= 0).all() and (r.items < big_n).all()
    assert eng.stats()["catalog_swaps"] == swaps + 1
    # The memory ledger re-accounts the swapped-in bank (and LCRec's trie
    # and sem-id table) as the heads' catalog operands.
    heads = eng.stats()["hbm"]["heads"]
    assert heads["notellm"]["operands"]["catalog_operands"] == nl_head._bank.numel() * 4
    trie = eng._heads["lcrec"].trie
    assert heads["lcrec"]["operands"]["catalog_operands"] >= sum(
        t.numel() * t.element_size() for t in (trie.keys, trie.offsets)) > 0


def _raises_like(port_call, jax_call):
    """Both raise ValueError with the same message."""
    with pytest.raises(ValueError) as got:
        port_call()
    with pytest.raises(ValueError) as want:
        jax_call()
    assert str(got.value) == str(want.value)


def test_lcrec_head_validation(qwen, corpus):
    valid, _, _ = corpus
    lc_cfg, lc_params, base = qwen["lc"]
    model = _port(lc_cfg, lc_params)
    head = LCRecGenerativeHead(model, base, C, K, item_sem_ids=valid, top_k=4)
    jhead = JaxLCRecHead(JaxQwenLM(lc_cfg), base, C, K, item_sem_ids=valid, top_k=4)
    # Snapshot depth / codebook mismatches are refused at staging time.
    _raises_like(lambda: head.validate_snapshot(CatalogSnapshot.build(valid[:, :2], K)),
                 lambda: jhead.validate_snapshot(JaxCatalogSnapshot.build(valid[:, :2], K)))
    _raises_like(lambda: head.validate_snapshot(CatalogSnapshot.build(valid % 4, 4)),
                 lambda: jhead.validate_snapshot(JaxCatalogSnapshot.build(valid % 4, 4)))
    # The codebook region must fit inside the extended vocab.
    _raises_like(lambda: LCRecGenerativeHead(model, base, C, 10_000, item_sem_ids=valid),
                 lambda: JaxLCRecHead(JaxQwenLM(lc_cfg), base, C, 10_000, item_sem_ids=valid))
    _raises_like(lambda: LCRecGenerativeHead(model, base, C, K),
                 lambda: JaxLCRecHead(JaxQwenLM(lc_cfg), base, C, K))
    # History buckets clamp so that L C prompt tokens + C steps fit 64 positions.
    assert head._clamp(64) == (64 - C) // C


def test_notellm_head_validation(qwen, corpus):
    _, vecs, nl_sem = corpus
    nl_cfg, nl_params, emb_id = qwen["nl"]
    model = _port(nl_cfg, nl_params)
    head = NoteLLMRetrievalHead(model, emb_id, item_sem_ids=nl_sem, item_vecs=vecs, top_k=5)
    jhead = JaxNoteLLMHead(JaxQwenLM(nl_cfg), emb_id, item_sem_ids=nl_sem, item_vecs=vecs,
                           top_k=5)
    # A snapshot without item vectors cannot serve a retrieval bank.
    _raises_like(lambda: head.validate_snapshot(CatalogSnapshot.build(nl_sem, 8)),
                 lambda: jhead.validate_snapshot(JaxCatalogSnapshot.build(nl_sem, 8)))
    # The vector dim must be the model's hidden size.
    bad = np.zeros((N_ITEMS, 16), np.float32)
    _raises_like(lambda: head.validate_snapshot(CatalogSnapshot.build(nl_sem, 8, item_vecs=bad)),
                 lambda: jhead.validate_snapshot(JaxCatalogSnapshot.build(nl_sem, 8,
                                                                          item_vecs=bad)))
    _raises_like(lambda: NoteLLMRetrievalHead(model, emb_id, item_sem_ids=nl_sem),
                 lambda: JaxNoteLLMHead(JaxQwenLM(nl_cfg), emb_id, item_sem_ids=nl_sem))
    # Query tokens below [EMB] are legal; [EMB] itself and beyond are not.
    head.validate(Request(head="notellm", history=[emb_id - 1]))
    with pytest.raises(ValueError, match="exceed the corpus"):
        head.validate(Request(head="notellm", history=[emb_id]))
    # The bank: row 0 and the capacity rows carry the pad bias.
    bank = head._bank.numpy()
    assert bank.shape == (64, 33) and bank[0, -1] == bank[N_ITEMS + 1, -1] == -1e9
    np.testing.assert_array_equal(bank[1:N_ITEMS + 1, :32], vecs)
    # top_k past the items: the pad rows' answers report item -1.
    wide = NoteLLMRetrievalHead(model, emb_id, item_sem_ids=nl_sem[:3], item_vecs=vecs[:3],
                                top_k=5)
    batch = wide.make_batch([Request(head="notellm", history=[3, 4])], 2, 4)
    with torch.no_grad():
        out = tuple(o.numpy() for o in wide.make_fn(2, 4)(*wide.runtime_operands(), *batch))
    items = wide.finalize(out, [None])[0]["items"]
    assert sorted(items[:3].tolist()) == [0, 1, 2] and items[3:].tolist() == [-1, -1]


def test_snapshot_in_its_swap_counts_as_staged(served):
    """A snapshot whose ``set_catalog`` is still running is staged: staging
    it again returns False and the batcher swaps it in once."""
    eng, _, nl_head = served
    rng = np.random.default_rng(9)
    snap = CatalogSnapshot.build(nl_head.catalog.item_sem_ids, 8,
                                 item_vecs=rng.standard_normal((N_ITEMS, 32)).astype(np.float32))
    entered, release = threading.Event(), threading.Event()
    real = nl_head.set_catalog

    def blocking_set_catalog(s):
        entered.set()
        assert release.wait(30)
        real(s)

    swaps = eng.stats()["catalog_swaps"]
    nl_head.set_catalog = blocking_set_catalog
    try:
        assert eng.stage_catalog("notellm", snap)
        assert entered.wait(30), "the batcher never began the swap"
        assert eng.catalog_version("notellm") != snap.version  # mid-swap
        assert not eng.stage_catalog("notellm", snap)  # being swapped in: staged
    finally:
        release.set()
        _wait_version(eng, "notellm", snap.version)
        del nl_head.set_catalog
    assert not eng.stage_catalog("notellm", snap)  # live
    deadline = time.monotonic() + 30
    while eng.stats()["catalog_swaps"] != swaps + 1:  # counted after set_catalog returns
        assert time.monotonic() < deadline, "the swap was never counted"
        time.sleep(0.02)
    assert eng.staged_catalog_version("notellm") is None
    assert eng.stats()["catalog_swaps"] == swaps + 1
