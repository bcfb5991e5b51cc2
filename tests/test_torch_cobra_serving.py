"""COBRA serving in the port's engine, held to the JAX package.

genrec_tpu_torch/serving/heads.py::CobraGenerativeHead pairs with
genrec_tpu/serving/heads.py::CobraGenerativeHead, and catalog/snapshot.py's
item tower tables with their pair. The engine serves more requests than
it has slots, so slots are evicted and reused mid-stream and rows of one
decode call sit at different codebooks; every answer must equal offline
``cobra_generate_paged`` of the same page type on that request at the
engine's history bucket (sem-ids and items equal, scores within 1e-5 at
T = 1 for float32 pages; the port's offline int8 path, and JAX's, for int8
pages, scores within 2e-3 as tests/test_torch_cobra.py holds int8), and
the float32 answers also JAX's. A TIGER head served beside COBRA in one
engine must answer as it does alone. On the CPU the paged-attention
kernels (B1, B2) run as their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.catalog.snapshot import CatalogSnapshot as JaxCatalogSnapshot
from genrec_tpu.catalog.tensor_trie import TensorTrie as JaxTensorTrie
from genrec_tpu.models import cobra as jcobra
from genrec_tpu.models import tiger as jtiger
from genrec_tpu_torch.catalog.snapshot import CatalogSnapshot
from genrec_tpu_torch.convert import cobra_params_from_flax, tiger_params_from_flax
from genrec_tpu_torch.models import cobra as tcobra
from genrec_tpu_torch.models.tiger import Tiger, tiger_generate_paged
from genrec_tpu_torch.serving.buckets import BucketLadder
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import CobraGenerativeHead, TigerGenerativeHead
from genrec_tpu_torch.serving.kv_pool import PagedConfig
from genrec_tpu_torch.serving.types import Request

torch.set_num_threads(1)

K_CB, C, BEAMS, LTXT = 8, 3, 4, 5
CFG = dict(encoder_n_layers=1, encoder_hidden_dim=16, encoder_num_heads=2,
           encoder_vocab_size=50, id_vocab_size=K_CB, n_codebooks=C, d_model=16,
           max_len=64, temperature=0.2, decoder_n_layers=2, decoder_num_heads=2,
           decoder_dropout=0.0)
LADDER = dict(batch_buckets=(1, 2), history_buckets=(2, 4))
PAGED = dict(max_slots=3, page_size=8, pages_per_slot=2)  # 16 >= 4 items x (C + 1)


@pytest.fixture(scope="module")
def served():
    """JAX model + params, the port with the same weights, a 20-item
    catalog (4 beams outnumber most prefixes' legal children, so illegal
    candidates tie at -1e32) and its item text."""
    jmodel = jcobra.Cobra(**CFG)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((2, 4 * C), jnp.int32),
                                  jnp.ones((2, 4, LTXT), jnp.int32))["params"]
    tmodel = tcobra.Cobra(device="cpu", **CFG).eval()
    tmodel.load_state_dict(cobra_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tmodel))
    rng = np.random.default_rng(7)
    catalog = np.unique(rng.integers(0, K_CB, (20, C)), axis=0)
    text = rng.integers(1, 50, (len(catalog), LTXT)).astype(np.int32)
    return jmodel, params, tmodel, catalog, text


def _requests(rng, n, n_items, head="cobra"):
    return [Request(head=head, history=rng.integers(0, n_items, int(k)),
                    user_id=int(rng.integers(0, 10**6)))
            for k in rng.integers(1, 5, n)]  # 1..4 items: buckets 2 and 4


def _engine(heads, kv_dtype="float32"):
    return ServingEngine(heads, device="cpu", ladder=BucketLadder(**LADDER), max_batch=2,
                         max_wait_ms=1.0, paged_config=PagedConfig(**PAGED, kv_dtype=kv_dtype)
                         ).start()


def _offline(head, req, L, kv_dtype):
    ids, vecs = head.make_batch([req], 1, L)
    out = tcobra.cobra_generate_paged(head.model, ids, None, n_candidates=BEAMS,
                                      temperature=1.0, item_vecs=vecs, trie=head.trie,
                                      page_size=PAGED["page_size"], kv_dtype=kv_dtype)
    return out.sem_ids[0].numpy(), out.scores[0].numpy()


def _jax_offline(jmodel, params, catalog, text, req, L, kv_dtype):
    """JAX cobra_generate_paged on one request laid out as the engine's
    prefill lays it out (history bucket L, newest items, then padding)."""
    h = np.asarray(req.history)[-L:]
    ids = np.full((1, L * C), jmodel.pad_id, np.int32)
    ids[0, : len(h) * C] = catalog[h].reshape(-1)
    tokens = np.ones((1, L, LTXT), np.int32)
    tokens[0, : len(h)] = text[h]
    vecs = jmodel.apply({"params": params}, jnp.asarray(tokens), method=jcobra.Cobra.encode_items)
    vecs = vecs * (jnp.arange(L) < len(h))[None, :, None]  # make_batch zeroes the padding
    out = jcobra.cobra_generate_paged(
        jmodel, params, jnp.asarray(ids), None, n_candidates=BEAMS, temperature=1.0,
        item_vecs=vecs, trie=JaxTensorTrie.build(catalog, K_CB).device(),
        page_size=PAGED["page_size"], kv_dtype=kv_dtype)
    return np.asarray(out.sem_ids[0]), np.asarray(out.scores[0])


@pytest.mark.parametrize("kv_dtype,atol", [("float32", 1e-5), ("int8", 2e-3)])
def test_engine_answers_match_offline_paged_generation(served, kv_dtype, atol):
    jmodel, params, tmodel, catalog, text = served
    rng = np.random.default_rng(11)
    reqs = _requests(rng, 9, len(catalog))
    head = CobraGenerativeHead(tmodel, item_sem_ids=catalog, item_text_tokens=text,
                               top_k=BEAMS)
    engine = _engine([head], kv_dtype)
    responses = [f.result(timeout=120) for f in [engine.submit(r) for r in reqs]]
    stats = engine.stop()

    index = {tuple(int(c) for c in row): i for i, row in enumerate(catalog)}
    for j, (req, resp) in enumerate(zip(reqs, responses)):
        sem, scores = _offline(head, req, resp.bucket[1], kv_dtype)
        np.testing.assert_array_equal(resp.sem_ids, sem)
        np.testing.assert_allclose(resp.scores, scores, atol=atol)
        np.testing.assert_array_equal(resp.items, [index[tuple(int(c) for c in s)] for s in sem])
        if j < 4:  # JAX's own tower, page type and search on the same layout
            jsem, jscores = _jax_offline(jmodel, params, catalog, text, req,
                                         resp.bucket[1], kv_dtype)
            np.testing.assert_array_equal(resp.sem_ids, jsem)
            np.testing.assert_allclose(resp.scores, jscores, atol=atol)
        assert resp.catalog_version == head.catalog_version
    # More requests than slots: slots were evicted and reused, and each
    # request took C - 1 decode steps after its prefill.
    assert stats["completed"] == stats["admits"] == stats["evictions"] == len(reqs)
    assert stats["failed"] == 0 and stats["decode_steps"] >= (C - 1) * len(reqs) // PAGED["max_slots"]
    assert {r.bucket[1] for r in responses} == {2, 4}
    pool = engine.runner("cobra").pool
    pool.check_invariants()
    assert pool.active_slot_count == 0 and pool.allocator.pages_in_use == 0


def test_decode_attention_reaches_only_full_rows(served, monkeypatch):
    """A row whose history fills its bucket answers from the decode steps'
    attention over its pages; a shorter row takes the prefill's hidden
    state (``state["full"]``, as JAX does), so a changed paged-attention
    result moves the first row's answer and leaves the second's bits."""
    _, _, tmodel, catalog, text = served
    head = CobraGenerativeHead(tmodel, item_sem_ids=catalog, item_text_tokens=text,
                               top_k=BEAMS)
    reqs = [Request(head="cobra", history=np.arange(4) + 3),
            Request(head="cobra", history=np.arange(2) + 9)]
    ids, vecs = head.make_batch(reqs, 2, 4)

    def answers():
        out = tcobra.cobra_generate_paged(tmodel, ids, None, n_candidates=BEAMS,
                                          temperature=1.0, item_vecs=vecs, trie=head.trie,
                                          page_size=PAGED["page_size"])
        return out.scores.numpy()

    want = answers()
    stats = tcobra.paged_attention_stats
    monkeypatch.setattr(tcobra, "paged_attention_stats",
                        lambda *a: (lambda acc, m, l: (acc * 3.0, m, l))(*stats(*a)))
    got = answers()
    assert np.abs(got[0] - want[0]).max() > 1e-3
    np.testing.assert_array_equal(got[1], want[1])


def test_tiger_answers_unchanged_beside_a_cobra_head(served):
    """One engine, a TIGER and a COBRA head, interleaved requests: TIGER's
    prefill returns no state rows and must answer exactly as offline
    tiger_generate_paged (TIGER alone), COBRA as offline COBRA."""
    _, _, tmodel, catalog, text = served
    tcfg = dict(embedding_dim=16, attn_dim=32, num_heads=2, n_layers=4,
                num_item_embeddings=K_CB, num_user_embeddings=20, sem_id_dim=C, max_pos=64)
    jt = jtiger.Tiger(dropout=0.0, **tcfg)
    z = jnp.zeros((2, 4 * C), jnp.int32)
    tparams = jax.jit(jt.init)(jax.random.key(1), jnp.zeros((2,), jnp.int32), z, z,
                               jnp.zeros((2, C), jnp.int32), jnp.zeros((2, C), jnp.int32),
                               z)["params"]
    tiger = Tiger(device="cpu", **tcfg).eval()
    tiger.load_state_dict(tiger_params_from_flax(
        jax.tree_util.tree_map(np.asarray, tparams), tiger))
    theads = TigerGenerativeHead(tiger, item_sem_ids=catalog, top_k=BEAMS)
    cheads = CobraGenerativeHead(tmodel, item_sem_ids=catalog, item_text_tokens=text,
                                 top_k=BEAMS)
    rng = np.random.default_rng(5)
    reqs = [r for pair in zip(_requests(rng, 6, len(catalog), "tiger"),
                              _requests(rng, 6, len(catalog), "cobra")) for r in pair]
    engine = _engine([theads, cheads])
    responses = [f.result(timeout=120) for f in [engine.submit(r) for r in reqs]]
    assert engine.stop()["failed"] == 0
    for req, resp in zip(reqs, responses):
        L = resp.bucket[1]
        if req.head == "cobra":
            sem, scores = _offline(cheads, req, L, "float32")
        else:
            user, ids, types, mask = theads.make_batch([req], 1, L)
            out = tiger_generate_paged(tiger, theads.trie, user, ids, types, mask,
                                       n_top_k_candidates=BEAMS, page_size=PAGED["page_size"])
            sem, scores = out.sem_ids[0].numpy(), out.log_probas[0].numpy()
        np.testing.assert_array_equal(resp.sem_ids, sem)
        np.testing.assert_allclose(resp.scores, scores, atol=1e-5)


def test_tower_encodes_once_a_catalog_version(served):
    """tests/test_catalog.py's tower test without hot reload: weight
    refreshes reuse the tower; a catalog with new text encodes once; a
    snapshot holding its vectors never encodes."""
    jmodel, params, tmodel, catalog, text = served
    head = CobraGenerativeHead(tmodel, item_sem_ids=catalog, item_text_tokens=text,
                               top_k=BEAMS)
    assert head.tower_encodes == 1
    vecs_v1 = head.item_vecs.clone()
    want = jmodel.apply({"params": params}, jnp.asarray(text), method=jcobra.Cobra.encode_items)
    np.testing.assert_allclose(vecs_v1.numpy(), np.asarray(want), atol=1e-5)
    head.on_params()
    head.on_params()
    assert head.tower_encodes == 1
    torch.testing.assert_close(head.item_vecs, vecs_v1, rtol=0, atol=0)

    rng = np.random.default_rng(5)
    catalog2 = np.unique(rng.integers(0, K_CB, (22, C)), axis=0)
    text2 = rng.integers(1, 50, (len(catalog2), LTXT)).astype(np.int32)
    head.set_catalog(CatalogSnapshot.build(catalog2, K_CB, item_text_tokens=text2))
    assert head.tower_encodes == 2 and head.item_vecs.shape[0] == len(catalog2)
    head.on_params()
    assert head.tower_encodes == 2

    vecs3 = rng.normal(size=(len(catalog), CFG["d_model"])).astype(np.float32)
    head.set_catalog(CatalogSnapshot.build(catalog, K_CB, item_vecs=vecs3))
    head.on_params()
    assert head.tower_encodes == 2
    np.testing.assert_array_equal(head.item_vecs.numpy(), vecs3)


@pytest.mark.parametrize("tables", ["none", "vecs", "text", "both"])
def test_snapshot_version_matches_jax(served, tables):
    _, _, _, catalog, text = served
    vecs = np.random.default_rng(0).normal(size=(len(catalog), 16)).astype(np.float32)
    kw = dict(item_vecs=vecs if tables in ("vecs", "both") else None,
              item_text_tokens=text if tables in ("text", "both") else None)
    port = CatalogSnapshot.build(catalog, K_CB, **kw)
    assert port.version == JaxCatalogSnapshot.build(catalog, K_CB, **kw).version
    assert port.version != CatalogSnapshot.build(catalog, K_CB).version or tables == "none"


def test_head_refuses_a_snapshot_it_cannot_serve(served):
    _, _, tmodel, catalog, text = served
    with pytest.raises(ValueError, match="item_vecs or item_text_tokens"):
        CobraGenerativeHead(tmodel, item_sem_ids=catalog)
    with pytest.raises(ValueError, match="n_codebooks"):
        CobraGenerativeHead(tmodel, item_sem_ids=catalog[:, :2], item_text_tokens=text)
    with pytest.raises(ValueError, match="id_vocab_size"):
        CobraGenerativeHead(tmodel, catalog=CatalogSnapshot.build(catalog, 16,
                                                                  item_text_tokens=text))
    with pytest.raises(ValueError, match="tower dim"):
        CobraGenerativeHead(tmodel, item_sem_ids=catalog,
                            item_vecs=np.zeros((len(catalog), 8), np.float32))
