"""Hot catalog swap of the port's engine on the CPU, held to JAX.

genrec_tpu_torch/catalog/snapshot.py (``save`` / ``load`` /
``list_snapshots`` / ``capacity=``), serving/catalog.py (``CatalogWatcher``)
and the engine's ``stage_catalog`` pair with the same paths under
genrec_tpu/. Snapshot files are shared: one saved by JAX loads in the
port with the same version and arrays, and the other way round; a garbled
file raises ``CatalogIntegrityError``. On a TIGER engine (weights
converted from Flax), catalog B is staged mid-churn over disjoint corpora:
every response is legal under the catalog version it names, both versions
serve, and answers equal JAX ``tiger_generate_paged`` under that version's
trie (sem-ids equal, scores within 1e-5 / T); a snapshot on a larger
capacity rung swaps too (eager PyTorch has nothing to recompile). The
watcher stages a published snapshot and quarantines a garbled one, or
one the head rejects (the port of tests/test_catalog.py's watcher test).
COBRA's tower is re-encoded only on a catalog change: a params swap keeps
it, a text-only snapshot is encoded once on the staging thread, equal to
JAX ``encode_items`` of its text, and post-swap answers equal offline
``cobra_generate_paged`` under the new catalog (the port of
tests/test_catalog.py::test_cobra_tower_reencodes_only_on_catalog_change).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.catalog.snapshot import CatalogSnapshot as JaxCatalogSnapshot
from genrec_tpu.models import cobra as jcobra
from genrec_tpu_torch.catalog.snapshot import (
    CatalogIntegrityError,
    CatalogSnapshot,
    list_snapshots,
)
from genrec_tpu_torch.convert import cobra_params_from_flax
from genrec_tpu_torch.models import cobra as tcobra
from genrec_tpu_torch.serving.buckets import BucketLadder
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import CobraGenerativeHead
from genrec_tpu_torch.serving.kv_pool import PagedConfig
from genrec_tpu_torch.serving.types import Request

from tests._torch_live import (
    D,
    K_CB,
    assert_answers_jax,
    corpus,
    disjoint_corpora,
    jax_tiger,
    port_tiger,
    requests,
    tiger_engine,
    wait_for,
)

torch.set_num_threads(1)


def _tables(rng, n, kind):
    vecs = rng.normal(size=(n, 6)).astype(np.float32) if kind in ("vecs", "both") else None
    text = rng.integers(1, 50, (n, 5)).astype(np.int32) if kind in ("text", "both") else None
    return dict(item_vecs=vecs, item_text_tokens=text)


@pytest.mark.parametrize("kind", ["none", "vecs", "text", "both"])
def test_snapshot_files_are_shared_with_jax(tmp_path, kind):
    rng = np.random.default_rng(0)
    valid = corpus(rng, 30)
    tables = _tables(rng, len(valid), kind)
    jsnap = JaxCatalogSnapshot.build(valid, K_CB, **tables)
    port = CatalogSnapshot.load(jsnap.save(str(tmp_path / "from_jax")))
    tsnap = CatalogSnapshot.build(valid, K_CB, **tables)
    back = JaxCatalogSnapshot.load(tsnap.save(str(tmp_path / "from_port")))
    assert port.version == jsnap.version == tsnap.version == back.version
    assert port.capacity == jsnap.capacity == tsnap.capacity == back.capacity
    assert tsnap.filename() == jsnap.filename() == f"catalog-{tsnap.version}.npz"
    np.testing.assert_array_equal(port.item_sem_ids, valid)
    for name, want in tables.items():
        got = getattr(port, name)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    # The trie of a loaded snapshot is built at its recorded rung.
    assert port.trie().capacity == port.capacity
    assert not [f for f in os.listdir(tmp_path / "from_port") if f.endswith(".tmp")]


def test_capacity_pins_the_rung_and_garbled_files_raise(tmp_path):
    rng = np.random.default_rng(1)
    valid = corpus(rng, 20)
    pinned = CatalogSnapshot.build(valid, K_CB, capacity=64)
    assert pinned.capacity == JaxCatalogSnapshot.build(valid, K_CB, capacity=64).capacity == 64
    assert pinned.version == CatalogSnapshot.build(valid, K_CB).version  # content, not rung
    path = pinned.save(str(tmp_path))
    assert CatalogSnapshot.load(path).capacity == 64
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CatalogIntegrityError):
        CatalogSnapshot.load(path)
    # A well-formed archive whose recorded version lies about its content.
    liar = CatalogSnapshot.build(valid[:-1], K_CB)
    liar.version = pinned.version
    with pytest.raises(CatalogIntegrityError, match="content hash"):
        CatalogSnapshot.load(liar.save(str(tmp_path / "liar")))
    open(tmp_path / "notes.txt", "w").write("not a snapshot")
    assert [os.path.basename(p) for p in list_snapshots(str(tmp_path))] == [
        os.path.basename(path)]
    assert list_snapshots(str(tmp_path / "absent")) == []


def test_catalog_swap_mid_churn_mixes_no_versions():
    """Catalog B staged with requests in flight: every response's beams are
    legal under the version it names (the corpora are disjoint, so a mix
    is legal nowhere), both versions served, the answers are JAX's under
    that version's trie, and the swap emptied the prefix index."""
    jm, params = jax_tiger(0)
    rng = np.random.default_rng(2)
    valid_a, valid_b = disjoint_corpora(rng)
    snap_a, snap_b = CatalogSnapshot.build(valid_a, K_CB), CatalogSnapshot.build(valid_b, K_CB)
    eng = tiger_engine(port_tiger(params), snapshot=snap_a).start()
    n = min(len(valid_a), len(valid_b))
    reqs, futures = [], []

    def submit(k=1):
        for r in requests(rng, k, n):
            reqs.append(r)
            futures.append(eng.submit(r))

    try:
        submit()
        futures[0].result(60)  # one answer under A before B is staged
        submit(6)
        assert eng.stage_catalog("tiger", snap_b) is True
        assert eng.stage_catalog("tiger", snap_b) is False  # staged already
        assert eng.staged_catalog_version("tiger") in (snap_b.version, None)
        submit(6)
        wait_for(lambda: eng.catalog_version("tiger") == snap_b.version, "the swap",
                 poll=submit)
        submit(4)
        resps = [f.result(60) for f in futures]
        assert eng.stage_catalog("tiger", snap_b) is False  # live already
        stats = eng.stats()
    finally:
        eng.stop()
    catalogs = {snap_a.version: valid_a, snap_b.version: valid_b}
    assert {r.catalog_version for r in resps} == set(catalogs)
    assert stats["catalog_swaps"] == 1 and stats["failed"] == 0
    assert stats["prefix_cache"]["tiger"]["invalidations"] >= 1
    for req, resp in zip(reqs, resps):
        legal = {tuple(t) for t in catalogs[resp.catalog_version]}
        assert all(tuple(t) in legal for t in resp.sem_ids.tolist())
        assert_answers_jax(resp, jm, params, catalogs[resp.catalog_version], req)


def test_a_grown_rung_swaps_without_recompiling():
    jm, params = jax_tiger(0)
    rng = np.random.default_rng(3)
    valid_a = corpus(rng, 20)
    big = np.unique(rng.integers(0, K_CB, (200, D)), axis=0)
    snap_a, snap_big = CatalogSnapshot.build(valid_a, K_CB), CatalogSnapshot.build(big, K_CB)
    assert snap_big.capacity > snap_a.capacity
    eng = tiger_engine(port_tiger(params), snapshot=snap_a).start()
    try:
        eng.stage_catalog("tiger", snap_big)
        wait_for(lambda: eng.catalog_version("tiger") == snap_big.version, "the swap")
        reqs = requests(rng, 4, len(big))
        resps = [eng.serve(r, timeout=60) for r in reqs]
        ledger = eng.stats()["hbm"]["heads"]["tiger"]["operands"]["catalog_operands"]
    finally:
        eng.stop()
    assert ledger == sum(t.numel() * t.element_size() for t in (
        eng._heads["tiger"].trie.keys, eng._heads["tiger"].trie.offsets,
        eng._heads["tiger"].trie.weights, eng._heads["tiger"]._item_sem_ids_dev))
    for req, resp in zip(reqs, resps):
        assert resp.catalog_version == snap_big.version
        assert_answers_jax(resp, jm, params, big, req)


def test_catalog_watcher_stages_new_snapshots_and_quarantines_bad_ones(tmp_path):
    from genrec_tpu_torch.obs import get_flight_recorder

    fr = get_flight_recorder()
    fr.clear()
    jm, params = jax_tiger(0)
    rng = np.random.default_rng(4)
    valid_a, valid_b = disjoint_corpora(rng)
    snap_a, snap_b = CatalogSnapshot.build(valid_a, K_CB), CatalogSnapshot.build(valid_b, K_CB)
    cat_dir = str(tmp_path / "catalogs")
    snap_a.save(cat_dir)
    eng = tiger_engine(port_tiger(params), snapshot=snap_a, catalog_dirs={"tiger": cat_dir},
                       catalog_poll_secs=0.02).start()
    n = min(len(valid_a), len(valid_b))
    try:
        assert eng.serve(requests(rng, 1, n)[0], timeout=60).catalog_version == snap_a.version
        # Published by the JAX package: the same file format.
        path_b = JaxCatalogSnapshot.build(valid_b, K_CB).save(cat_dir)
        wait_for(lambda: eng.catalog_version("tiger") == snap_b.version, "the watcher's swap")
        req = requests(rng, 1, n)[0]
        resp = eng.serve(req, timeout=60)
        assert resp.catalog_version == snap_b.version
        assert_answers_jax(resp, jm, params, valid_b, req)

        # A garbled newer file: quarantined, serving goes on under B. It is
        # garbled outside the watched directory and moved in whole, so the
        # watcher never sees it intact or half written.
        staged = CatalogSnapshot.build(valid_a[:-1], K_CB).save(str(tmp_path / "staging"))
        raw = bytearray(open(staged, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(staged, "wb").write(bytes(raw))
        path_c = os.path.join(cat_dir, os.path.basename(staged))
        os.replace(staged, path_c)
        qdir = os.path.join(cat_dir, "quarantine")
        wait_for(lambda: os.path.exists(os.path.join(qdir, os.path.basename(path_c))),
                 "the garbled file's quarantine")
        # A snapshot the head cannot decode against (depth 2): quarantined.
        path_d = CatalogSnapshot.build(valid_a[:, :2], K_CB).save(cat_dir)
        wait_for(lambda: os.path.exists(os.path.join(qdir, os.path.basename(path_d))),
                 "the rejected file's quarantine")
        assert eng.serve(requests(rng, 1, n)[0], timeout=60).catalog_version == snap_b.version
        assert os.path.exists(path_b)  # good snapshots stay in place
        stats = eng.stats()
    finally:
        eng.stop()
    assert stats["catalog_swaps"] == 1 and stats["failed"] == 0
    reasons = [e["reason"] for e in fr.events("catalog_quarantined")]
    assert len(reasons) == 2 and "rejected by head" in reasons[1]
    assert [e["version"] for e in fr.events("catalog_swapped")] == [snap_b.version]


# ---- COBRA: the tower is a catalog artifact ----------------------------------------

C, LTXT, COBRA_BEAMS = 3, 5, 4
COBRA_CFG = dict(encoder_n_layers=1, encoder_hidden_dim=16, encoder_num_heads=2,
                 encoder_vocab_size=50, id_vocab_size=K_CB, n_codebooks=C, d_model=16,
                 max_len=64, temperature=0.2, decoder_n_layers=2, decoder_num_heads=2,
                 decoder_dropout=0.0)


def test_cobra_tower_reencodes_only_on_a_catalog_change():
    jm = jcobra.Cobra(**COBRA_CFG)
    init = jax.jit(jm.init)
    p1 = init(jax.random.key(0), jnp.zeros((2, 4 * C), jnp.int32),
              jnp.ones((2, 4, LTXT), jnp.int32))["params"]
    p2 = init(jax.random.key(1), jnp.zeros((2, 4 * C), jnp.int32),
              jnp.ones((2, 4, LTXT), jnp.int32))["params"]
    model = tcobra.Cobra(device="cpu", **COBRA_CFG).eval()
    model.load_state_dict(cobra_params_from_flax(jax.tree_util.tree_map(np.asarray, p1), model))
    rng = np.random.default_rng(5)
    valid = corpus(rng, 20)
    text = rng.integers(1, 50, (len(valid), LTXT)).astype(np.int32)
    head = CobraGenerativeHead(model, item_sem_ids=valid, item_text_tokens=text,
                               top_k=COBRA_BEAMS)
    eng = ServingEngine([head], device="cpu", ladder=BucketLadder((1, 2), (2, 4)), max_batch=2,
                        max_wait_ms=1.0, params_step=1, handle_signals=False,
                        paged_config=PagedConfig(max_slots=3, page_size=8, pages_per_slot=2)
                        ).start()

    def reqs(n, n_items):
        return [Request(head="cobra", history=rng.integers(0, n_items, int(k)))
                for k in rng.integers(1, 5, n)]

    try:
        assert head.tower_encodes == 1
        vecs_v1 = head.item_vecs.clone()
        new = cobra_params_from_flax(jax.tree_util.tree_map(np.asarray, p2), model)
        eng.stage_params(new, 2)
        wait_for(lambda: eng.params_step == 2, "the params swap")
        [eng.serve(r, timeout=60) for r in reqs(2, len(valid))]
        assert head.tower_encodes == 1  # a params swap keeps the tower
        torch.testing.assert_close(head.item_vecs, vecs_v1, rtol=0, atol=0)

        valid2 = corpus(np.random.default_rng(6), 22)
        text2 = rng.integers(1, 50, (len(valid2), LTXT)).astype(np.int32)
        snap2 = CatalogSnapshot.build(valid2, K_CB, item_text_tokens=text2)
        assert eng.stage_catalog("cobra", snap2)
        assert head.tower_encodes == 2  # encoded on this (the staging) thread
        wait_for(lambda: eng.catalog_version("cobra") == snap2.version, "the catalog swap")
        assert head.tower_encodes == 2
        post = reqs(4, len(valid2))
        resps = [eng.serve(r, timeout=60) for r in post]
    finally:
        eng.stop()
    want = jm.apply({"params": p2}, jnp.asarray(text2), method=jcobra.Cobra.encode_items)
    np.testing.assert_allclose(head.item_vecs.numpy(), np.asarray(want), atol=1e-5)
    for req, resp in zip(post, resps):
        assert resp.catalog_version == snap2.version and resp.params_step == 2
        ids, vecs = head.make_batch([req], 1, resp.bucket[1])
        out = tcobra.cobra_generate_paged(model, ids, None, n_candidates=COBRA_BEAMS,
                                          temperature=1.0, item_vecs=vecs, trie=head.trie,
                                          page_size=8)
        np.testing.assert_array_equal(resp.sem_ids, out.sem_ids[0].numpy())
        np.testing.assert_allclose(resp.scores, out.scores[0].numpy(), atol=1e-5)
