"""Hot params reload of the port's engine on the CPU, held to JAX.

genrec_tpu_torch/serving/engine.py's ``ckpt_dir`` watcher, ``stage_params``
and the drain barrier pair with genrec_tpu/serving/engine.py. A TIGER head
serves weights converted from Flax params; the watcher finds step 2 (a
second seeded init of the same shapes) published mid-burst: every response carries step 1
or 2 and equals JAX ``tiger_generate_paged`` under that step's params
(sem-ids equal, scores within 1e-5 / T); a damaged step 3 is quarantined
to ``quarantine/p0/3`` and a step 4 of another layout stays on disk while
step 2 keeps serving, and no request fails (the outputs the JAX engine's
test_checkpoint_watcher_hot_reload_and_quarantine asks for; its own
ladder leaves garbled orbax bytes in place, ROADMAP C). A TIGER head and
an int8 SASRec head swap together through ``stage_params`` (one tree
{head: state dict}); both answer as JAX under the new params, the int8
table rebuilt by ``on_params``, the weights copied in place. Both swaps
empty the prefix index and replays admit cold (the port of
tests/test_prefix_cache.py::test_params_and_catalog_hot_swaps_empty_prefix_index).
"""

import os

import jax
import numpy as np
import pytest
import torch

from genrec_tpu.models.sasrec import SASRec as JaxSASRec
from genrec_tpu.ops.quant import QuantizedTable as JaxQuantizedTable
from genrec_tpu.parallel.shardings import item_topk as jax_item_topk
from genrec_tpu_torch.catalog.snapshot import CatalogSnapshot
from genrec_tpu_torch.convert import sasrec_params_from_flax
from genrec_tpu_torch.core.checkpoint import TENSORS, CheckpointManager
from genrec_tpu_torch.models.sasrec import SASRec
from genrec_tpu_torch.models.tiger import Tiger
from genrec_tpu_torch.obs import get_flight_recorder
from genrec_tpu_torch.serving.heads import RetrievalHead
from genrec_tpu_torch.serving.types import Request

from tests._torch_live import (
    CFG,
    K_CB,
    assert_answers_jax,
    corpus,
    jax_tiger,
    port_state,
    port_tiger,
    requests,
    tiger_engine,
    wait_for,
)

torch.set_num_threads(1)


def _flip_a_tensor_byte(step_dir, data: bytes) -> None:
    path = os.path.join(step_dir, TENSORS)
    raw = bytearray(open(path, "rb").read())
    at = raw.find(data)
    assert at >= 0
    raw[at + 3] ^= 0x40
    open(path, "wb").write(bytes(raw))


def test_watcher_reloads_newer_params_and_quarantines_a_damaged_step(tmp_path):
    fr = get_flight_recorder()
    fr.clear()
    jm, p1 = jax_tiger(0)
    by_step = {1: p1, 2: jax_tiger(1)[1]}
    model = port_tiger(p1)
    rng = np.random.default_rng(0)
    catalog = corpus(rng)
    ckpt = str(tmp_path / "ckpt")
    mgr = CheckpointManager(ckpt)
    mgr.save(1, model.state_dict())
    eng = tiger_engine(model, catalog=catalog, ckpt_dir=ckpt, ckpt_poll_secs=0.02,
                       params_step=1).start()
    reqs = requests(rng, 24, len(catalog))
    try:
        first = eng.serve(reqs[0], timeout=60)
        assert first.params_step == 1
        futures = [eng.submit(r) for r in reqs[1:8]]
        mgr.save(2, port_state(by_step[2], model))  # published mid-burst
        futures += [eng.submit(r) for r in reqs[8:14]]
        wait_for(lambda: eng.params_step == 2, "the swap to step 2")
        futures += [eng.submit(r) for r in reqs[14:18]]
        burst = [first] + [f.result(60) for f in futures]

        # A damaged step 3 (damaged before it is renamed into the watched
        # directory, so the watcher never sees it whole): quarantined, step
        # 2 keeps serving.
        p3 = port_state(jax_tiger(2)[1], model)
        CheckpointManager(str(tmp_path / "unpublished")).save(3, p3)
        _flip_a_tensor_byte(str(tmp_path / "unpublished" / "3"),
                            p3["bos_embedding"].numpy().tobytes())
        os.replace(tmp_path / "unpublished" / "3", os.path.join(ckpt, "3"))
        wait_for(lambda: os.path.isdir(os.path.join(ckpt, "quarantine", "p0", "3")),
                 "step 3's quarantine")
        # A step 4 of another layout (a wider model): left on disk.
        other = Tiger(device="cpu", **{**CFG, "embedding_dim": 24})
        mgr.save(4, other.state_dict())
        wait_for(lambda: any(e["step"] == 4 and e["verdict"] == "mismatch"
                             for e in fr.events("integrity_ladder")), "step 4's verdict")
        after = [f.result(60) for f in [eng.submit(r) for r in reqs[18:]]]
    finally:
        stats = eng.stop()
    assert stats["failed"] == 0 and stats["completed"] == len(reqs)
    assert stats["params_swaps"] == 1 and stats["params_step"] == 2
    assert mgr.all_steps() == [1, 2, 4]  # max_to_keep 3; step 3 out of discovery
    steps = [r.params_step for r in burst]
    assert set(steps) == {1, 2} and steps == sorted(steps)  # one barrier, in order
    assert all(r.params_step == 2 for r in after)
    for req, resp in zip(reqs, burst + after):
        assert_answers_jax(resp, jm, by_step[resp.params_step], catalog, req)
    kinds = [e["kind"] for e in fr.events()]
    assert kinds.count("hot_reload_swapped") == 1
    assert kinds.index("hot_reload_staged") < kinds.index("hot_reload_swapped")
    assert [e["step"] for e in fr.events("checkpoint_quarantine")] == [3]


N_ITEMS, TOP_K = 30, 5


def test_stage_params_swaps_every_head_at_once():
    """One tree {head: state dict} for a TIGER head and an int8 SASRec head:
    staged mid-burst, swapped after the slots drain, each head answering
    as JAX under the version its response names; the weights are copied
    in place (the ledger's params bytes and the tensors' storage are the
    same) and the int8 table is rebuilt."""
    jm, p1 = jax_tiger(0)
    js = JaxSASRec(num_items=N_ITEMS, max_seq_len=8, embed_dim=16, num_heads=2, num_blocks=1,
                   ffn_dim=32, dropout=0.0)
    sas_by = {seed: js.init(jax.random.key(seed), np.zeros((1, 8), np.int32))["params"]
              for seed in (1, 2)}
    tiger_by = {1: p1, 2: jax_tiger(1)[1]}
    model = port_tiger(p1)
    sasrec = SASRec(num_items=N_ITEMS, max_seq_len=8, embed_dim=16, num_heads=2, num_blocks=1,
                    ffn_dim=32, dropout=0.0, device="cpu").eval()
    sasrec.load_state_dict(sasrec_params_from_flax(jax.device_get(sas_by[1]), sasrec))
    rng = np.random.default_rng(1)
    catalog = corpus(rng)
    head = RetrievalHead("sasrec", sasrec, top_k=TOP_K, quantized=True)
    eng = tiger_engine(model, heads=[head], catalog=catalog, params_step=1).start()
    storage = {k: t.data_ptr() for k, t in model.state_dict().items()}
    scale_before = head.table.scale.clone()
    try:
        with pytest.raises(RuntimeError, match="does not match"):
            eng.stage_params({"tiger": model.state_dict()}, 9)
        ledger_before = eng.stats()["hbm"]["heads"]
        tiger_reqs = requests(rng, 10, len(catalog))
        sas_reqs = [Request(head="sasrec", history=rng.integers(1, N_ITEMS + 1, 6))
                    for _ in range(10)]
        futures = [eng.submit(r) for r in tiger_reqs[:5] + sas_reqs[:5]]
        new = {"tiger": port_state(tiger_by[2], model),
               "sasrec": sasrec_params_from_flax(jax.device_get(sas_by[2]), sasrec)}
        eng.stage_params(new, 2, source="test")
        wait_for(lambda: eng.params_step == 2, "the swap")
        futures += [eng.submit(r) for r in tiger_reqs[5:] + sas_reqs[5:]]
        resps = [f.result(60) for f in futures]
        ledger_after = eng.stats()["hbm"]["heads"]
    finally:
        stats = eng.stop()
    assert stats["params_swaps"] == 1 and stats["failed"] == 0
    assert {k: t.data_ptr() for k, t in model.state_dict().items()} == storage
    assert {h: v["operands"]["params"] for h, v in ledger_after.items()} == {
        h: v["operands"]["params"] for h, v in ledger_before.items()}
    assert not torch.equal(head.table.scale, scale_before)  # on_params rebuilt it
    reqs = tiger_reqs[:5] + sas_reqs[:5] + tiger_reqs[5:] + sas_reqs[5:]
    assert all(r.params_step == 2 for r in resps[10:])
    for req, resp in zip(reqs, resps):
        if req.head == "tiger":
            assert_answers_jax(resp, jm, tiger_by[resp.params_step], catalog, req)
            continue
        params = sas_by[resp.params_step]
        ids = np.zeros((1, 8), np.int32)
        ids[0, 8 - len(req.history):] = req.history
        h = js.apply({"params": params}, ids, method=JaxSASRec.last_hidden)
        scores, items = jax_item_topk(h, JaxQuantizedTable.from_array(params["item_embedding"]),
                                      TOP_K)
        np.testing.assert_array_equal(resp.items, np.asarray(items[0]))
        np.testing.assert_allclose(resp.scores, np.asarray(scores[0]), atol=1e-5)


def test_params_and_catalog_swaps_empty_the_prefix_index():
    """A retained prefix was prefilled under the old params / old catalog:
    after either swap the index is empty and a replay prefills again under
    the new version (a miss, not a hit), answering as JAX under it."""
    jm, p1 = jax_tiger(0)
    p2 = jax_tiger(1)[1]
    model = port_tiger(p1)
    valid = corpus(np.random.default_rng(2))
    snap_a = CatalogSnapshot.build(valid, K_CB)
    valid_b = valid[: len(valid) - 2]
    snap_b = CatalogSnapshot.build(valid_b, K_CB, capacity=snap_a.capacity)
    eng = tiger_engine(model, snapshot=snap_a, params_step=1).start()
    fixed = Request(head="tiger", history=np.arange(5) % len(valid_b))
    try:
        r1 = eng.serve(fixed, timeout=60)
        assert eng.stats()["prefix_cache"]["tiger"]["entries"] == 1
        assert eng.serve(fixed, timeout=60).params_step == 1
        assert eng.stats()["prefix_cache"]["tiger"]["hits"] == 1  # warm before a swap

        eng.stage_params(port_state(p2, model), 2)
        wait_for(lambda: eng.params_step == 2, "the params swap")
        pc = eng.stats()["prefix_cache"]["tiger"]
        assert pc["entries"] == 0 and pc["retained_pages"] == 0 and pc["invalidations"] >= 1
        r2 = eng.serve(fixed, timeout=60)
        pc = eng.stats()["prefix_cache"]["tiger"]
        assert r2.params_step == 2 and pc["hits"] == 1 and pc["misses"] == 2
        assert not np.allclose(r1.scores, r2.scores)

        assert eng.stage_catalog("tiger", snap_b)
        wait_for(lambda: eng.catalog_version("tiger") == snap_b.version, "the catalog swap")
        pc = eng.stats()["prefix_cache"]["tiger"]
        assert pc["entries"] == 0 and pc["invalidations"] >= 2
        r3 = eng.serve(fixed, timeout=60)
        st = eng.stats()
    finally:
        eng.stop()
    assert r3.catalog_version == snap_b.version and r3.params_step == 2
    assert st["prefix_cache"]["tiger"]["hits"] == 1 and st["catalog_swaps"] == 1
    assert_answers_jax(r1, jm, p1, valid, fixed)
    assert_answers_jax(r2, jm, p2, valid, fixed)
    assert_answers_jax(r3, jm, p2, valid_b, fixed)
