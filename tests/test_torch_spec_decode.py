"""Speculative tree decode in the port, held to the JAX package.

genrec_tpu_torch/models/{tiger,cobra}.py (``tiger_spec_tree_step``,
``cobra_spec_tree_step`` and the tree passes under them) pair with
genrec_tpu/models/{tiger,cobra}.py; the engine's speculative runner
(genrec_tpu_torch/serving/engine.py) with genrec_tpu/serving/engine.py.
Sizes are those of tests/test_spec_decode.py: 8 codes a codebook, 4 beams,
a few layers, one history bucket, max_slots == max_batch. The port's
weights are the JAX init carried across by genrec_tpu_torch.convert.

Tolerances. Sem-ids, trie prefixes and accept lengths are exact. Scores
are held within 1e-4: they are sums of log-softmaxes of logits / T, and
two programs that sum in other orders put them ~1e-5 apart at T = 0.2
(the JAX package's own spec == plain pin of 1e-5 misses by 1.5e-5 at
D 4, ROADMAP §C). The suffix caches (K/V projections, no temperature) are
held within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.catalog.tensor_trie import TensorTrie as JaxTensorTrie
from genrec_tpu.models import cobra as jcobra
from genrec_tpu.models import tiger as jtiger
from genrec_tpu_torch.catalog.tensor_trie import TensorTrie
from genrec_tpu_torch.convert import cobra_params_from_flax, tiger_params_from_flax
from genrec_tpu_torch.models import cobra as tcobra
from genrec_tpu_torch.models import tiger as ttiger
from genrec_tpu_torch.models.sasrec import SASRec
from genrec_tpu_torch.ops.trie import tuples_are_valid
from genrec_tpu_torch.serving.buckets import BucketLadder
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import (
    CobraGenerativeHead,
    RetrievalHead,
    TigerGenerativeHead,
)
from genrec_tpu_torch.serving.kv_pool import KVPagePool, PagedConfig, PrefixIndex
from genrec_tpu_torch.serving.types import Request

torch.set_num_threads(1)

K_CB = 8
BEAMS = 4
SCORE_TOL = 1e-4
CACHE_TOL = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_state(jax_state, port_state, int_keys, score_keys, cache_keys=()):
    for k in int_keys:
        np.testing.assert_array_equal(_np(port_state[k]), _np(jax_state[k]), err_msg=k)
    for k in score_keys:
        np.testing.assert_allclose(_np(port_state[k]), _np(jax_state[k]), atol=SCORE_TOL,
                                   rtol=0, err_msg=k)
    for k in cache_keys:
        np.testing.assert_allclose(_np(port_state[k]), _np(jax_state[k]), atol=CACHE_TOL,
                                   rtol=0, err_msg=k)


# ---- TIGER ----------------------------------------------------------------------


def _tiger_cfg(D):
    return dict(embedding_dim=16, attn_dim=32, num_heads=4, n_layers=4,
                num_item_embeddings=K_CB, num_user_embeddings=20, sem_id_dim=D, max_pos=64)


@functools.lru_cache(maxsize=None)
def _tiger(D: int):
    """Both models on one init, both tries, and both prefills of one batch
    (a full row and two partial ones) into pools with contiguous block
    tables; the port's prefill also returns the step-0 draft window."""
    jmodel = jtiger.Tiger(dropout=0.0, **_tiger_cfg(D))
    rng = np.random.default_rng(D)
    valid = np.unique(rng.integers(0, K_CB, (30, D)), axis=0)
    B, L = 3, 4 * D
    mask = np.zeros((B, L), np.int64)
    for i, n in enumerate((L, 2 * D, 3 * D)):
        mask[i, :n] = 1
    batch = dict(user=rng.integers(0, 20, (B,)), items=rng.integers(0, K_CB, (B, L)),
                 types=np.tile(np.arange(D), (B, L // D)), mask=mask)
    jb = [jnp.asarray(batch[k], jnp.int32) for k in ("user", "items", "types", "mask")]
    tb = [torch.as_tensor(batch[k]) for k in ("user", "items", "types", "mask")]
    params = jax.jit(jmodel.init)(
        jax.random.key(0), *jb[:3], jnp.zeros((B, D), jnp.int32),
        jnp.zeros((B, D), jnp.int32), jb[3])["params"]
    tmodel = ttiger.Tiger(device="cpu", **_tiger_cfg(D))
    tmodel.load_state_dict(
        tiger_params_from_flax(jax.tree_util.tree_map(np.asarray, params), tmodel))
    tmodel.eval()
    nl, H = jmodel.n_layers // 2, jmodel.num_heads
    hd = jmodel.attn_dim // H
    page = 8
    pps = -(-(L + 1) // page)
    bt = (1 + np.arange(B * pps)).reshape(B, pps).astype(np.int32)
    shape = (1 + B * pps, page, H, hd)
    jk, jv, jlens, jextra = jax.jit(functools.partial(
        jtiger.tiger_prefill_paged, jmodel, draft_hint=True))(
        params, *jb, jnp.asarray(bt), tuple(jnp.zeros(shape) for _ in range(nl)),
        tuple(jnp.zeros(shape) for _ in range(nl)), trie=JaxTensorTrie.build(
            valid, K_CB).device())
    tk, tv, tlens, textra = ttiger.tiger_prefill_paged(
        tmodel, *tb, torch.as_tensor(bt), tuple(torch.zeros(shape) for _ in range(nl)),
        tuple(torch.zeros(shape) for _ in range(nl)), trie=TensorTrie.build(
            valid, K_CB).to("cpu"), draft_hint=True)
    return dict(
        jmodel=jmodel, params=params, tmodel=tmodel, B=B, D=D,
        jtrie=JaxTensorTrie.build(valid, K_CB).device(),
        ttrie=TensorTrie.build(valid, K_CB).to("cpu"),
        jargs=(jnp.asarray(bt), jlens, jk, jv), targs=(torch.as_tensor(bt), tlens, tk, tv),
        jextra=jextra, textra=textra, valid=valid,
    )


@functools.cache
def _jax_tiger_spec(jmodel, fanout):
    return jax.jit(functools.partial(jtiger.tiger_spec_tree_step, jmodel, fanout=fanout))


def _tiger_plain(s, state, steps):
    return ttiger.tiger_paged_decode_step(s["tmodel"], s["ttrie"], state, steps,
                                          *s["targs"])


def test_tiger_prefill_draft_window_matches_jax():
    s = _tiger(3)
    np.testing.assert_allclose(s["textra"]["logits0"].numpy(),
                               np.asarray(s["jextra"]["logits0"]), atol=1e-5, rtol=0)
    assert np.isneginf(s["textra"]["logits0"].numpy()).any()  # trie-masked codes


@pytest.mark.parametrize("D,hint", [(3, False), (4, False), (3, True)],
                         ids=["D3", "D4", "D3_draft_hint"])
def test_tiger_spec_step_matches_jax_call_by_call(D, hint):
    """Each call of the port's spec step against the JAX step on the same
    state: equal accept lengths, sem-ids and prefixes, scores within
    1e-4, caches within 1e-5; both reach the end in <= D calls."""
    s = _tiger(D)
    B = s["B"]
    jstate = dict(jtiger.init_tiger_paged_state(s["jmodel"], B, BEAMS, draft_hint=hint))
    tstate = ttiger.init_tiger_paged_state(s["tmodel"], B, BEAMS, draft_hint=hint)
    if hint:
        jstate["logits0"] = s["jextra"]["logits0"]
        tstate["logits0"] = s["textra"]["logits0"]
    jstep = _jax_tiger_spec(s["jmodel"], 3)
    steps = np.zeros(B, np.int64)
    calls = 0
    while steps.min() < D:
        jstate_new, jacc = jstep(s["params"], s["jtrie"], jstate,
                                 jnp.asarray(steps, jnp.int32), *s["jargs"])
        tstate, tacc = ttiger.tiger_spec_tree_step(
            s["tmodel"], s["ttrie"], tstate, torch.as_tensor(steps), *s["targs"], fanout=3)
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        jstate = {**jstate, **jstate_new}
        _assert_state(jstate, tstate, ("beam_seqs", "prefix_idx"), ("beam_logps",),
                      ("cache_k", "cache_v"))
        assert tacc.min() >= 1
        steps = steps + tacc.numpy()
        calls += 1
    assert calls <= D
    assert bool(tuples_are_valid(s["ttrie"], tstate["beam_seqs"]).all())


@pytest.mark.parametrize("D", [3, 4])
def test_tiger_spec_matches_plain_within_the_port(D):
    """Full-fanout drafting: the port's spec decode against its plain
    step, sem-ids and prefixes bit-equal, scores within 1e-4, in <= D
    calls (one call when every drafted level holds)."""
    s = _tiger(D)
    B = s["B"]
    plain = ttiger.init_tiger_paged_state(s["tmodel"], B, BEAMS)
    for step in range(D):
        plain = _tiger_plain(s, plain, torch.full((B,), step))
    spec = ttiger.init_tiger_paged_state(s["tmodel"], B, BEAMS)
    steps = torch.zeros(B, dtype=torch.int64)
    calls = 0
    while int(steps.min()) < D:
        spec, acc = ttiger.tiger_spec_tree_step(s["tmodel"], s["ttrie"], spec, steps,
                                                *s["targs"], fanout=K_CB)
        assert int(acc.min()) >= 1
        steps = steps + acc
        calls += 1
    assert calls <= D
    _assert_state(plain, spec, ("beam_seqs", "prefix_idx"), ("beam_logps",),
                  ("cache_k", "cache_v"))


def _reject_all_drafts(B, fanout, depth):
    """Every speculated candidate an illegal code: no selection can match."""
    return [np.full((B, BEAMS * fanout**l, fanout), K_CB + 3, np.int64)
            for l in range(depth)]


def test_fully_rejected_tree_rolls_back_clean():
    """A fully rejected tree (forced drafts) commits exactly the exact root
    level: its state equals the plain step's (the same tolerances), and
    the pool-side world is byte-equal to what it was: refcounts, block
    tables, seq_lens, retained prefix pages, the scratch reservation."""
    s = _tiger(3)
    B, D = s["B"], s["D"]
    pool = KVPagePool(PagedConfig(max_slots=B, page_size=8, pages_per_slot=4), 1, 2, 4,
                      device="cpu")
    slots = [pool.admit(9) for _ in range(B)]
    index = PrefixIndex(pool.allocator)
    index.insert((1, 2, 3), n_tokens=9, pages=pool.slot_pages(slots[0]))
    pool.reserve_scratch(2)
    before = (pool.allocator._refs.copy(), pool.block_tables.copy(), pool.seq_lens.copy(),
              index.retained_pages, list(pool.allocator._free))

    state = ttiger.init_tiger_paged_state(s["tmodel"], B, BEAMS)
    steps = torch.zeros(B, dtype=torch.int64)
    plain = _tiger_plain(s, dict(state), steps)
    spec, acc = ttiger.tiger_spec_tree_step(
        s["tmodel"], s["ttrie"], dict(state), steps, *s["targs"], fanout=4,
        draft_override=_reject_all_drafts(B, 4, D - 1))
    np.testing.assert_array_equal(acc.numpy(), np.ones(B))
    _assert_state(plain, spec, ("beam_seqs", "prefix_idx"), ("beam_logps",),
                  ("cache_k", "cache_v"))
    after = (pool.allocator._refs, pool.block_tables, pool.seq_lens, index.retained_pages,
             pool.allocator._free)
    for a, b in zip(before, after):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert pool.scratch_page_count == 2
    pool.check_invariants()


def test_drafter_disagrees_terminates_in_D_steps():
    s = _tiger(3)
    B, D = s["B"], s["D"]
    state = ttiger.init_tiger_paged_state(s["tmodel"], B, BEAMS)
    steps = torch.zeros(B, dtype=torch.int64)
    calls = 0
    while int(steps.min()) < D:
        state, acc = ttiger.tiger_spec_tree_step(
            s["tmodel"], s["ttrie"], state, steps, *s["targs"], fanout=4,
            draft_override=_reject_all_drafts(B, 4, D - 1))
        np.testing.assert_array_equal(acc.numpy(), np.ones(B))
        steps = steps + acc
        calls += 1
    assert calls == D
    plain = ttiger.init_tiger_paged_state(s["tmodel"], B, BEAMS)
    for step in range(D):
        plain = _tiger_plain(s, plain, torch.full((B,), step))
    _assert_state(plain, state, ("beam_seqs", "prefix_idx"), ("beam_logps",))


# ---- COBRA ----------------------------------------------------------------------


COBRA_CFG = dict(encoder_n_layers=1, encoder_hidden_dim=16, encoder_num_heads=2,
                 encoder_vocab_size=50, id_vocab_size=K_CB, n_codebooks=3, d_model=16,
                 max_len=64, temperature=0.2, decoder_n_layers=2, decoder_num_heads=2)


@functools.lru_cache(maxsize=None)
def _cobra(with_trie: bool):
    """Both models on one init, the prefill of a batch with a partial row
    (its steps read the prefill tail), and the initial states."""
    C = COBRA_CFG["n_codebooks"]
    jmodel = jcobra.Cobra(decoder_dropout=0.0, **COBRA_CFG)
    rng = np.random.default_rng(5)
    valid = np.unique(rng.integers(0, K_CB, (25, C)), axis=0)
    B, T, Ltxt = 3, 4, 5
    ids = rng.integers(0, K_CB, (B, T * C)).astype(np.int64)
    ids[1, 2 * C:] = jmodel.pad_id
    txt = rng.integers(1, 50, (B, T, Ltxt))
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(ids, jnp.int32),
                                  jnp.asarray(txt, jnp.int32))["params"]
    tmodel = tcobra.Cobra(decoder_dropout=0.0, device="cpu", **COBRA_CFG)
    tmodel.load_state_dict(
        cobra_params_from_flax(jax.tree_util.tree_map(np.asarray, params), tmodel))
    tmodel.eval()
    vecs = np.asarray(jmodel.apply({"params": params}, jnp.asarray(txt, jnp.int32),
                                   method=jcobra.Cobra.encode_items))
    nl, H = jmodel.decoder_n_layers, jmodel.decoder_num_heads
    hd = jmodel.d_model // H
    page = 8
    pps = -(-(T * (C + 1)) // page)
    bt = (1 + np.arange(B * pps)).reshape(B, pps).astype(np.int32)
    shape = (1 + B * pps, page, H, hd)
    jtrie = JaxTensorTrie.build(valid, K_CB).device() if with_trie else None
    ttrie = TensorTrie.build(valid, K_CB).to("cpu") if with_trie else None
    jk, jv, jinit = jcobra.cobra_prefill_paged(
        jmodel, params, jnp.asarray(ids, jnp.int32), jnp.asarray(vecs), jnp.asarray(bt),
        tuple(jnp.zeros(shape) for _ in range(nl)), tuple(jnp.zeros(shape) for _ in range(nl)),
        jtrie, BEAMS, 1.0)
    tk, tv, tinit = tcobra.cobra_prefill_paged(
        tmodel, torch.as_tensor(ids), torch.as_tensor(vecs), torch.as_tensor(bt),
        tuple(torch.zeros(shape) for _ in range(nl)),
        tuple(torch.zeros(shape) for _ in range(nl)), ttrie, BEAMS, 1.0)
    jstate = dict(jcobra.init_cobra_paged_state(jmodel, B, BEAMS))
    jstate.update(jinit)
    tstate = tcobra.init_cobra_paged_state(tmodel, B, BEAMS)
    tstate.update(tinit)
    return dict(jmodel=jmodel, params=params, tmodel=tmodel, B=B, C=C, jtrie=jtrie, valid=valid,
                ttrie=ttrie, jstate=jstate, tstate=tstate,
                jargs=(jnp.asarray(bt), jinit["base_pos"], jk, jv),
                targs=(torch.as_tensor(bt), tinit["base_pos"], tk, tv))


COBRA_INT = ("beam_tokens", "prefix_idx")
COBRA_SCORES = ("beam_scores",)
COBRA_FLOAT = ("cache_k", "cache_v", "h_last")


@pytest.mark.parametrize("with_trie", [True, False], ids=["trie", "free"])
def test_cobra_spec_step_matches_jax_call_by_call(with_trie):
    s = _cobra(with_trie)
    B, C = s["B"], s["C"]
    jstep = jax.jit(functools.partial(jcobra.cobra_spec_tree_step, s["jmodel"], fanout=3))
    jstate, tstate = dict(s["jstate"]), dict(s["tstate"])
    steps = np.ones(B, np.int64)
    calls = 0
    while steps.min() < C:
        jstate, jacc = jstep(s["params"], s["jtrie"], jstate, jnp.asarray(steps, jnp.int32),
                             *s["jargs"])
        tstate, tacc = tcobra.cobra_spec_tree_step(
            s["tmodel"], s["ttrie"], tstate, torch.as_tensor(steps), *s["targs"], fanout=3)
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        _assert_state(jstate, tstate, COBRA_INT, COBRA_SCORES, COBRA_FLOAT)
        steps = steps + tacc.numpy()
        calls += 1
    assert calls <= C - 1


@pytest.mark.parametrize("with_trie", [True, False], ids=["trie", "free"])
def test_cobra_spec_matches_plain_within_the_port(with_trie):
    s = _cobra(with_trie)
    B, C = s["B"], s["C"]
    plain = dict(s["tstate"])
    for c in range(1, C):
        plain = tcobra.cobra_paged_decode_step(s["tmodel"], s["ttrie"], plain,
                                               torch.full((B,), c), *s["targs"])
    spec = dict(s["tstate"])
    steps = torch.ones(B, dtype=torch.int64)
    calls = 0
    while int(steps.min()) < C:
        spec, acc = tcobra.cobra_spec_tree_step(s["tmodel"], s["ttrie"], spec, steps,
                                                *s["targs"], fanout=K_CB)
        assert int(acc.min()) >= 1
        steps = steps + acc
        calls += 1
    if with_trie:  # full-fanout legal drafting covers every child: one call
        assert calls == 1
        assert bool(tuples_are_valid(s["ttrie"], spec["beam_tokens"]).all())
    assert calls <= C - 1
    _assert_state(plain, spec, COBRA_INT, COBRA_SCORES, COBRA_FLOAT)


# ---- the engine: spec and plain heads on one engine, the prefix cache -----------


@functools.lru_cache(maxsize=None)
def _engine_heads():
    """The tiny TIGER (D 3) and COBRA of the tests above with their
    catalogs, COBRA's item text, and a tiny SASRec for a plain retrieval
    head."""
    tg, cb = _tiger(3), _cobra(True)
    text = np.random.default_rng(7).integers(1, 50, (len(cb["valid"]), 5))
    sasrec = SASRec(num_items=30, max_seq_len=8, embed_dim=16, num_heads=2, num_blocks=1,
                    ffn_dim=32, dropout=0.0, device="cpu", seed=3).eval()
    return tg, cb, text, sasrec


def _serve_all(spec_decode, reqs, prefix_cache=True):
    """One engine with spec-capable TIGER and COBRA heads and a plain
    retrieval head; submits staggered (a wait every fifth request), so
    slots sit at mixed steps. Returns (responses, stats, runners)."""
    tg, cb, text, sasrec = _engine_heads()
    heads = [
        TigerGenerativeHead(tg["tmodel"], item_sem_ids=tg["valid"], top_k=BEAMS),
        CobraGenerativeHead(cb["tmodel"], item_sem_ids=cb["valid"], item_text_tokens=text,
                            top_k=BEAMS),
        RetrievalHead("sasrec", sasrec, top_k=5),
    ]
    eng = ServingEngine(heads, device="cpu", ladder=BucketLadder((1, 2), (8,)), max_batch=2,
                        max_wait_ms=1.0, prefix_cache=prefix_cache,
                        paged_config=PagedConfig(max_slots=2, page_size=8, pages_per_slot=4),
                        spec_decode=spec_decode, spec_fanout=K_CB).start()
    futs, resps = [], []
    for i, r in enumerate(reqs):
        futs.append(eng.submit(r))
        if i % 5 == 4:
            resps.extend(f.result(300) for f in futs)
            futs = []
    resps.extend(f.result(300) for f in futs)
    stats = eng.stop()
    return resps, stats, {n: eng.runner(n) for n in ("tiger", "cobra")}


def _mixed_requests(n_tiger, n_cobra):
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(18):
        head = ("tiger", "cobra", "sasrec")[i % 3]
        n = (n_tiger, n_cobra, None)[i % 3]
        hist = (rng.integers(0, n, int(rng.integers(1, 9))) if n is not None
                else rng.integers(1, 31, 5))
        reqs.append(Request(head=head, history=hist, user_id=int(rng.integers(0, 20))))
    return reqs


def test_spec_engine_answers_as_the_plain_engine():
    """Spec TIGER + spec COBRA + a plain retrieval head on one engine,
    against an all-plain engine on the same requests: equal sem-ids and
    items, scores within 1e-4, fewer decoder calls, and after the drain
    no page held (slots, retained prefixes, scratch)."""
    tg, cb, _, _ = _engine_heads()
    reqs = _mixed_requests(len(tg["valid"]), len(cb["valid"]))
    spec, spec_stats, runners = _serve_all({"tiger", "cobra"}, reqs)
    plain, plain_stats, _ = _serve_all(False, reqs)
    for a, b in zip(spec, plain):
        np.testing.assert_array_equal(a.items, b.items)
        if a.sem_ids is not None:
            np.testing.assert_array_equal(a.sem_ids, b.sem_ids)
        np.testing.assert_allclose(a.scores, b.scores, atol=SCORE_TOL, rtol=0)
    assert spec_stats["completed"] == plain_stats["completed"] == len(reqs)
    assert spec_stats["failed"] == plain_stats["failed"] == 0
    assert spec_stats["decode_steps"] < plain_stats["decode_steps"]
    assert set(spec_stats["spec"]) == {"tiger", "cobra"} and not plain_stats["spec"]
    for name in ("tiger", "cobra"):
        st = spec_stats["spec"][name]
        assert st["accepted"] >= st["slot_steps"] >= 1
        assert sum(st["accept_len_hist"].values()) == st["slot_steps"]
        pool = runners[name].pool
        pool.check_invariants()
        assert pool.allocator.pages_in_use == 0 and pool.scratch_page_count == 0
        assert spec_stats["kv_pool"][name]["scratch_pages"] == 0
        assert spec_stats["prefix_cache"][name]["entries"] == 0
    # TIGER (D 3) at full fanout drafts every legal child: more than one
    # code a call on average.
    assert spec_stats["spec"]["tiger"]["codes_per_invocation"] > 1.5
    # The scratch reservation extended the page budget by the tree's pages
    # for every slot: ceil(292 nodes / 8) x 2 slots.
    assert runners["tiger"].cfg.num_pages == 1 + 2 * 4 + 2 * 37


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_repeated_history_is_answered_warm_as_cold(spec):
    """Each repeat of a (user, history) admits warm onto the retained pages
    (two a head; fewer prefill batches) and answers as its cold first
    serving; with the prefix cache off every answer is cold and the same."""
    tg, cb, _, _ = _engine_heads()
    rng = np.random.default_rng(3)
    first = [Request(head="tiger", history=rng.integers(0, len(tg["valid"]), 6), user_id=4),
             Request(head="cobra", history=rng.integers(0, len(cb["valid"]), 8), user_id=2)]
    other = [Request(head="tiger", history=np.asarray([1, 2]), user_id=9)]
    reqs = first + other + first + first  # served in groups of five: repeats land warm
    spec_decode = {"tiger", "cobra"} if spec else False
    warm, stats, runners = _serve_all(spec_decode, reqs)
    cold, cold_stats, _ = _serve_all(spec_decode, reqs, prefix_cache=False)
    for a, b in zip(warm, cold):
        np.testing.assert_array_equal(a.sem_ids, b.sem_ids)
        np.testing.assert_allclose(a.scores, b.scores, atol=SCORE_TOL, rtol=0)
    for i, j in ((0, 3), (1, 4), (0, 5), (1, 6)):  # each repeat as its first serving
        np.testing.assert_array_equal(warm[j].sem_ids, warm[i].sem_ids)
        np.testing.assert_allclose(warm[j].scores, warm[i].scores, atol=SCORE_TOL, rtol=0)
    for name in ("tiger", "cobra"):
        pc = stats["prefix_cache"][name]
        assert pc["hits"] == 2 and pc["warm_tokens"] > 0 and pc["insertions"] >= 1
        assert pc["entries"] == 0 and pc["invalidations"] >= 1  # the drain cleared it
        runners[name].pool.check_invariants()
        assert runners[name].pool.allocator.pages_in_use == 0
    assert stats["batches"] < cold_stats["batches"]  # a warm admit runs no prefill
    assert not cold_stats["prefix_cache"]
