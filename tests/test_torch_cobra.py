"""The COBRA model and its decoders, port against the golden and the JAX
package.

genrec_tpu_torch/models/cobra.py pairs with genrec_tpu/models/cobra.py
(and ops/paged.merge_attention_stats, models/t5transformer.
init_decode_caches and catalog/tensor_trie's legal_mask / advance with
their pairs). The reference torch implementation's weights and outputs
(tests/data/cobra_golden.npz) reach the port through
tests/test_cobra.py::_params_from_golden and the converter, at that file's
tolerances: losses rel 2e-4, counts exact, cosine and entropy 1e-4,
generated sem-ids exact, scores and vectors 2e-4. Against JAX, inputs are
made from a seed with numpy and the JAX init is carried across by
``cobra_params_from_flax``: hidden states 1e-5, sem-ids exact, scores
1e-5 at T = 1 (fp32 on both sides; only the summation order differs).

int8 pages are held to JAX's int8 path, never to fp32: a K/V element
within rounding noise of a .5 edge lands one int8 step apart between the
packages, which moves a score by up to its row's scale (tests/
test_torch_quant.py); sem-ids must be equal and scores within 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.catalog.tensor_trie import TensorTrie as JaxTensorTrie
from genrec_tpu.models import cobra as jcobra
from genrec_tpu.models.t5transformer import init_decode_caches as jax_init_decode_caches
from genrec_tpu.ops.paged import merge_attention_stats as jax_merge
from genrec_tpu_torch.catalog.tensor_trie import TensorTrie
from genrec_tpu_torch.convert import cobra_params_from_flax
from genrec_tpu_torch.models import cobra as tcobra
from genrec_tpu_torch.models.t5transformer import init_decode_caches
from genrec_tpu_torch.ops.paged import merge_attention_stats

torch.set_num_threads(1)

K_CB, C = 8, 3
CFG = dict(encoder_n_layers=1, encoder_hidden_dim=16, encoder_num_heads=2,
           encoder_vocab_size=50, id_vocab_size=K_CB, n_codebooks=C, d_model=16,
           max_len=64, temperature=0.2, decoder_n_layers=2, decoder_num_heads=2,
           decoder_dropout=0.0)


def _port(params) -> tcobra.Cobra:
    model = tcobra.Cobra(device="cpu", **CFG).eval()
    model.load_state_dict(cobra_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), model))
    return model


t = torch.as_tensor


# ---- the reference golden ---------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    return np.load("tests/data/cobra_golden.npz")


@pytest.fixture(scope="module")
def golden_model(golden):
    from test_cobra import _params_from_golden

    return _port(_params_from_golden(golden))


def test_forward_matches_the_golden(golden, golden_model):
    with torch.no_grad():
        out = golden_model(t(golden["ids"]), t(golden["txt"]))
    for name, key in (("loss_sparse", "loss_sparse"), ("loss_dense", "loss_dense"),
                      ("loss", "loss")):
        assert float(getattr(out, name)) == pytest.approx(float(golden[key]), rel=2e-4)
    for name in ("acc_correct", "acc_total", "recall_correct", "recall_total"):
        assert int(getattr(out, name)) == int(golden[name])
    assert float(out.vec_cos_sim) == pytest.approx(float(golden["cos"]), abs=1e-4)
    assert float(out.codebook_entropy) == pytest.approx(float(golden["entropy"]), abs=1e-4)


def test_padded_forward_matches_the_golden(golden, golden_model):
    with torch.no_grad():
        out = golden_model(t(golden["ids_pad"]), t(golden["txt"]))
    assert float(out.loss_sparse) == pytest.approx(float(golden["pad_sparse"]), rel=2e-4)
    assert float(out.loss_dense) == pytest.approx(float(golden["pad_dense"]), rel=2e-4)


@pytest.mark.parametrize("use_cache", [True, False], ids=["cached", "uncached"])
def test_generate_matches_the_golden(golden, golden_model, use_cache):
    gen = tcobra.cobra_generate(golden_model, t(golden["ids"]), t(golden["txt"]),
                                n_candidates=4, temperature=1.0, use_cache=use_cache)
    np.testing.assert_array_equal(gen.sem_ids.numpy(), golden["gen_ids"])
    np.testing.assert_allclose(gen.scores.numpy(), golden["gen_scores"], atol=2e-4)
    np.testing.assert_allclose(gen.dense_vecs.numpy(), golden["gen_vecs"], atol=2e-4)


def test_item_encoding_matches_the_golden(golden, golden_model):
    with torch.no_grad():
        vecs = golden_model.encode_items(t(golden["txt"]))
    np.testing.assert_allclose(vecs.numpy(), golden["vecs"], atol=2e-4)


def test_beam_fusion_matches_the_golden(golden, golden_model):
    bf = tcobra.beam_fusion(golden_model, t(golden["ids"]), t(golden["txt"]),
                            t(golden["item_vecs"]), t(golden["item_sem"]),
                            n_candidates=3, n_beam=4, temperature=1.0, alpha=0.5)
    np.testing.assert_array_equal(bf.item_ids.numpy(), golden["bf_items"])
    np.testing.assert_allclose(bf.scores.numpy(), golden["bf_scores"], atol=2e-4)


# ---- against the JAX package --------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """JAX model and params, the port with the same weights, and a batch
    whose rows 1 and 2 are partially padded (they read the prefill tail;
    row 0 the incremental suffix), as tests/test_paged_parity.py builds it."""
    jmodel = jcobra.Cobra(**CFG)
    rng = np.random.default_rng(0)
    B, T, Ltxt = 3, 4, 5
    ids = rng.integers(0, K_CB, (B, T * C)).astype(np.int32)
    ids[1, 2 * C:] = jmodel.pad_id
    ids[2, 3 * C:] = jmodel.pad_id
    txt = rng.integers(1, 50, (B, T, Ltxt)).astype(np.int32)
    valid = np.unique(rng.integers(0, K_CB, (30, C)), axis=0)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(ids), jnp.asarray(txt))["params"]
    return jmodel, params, _port(params), ids, txt, valid


def _tries(valid):
    return JaxTensorTrie.build(valid, K_CB).device(), TensorTrie.build(valid, K_CB).to("cpu")


def test_converter_consumes_every_leaf_and_fills_every_parameter(setup):
    jmodel, params, tmodel, *_ = setup
    tree = jax.tree_util.tree_map(np.asarray, params)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert len(cobra_params_from_flax(tree, tmodel)) == n_leaves == len(tmodel.state_dict())
    extra = dict(tree, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(AssertionError, match="no port parameter"):
        cobra_params_from_flax(extra, tmodel)
    short = {k: v for k, v in tree.items() if k != "sparse_head_2"}
    with pytest.raises(AssertionError, match="no Flax leaf"):
        cobra_params_from_flax(short, tmodel)


@pytest.mark.parametrize("row", [[1, 1, 1, 1, 1, 0], [1, 1, 1, 0, 0, 0, 1, 1]])
def test_interleave_seq_mask_matches_jax(row):
    m = np.asarray([row], bool)
    for n in (None, 1):
        np.testing.assert_array_equal(
            tcobra.interleave_seq_mask(t(m), C, n).numpy(),
            np.asarray(jcobra.interleave_seq_mask(jnp.asarray(m), C, n)))


def test_training_forward_matches_jax(setup):
    jmodel, params, tmodel, ids, txt, _ = setup
    want = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(txt))
    with torch.no_grad():
        got = tmodel(t(ids), t(txt))
    for name in jcobra.CobraOutput._fields:
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_encode_items_matches_jax(setup):
    jmodel, params, tmodel, _, txt, _ = setup
    want = jmodel.apply({"params": params}, jnp.asarray(txt), method=jcobra.Cobra.encode_items)
    with torch.no_grad():
        got = tmodel.encode_items(t(txt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_decode_prefill_matches_jax_decode_hidden(setup):
    """The prefill's hidden states equal decode_hidden over the same history
    (the same forward, plus the returned K/V), on both sides."""
    jmodel, params, tmodel, ids, txt, _ = setup
    vecs = jmodel.apply({"params": params}, jnp.asarray(txt), method=jcobra.Cobra.encode_items)
    T = vecs.shape[1]
    h_j, mask_j = jmodel.apply({"params": params}, jnp.asarray(ids), vecs, T,
                               method=jcobra.Cobra.decode_hidden)
    h_jp, _, kvs_j = jmodel.apply({"params": params}, jnp.asarray(ids), vecs, T,
                                  method=jcobra.Cobra.decode_prefill)
    with torch.no_grad():
        tv = t(np.array(vecs))
        h_t, mask_t = tmodel.decode_hidden(t(ids), tv, T)
        h_tp, _, kvs_t = tmodel.decode_prefill(t(ids), tv, T)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(h_tp.numpy(), h_t.numpy())
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-5)
    np.testing.assert_allclose(h_tp.numpy(), np.asarray(h_jp), atol=1e-5)
    for (kt, vt), (kj, vj) in zip(kvs_t, kvs_j):
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-5)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5)


def _assert_same_generation(got, want, atol=1e-5):
    np.testing.assert_array_equal(got.sem_ids.numpy(), np.asarray(want.sem_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=atol)
    np.testing.assert_allclose(got.dense_vecs.numpy(), np.asarray(want.dense_vecs), atol=atol)


@pytest.mark.parametrize("constrained", [True, False], ids=["trie", "free"])
@pytest.mark.parametrize("use_cache", [True, False], ids=["cached", "uncached"])
def test_generate_matches_jax(setup, use_cache, constrained):
    jmodel, params, tmodel, ids, txt, valid = setup
    jtrie, ttrie = _tries(valid) if constrained else (None, None)
    want = jcobra.cobra_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(txt),
                                 n_candidates=4, temperature=1.0, use_cache=use_cache,
                                 trie=jtrie)
    got = tcobra.cobra_generate(tmodel, t(ids), t(txt), n_candidates=4, temperature=1.0,
                                use_cache=use_cache, trie=ttrie)
    _assert_same_generation(got, want)


def test_cached_matches_uncached(setup):
    """tests/test_decode_cache.py's pin on the port: the KV-cached search
    equals the full re-decode per step (full and partially padded rows)."""
    _, _, tmodel, ids, txt, _ = setup
    old = tcobra.cobra_generate(tmodel, t(ids), t(txt), n_candidates=4, temperature=1.0,
                                use_cache=False)
    new = tcobra.cobra_generate(tmodel, t(ids), t(txt), n_candidates=4, temperature=1.0,
                                use_cache=True)
    np.testing.assert_array_equal(old.sem_ids.numpy(), new.sem_ids.numpy())
    np.testing.assert_allclose(old.scores.numpy(), new.scores.numpy(), atol=1e-4)
    np.testing.assert_allclose(old.dense_vecs.numpy(), new.dense_vecs.numpy(), atol=1e-4)


def test_beam_fusion_matches_jax(setup):
    jmodel, params, tmodel, ids, txt, valid = setup
    rng = np.random.default_rng(3)
    item_vecs = rng.normal(size=(len(valid), CFG["d_model"])).astype(np.float32)
    want = jcobra.beam_fusion(jmodel, params, jnp.asarray(ids), jnp.asarray(txt),
                              jnp.asarray(item_vecs), jnp.asarray(valid), n_candidates=3,
                              n_beam=4, temperature=1.0, alpha=0.5)
    got = tcobra.beam_fusion(tmodel, t(ids), t(txt), t(item_vecs), t(valid), n_candidates=3,
                             n_beam=4, temperature=1.0, alpha=0.5)
    np.testing.assert_array_equal(got.item_ids.numpy(), np.asarray(want.item_ids))
    np.testing.assert_array_equal(got.sem_ids.numpy(), np.asarray(want.sem_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5)


@pytest.mark.parametrize("constrained", [True, False], ids=["trie", "free"])
def test_paged_matches_dense(setup, constrained):
    """tests/test_paged_parity.py's pin on the port: the paged path equals
    the dense cached search at 1e-5, and every constrained answer is a
    catalog tuple."""
    _, _, tmodel, ids, txt, valid = setup
    trie = TensorTrie.build(valid, K_CB).to("cpu") if constrained else None
    dense = tcobra.cobra_generate(tmodel, t(ids), t(txt), n_candidates=4, temperature=1.0,
                                  use_cache=True, trie=trie)
    paged = tcobra.cobra_generate_paged(tmodel, t(ids), t(txt), n_candidates=4,
                                        temperature=1.0, trie=trie)
    np.testing.assert_array_equal(dense.sem_ids.numpy(), paged.sem_ids.numpy())
    np.testing.assert_allclose(dense.scores.numpy(), paged.scores.numpy(), atol=1e-5)
    np.testing.assert_allclose(dense.dense_vecs.numpy(), paged.dense_vecs.numpy(), atol=1e-5)
    if constrained:
        catalog = {tuple(r) for r in valid.tolist()}
        assert all(tuple(s) in catalog for s in paged.sem_ids.reshape(-1, C).tolist())


@pytest.mark.parametrize("kv_dtype,atol", [("float32", 1e-5), ("int8", 2e-3)])
@pytest.mark.parametrize("page_size", [8, 5])
def test_generate_paged_matches_jax(setup, kv_dtype, atol, page_size):
    """Port cobra_generate_paged against JAX's of the same page type, over
    full and partially padded rows; page size 5 splits items across pages."""
    jmodel, params, tmodel, ids, txt, valid = setup
    jtrie, ttrie = _tries(valid)
    want = jcobra.cobra_generate_paged(jmodel, params, jnp.asarray(ids), jnp.asarray(txt),
                                       n_candidates=4, temperature=1.0, trie=jtrie,
                                       page_size=page_size, kv_dtype=kv_dtype)
    got = tcobra.cobra_generate_paged(tmodel, t(ids), t(txt), n_candidates=4, temperature=1.0,
                                      trie=ttrie, page_size=page_size, kv_dtype=kv_dtype)
    _assert_same_generation(got, want, atol)


def test_paged_decode_steps_at_mixed_codebooks_match_lockstep(setup):
    """One decode call over rows at DIFFERENT codebooks (as the engine's
    slots are) equals each row's own lockstep step: rows 0 and 2 advance
    codebook 2 while row 1, admitted one step later, advances codebook 1."""
    _, _, tmodel, ids, txt, valid = setup
    trie = TensorTrie.build(valid, K_CB).to("cpu")
    B, T = ids.shape[0], txt.shape[1]
    page = 8
    Pm = -(-T * (C + 1) // page)
    bt = (1 + torch.arange(B * Pm)).reshape(B, Pm).to(torch.int32)
    shape = (1 + B * Pm, page, CFG["decoder_num_heads"], tmodel.head_dim)
    pools = lambda: tuple(torch.zeros(shape) for _ in range(CFG["decoder_n_layers"]))  # noqa: E731
    with torch.no_grad():
        vecs = tmodel.encode_items(t(txt))
    kp, vp, init = tcobra.cobra_prefill_paged(tmodel, t(ids), vecs, bt, pools(), pools(), trie, 4)
    state = tcobra.init_cobra_paged_state(tmodel, B, 4)
    state.update(init)
    step = lambda s, steps: tcobra.cobra_paged_decode_step(  # noqa: E731
        tmodel, trie, s, torch.as_tensor(steps), bt, init["base_pos"], kp, vp)
    one = step(state, [1, 1, 1])
    two = step(one, [2, 2, 2])
    mixed_in = {k: torch.where(torch.as_tensor([True, False, True]).reshape(
        -1, *[1] * (v.dim() - 1)), one[k], state[k]) for k, v in state.items()}
    mixed = step(mixed_in, [2, 1, 2])
    for key in ("beam_tokens", "beam_scores", "prefix_idx", "h_last", "cache_k"):
        torch.testing.assert_close(mixed[key][[0, 2]], two[key][[0, 2]], rtol=0, atol=1e-6)
        torch.testing.assert_close(mixed[key][1], one[key][1], rtol=0, atol=1e-6)


def test_merge_attention_stats_matches_jax():
    rng = np.random.default_rng(4)
    S, K, H, hd = 3, 4, 2, 8
    parts = [rng.normal(size=(S, K, H, hd)).astype(np.float32),
             rng.normal(size=(S, K, H)).astype(np.float32) * 10,
             rng.uniform(0.5, 4.0, size=(S, K, H)).astype(np.float32),
             rng.normal(size=(S, K, H, hd)).astype(np.float32),
             rng.normal(size=(S, K, H)).astype(np.float32) * 10,
             rng.uniform(0.5, 4.0, size=(S, K, H)).astype(np.float32)]
    parts[1][0] = -1e9  # a fully masked history partial
    want = np.asarray(jax_merge(*map(jnp.asarray, parts)))
    np.testing.assert_allclose(merge_attention_stats(*map(t, parts)).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_init_decode_caches_match_jax():
    want = jax_init_decode_caches(2, 3, 4, 2, 2, 16)
    got = init_decode_caches(2, 3, 4, 2, 2, 16, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("k", "v"):
            assert tuple(g[name].shape) == w[name].shape and not g[name].any()


@pytest.mark.parametrize("step", [0, 1, 2])
def test_trie_legal_mask_and_advance_match_jax(step):
    rng = np.random.default_rng(step)
    valid = np.unique(rng.integers(0, K_CB, (40, C)), axis=0)
    jtrie, ttrie = _tries(valid)
    prefix = rng.integers(0, 12, (3, 5))
    prefix[0, 0] = ttrie.capacity  # the dead-prefix sentinel
    tok = rng.integers(0, K_CB, (3, 5))
    np.testing.assert_array_equal(ttrie.legal_mask(t(prefix), step).numpy(),
                                  np.asarray(jtrie.legal_mask(jnp.asarray(prefix), step)))
    np.testing.assert_array_equal(
        ttrie.advance(t(prefix), t(tok), step).numpy(),
        np.asarray(jtrie.advance(jnp.asarray(prefix), jnp.asarray(tok), step)))
