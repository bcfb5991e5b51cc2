"""TIGER's dense trie-constrained decode and the tries, port against the
JAX package.

genrec_tpu_torch/models/tiger.py (``tiger_generate``) and ops/trie.py
(``DenseTrie``, ``PackedTrie``, ``build_trie``, ``tuples_are_valid``, the
per-row-step helpers) pair with their JAX twins. Weights are the JAX init
carried across by genrec_tpu_torch.convert; inputs are made from a seed
with numpy. Tolerances: tries exact; deterministic decode sem-ids equal
and log-probs within 1e-4 (tests/test_decode_cache.py's bar between the
cached and uncached JAX decodes); dense against the paged decode 1e-5
(tests/test_paged_parity.py's). Sampled decode draws its Gumbel noise
from a torch.Generator, which JAX's keys cannot reproduce, so it is held
to its contract instead: every tuple a catalog item, beams unique, the
cached and uncached decodes equal under the same generator, and the
draw distributed as multinomial sampling without replacement.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.models import tiger as jtiger
from genrec_tpu.ops import trie as jtrie
from genrec_tpu_torch.catalog.tensor_trie import TensorTrie
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.models import tiger as ttiger
from genrec_tpu_torch.ops import trie as ttrie

torch.set_num_threads(1)

K_CB, D, N_USERS = 8, 3, 20
CFG = dict(embedding_dim=16, attn_dim=32, num_heads=4, n_layers=4,
           num_item_embeddings=K_CB, num_user_embeddings=N_USERS, sem_id_dim=D, max_pos=64)
TRIES = {"dense": (jtrie.DenseTrie, ttrie.DenseTrie),
         "packed": (jtrie.PackedTrie, ttrie.PackedTrie)}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    valid = np.unique(rng.integers(0, K_CB, (30, D)), axis=0)
    B, L = 3, 12
    b = dict(
        user=rng.integers(0, N_USERS, (B,)),
        items=rng.integers(0, K_CB, (B, L)),
        types=np.tile(np.arange(D), (B, L // D)),
        # Contiguous valid prefixes of mixed lengths: the paged decode's
        # layout, and padding the cross-attention mask must honour.
        mask=(np.arange(L)[None, :] < np.asarray([[12], [7], [3]])).astype(np.int64),
    )
    jmodel = jtiger.Tiger(dropout=0.0, **CFG)
    params = jmodel.init(
        jax.random.key(0), *(jnp.asarray(b[k], jnp.int32) for k in ("user", "items", "types")),
        jnp.zeros((B, D), jnp.int32), jnp.zeros((B, D), jnp.int32),
        jnp.asarray(b["mask"], jnp.int32),
    )["params"]
    tmodel = ttiger.Tiger(device="cpu", **CFG)
    tmodel.load_state_dict(tiger_params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                  tmodel))
    return jmodel, params, tmodel.eval(), valid, b


def _jb(b):
    return [jnp.asarray(b[k], jnp.int32) for k in ("user", "items", "types", "mask")]


def _tb(b):
    return [torch.as_tensor(b[k]) for k in ("user", "items", "types", "mask")]


@pytest.mark.parametrize("kind", sorted(TRIES))
def test_tries_match_jax(kind):
    """legal_mask / advance at every depth, the ragged helpers at mixed
    depths, and tuples_are_valid, on live, dead and foreign prefixes."""
    rng = np.random.default_rng(1)
    valid = np.unique(rng.integers(0, K_CB, (40, D)), axis=0)
    jcls, tcls = TRIES[kind]
    jt, tt = jcls.build(valid, K_CB), tcls.build(valid, K_CB, device="cpu")
    prefix = np.zeros((6, 4), np.int64)
    tok = rng.integers(0, K_CB, (6, 4))
    for t in range(D):
        np.testing.assert_array_equal(
            tt.legal_mask(torch.as_tensor(prefix), t).numpy(),
            np.asarray(jt.legal_mask(jnp.asarray(prefix, jnp.int32), t)))
        nxt = tt.advance(torch.as_tensor(prefix), torch.as_tensor(tok), t).numpy()
        np.testing.assert_array_equal(
            nxt, np.asarray(jt.advance(jnp.asarray(prefix, jnp.int32),
                                       jnp.asarray(tok, jnp.int32), t)))
        prefix = nxt
        tok = rng.integers(0, K_CB, (6, 4))
    steps = np.asarray([0, 1, 2, 2, 1, 0])
    ragged_prefix = rng.integers(0, 12, (6, 4))
    np.testing.assert_array_equal(
        ttrie.legal_mask_ragged(tt, torch.as_tensor(ragged_prefix),
                                torch.as_tensor(steps)).numpy(),
        np.asarray(jtrie.legal_mask_ragged(jt, jnp.asarray(ragged_prefix, jnp.int32),
                                           jnp.asarray(steps, jnp.int32))))
    np.testing.assert_array_equal(
        ttrie.advance_ragged(tt, torch.as_tensor(ragged_prefix), torch.as_tensor(tok),
                             torch.as_tensor(steps)).numpy(),
        np.asarray(jtrie.advance_ragged(jt, jnp.asarray(ragged_prefix, jnp.int32),
                                        jnp.asarray(tok, jnp.int32),
                                        jnp.asarray(steps, jnp.int32))))
    seqs = np.concatenate([valid[:10], rng.integers(0, K_CB, (30, D))])
    got = ttrie.tuples_are_valid(tt, torch.as_tensor(seqs)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jtrie.tuples_are_valid(jt, jnp.asarray(seqs, jnp.int32))))
    assert got[:10].all() and not got.all()


def test_build_trie_picks_dense_under_the_bit_budget():
    valid = np.asarray([[1, 2, 3], [4, 5, 6]])
    assert isinstance(ttrie.build_trie(valid, 8, device="cpu"), ttrie.DenseTrie)
    assert isinstance(ttrie.build_trie(valid, 8, dense_max_bits=100, device="cpu"),
                      ttrie.PackedTrie)
    assert isinstance(jtrie.build_trie(valid, 8, dense_max_bits=100), jtrie.PackedTrie)


@functools.cache
def _jax_generate(jmodel, use_cache):
    return jax.jit(functools.partial(jtiger.tiger_generate, jmodel, n_top_k_candidates=5,
                                     deterministic=True, use_cache=use_cache),
                   static_argnums=(1,))


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("kind", sorted(TRIES))
def test_deterministic_generate_matches_jax(setup, kind, use_cache):
    jmodel, params, tmodel, valid, b = setup
    jcls, tcls = TRIES[kind]
    jout = _jax_generate(jmodel, use_cache)(params, jcls.build(valid, K_CB), *_jb(b),
                                             jax.random.key(0))
    tout = ttiger.tiger_generate(tmodel, tcls.build(valid, K_CB, device="cpu"), *_tb(b),
                                 n_top_k_candidates=5, deterministic=True,
                                 use_cache=use_cache)
    np.testing.assert_array_equal(tout.sem_ids.numpy(), np.asarray(jout.sem_ids))
    np.testing.assert_allclose(tout.log_probas.numpy(), np.asarray(jout.log_probas),
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["dense", "packed", "tensor"])
def test_dense_matches_paged_decode(setup, kind):
    """Deterministic dense decode against the serving engine's paged
    decode on the same trie, as tests/test_paged_parity.py holds the JAX
    pair."""
    _, _, tmodel, valid, b = setup
    trie = (TensorTrie.build(valid, K_CB).to("cpu") if kind == "tensor"
            else TRIES[kind][1].build(valid, K_CB, device="cpu"))
    dense = ttiger.tiger_generate(tmodel, trie, *_tb(b), n_top_k_candidates=5,
                                  deterministic=True)
    paged = ttiger.tiger_generate_paged(tmodel, trie, *_tb(b), n_top_k_candidates=5)
    np.testing.assert_array_equal(dense.sem_ids.numpy(), paged.sem_ids.numpy())
    np.testing.assert_allclose(dense.log_probas.numpy(), paged.log_probas.numpy(),
                               atol=1e-5)
    assert bool(ttrie.tuples_are_valid(trie, paged.sem_ids).all())


@pytest.mark.parametrize("kind", sorted(TRIES))
def test_sampled_generate_is_valid_unique_and_cache_independent(setup, kind):
    _, _, tmodel, _, b = setup
    # A dense catalog (most prefixes have more legal children than a beam
    # draws) and KK = 3 of the 8 codes a beam, so the draw decides.
    valid = np.unique(np.random.default_rng(5).integers(0, K_CB, (400, D)), axis=0)
    trie = TRIES[kind][1].build(valid, K_CB, device="cpu")

    def run(use_cache, seed=7):
        return ttiger.tiger_generate(tmodel, trie, *_tb(b), torch.Generator().manual_seed(seed),
                                     temperature=1.0, n_top_k_candidates=3, sample_factor=1,
                                     use_cache=use_cache)

    cached, uncached = run(True), run(False)
    np.testing.assert_array_equal(cached.sem_ids.numpy(), uncached.sem_ids.numpy())
    np.testing.assert_allclose(cached.log_probas.numpy(), uncached.log_probas.numpy(),
                               atol=1e-4)
    assert bool(ttrie.tuples_are_valid(trie, cached.sem_ids).all())
    for row in cached.sem_ids.numpy():
        assert len({tuple(r) for r in row}) == len(row)
    draws = {tuple(run(True, seed).sem_ids.numpy().ravel()) for seed in range(8)}
    assert len(draws) > 1  # the noise really moves the beams
    with pytest.raises(ValueError, match="torch.Generator"):
        ttiger.tiger_generate(tmodel, trie, *_tb(b))


def test_gumbel_top_k_draws_as_multinomial_without_replacement():
    """The ordered pair of the first two candidates of Gumbel-top-k over
    softmax(logp) has P(i, j) = p_i p_j / (1 - p_i), the law of
    ``torch.multinomial(p, 2, replacement=False)``: the empirical
    frequencies of 200,000 draws sit within 5 standard errors of it, and
    of torch.multinomial's own."""
    p = np.asarray([0.4, 0.25, 0.2, 0.1, 0.05])
    n = 200_000
    logp = torch.log(torch.as_tensor(p, dtype=torch.float32)).expand(n, len(p))
    tok = ttiger._draw_candidates(logp, 2, torch.Generator().manual_seed(0)).numpy()
    exact = p[:, None] * p[None, :] / (1 - p[:, None])
    np.fill_diagonal(exact, 0.0)
    got = np.zeros_like(exact)
    np.add.at(got, (tok[:, 0], tok[:, 1]), 1.0 / n)
    mult = torch.multinomial(torch.as_tensor(p).expand(n, len(p)), 2, replacement=False,
                             generator=torch.Generator().manual_seed(1)).numpy()
    ref = np.zeros_like(exact)
    np.add.at(ref, (mult[:, 0], mult[:, 1]), 1.0 / n)
    se = np.sqrt(exact * (1 - exact) / n) + 1e-12
    assert np.all(np.abs(got - exact) <= 5 * se + 1e-9), np.abs(got - exact) / se
    assert np.all(np.abs(got - ref) <= 5 * np.sqrt(2) * se + 1e-9)
    assert np.all(got[np.eye(len(p), dtype=bool)] == 0)  # never the same category twice


def test_bf16_model_decodes_dense_but_not_paged(setup):
    """A bf16 TIGER (the trainers' amp) decodes through tiger_generate and,
    now that B1 reads bf16 pages, through tiger_generate_paged as well
    (the name predates that): bf16 and int8 pages give catalog tuples with
    finite, descending scores. tests/test_torch_bf16_serving.py holds the
    bf16 paged decode to JAX's."""
    _, _, tmodel, valid, b = setup
    bf16 = ttiger.Tiger(device="cpu", dtype=torch.bfloat16, **CFG).eval()
    bf16.load_state_dict(tmodel.state_dict())
    trie = ttrie.DenseTrie.build(valid, K_CB, device="cpu")
    out = ttiger.tiger_generate(bf16, trie, *_tb(b), n_top_k_candidates=5, deterministic=True)
    assert bool(ttrie.tuples_are_valid(trie, out.sem_ids).all())
    for kv_dtype in ("float32", "int8"):
        paged = ttiger.tiger_generate_paged(bf16, TensorTrie.build(valid, K_CB).to("cpu"),
                                            *_tb(b), n_top_k_candidates=5, kv_dtype=kv_dtype)
        assert bool(ttrie.tuples_are_valid(trie, paged.sem_ids).all())
        scores = paged.log_probas
        assert scores.dtype == torch.float32 and bool(torch.isfinite(scores).all())
        assert bool((scores[:, 1:] <= scores[:, :-1]).all())
