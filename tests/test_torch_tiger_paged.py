"""TIGER's paged decode path, port against the JAX package.

genrec_tpu_torch/models/tiger.py pairs with genrec_tpu/models/tiger.py
(and t5transformer, layers, embeddings, ops/buckets, catalog/tensor_trie
with their pairs). Inputs are made from a seed with numpy and handed to
both sides; the port's weights are the JAX init carried across by
genrec_tpu_torch.convert. Tolerances: 1e-5 on float outputs (fp32 on
both sides; only the summation order differs), exact on sem-ids — the
bar tests/test_paged_parity.py holds paged against dense decode to.

Log-probs are the exception to the flat 1e-5: they are sums over D steps
of log_softmax(logits / T), so a logit difference d shows up as about
D * d / T. The logits of the two packages agree to ~1e-6 (XLA's and
PyTorch's CPU matrix products sum in different orders), which puts the
log-probs ~3e-6 apart at T = 1 and ~1.5e-5 apart at the serving
temperature T = 0.2. The tolerance is therefore 1e-5 / T: the 1e-5 bar
at T = 1, scaled by the 1 / T that the softmax temperature applies.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.catalog.tensor_trie import TensorTrie as JaxTensorTrie
from genrec_tpu.models import tiger as jtiger
from genrec_tpu.models.t5transformer import T5Attention as JaxT5Attention
from genrec_tpu.ops.buckets import t5_relative_position_bucket as jax_buckets
from genrec_tpu_torch.catalog.tensor_trie import TensorTrie
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.models import tiger as ttiger
from genrec_tpu_torch.models.t5transformer import T5Attention
from genrec_tpu_torch.ops.buckets import t5_relative_position_bucket

torch.set_num_threads(1)

K_CB, D, N_USERS = 32, 3, 50
CFG = dict(embedding_dim=32, attn_dim=64, num_heads=4, n_layers=4,
           num_item_embeddings=K_CB, num_user_embeddings=N_USERS,
           sem_id_dim=D, max_pos=64)


def _batch(rng, lengths, L):
    """Contiguous valid prefixes of mixed lengths (the serving layout)."""
    B = len(lengths)
    mask = np.zeros((B, L * D), np.int64)
    for i, n in enumerate(lengths):
        mask[i, : n * D] = 1
    return dict(
        user=rng.integers(0, N_USERS, (B,)),
        items=rng.integers(0, K_CB, (B, L * D)) * mask,
        types=np.tile(np.arange(D), (B, L)),
        mask=mask,
    )


def _jax(b):
    return [jnp.asarray(b[k], jnp.int32) for k in ("user", "items", "types", "mask")]


def _torch(b):
    return [torch.as_tensor(b[k], dtype=torch.int64) for k in ("user", "items", "types", "mask")]


@pytest.fixture(scope="module")
def models():
    jmodel = jtiger.Tiger(dropout=0.0, **CFG)
    rng = np.random.default_rng(0)
    b = _batch(rng, (4, 2), 4)
    params = jax.jit(jmodel.init)(
        jax.random.key(0), *_jax(b)[:3], jnp.zeros((2, D), jnp.int32),
        jnp.zeros((2, D), jnp.int32), jnp.asarray(b["mask"], jnp.int32),
    )["params"]
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tmodel = ttiger.Tiger(device="cpu", **CFG)
    tmodel.load_state_dict(tiger_params_from_flax(params_np, tmodel))
    tmodel.eval()
    return jmodel, params, tmodel


def test_converter_consumes_every_leaf_and_fills_every_parameter(models):
    jmodel, params, tmodel = models
    params_np = jax.tree_util.tree_map(np.asarray, params)
    sd = tiger_params_from_flax(params_np, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    # Dense kernels are transposed into nn.Linear's (out, in).
    np.testing.assert_array_equal(
        sd["output_head.weight"].numpy(), params_np["output_head"]["kernel"].T
    )
    with pytest.raises(AssertionError, match="no port parameter"):
        extra = dict(params_np, stray={"kernel": np.zeros((2, 2), np.float32)})
        tiger_params_from_flax(extra, tmodel)


def test_encode_for_decode_cross_kv_matches_jax(models):
    jmodel, params, tmodel = models
    b = _batch(np.random.default_rng(1), (5, 1, 3), 5)
    jkv, jpad = jax.jit(functools.partial(
        jmodel.apply, method=jtiger.Tiger.encode_for_decode))({"params": params}, *_jax(b))
    with torch.no_grad():
        tkv, tpad = tmodel.encode_for_decode(*_torch(b))
    np.testing.assert_array_equal(np.asarray(jpad), tpad.numpy())
    assert len(jkv) == len(tkv) == CFG["n_layers"] // 2
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


@functools.cache
def _jax_generate(jmodel, beams):
    return jax.jit(functools.partial(
        jtiger.tiger_generate_paged, jmodel, n_top_k_candidates=beams,
        deterministic=True,
    ))


@pytest.mark.parametrize("temperature", [1.0, 0.2])
@pytest.mark.parametrize("n_items,beams", [(40, 5), (6, 10)])
def test_generate_paged_matches_jax(models, n_items, beams, temperature):
    """Deterministic beam search through the paged path. (6, 10) is the
    tie case: six catalog items, ten beams, so at every step illegal
    candidates tie at -1e32 and only the lower-index-first rule of
    jax.lax.top_k / jnp.lexsort decides which survive."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(2)
    valid = np.unique(rng.integers(0, K_CB, (n_items, D)), axis=0)
    b = _batch(rng, (6, 2, 4), 6)
    jout = _jax_generate(jmodel, beams)(
        params, JaxTensorTrie.build(valid, K_CB).device(), *_jax(b),
        jax.random.key(0), temperature=temperature,
    )
    tout = ttiger.tiger_generate_paged(
        tmodel, TensorTrie.build(valid, K_CB).to("cpu"), *_torch(b),
        n_top_k_candidates=beams, temperature=temperature,
    )
    np.testing.assert_array_equal(tout.sem_ids.numpy(), np.asarray(jout.sem_ids))
    np.testing.assert_allclose(tout.log_probas.numpy(), np.asarray(jout.log_probas),
                               atol=1e-5 / temperature)
    # Beams that found a legal item carry real catalog tuples.
    legal = tout.log_probas.numpy() > -1e30
    rows = {tuple(r) for r in valid}
    assert all(tuple(s) in rows for s in tout.sem_ids.numpy()[legal])
    if n_items < beams:
        assert (~legal).any()  # the tie case really had dead beams


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_top_k_tie_breaking_matches_jax(seed):
    """Scores with many exact ties (illegal candidates at -1e32, repeated
    keys): same kept instances, same order, same indices as JAX."""
    rng = np.random.default_rng(seed)
    S, M, k = 4, 30, 8
    scores = rng.choice([-1e32, -3.0, -2.5, -1.0], size=(S, M)).astype(np.float32)
    keys = rng.integers(0, 6, (S, M))
    j_scores, j_idx = jax.vmap(lambda s, c: jtiger._dedup_top_k(s, c, k))(
        jnp.asarray(scores), jnp.asarray(keys, jnp.int32))
    t_scores, t_idx = ttiger._dedup_top_k(torch.as_tensor(scores),
                                          torch.as_tensor(keys), k)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_scores.numpy(), np.asarray(j_scores))


def test_top_k_breaks_ties_like_lax_top_k():
    x = np.asarray([[1.0, 3.0, 3.0, -1e32, 3.0, -1e32, 0.5]], np.float32)
    j_val, j_idx = jax.lax.top_k(jnp.asarray(x), 5)
    t_val, t_idx = ttiger._top_k(torch.as_tensor(x), 5)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_val.numpy(), np.asarray(j_val))


def test_t5_relative_position_bucket_matches_jax():
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 64)[:, None]
    for bidirectional in (True, False):
        want = np.asarray(jax_buckets(jnp.asarray(rel, jnp.int32), 32, 128, bidirectional))
        got = t5_relative_position_bucket(torch.as_tensor(rel), 32, 128, bidirectional)
        np.testing.assert_array_equal(got.numpy(), want)


def test_tensor_trie_ragged_matches_jax(rng):
    """legal_mask_ragged / advance_ragged with rows at MIXED steps, the
    configuration the engine's decode runs, including dead prefixes (the
    sentinel rank C)."""
    valid = np.unique(rng.integers(0, K_CB, (50, D)), axis=0)
    jt = JaxTensorTrie.build(valid, K_CB).device()
    tt = TensorTrie.build(valid, K_CB).to("cpu")
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    np.testing.assert_array_equal(tt.offsets.numpy(), np.asarray(jt.offsets))
    S, K = 6, 4
    steps = np.asarray([0, 1, 2, 2, 1, 0])
    prefix = rng.integers(0, 20, (S, K))
    prefix[0, 0] = tt.capacity  # a dead beam
    tok = rng.integers(0, K_CB, (S, K))
    j_mask = jt.legal_mask_ragged(jnp.asarray(prefix, jnp.int32), jnp.asarray(steps, jnp.int32))
    j_adv = jt.advance_ragged(jnp.asarray(prefix, jnp.int32), jnp.asarray(tok, jnp.int32),
                              jnp.asarray(steps, jnp.int32))
    t_mask = tt.legal_mask_ragged(torch.as_tensor(prefix), torch.as_tensor(steps))
    t_adv = tt.advance_ragged(torch.as_tensor(prefix), torch.as_tensor(tok),
                              torch.as_tensor(steps))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(t_adv.numpy(), np.asarray(j_adv))


def test_decode_self_ragged_matches_jax(rng):
    B, K, d, H, S = 4, 3, 16, 2, 5
    jattn = JaxT5Attention(d_model=d, n_heads=H)
    x = rng.normal(size=(B, K, d)).astype(np.float32)
    params = jattn.init(jax.random.key(0), jnp.asarray(x))["params"]
    tattn = T5Attention(d, H, device="cpu")
    sd = tiger_params_from_flax(jax.tree_util.tree_map(np.asarray, params), tattn)
    tattn.load_state_dict(sd)
    cache = {n: rng.normal(size=(B, K, S, H, d // H)).astype(np.float32) for n in "kv"}
    steps = np.asarray([0, 2, 4, 1])
    j_out, j_cache = jax.jit(functools.partial(
        jattn.apply, method=JaxT5Attention.decode_self_ragged))(
        {"params": params}, jnp.asarray(x), {n: jnp.asarray(c) for n, c in cache.items()},
        jnp.asarray(steps, jnp.int32),
    )
    with torch.no_grad():
        t_out, t_cache = tattn.decode_self_ragged(
            torch.as_tensor(x), {n: torch.as_tensor(c) for n, c in cache.items()},
            torch.as_tensor(steps),
        )
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5)
    for n in "kv":
        np.testing.assert_allclose(t_cache[n].numpy(), np.asarray(j_cache[n]), atol=1e-6)


def test_paged_decode_step_at_mixed_steps_matches_jax(models):
    """One `tiger_paged_decode_step` over slots sitting at DIFFERENT
    steps (with a free slot at seq_len 0), from the same state."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(3)
    valid = np.unique(rng.integers(0, K_CB, (40, D)), axis=0)
    b = _batch(rng, (3, 1, 2), 3)
    page, Pm = 8, 2
    nl, H, hd = CFG["n_layers"] // 2, CFG["num_heads"], CFG["attn_dim"] // CFG["num_heads"]
    bt = np.asarray([[1, 2], [3, 0], [4, 0]], np.int32)
    shape = (5, page, H, hd)
    jk, jv, j_len, _ = jax.jit(functools.partial(jtiger.tiger_prefill_paged, jmodel))(
        params, *_jax(b), jnp.asarray(bt),
        tuple(jnp.zeros(shape) for _ in range(nl)), tuple(jnp.zeros(shape) for _ in range(nl)),
    )
    tk = tuple(torch.zeros(shape) for _ in range(nl))
    tv = tuple(torch.zeros(shape) for _ in range(nl))
    _, _, t_len, _ = ttiger.tiger_prefill_paged(tmodel, *_torch(b), torch.as_tensor(bt), tk, tv)
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    for a, c in zip(tk + tv, tuple(jk) + tuple(jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5)
    # A mid-decode state: random beams/prefixes/caches, steps 0..2, and
    # the third slot freed (seq_len 0: the fully masked row).
    beams = 4
    state = {
        "beam_seqs": rng.integers(0, K_CB, (3, beams, D)),
        "beam_logps": rng.normal(size=(3, beams)).astype(np.float32),
        "prefix_idx": rng.integers(0, 10, (3, beams)),
        "cache_k": rng.normal(size=(3, nl, beams, D, H, hd)).astype(np.float32),
        "cache_v": rng.normal(size=(3, nl, beams, D, H, hd)).astype(np.float32),
    }
    steps = np.asarray([2, 1, 0])
    seq_lens = np.asarray(j_len).copy()
    seq_lens[2] = 0
    j_state = jax.jit(functools.partial(jtiger.tiger_paged_decode_step, jmodel))(
        params, JaxTensorTrie.build(valid, K_CB).device(),
        {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
         for k, v in state.items()},
        jnp.asarray(steps, jnp.int32), jnp.asarray(bt), jnp.asarray(seq_lens), jk, jv,
    )
    t_state = ttiger.tiger_paged_decode_step(
        tmodel, TensorTrie.build(valid, K_CB).to("cpu"),
        {k: torch.as_tensor(v) for k, v in state.items()},
        torch.as_tensor(steps), torch.as_tensor(bt), torch.as_tensor(seq_lens), tk, tv,
    )
    for key in ("beam_seqs", "prefix_idx"):
        np.testing.assert_array_equal(t_state[key].numpy(), np.asarray(j_state[key]))
    for key in ("beam_logps", "cache_k", "cache_v"):
        np.testing.assert_allclose(t_state[key].numpy(), np.asarray(j_state[key]), atol=1e-5)
