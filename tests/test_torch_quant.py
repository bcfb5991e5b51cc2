"""int8 TIGER paged serving, port against the JAX package.

genrec_tpu_torch/ops/quant.py, the int8 branches of ops/paged.py,
serving/kv_pool.py, models/tiger.py ``tiger_generate_paged(kv_dtype=)``
and serving/engine.py's ``kv_dtype`` pair with the same paths under
genrec_tpu/. Inputs are made from a seed with numpy and handed to both
sides. Tolerances: quantised data and scales bit-equal (the port repeats
JAX's arithmetic: a max, a clamp, a division, round half to even);
attention statistics 1e-5 (fp32 both sides, only the summation order
differs); sem-ids exact.

Log-probs end to end: 2e-3 / T, not the fp32 path's 1e-5 / T
(tests/test_torch_tiger_paged.py says why log-probs scale with 1 / T).
The two packages' cross-attention K/V agree to ~1e-6 (their matrix
products sum in different orders), and quantisation turns that into an
integer: an element whose x / scale lies within ~1e-4 of a rounding edge
lands one int8 step apart, moving it by its row's scale (amax / 127,
~1e-2 here). ``test_prefill_int8_pools_match_jax`` holds those flips to
one step on under 0.1% of the elements; each moves the beams' log-probs
by up to ~1e-3 at T = 0.2 (measured: 6.2e-4 offline, 7.2e-3 for the
engine's batch-of-two prefills, at T = 0.2), while the fp32 path stays
at ~1e-5.

The port's int8 path is held to JAX's int8 output, never to fp32: the
reference's own int8-vs-fp32 pin (tests/test_quantized.py::
test_tiger_paged_int8_matches_fp32) does not hold on the reference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.catalog.tensor_trie import TensorTrie as JaxTensorTrie
from genrec_tpu.kernels.paged_attention import paged_attention_stats_pallas_quantized
from genrec_tpu.models import tiger as jtiger
from genrec_tpu.ops import paged as jpaged
from genrec_tpu.ops import quant as jquant
from genrec_tpu.serving.kv_pool import PagedConfig as JaxPagedConfig
from genrec_tpu_torch.catalog.tensor_trie import TensorTrie
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.kernels.paged_attention import paged_attention_stats_quantized_ref
from genrec_tpu_torch.models import tiger as ttiger
from genrec_tpu_torch.ops import paged as tpaged
from genrec_tpu_torch.ops.quant import QuantizedKVPool, quantize_symmetric
from genrec_tpu_torch.serving.buckets import BucketLadder
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import TigerGenerativeHead
from genrec_tpu_torch.serving.kv_pool import KVPagePool, PagedConfig
from genrec_tpu_torch.serving.types import Request

torch.set_num_threads(1)

K_CB, D, N_USERS = 32, 3, 50
CFG = dict(embedding_dim=32, attn_dim=64, num_heads=4, n_layers=4,
           num_item_embeddings=K_CB, num_user_embeddings=N_USERS,
           sem_id_dim=D, max_pos=64)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,axes,zero_rows", [
    ((7, 8, 3, 16), (-2, -1), False),   # KV pages: one scale per (page, row)
    ((5, 4, 2, 6), (-2, -1), True),     # all-zero rows: scale 1e-12 / 127
    ((33, 20), (-1,), False),           # a table, one scale per row
    ((2, 3, 8, 4, 5), (-2, -1), True),  # write_pages' (B, Pm, page, H, hd)
])
def test_quantize_symmetric_bit_equal_to_jax(shape, axes, zero_rows):
    rng = np.random.default_rng(0)
    x = _normal(rng, *shape, scale=3.0)
    if zero_rows:
        x.reshape(-1, *shape[len(shape) - len(axes):])[::3] = 0.0
    # Values whose x / scale lands on a half: round half to even decides.
    x.reshape(-1)[:6] = [127.0, 63.5, -63.5, 0.5, 1.5, -2.5]
    jd, js = jquant.quantize_symmetric(jnp.asarray(x), axes)
    td, ts = quantize_symmetric(torch.as_tensor(x), axes)
    assert td.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if zero_rows:
        assert (ts.numpy() == np.float32(1e-12) / np.float32(127)).any()


def test_quantized_kv_pool_matches_jax():
    rng = np.random.default_rng(1)
    shape = (6, 8, 2, 4)
    j0, t0 = jquant.QuantizedKVPool.zeros(shape), QuantizedKVPool.zeros(shape)
    np.testing.assert_array_equal(t0.scale.numpy(), np.asarray(j0.scale))
    assert t0.nbytes == j0.nbytes == 6 * 8 * 2 * 4 + 6 * 8 * 4
    assert tuple(t0.shape) == tuple(j0.shape) and t0.dtype == torch.int8
    data, scale = jquant.quantize_symmetric(jnp.asarray(_normal(rng, 2, 8, 2, 4)), (-2, -1))
    pages = np.asarray([4, 1], np.int32)
    jp = j0.put_rows(jnp.asarray(pages), data, scale)
    tp = t0.put_rows(torch.as_tensor(pages), torch.as_tensor(np.asarray(data)),
                     torch.as_tensor(np.asarray(scale)))
    assert tp is t0  # in place
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))
    np.testing.assert_array_equal(tp.dequantize().numpy(), np.asarray(jp.dequantize()))
    for a, b in zip(tp.take_rows(torch.as_tensor([1, 4])), jp.take_rows(jnp.asarray([1, 4]))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _quant_pools(rng, P, page, H, hd):
    """One K and one V pool, quantised by JAX: (jax pools, port pools)."""
    out = []
    for _ in range(2):
        d, s = jquant.quantize_symmetric(jnp.asarray(_normal(rng, P, page, H, hd)), (-2, -1))
        out.append((jquant.QuantizedKVPool(d, s),
                    QuantizedKVPool(torch.as_tensor(np.asarray(d)),
                                    torch.as_tensor(np.asarray(s)))))
    return out


@pytest.mark.parametrize("K,lens,bt", [
    # a full slot, a partial last page, a seq_len-0 slot, null-page entries
    (5, [24, 3, 0, 17], [[1, 2, 3], [4, 0, 0], [5, 6, 0], [7, 8, 9]]),
    (1, [9, 1], [[2, 3, 0], [1, 0, 0]]),     # K = 1
    (10, [8, 20], [[3, 1, 0], [4, 5, 6]]),   # K = 10, the serving beams
])
def test_quantized_stats_match_pallas_and_jax_fallback(K, lens, bt):
    rng = np.random.default_rng(2)
    S, H, hd, page, P = len(lens), 2, 8, 8, 10
    q = _normal(rng, S, K, H, hd)
    (jk, tk), (jv, tv) = _quant_pools(rng, P, page, H, hd)
    jbt, jsl = jnp.asarray(bt, jnp.int32), jnp.asarray(lens, jnp.int32)
    got = paged_attention_stats_quantized_ref(
        torch.as_tensor(q), tk, tv, torch.as_tensor(np.asarray(bt, np.int32)),
        torch.as_tensor(np.asarray(lens, np.int32)))
    routed = tpaged.paged_attention_stats(
        torch.as_tensor(q), tk, tv, torch.as_tensor(np.asarray(bt, np.int32)),
        torch.as_tensor(np.asarray(lens, np.int32)))
    for want in (
        paged_attention_stats_pallas_quantized(jnp.asarray(q), jk, jv, jbt, jsl,
                                               interpret=True),
        jpaged.paged_attention_stats(jnp.asarray(q), jk, jv, jbt, jsl, use_kernel=False),
    ):
        for name, g, r, w in zip(("acc", "m", "l"), got, routed, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            np.testing.assert_array_equal(r.numpy(), g.numpy())


def test_write_and_gather_pages_int8_match_jax():
    """Prefill K of 3 rows into an int8 pool: data and scales bit-equal to
    JAX's on every page but the null page 0 (its rows may come from any of
    the padded rows in an in-place scatter); the gathered, dequantised
    rows equal JAX's on real pages."""
    rng = np.random.default_rng(3)
    P, page, H, hd, B, L, Pm = 8, 4, 2, 4, 3, 7, 2
    kv = _normal(rng, B, H, L, hd)
    bt = np.asarray([[1, 2], [3, 0], [4, 5]], np.int32)
    jp = jpaged.write_pages(jquant.QuantizedKVPool.zeros((P, page, H, hd)), jnp.asarray(bt),
                            jnp.asarray(kv))
    tp = tpaged.write_pages(QuantizedKVPool.zeros((P, page, H, hd)), torch.as_tensor(bt),
                            torch.as_tensor(kv))
    np.testing.assert_array_equal(tp.data.numpy()[1:], np.asarray(jp.data)[1:])
    np.testing.assert_array_equal(tp.scale.numpy()[1:], np.asarray(jp.scale)[1:])
    real = np.asarray([[1, 2], [4, 5]], np.int32)
    np.testing.assert_array_equal(
        tpaged.gather_pages(tp, torch.as_tensor(real)).numpy(),
        np.asarray(jpaged.gather_pages(jp, jnp.asarray(real))))


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_hbm_bytes_match_jax(kv_dtype):
    kw = dict(max_slots=4, page_size=16, pages_per_slot=3, kv_dtype=kv_dtype)
    t, j = PagedConfig(**kw), JaxPagedConfig(**kw)
    assert t.hbm_bytes(n_layers=2, n_heads=4, head_dim=8) == j.hbm_bytes(
        n_layers=2, n_heads=4, head_dim=8)
    pool = KVPagePool(t, n_layers=2, n_heads=4, head_dim=8, device="cpu")
    held = sum(p.nbytes if isinstance(p, QuantizedKVPool) else p.numel() * p.element_size()
               for p in (*pool.k_pools, *pool.v_pools))
    assert held == t.hbm_bytes(n_layers=2, n_heads=4, head_dim=8)
    assert isinstance(pool.k_pools[0], QuantizedKVPool) == (kv_dtype == "int8")


@pytest.fixture(scope="module")
def models():
    jmodel = jtiger.Tiger(dropout=0.0, **CFG)
    z = jnp.zeros((2, 4 * D), jnp.int32)
    params = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((2,), jnp.int32), z, z,
        jnp.zeros((2, D), jnp.int32), jnp.zeros((2, D), jnp.int32), z,
    )["params"]
    tmodel = ttiger.Tiger(device="cpu", **CFG)
    tmodel.load_state_dict(
        tiger_params_from_flax(jax.tree_util.tree_map(np.asarray, params), tmodel))
    return jmodel, params, tmodel.eval()


INT8_LOGP_ATOL = 2e-3  # times 1 / T; see the module docstring


@functools.cache
def _jax_generate(jmodel, beams, page_size=8):
    return jax.jit(functools.partial(
        jtiger.tiger_generate_paged, jmodel, n_top_k_candidates=beams,
        deterministic=True, kv_dtype="int8", page_size=page_size,
    ))


def _batch(rng, lengths, L):
    B = len(lengths)
    mask = np.zeros((B, L * D), np.int64)
    for i, n in enumerate(lengths):
        mask[i, : n * D] = 1
    return dict(user=rng.integers(0, N_USERS, (B,)),
                items=rng.integers(0, K_CB, (B, L * D)) * mask,
                types=np.tile(np.arange(D), (B, L)), mask=mask)


@pytest.mark.parametrize("temperature", [1.0, 0.2])
def test_generate_paged_int8_matches_jax_int8(models, temperature):
    jmodel, params, tmodel = models
    rng = np.random.default_rng(4)
    valid = np.unique(rng.integers(0, K_CB, (40, D)), axis=0)
    b = _batch(rng, (6, 2, 4), 6)
    keys = ("user", "items", "types", "mask")
    jout = _jax_generate(jmodel, 5)(
        params, JaxTensorTrie.build(valid, K_CB).device(),
        *[jnp.asarray(b[k], jnp.int32) for k in keys], jax.random.key(0),
        temperature=temperature)
    tout = ttiger.tiger_generate_paged(
        tmodel, TensorTrie.build(valid, K_CB).to("cpu"),
        *[torch.as_tensor(b[k]) for k in keys], n_top_k_candidates=5,
        temperature=temperature, kv_dtype="int8")
    np.testing.assert_array_equal(tout.sem_ids.numpy(), np.asarray(jout.sem_ids))
    np.testing.assert_allclose(tout.log_probas.numpy(), np.asarray(jout.log_probas),
                               atol=INT8_LOGP_ATOL / temperature)
    with pytest.raises(ValueError, match="kv_dtype"):
        ttiger.tiger_generate_paged(
            tmodel, TensorTrie.build(valid, K_CB).to("cpu"),
            *[torch.as_tensor(b[k]) for k in keys], kv_dtype="bf16")


def test_engine_int8_answers_equal_jax_int8(models):
    """The int8 engine (a pool of 3 slots for 7 requests, so slots are
    reused) answers every request as JAX's int8 tiger_generate_paged does
    on it alone: equal sem-ids, scores within 1e-5 / T."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(5)
    catalog = np.unique(rng.integers(0, K_CB, (12, D)), axis=0)
    head = TigerGenerativeHead(tmodel, item_sem_ids=catalog, top_k=10)
    L = 8
    eng = ServingEngine([head], device="cpu", ladder=BucketLadder((1, 2), (4, L)),
                        max_batch=2, max_wait_ms=1.0, kv_dtype="int8",
                        paged_config=PagedConfig(max_slots=3, page_size=8, pages_per_slot=4,
                                                 kv_dtype="int8")).start()
    reqs = [Request(head="tiger", history=rng.integers(0, len(catalog), int(n)),
                    user_id=int(rng.integers(0, 1000)))
            for n in rng.integers(1, L + 1, 7)]
    try:
        resps = [f.result(timeout=120) for f in [eng.submit(r) for r in reqs]]
    finally:
        eng.stop()
    assert isinstance(eng.runner("tiger").pool.k_pools[0], QuantizedKVPool)
    trie = JaxTensorTrie.build(catalog, K_CB).device()
    for req, resp in zip(reqs, resps):
        Lb = resp.bucket[1]
        h = np.asarray(req.history)[-Lb:]
        ids = np.zeros((1, Lb * D), np.int32)
        mask = np.zeros((1, Lb * D), np.int32)
        ids[0, : len(h) * D] = catalog[h].reshape(-1)
        mask[0, : len(h) * D] = 1
        out = _jax_generate(jmodel, 10)(
            params, trie, jnp.asarray([req.user_id % N_USERS], jnp.int32), jnp.asarray(ids),
            jnp.asarray(np.tile(np.arange(D, dtype=np.int32), (1, Lb))), jnp.asarray(mask),
            jax.random.key(0), temperature=0.2)
        np.testing.assert_array_equal(resp.sem_ids, np.asarray(out.sem_ids)[0])
        np.testing.assert_allclose(resp.scores, np.asarray(out.log_probas)[0],
                                   atol=INT8_LOGP_ATOL / 0.2)


def test_prefill_int8_pools_match_jax(models):
    """The int8 pools one prefill writes: scales within 1e-5 relative, and
    the int8 data equal to JAX's but for rounding-edge flips of one step
    on under 0.1% of the elements (module docstring)."""
    jmodel, params, tmodel = models
    b = _batch(np.random.default_rng(6), (6, 2, 4), 6)
    keys = ("user", "items", "types", "mask")
    nl, H, hd, page = CFG["n_layers"] // 2, CFG["num_heads"], 16, 8
    bt = (1 + np.arange(3 * 3)).reshape(3, 3).astype(np.int32)
    shape = (1 + bt.size, page, H, hd)
    jk, jv, jsl, _ = jax.jit(functools.partial(jtiger.tiger_prefill_paged, jmodel))(
        params, *[jnp.asarray(b[k], jnp.int32) for k in keys], jnp.asarray(bt),
        tuple(jquant.QuantizedKVPool.zeros(shape) for _ in range(nl)),
        tuple(jquant.QuantizedKVPool.zeros(shape) for _ in range(nl)))
    tk, tv, tsl, _ = ttiger.tiger_prefill_paged(
        tmodel, *[torch.as_tensor(b[k]) for k in keys], torch.as_tensor(bt),
        tuple(QuantizedKVPool.zeros(shape) for _ in range(nl)),
        tuple(QuantizedKVPool.zeros(shape) for _ in range(nl)))
    np.testing.assert_array_equal(tsl.numpy(), np.asarray(jsl))
    flips = total = 0
    for t, j in zip((*tk, *tv), (*jk, *jv)):
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale), rtol=1e-5)
        diff = np.abs(t.data.numpy().astype(np.int32) - np.asarray(j.data).astype(np.int32))
        assert diff.max() <= 1
        flips += int((diff > 0).sum())
        total += diff.size
    assert flips <= 1e-3 * total, (flips, total)


def test_engine_kv_dtype_conflict_refused(models):
    head = TigerGenerativeHead(models[2], item_sem_ids=np.asarray([[0, 1, 2]]), top_k=2)
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine([head], device="cpu", kv_dtype="int8",
                      paged_config=PagedConfig(max_slots=2, page_size=8, pages_per_slot=2))
    eng = ServingEngine([head], device="cpu", kv_dtype="int8")
    assert eng._default_paged_config(head).kv_dtype == "int8"
