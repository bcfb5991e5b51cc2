"""bf16 serving of TIGER and COBRA, port against the JAX package.

genrec_tpu_torch/kernels/paged_attention.py's plain versions pair with
genrec_tpu/kernels/paged_attention.py's Pallas kernels, and the bf16
paged paths of models/tiger.py, models/cobra.py, serving/heads.py,
serving/kv_pool.py and serving/engine.py with their JAX twins. A bf16
model serves pages of its own dtype and bf16 queries, or int8 pages under
bf16 queries, as the JAX engine does. Inputs are made from a seed with
numpy; the port's weights are the JAX init carried across by
genrec_tpu_torch.convert (Flax keeps parameters in fp32 and casts them
where they are used, so one converted state dict fills a bf16 model).

Tolerances and why:

- The plain versions on bf16 inputs against the Pallas kernels in
  interpret mode: 1e-5 on acc, m and l. Both convert q, K and V exactly
  to fp32 after the load and then run fp32 arithmetic; only the summation
  order differs.
- The same plain versions against JAX's CPU fallback ``_stats_fallback``:
  the fallback takes the score einsum in bf16, rounding each unscaled
  score to bf16 (half an ulp: at most 2^-9 of the power of two above it,
  so at most 2^-8 of the score) before it scales it by hd^-0.5. m is held
  within 2^-8 of max |m| and l and acc within exp(2^-7 max |m|) - 1 of
  their scale; the gap is real (more than 1e-3 in m here).
- bf16 ``tiger_generate_paged`` / ``cobra_generate_paged`` against JAX's:
  sem-ids equal outside near ties, scores within 2e-2 at T = 1, with JAX
  jitted as its CPU tests jit it, its Pallas kernels reached through
  ``kernels.policy.auto_paged_attention`` (the contract the port follows)
  and the computation compiled with ``xla_allow_excess_precision`` off.
  XLA otherwise keeps bf16 values of a fusion in fp32 between ops, where
  PyTorch rounds after each op, and many of the prefill's bf16 K/V
  elements land a rounding step apart between the packages; with it off
  nearly all are bit-equal (the rest one bf16 step apart, from summation
  order), which ``test_bf16_prefill_pages_match_jax_bit_for_bit_without_
  excess_precision`` holds. The flag changes no semantics, only where
  bf16 rounds. Scores are sums of 3 log-softmaxes, so logits one bf16
  step apart move them by up to ~1e-2 at T = 1 (the bf16 forward is held
  at 1e-2 of max |JAX| in tests/test_torch_tiger.py); int8 pages add K/V
  elements one bf16 step apart that land one int8 step apart. At T = 0.2
  the same logits move the scores 5x as far, which is no test of the
  paged path, so the JAX comparisons run at T = 1.
- The port's engine against the port's offline generate, plain and
  speculative: exact. bf16 GEMMs round per element after an fp32 sum
  whose order may depend on the number of rows, so a request decoded in a
  batch of another shape can land one bf16 step apart; the engine is
  therefore served in waves of ``max_slots`` requests that prefill as one
  group and decode in lockstep, and each wave is held to the offline
  generate of the same group, whose shapes are the engine's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.catalog.tensor_trie import TensorTrie as JaxTensorTrie
from genrec_tpu.kernels.paged_attention import (
    paged_attention_stats_pallas,
    paged_attention_stats_pallas_quantized,
)
from genrec_tpu.models import cobra as jcobra
from genrec_tpu.models import tiger as jtiger
from genrec_tpu.ops import paged as jpaged
from genrec_tpu.ops.quant import QuantizedKVPool as JaxQuantizedKVPool
from genrec_tpu.serving import heads as jheads
from genrec_tpu.serving.buckets import BucketLadder as JaxBucketLadder
from genrec_tpu.serving.engine import ServingEngine as JaxServingEngine
from genrec_tpu.serving.kv_pool import PagedConfig as JaxPagedConfig
from genrec_tpu.serving.types import Request as JaxRequest
from genrec_tpu_torch.catalog.tensor_trie import TensorTrie
from genrec_tpu_torch.convert import cobra_params_from_flax, tiger_params_from_flax
from genrec_tpu_torch.kernels import paged_attention as pa
from genrec_tpu_torch.models import cobra as tcobra
from genrec_tpu_torch.models import tiger as ttiger
from genrec_tpu_torch.ops import paged as tpaged
from genrec_tpu_torch.ops.quant import QuantizedKVPool, quantize_symmetric
from genrec_tpu_torch.serving.buckets import BucketLadder
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import CobraGenerativeHead, TigerGenerativeHead
from genrec_tpu_torch.serving.kv_pool import PagedConfig
from genrec_tpu_torch.serving.types import Request

torch.set_num_threads(1)

BF16 = torch.bfloat16


def _exact_jit(fn, *args, **kwargs):
    """``jax.jit(fn)(*args, **kwargs)`` compiled with XLA rounding every
    bf16 op, as PyTorch does (see the module docstring)."""
    lowered = jax.jit(fn).lower(*args, **kwargs)
    return lowered.compile(compiler_options={"xla_allow_excess_precision": False})(
        *args, **kwargs)


@pytest.fixture
def pallas(monkeypatch):
    """JAX's paged attention through its Pallas kernels (interpret mode on
    the CPU) for the traces made inside the test: the kernel the port's
    CUDA kernel replaces, whose bf16 arithmetic the port follows."""
    import genrec_tpu.kernels.policy as policy

    monkeypatch.setattr(policy, "auto_paged_attention", lambda: True)


# ---- the plain versions on bf16 inputs --------------------------------------

# Block tables and seq_lens: "mixed" slots of different lengths, short rows
# padded with the null page 0; "masked" a fully masked slot (seq_len 0, every
# entry the null page) beside live ones; "clamped" block-table entries
# >= P, which the kernels clamp to the last page (the Pallas grid's block
# index clamps the same way; negative entries are left out, as in
# tests/test_torch_paged_attention.py: JAX wraps them).
CASES = {
    "mixed": ([[1, 2, 3], [4, 0, 0], [5, 6, 0], [7, 8, 9]], [24, 3, 9, 17]),
    "masked": ([[1, 2, 3], [0, 0, 0], [5, 6, 0], [7, 8, 0]], [20, 0, 16, 1]),
    "clamped": ([[1, 12, 3], [4, 0, 0], [5, 6, 19], [7, 8, 9]], [24, 3, 20, 17]),
}


def _inputs(seed, case, K=5, H=3, hd=8, page=8, P=12):
    rng = np.random.default_rng(seed)
    bt, sl = (np.asarray(x, np.int32) for x in CASES[case])
    S = bt.shape[0]
    return dict(
        q=rng.normal(size=(S, K, H, hd)).astype(np.float32),
        k_pool=rng.normal(size=(P, page, H, hd)).astype(np.float32),
        v_pool=rng.normal(size=(P, page, H, hd)).astype(np.float32),
        block_tables=bt,
        seq_lens=sl,
    )


def _port_args(x, int8):
    """Torch operands: q bf16; pools bf16, or int8 pools quantised from
    the bf16 values."""
    out = {k: torch.as_tensor(v) for k, v in x.items()}
    for name in ("q", "k_pool", "v_pool"):
        out[name] = out[name].to(BF16)
    if int8:
        for name in ("k_pool", "v_pool"):
            out[name] = QuantizedKVPool(*quantize_symmetric(out[name], (-2, -1)))
    return out


def _jax_args(t):
    def conv(v):
        if isinstance(v, QuantizedKVPool):
            return JaxQuantizedKVPool(jnp.asarray(v.data.numpy()), jnp.asarray(v.scale.numpy()))
        if v.dtype == BF16:
            return jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(v.numpy())

    return {k: conv(v) for k, v in t.items()}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_plain_versions_match_the_pallas_kernels(case, int8):
    """B1 on a bf16 q over bf16 pools, B2 on a bf16 q over int8 pools,
    against the Pallas kernels on the same values in interpret mode."""
    x = _port_args(_inputs(0, case), int8)
    if int8:
        want = paged_attention_stats_pallas_quantized(**_jax_args(x), interpret=True)
        got = pa.paged_attention_stats_quantized_ref(**x)
    else:
        want = paged_attention_stats_pallas(**_jax_args(x), interpret=True)
        got = pa.paged_attention_stats_ref(**x)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def _past_seq_len(bt, sl, page, P):
    """(P, page) mask of the pool rows no slot reads below its seq_len."""
    live = np.zeros((P, page), bool)
    for row, n in zip(bt, sl):
        for t in range(max(int(n), 0)):
            live[row[t // page], t % page] = True
    return ~live


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
def test_bf16_positions_past_seq_len_weigh_exactly_zero(int8):
    """Rows past each slot's seq_len holding large finite values change no
    bit of the plain version's (acc, m, l), and the Pallas kernel agrees
    at 1e-5 with the large values in place."""
    x = _inputs(6, "mixed")
    P, page = x["k_pool"].shape[:2]
    dead = _past_seq_len(x["block_tables"], x["seq_lens"], page, P)
    assert dead.any() and not dead.all()
    rng = np.random.default_rng(7)
    big = rng.choice([-1.0, 1.0], size=x["k_pool"].shape) * rng.uniform(1e3, 1e4,
                                                                        x["k_pool"].shape)
    zeros, filled = dict(x), dict(x)
    for name in ("k_pool", "v_pool"):
        zeros[name] = np.where(dead[..., None, None], 0.0, x[name]).astype(np.float32)
        filled[name] = np.where(dead[..., None, None], big, x[name]).astype(np.float32)
    plain = pa.paged_attention_stats_quantized_ref if int8 else pa.paged_attention_stats_ref
    if int8:  # quantise each row once: the live rows' scales must not move
        za, fa = _port_args(zeros, False), _port_args(filled, False)
        for name in ("k_pool", "v_pool"):
            za[name] = QuantizedKVPool(*quantize_symmetric(za[name], (-2, -1)))
            fa[name] = QuantizedKVPool(*quantize_symmetric(fa[name], (-2, -1)))
    else:
        za, fa = _port_args(zeros, False), _port_args(filled, False)
    a, b = plain(**za), plain(**fa)
    for name, u, v in zip(("acc", "m", "l"), a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy(), err_msg=name)
    kernel = paged_attention_stats_pallas_quantized if int8 else paged_attention_stats_pallas
    for name, u, w in zip(("acc", "m", "l"), b, kernel(**_jax_args(fa), interpret=True)):
        np.testing.assert_allclose(u.numpy(), np.asarray(w), atol=1e-5, err_msg=name)
    assert float(a[1].min()) > -1e3  # every live score is far above -1e9


def test_bf16_plain_version_against_the_jax_fallback_within_score_rounding():
    """The measured gap: JAX's fallback rounds the unscaled bf16 scores,
    the port (like the Pallas kernel) does not. S 2, K 3, H 2, hd 64,
    page 8, Pm 4, q and K of scale 2."""
    rng = np.random.default_rng(3)
    S, K, H, hd, page, Pm = 2, 3, 2, 64, 8, 4
    P = 1 + S * Pm
    x = dict(q=2 * rng.normal(size=(S, K, H, hd)).astype(np.float32),
             k_pool=2 * rng.normal(size=(P, page, H, hd)).astype(np.float32),
             v_pool=rng.normal(size=(P, page, H, hd)).astype(np.float32),
             block_tables=(1 + np.arange(S * Pm)).reshape(S, Pm).astype(np.int32),
             seq_lens=np.asarray([29, 17], np.int32))
    t = _port_args(x, False)
    got = pa.paged_attention_stats_ref(**t)
    fallback = jpaged._stats_fallback(**_jax_args(t))
    kernel = paged_attention_stats_pallas(**_jax_args(t), interpret=True)
    m_scale = float(got[1].abs().max())
    rel = float(np.expm1(2 * 2.0**-8 * m_scale))
    tol = dict(acc=rel * float(got[2].max()) * float(np.abs(x["v_pool"]).max()),
               m=2.0**-8 * m_scale, l=rel * float(got[2].max()))
    gap = {}
    for name, g, f, k in zip(("acc", "m", "l"), got, fallback, kernel):
        np.testing.assert_allclose(g.numpy(), np.asarray(k), atol=1e-5, err_msg=name)
        gap[name] = float(np.abs(g.numpy() - np.asarray(f)).max())
        assert gap[name] <= tol[name], (name, gap[name], tol[name])
    assert gap["m"] > 1e-3, gap  # the fallback's rounding is really there


def test_write_pages_into_a_bf16_pool_matches_jax():
    rng = np.random.default_rng(5)
    P, page, H, hd = 9, 4, 2, 3
    bt = np.asarray([[3, 1, 0], [2, 5, 7]], np.int32)
    kv = rng.normal(size=(2, H, 10, hd)).astype(np.float32)
    pool = rng.normal(size=(P, page, H, hd)).astype(np.float32)
    want = jpaged.write_pages(jnp.asarray(pool).astype(jnp.bfloat16), jnp.asarray(bt),
                              jnp.asarray(kv))  # fp32 rows into a bf16 pool: cast there
    got = tpaged.write_pages(torch.as_tensor(pool).to(BF16), torch.as_tensor(bt),
                             torch.as_tensor(kv))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    # Page 0 absorbs both rows' padded tails in an unspecified order.
    np.testing.assert_array_equal(got.float().numpy()[1:],
                                  np.asarray(want.astype(jnp.float32))[1:])


def test_bf16_wrappers_refuse_cpu_tensors_and_route_by_type():
    """The CPU takes the plain version for bf16 too; the CUDA wrappers
    refuse a CPU tensor and count nothing, and a bf16 q never reaches the
    fp32 kernel."""
    for int8 in (False, True):
        x = _port_args(_inputs(4, "mixed"), int8)
        counters = (pa.paged_attention_stats_cuda, pa.paged_attention_stats_bf16_cuda,
                    pa.paged_attention_stats_quantized_cuda,
                    pa.paged_attention_stats_quantized_bf16q_cuda)
        before = [c.launches for c in counters]
        plain = pa.paged_attention_stats_quantized_ref if int8 else pa.paged_attention_stats_ref
        for a, b in zip(tpaged.paged_attention_stats(**x), plain(**x)):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
        wrappers = ((pa.paged_attention_stats_quantized_cuda,
                     pa.paged_attention_stats_quantized_bf16q_cuda) if int8
                    else (pa.paged_attention_stats_cuda, pa.paged_attention_stats_bf16_cuda))
        for fn in wrappers:
            with pytest.raises(ValueError, match="CUDA tensor"):
                fn(**x)
        assert [c.launches for c in counters] == before
    assert tpaged.paged_attention(**x).dtype == BF16


# ---- TIGER ----------------------------------------------------------------------

K_CB, D, N_USERS = 32, 3, 50
TIGER_CFG = dict(embedding_dim=32, attn_dim=64, num_heads=4, n_layers=4,
                 num_item_embeddings=K_CB, num_user_embeddings=N_USERS, sem_id_dim=D,
                 max_pos=64)


def _tiger_batch(rng, lengths, L):
    """Contiguous valid prefixes of mixed lengths (the serving layout)."""
    B = len(lengths)
    mask = np.zeros((B, L * D), np.int64)
    for i, n in enumerate(lengths):
        mask[i, : n * D] = 1
    return dict(user=rng.integers(0, N_USERS, (B,)),
                items=rng.integers(0, K_CB, (B, L * D)) * mask,
                types=np.tile(np.arange(D), (B, L)), mask=mask)


def _jax_ints(b):
    return [jnp.asarray(b[k], jnp.int32) for k in ("user", "items", "types", "mask")]


def _torch_ints(b):
    return [torch.as_tensor(b[k], dtype=torch.int64) for k in ("user", "items", "types", "mask")]


@pytest.fixture(scope="module")
def tiger():
    """JAX bf16 TIGER + fp32 params, and the bf16 port with those weights."""
    jinit = jtiger.Tiger(dropout=0.0, **TIGER_CFG)
    b = _tiger_batch(np.random.default_rng(0), (4, 2), 4)
    params = jax.jit(jinit.init)(
        jax.random.key(0), *_jax_ints(b)[:3], jnp.zeros((2, D), jnp.int32),
        jnp.zeros((2, D), jnp.int32), jnp.asarray(b["mask"], jnp.int32),
    )["params"]
    jmodel = jtiger.Tiger(dropout=0.0, dtype=jnp.bfloat16, **TIGER_CFG)
    tmodel = ttiger.Tiger(device="cpu", dtype=BF16, **TIGER_CFG)
    tmodel.load_state_dict(tiger_params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                  tmodel))
    catalog = np.unique(np.random.default_rng(1).integers(0, K_CB, (40, D)), axis=0)
    return jmodel, params, tmodel.eval(), catalog


def _dtype_name(x) -> str:
    name = str(x.dtype).replace("torch.", "")
    return "int" if name.startswith("int") else name


def _same_dtypes(port: dict, jax_state: dict):
    """Leaf by leaf: float and bool leaves of one dtype; index leaves
    integers on both sides (int64 in the port, which torch indexes with,
    int32 in JAX, as in float32)."""
    assert set(port) == set(jax_state)
    assert {k: _dtype_name(v) for k, v in port.items()} == {
        k: _dtype_name(v) for k, v in jax_state.items()}


@pytest.mark.parametrize("draft_hint", [False, True])
def test_tiger_paged_state_and_layout_dtypes_match_jax(tiger, draft_hint):
    jmodel, _, tmodel, catalog = tiger
    _same_dtypes(ttiger.init_tiger_paged_state(tmodel, 3, 5, draft_hint=draft_hint),
                 jtiger.init_tiger_paged_state(jmodel, 3, 5, draft_hint=draft_hint))
    want = jheads.TigerGenerativeHead(jmodel, item_sem_ids=catalog).paged_layout()
    got = TigerGenerativeHead(tmodel, item_sem_ids=catalog).paged_layout()
    assert got[:3] == tuple(want[:3]) and got[3] == BF16 and want[3] == jnp.bfloat16


def _beams_agree(sem_a, sc_a, sem_b, sc_b, atol):
    """Sem-ids equal outside near ties: every tuple both beam lists hold
    scores within ``atol`` on both sides, and a tuple only one holds
    scores within ``atol`` of the other's last (it sat at the cut-off)."""
    for sa, ca, sb, cb in zip(sem_a, sc_a, sem_b, sc_b):
        a = {tuple(t): float(v) for t, v in zip(sa.tolist(), ca)}
        b = {tuple(t): float(v) for t, v in zip(sb.tolist(), cb)}
        for t in a.keys() & b.keys():
            assert abs(a[t] - b[t]) <= atol, (t, a[t], b[t])
        for x, y in ((a, b), (b, a)):
            assert all(x[t] <= min(y.values()) + atol for t in x.keys() - y.keys()), (a, b)


def test_bf16_prefill_pages_match_jax_bit_for_bit_without_excess_precision(tiger):
    """Why the JAX side is compiled with ``xla_allow_excess_precision``
    off: with it on, XLA keeps a fusion's bf16 values in fp32 between ops
    and many of the prefill's bf16 K/V elements land a rounding step away
    from the port's; with it off it rounds every op as PyTorch does and
    all but the few an fp32 summation order flips are bit-equal."""
    jmodel, params, tmodel, _ = tiger
    b = _tiger_batch(np.random.default_rng(9), (6, 2, 4, 5, 1, 3), 6)
    B, page, nl = 6, 8, TIGER_CFG["n_layers"] // 2
    H, hd = TIGER_CFG["num_heads"], TIGER_CFG["attn_dim"] // TIGER_CFG["num_heads"]
    Pm = -(-(6 * D + 1) // page)
    bt = (1 + np.arange(B * Pm)).reshape(B, Pm).astype(np.int32)
    shape = (1 + B * Pm, page, H, hd)
    tk = tuple(torch.zeros(shape, dtype=BF16) for _ in range(nl))
    tv = tuple(torch.zeros(shape, dtype=BF16) for _ in range(nl))
    ttiger.tiger_prefill_paged(tmodel, *_torch_ints(b), torch.as_tensor(bt), tk, tv)
    port = np.concatenate([t.float().numpy().ravel() for t in tk + tv])
    args = (params, *_jax_ints(b), jnp.asarray(bt),
            tuple(jnp.zeros(shape, jnp.bfloat16) for _ in range(nl)),
            tuple(jnp.zeros(shape, jnp.bfloat16) for _ in range(nl)))
    fn = functools.partial(jtiger.tiger_prefill_paged, jmodel)
    share = {}
    for excess in (True, False):
        compiled = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": excess})
        jk, jv, _, _ = compiled(*args)
        want = np.concatenate([np.asarray(t.astype(jnp.float32)).ravel()
                               for t in tuple(jk) + tuple(jv)])
        share[excess] = float((port == want).mean())
    assert share[False] > 0.98 and share[True] < 0.8, share


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_bf16_tiger_generate_paged_matches_jax(tiger, pallas, kv_dtype):
    """bf16 pages (kv_dtype "float32": not quantised, the model's dtype) or
    int8 pages under a bf16 model, deterministic beam search at T = 1."""
    jmodel, params, tmodel, _ = tiger
    rng = np.random.default_rng(2)
    valid = np.unique(rng.integers(0, K_CB, (40, D)), axis=0)
    b = _tiger_batch(rng, (6, 2, 4, 5, 1, 3), 6)
    fn = functools.partial(jtiger.tiger_generate_paged, jmodel, n_top_k_candidates=5,
                           deterministic=True, kv_dtype=kv_dtype, temperature=1.0)
    jout = _exact_jit(fn, params, JaxTensorTrie.build(valid, K_CB).device(), *_jax_ints(b),
                      jax.random.key(0))
    tout = ttiger.tiger_generate_paged(tmodel, TensorTrie.build(valid, K_CB).to("cpu"),
                                       *_torch_ints(b), n_top_k_candidates=5, temperature=1.0,
                                       kv_dtype=kv_dtype)
    assert tout.log_probas.dtype == torch.float32
    _beams_agree(tout.sem_ids.numpy(), tout.log_probas.numpy(),
                 np.asarray(jout.sem_ids), np.asarray(jout.log_probas), 2e-2)


# ---- COBRA ----------------------------------------------------------------------

C, C_VOCAB, LTXT = 3, 8, 5
COBRA_CFG = dict(encoder_n_layers=1, encoder_hidden_dim=16, encoder_num_heads=2,
                 encoder_vocab_size=50, id_vocab_size=C_VOCAB, n_codebooks=C, d_model=16,
                 max_len=64, temperature=0.2, decoder_n_layers=2, decoder_num_heads=2,
                 decoder_dropout=0.0)


@pytest.fixture(scope="module")
def cobra():
    jinit = jcobra.Cobra(**COBRA_CFG)
    params = jax.jit(jinit.init)(jax.random.key(0), jnp.zeros((2, 4 * C), jnp.int32),
                                 jnp.ones((2, 4, LTXT), jnp.int32))["params"]
    jmodel = jcobra.Cobra(**COBRA_CFG, dtype=jnp.bfloat16)
    tmodel = tcobra.Cobra(device="cpu", dtype=BF16, **COBRA_CFG).eval()
    tmodel.load_state_dict(cobra_params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                  tmodel))
    rng = np.random.default_rng(7)
    catalog = np.unique(rng.integers(0, C_VOCAB, (20, C)), axis=0)
    text = rng.integers(1, 50, (len(catalog), LTXT)).astype(np.int32)
    return jmodel, params, tmodel, catalog, text


def test_cobra_paged_state_and_layout_dtypes_match_jax(cobra):
    jmodel, _, tmodel, catalog, text = cobra
    _same_dtypes(tcobra.init_cobra_paged_state(tmodel, 3, 4),
                 jcobra.init_cobra_paged_state(jmodel, 3, 4))
    vecs = np.zeros((len(catalog), COBRA_CFG["d_model"]), np.float32)
    want = jheads.CobraGenerativeHead(jmodel, item_sem_ids=catalog, item_vecs=vecs
                                      ).paged_layout()
    got = CobraGenerativeHead(tmodel, item_sem_ids=catalog, item_vecs=vecs).paged_layout()
    assert got[:3] == tuple(want[:3]) and got[3] == BF16 and want[3] == jnp.bfloat16


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_bf16_cobra_generate_paged_matches_jax(cobra, pallas, kv_dtype):
    """Histories of 1-4 complete items (rows that do not fill the layout
    read their prefill tail, rows that do the decode steps' attention),
    the port's bf16 tower output handed to both sides, T = 1."""
    jmodel, params, tmodel, catalog, text = cobra
    rng = np.random.default_rng(3)
    L, B = 4, 6
    n = np.asarray([4, 1, 4, 3, 2, 4])
    hist = rng.integers(0, len(catalog), (B, L))
    ids = np.full((B, L * C), jmodel.pad_id, np.int64)
    tokens = np.ones((B, L, LTXT), np.int64)
    for i in range(B):
        ids[i, : n[i] * C] = catalog[hist[i, : n[i]]].reshape(-1)
        tokens[i, : n[i]] = text[hist[i, : n[i]]]
    with torch.no_grad():
        vecs = tmodel.encode_items(torch.as_tensor(tokens))
    vecs = vecs * (torch.arange(L) < torch.as_tensor(n)[:, None])[..., None].to(vecs.dtype)
    trie = TensorTrie.build(catalog, C_VOCAB).to("cpu")
    tout = tcobra.cobra_generate_paged(tmodel, torch.as_tensor(ids), None, n_candidates=4,
                                       temperature=1.0, item_vecs=vecs, trie=trie,
                                       page_size=8, kv_dtype=kv_dtype)
    fn = functools.partial(jcobra.cobra_generate_paged, jmodel, n_candidates=4,
                           temperature=1.0, page_size=8, kv_dtype=kv_dtype)
    assert vecs.dtype == BF16
    jvecs = jnp.asarray(vecs.float().numpy()).astype(jnp.bfloat16)
    jout = _exact_jit(lambda p, i, v, t: fn(p, i, None, item_vecs=v, trie=t), params,
                      jnp.asarray(ids, jnp.int32), jvecs,
                      JaxTensorTrie.build(catalog, C_VOCAB).device())
    assert tout.scores.dtype == torch.float32
    _beams_agree(tout.sem_ids.numpy(), tout.scores.numpy(),
                 np.asarray(jout.sem_ids), np.asarray(jout.scores), 2e-2)


# ---- the port's engine with bf16 heads -------------------------------------------

WAVE = 3  # requests a wave: the slots, the prefill group, the decode batch
TIGER_PAGED = dict(max_slots=WAVE, page_size=8, pages_per_slot=2)  # 1 + 4 x 3 <= 16
COBRA_PAGED = dict(max_slots=WAVE, page_size=8, pages_per_slot=2)  # 4 x (3 + 1) <= 16


def _serve_waves(heads, reqs, kv_dtype, paged, spec):
    engine = ServingEngine(heads, device="cpu", ladder=BucketLadder((1, 2, WAVE), (2, 4)),
                           max_batch=WAVE, max_wait_ms=200.0,
                           paged_config=PagedConfig(**paged, kv_dtype=kv_dtype),
                           prefix_cache=False, spec_decode=spec, spec_fanout=4).start()
    try:
        responses = []
        for i in range(0, len(reqs), WAVE):
            responses += [f.result(timeout=120)
                          for f in [engine.submit(r) for r in reqs[i:i + WAVE]]]
        pools = {h.name: engine.runner(h.name).pool for h in heads}
    finally:
        stats = engine.stop()
    assert stats["completed"] == len(reqs) and stats["failed"] == 0
    for pool in pools.values():
        pool.check_invariants()
        assert pool.allocator.pages_in_use == 0
        want = torch.int8 if kv_dtype == "int8" else BF16
        assert all(p.dtype == want for p in pool.k_pools + pool.v_pools)
    return responses


def _waves(reqs, responses):
    """(requests, B, L, responses) of each wave, which prefilled as one
    group at one bucket."""
    for i in range(0, len(reqs), WAVE):
        grp = responses[i:i + WAVE]
        assert len({r.bucket for r in grp}) == 1, [r.bucket for r in grp]
        yield reqs[i:i + WAVE], *grp[0].bucket, grp


def _requests(rng, n, n_items, head):
    return [Request(head=head, history=rng.integers(0, n_items, int(k)),
                    user_id=int(rng.integers(0, N_USERS)))
            for k in rng.integers(1, 5, n)]  # 1..4 items: buckets 2 and 4


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_bf16_tiger_engine_matches_offline_plain_and_spec(tiger, kv_dtype):
    """Plain and speculative engines over a bf16 TIGER: each wave equal to
    offline bf16 ``tiger_generate_paged`` of the same group, of the same
    page type; the speculative engine equal to the plain one."""
    _, _, tmodel, catalog = tiger
    head = TigerGenerativeHead(tmodel, item_sem_ids=catalog, top_k=5)
    reqs = _requests(np.random.default_rng(11), 4 * WAVE, len(catalog), "tiger")
    answers = {}
    for spec in (False, True):
        answers[spec] = responses = _serve_waves([head], reqs, kv_dtype, TIGER_PAGED, spec)
        for grp, B, L, got in _waves(reqs, responses):
            out = ttiger.tiger_generate_paged(tmodel, head.trie, *head.make_batch(grp, B, L),
                                              n_top_k_candidates=5, page_size=8,
                                              kv_dtype=kv_dtype)
            for j, resp in enumerate(got):
                np.testing.assert_array_equal(resp.sem_ids, out.sem_ids[j].numpy())
                np.testing.assert_array_equal(resp.scores, out.log_probas[j].numpy())
    for a, b in zip(answers[False], answers[True]):
        np.testing.assert_array_equal(a.sem_ids, b.sem_ids)
        np.testing.assert_array_equal(a.scores, b.scores)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_bf16_cobra_engine_matches_offline_plain_and_spec(cobra, kv_dtype):
    """The same for a bf16 COBRA head (the tower encoded once, in bf16)."""
    _, _, tmodel, catalog, text = cobra
    head = CobraGenerativeHead(tmodel, item_sem_ids=catalog, item_text_tokens=text, top_k=4)
    assert head.item_vecs.dtype == BF16
    reqs = _requests(np.random.default_rng(12), 4 * WAVE, len(catalog), "cobra")
    answers = {}
    for spec in (False, True):
        answers[spec] = responses = _serve_waves([head], reqs, kv_dtype, COBRA_PAGED, spec)
        for grp, B, L, got in _waves(reqs, responses):
            ids, vecs = head.make_batch(grp, B, L)
            out = tcobra.cobra_generate_paged(tmodel, ids, None, n_candidates=4,
                                              temperature=1.0, item_vecs=vecs, trie=head.trie,
                                              page_size=8, kv_dtype=kv_dtype)
            for j, resp in enumerate(got):
                np.testing.assert_array_equal(resp.sem_ids, out.sem_ids[j].numpy())
                np.testing.assert_array_equal(resp.scores, out.scores[j].numpy())
    assert {r.bucket[1] for r in answers[False]} == {2, 4}
    for a, b in zip(answers[False], answers[True]):
        np.testing.assert_array_equal(a.sem_ids, b.sem_ids)
        np.testing.assert_array_equal(a.scores, b.scores)


# ---- the retained-bytes gauge ------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_page_bytes_measure_the_pools(tiger, kv_dtype):
    """A page's bytes over all layers' K and V pools, measured on the pools
    as JAX measures them: for fp32 and int8 pools the value the page
    geometry gives (as before), for a bf16 model's pools half fp32's."""
    _, _, tmodel, catalog = tiger
    m32 = ttiger.Tiger(device="cpu", **TIGER_CFG).eval()
    m32.load_state_dict(tmodel.state_dict())
    cfg = PagedConfig(**TIGER_PAGED, kv_dtype=kv_dtype)
    geometry = (TIGER_CFG["n_layers"] // 2, TIGER_CFG["num_heads"],
                TIGER_CFG["attn_dim"] // TIGER_CFG["num_heads"])
    nbytes = {}
    for name, model in (("fp32", m32), ("bf16", tmodel)):
        engine = ServingEngine([TigerGenerativeHead(model, item_sem_ids=catalog, top_k=5)],
                               device="cpu", ladder=BucketLadder((1, 2), (2, 4)),
                               max_batch=2, paged_config=cfg).start()
        nbytes[name] = engine.runner("tiger")._page_nbytes
        engine.stop()
    assert nbytes["fp32"] == cfg.hbm_bytes(*geometry) // cfg.num_pages
    if kv_dtype == "int8":
        assert nbytes["bf16"] == nbytes["fp32"]
    else:
        assert nbytes["bf16"] * 2 == nbytes["fp32"]


def test_bf16_retained_bytes_match_the_jax_engine(tiger):
    """On a bf16 pool the port's ``stats()["retained_bytes"]`` (retained
    pages x a page's bytes) equals the JAX engine's on the same traffic:
    cold requests, one repeat admitted warm, the pool kept after the
    drain."""
    jmodel, params, tmodel, catalog = tiger
    histories = [np.asarray([2, 5, 7]), np.asarray([1]), np.asarray([3, 3, 9, 4]),
                 np.asarray([2, 5, 7])]
    paged = dict(max_slots=2, page_size=8, pages_per_slot=2, num_pages=25)
    jeng = JaxServingEngine(
        [jheads.TigerGenerativeHead(jmodel, item_sem_ids=catalog, top_k=5)], params,
        ladder=JaxBucketLadder((1, 2), (2, 4)), max_batch=2, max_wait_ms=1.0,
        handle_signals=False, paged_config=JaxPagedConfig(**paged)).start()
    try:
        for i, h in enumerate(histories):
            jeng.serve(JaxRequest(head="tiger", history=h, user_id=i % 3), timeout=120)
        want = jeng.stats()["prefix_cache"]["tiger"]
    finally:
        jeng.stop()
    teng = ServingEngine([TigerGenerativeHead(tmodel, item_sem_ids=catalog, top_k=5)],
                         device="cpu", ladder=BucketLadder((1, 2), (2, 4)), max_batch=2,
                         max_wait_ms=1.0, paged_config=PagedConfig(**paged)).start()
    try:
        for i, h in enumerate(histories):
            teng.submit(Request(head="tiger", history=h, user_id=i % 3)).result(timeout=120)
        got = teng.stats()["prefix_cache"]["tiger"]
    finally:
        teng.stop()
    assert got["hits"] == want["hits"] >= 1
    assert got["retained_pages"] == want["retained_pages"] > 0
    assert got["retained_bytes"] == want["retained_bytes"]
