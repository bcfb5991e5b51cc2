"""LCRec, port against the JAX package.

genrec_tpu_torch/models/lcrec.py pairs with genrec_tpu/models/lcrec.py on
the same Flax parameters (``convert.qwen_params_from_flax``), and
genrec_tpu_torch/data/lcrec_tasks.py with its JAX original:

- ``extend_vocab``: base rows kept, codebook rows at the base, zero pad
  rows, the same vocab size as JAX's;
- ``sft_loss`` dense and fused, loss and every parameter's gradient;
- ``make_tp_sharded_fused_sft_loss`` at tensor_parallel=2 (2 ranks on a
  gloo group on the CPU) against JAX's on a ``model=2`` mesh of the
  conftest's virtual devices;
- ``generate_topk_constrained`` (beam widths below and above the codebook
  size) and ``generate_greedy`` at tensor_parallel 1 and 2;
- ``synthetic_lcrec_data``: identical arrays for one seed.

One spawn serves the module's tensor-parallel cases. Tiny backbone: 2
layers, hidden 32, 4 heads / 2 KV heads, 90 base tokens + 3 x 8 codebook
tokens padded to 120 (pad rows on the second shard). Tolerances, fp32 on
both sides: losses 1e-5 absolute plus 1e-5 relative; a gradient 1e-5 of
its largest element (sums over every token's path in another order);
sem-ids and tokens equal; beam log-probabilities 1e-5 absolute.
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from genrec_tpu.data.lcrec_tasks import synthetic_lcrec_data as jax_synthetic_lcrec_data
from genrec_tpu.models import lcrec as jl
from genrec_tpu.models.backbones.qwen import QwenConfig as JaxQwenConfig
from genrec_tpu.models.backbones.qwen import QwenLM as JaxQwenLM
from genrec_tpu_torch.convert import qwen_params_from_flax
from genrec_tpu_torch.data.lcrec_tasks import synthetic_lcrec_data
from genrec_tpu_torch.models import lcrec as tl
from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM, qwen_init_params
from genrec_tpu_torch.parallel.mesh import spawn
from genrec_tpu_torch.parallel.shardings import shard_dim

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
BASE, C, K = 90, 3, 8
LIVE = BASE + C * K  # 114; padded to 120
CFG = dict(vocab_size=BASE, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
           rope_theta=10000.0, tie_word_embeddings=False)


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test fails after 120 s instead of hanging."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _near_grad(got, want, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, f"{name}: max abs err {err} > 1e-5 x {scale}"


def _jax_model(tie=False, head_scale=1.0):
    """JAX model and params with the codebook tokens appended (pad_to 8).
    ``head_scale`` spreads the logits so that beam search has no near ties."""
    cfg0 = JaxQwenConfig(**{**CFG, "tie_word_embeddings": tie})
    params = JaxQwenLM(cfg0).init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    cfg, params, base = jl.extend_vocab(cfg0, params, C, K, jax.random.key(1), pad_to=8)
    assert base == BASE and cfg.vocab_size == 120
    params = dict(params)
    for name in ("embed_tokens", "lm_head"):
        if name in params:
            params[name] = params[name] * head_scale
    return JaxQwenLM(cfg), params


def _port_cfg(tie=False):
    return QwenConfig(**{**CFG, "vocab_size": 120, "tie_word_embeddings": tie})


def _port_model(params, tie=False, group=None):
    cfg = _port_cfg(tie)
    model = QwenLM(cfg, group=group, device="cpu")
    rank, tp = (0, 1) if group is None else (group.rank, group.size)
    model.load_state_dict(qwen_params_from_flax(jax.device_get(params), cfg, rank, tp))
    return model


def _sft_batch(B=4, L=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, LIVE, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, :4] = 0
    labels = np.where(rng.random((B, L)) < 0.4, -100, ids).astype(np.int32)
    labels[mask == 0] = -100
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def _prompts(B=3, L=7, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, BASE, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, :2] = 0  # left padding
    return ids, mask


WIDTHS = (4, 10)  # below and above the codebook size K = 8


def _port_generate(model, ids, mask):
    out = {}
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    for W in WIDTHS:
        g = tl.generate_topk_constrained(model, t(ids), t(mask), BASE, C, K, beam_width=W)
        out[W] = (g.sem_ids.numpy(), g.log_probas.numpy())
    out["greedy"] = tl.generate_greedy(model, t(ids), t(mask), 5, 1,
                                       valid_vocab=LIVE).numpy()
    return out


def _jax_generate(jm, params, ids, mask):
    out = {}
    for W in WIDTHS:
        g = jax.jit(lambda p, i, m, W=W: jl.generate_topk_constrained(
            jm, p, i, m, BASE, C, K, beam_width=W))(params, ids, mask)
        out[W] = (np.asarray(g.sem_ids), np.asarray(g.log_probas))
    out["greedy"] = np.asarray(jax.jit(lambda p, i, m: jl.generate_greedy(
        jm, p, i, m, 5, 1, valid_vocab=LIVE))(params, ids, mask))
    return out


def _assert_generations_equal(got, want):
    for W in WIDTHS:
        np.testing.assert_array_equal(got[W][0], want[W][0])
        np.testing.assert_allclose(got[W][1], want[W][1], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["greedy"], want["greedy"])


def _ranks(group, params, gen_params, batch, ids, mask):
    """Rank side: the sharded fused SFT loss and its gradients (this
    rank's shards), then the searches at tensor_parallel=2."""
    model = _port_model(params, group=group)
    loss = tl.make_tp_sharded_fused_sft_loss(model, LIVE)(
        {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return (loss.item(), grads, _port_generate(_port_model(gen_params, group=group), ids, mask))


@pytest.fixture(scope="module")
def setup():
    jm, params = _jax_model()
    _, gen_params = _jax_model(head_scale=30.0)
    return jm, params, gen_params


@pytest.fixture(scope="module")
def tp_ranks(setup, tmp_path_factory):
    _, params, gen_params = setup
    return spawn(_ranks, 2, (jax.device_get(params), jax.device_get(gen_params),
                             _sft_batch(), *_prompts()),
                 device="cpu", threads=1, timeout_s=120,
                 store_dir=tmp_path_factory.mktemp("store"))


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_extend_vocab(tie):
    cfg0 = QwenConfig(**{**CFG, "tie_word_embeddings": tie})
    full = qwen_init_params(cfg0, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    cfg, new, base = tl.extend_vocab(cfg0, full, C, K, gen, pad_to=8)
    jcfg, _, jbase = jl.extend_vocab(JaxQwenConfig(**{**CFG, "tie_word_embeddings": tie}),
                                     {"embed_tokens": jnp.zeros((BASE, 32)),
                                      "lm_head": jnp.zeros((BASE, 32))},
                                     C, K, jax.random.key(0), pad_to=8)
    assert (cfg.vocab_size, base) == (jcfg.vocab_size, jbase) == (120, BASE)
    names = ["embed_tokens.weight"] + ([] if tie else ["lm_head"])
    for name in names:
        t = new[name]
        assert t.shape == (120, 32)
        torch.testing.assert_close(t[:BASE], full[name], rtol=0, atol=0)
        codebook = t[BASE:LIVE]
        assert float(codebook.abs().min()) > 0 and 0.01 < float(codebook.std()) < 0.03
        assert float(t[LIVE:].abs().max()) == 0.0
    # An HF-style table padded past the tokenizer: codebook rows start at
    # the tokenizer's base inside the table, which grows only by the rest.
    cfg2, new2, base2 = tl.extend_vocab(cfg0, full, C, K, gen, base=80, pad_to=8)
    assert (cfg2.vocab_size, base2) == (104, 80)
    torch.testing.assert_close(new2["embed_tokens.weight"][:80],
                               full["embed_tokens.weight"][:80], rtol=0, atol=0)


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_sft_loss_matches_jax(setup, fused):
    jm, params, _ = setup
    batch = _sft_batch()
    want, want_grads = jax.jit(jax.value_and_grad(lambda p: jl.sft_loss(
        jm, p, batch["input_ids"], batch["attention_mask"], batch["labels"],
        valid_vocab=LIVE, use_fused_ce=fused)))(params)
    model = _port_model(params)
    loss = tl.sft_loss(model, *(torch.as_tensor(batch[k])
                                for k in ("input_ids", "attention_mask", "labels")),
                       valid_vocab=LIVE, use_fused_ce=fused)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    want_grads = qwen_params_from_flax(jax.device_get(want_grads), _port_cfg())
    for name, p in model.named_parameters():
        _near_grad(p.grad.numpy(), want_grads[name].numpy(), name)


def test_tp_sharded_sft_loss_matches_jax(setup, tp_ranks):
    jm, params, _ = setup
    batch = _sft_batch()
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    with mesh:
        loss_fn = jl.make_tp_sharded_fused_sft_loss(jm, mesh, valid_vocab=LIVE)
        want, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    want_grads = qwen_params_from_flax(jax.device_get(want_grads), _port_cfg())
    (loss0, grads0, _), (loss1, grads1, _) = tp_ranks
    np.testing.assert_allclose(loss0, float(want), **TOL)
    assert loss1 == loss0
    for name, want_g in want_grads.items():
        dim = shard_dim(name)
        got = grads0[name] if dim is None else np.concatenate([grads0[name], grads1[name]],
                                                              axis=dim)
        _near_grad(got, want_g.numpy(), name)
    assert np.abs(grads1["lm_head"][LIVE - 60:]).max() == 0.0  # pad rows: zero dW


def test_generation_matches_jax_at_tp1(setup):
    jm, _, gen_params = setup
    ids, mask = _prompts()
    got = _port_generate(_port_model(gen_params), ids, mask)
    _assert_generations_equal(got, _jax_generate(jm, gen_params, ids, mask))
    assert np.isfinite(got[10][1]).all()  # step 1 displaced the -inf fill beams


def test_generation_matches_jax_at_tp2(setup, tp_ranks):
    jm, _, gen_params = setup
    want = _jax_generate(jm, gen_params, *_prompts())
    for _, _, got in tp_ranks:
        _assert_generations_equal(got, want)


def test_synthetic_lcrec_data_matches_jax():
    data, tok = synthetic_lcrec_data(seed=3)
    jdata, jtok = jax_synthetic_lcrec_data(seed=3)
    assert (tok.base_vocab, tok.vocab_size) == (jtok.base_vocab, jtok.vocab_size)
    pairs = [(data.train_arrays(samples_per_user=2), jdata.train_arrays(samples_per_user=2)),
             (data.eval_arrays("valid"), jdata.eval_arrays("valid")),
             (data.item2index_eval_arrays(16), jdata.item2index_eval_arrays(16)),
             (data.index2item_eval_arrays(16)[0], jdata.index2item_eval_arrays(16)[0])]
    for got, want in pairs:
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert data.index2item_eval_arrays(16)[1] == jdata.index2item_eval_arrays(16)[1]


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        tl.make_sp_sft_loss(None, None)
    model = QwenLM(_port_cfg(), device="cpu")
    ids = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP A19"):
        tl.generate_topk_constrained(model, ids, torch.ones_like(ids), BASE, C, K, trie=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A18"):
        from genrec_tpu_torch.data.lcrec_tasks import amazon_lcrec_data

        amazon_lcrec_data("dataset/amazon", "beauty", "sem_ids.npz")
