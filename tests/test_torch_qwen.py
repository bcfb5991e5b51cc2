"""The Qwen2-class backbone, port against the JAX package, and the port's
tensor-parallel shards against its single-device model.

genrec_tpu_torch/models/backbones/qwen.py pairs with
genrec_tpu/models/backbones/qwen.py on the same Flax parameters
(``convert.qwen_params_from_flax``): logits and hidden states, every
parameter's gradient, and ``decode_step`` over the KV cache (against the
port's own full forward and against JAX ``decode_step``). Then the port
at tensor_parallel=2 (2 ranks on a gloo group on the CPU, one spawn for
the module) against the port at tensor_parallel=1 from the same full
parameters: logits, hidden states and gradients, the shards put back
together.

``params_from_hf_state_dict`` holds the port to the HF golden
(tests/data/qwen_golden.npz) as tests/test_qwen.py holds the JAX model:
logits at the valid positions, positions from the mask, atol 3e-4 and
rtol 1e-3.

Tiny size: 2 layers, hidden 32, 4 heads / 2 KV heads, FFN 64, vocab 96.
Tolerance, fp32 on both sides: logits and hidden states 1e-5 absolute
plus 1e-5 relative; a gradient 1e-5 of its largest element (each element
sums the B L V weighted logits' paths in another order: GEMM blocking
differs between XLA and PyTorch, and between one matmul and the sum of
two halves).
"""

import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.models.backbones.qwen import QwenConfig as JaxQwenConfig
from genrec_tpu.models.backbones.qwen import QwenLM as JaxQwenLM
from genrec_tpu_torch.convert import qwen_params_from_flax
from genrec_tpu_torch.models.backbones.qwen import (
    QwenConfig,
    QwenLM,
    params_from_hf_state_dict,
    qwen_init_params,
)
from genrec_tpu_torch.parallel.mesh import TPGroup, spawn
from genrec_tpu_torch.parallel.shardings import shard_dim, shard_qwen_params

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
           rope_theta=10000.0)


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


def _batch(B=3, L=10, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, :3] = 0  # a left-padded row
    weights = rng.normal(size=(B, L, CFG["vocab_size"])).astype(np.float32)
    return ids, mask, weights


def _pair(tie: bool):
    """(JAX model, its params, port model on the same weights, cfg)."""
    jm = JaxQwenLM(JaxQwenConfig(**CFG, tie_word_embeddings=tie))
    ids, _, _ = _batch()
    params = jm.init(jax.random.key(1), jnp.asarray(ids[:1]))["params"]
    cfg = QwenConfig(**CFG, tie_word_embeddings=tie)
    model = QwenLM(cfg, device="cpu")
    model.load_state_dict(qwen_params_from_flax(jax.device_get(params), cfg))
    return jm, params, model, cfg


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_forward_and_gradients_match_jax(tie):
    jm, params, model, cfg = _pair(tie)
    ids, mask, weights = _batch()

    def jax_loss(p):
        logits, h = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                             return_hidden=True)
        return (logits * weights).sum(), (logits, h)

    (_, (want_logits, want_h)), want_grads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(params)
    logits, h = model(torch.as_tensor(ids), torch.as_tensor(mask), return_hidden=True)
    (logits * torch.as_tensor(weights)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), **TOL)
    want = qwen_params_from_flax(jax.device_get(want_grads), cfg)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        _near_grad(got[name].grad.numpy(), g.numpy(), name)


def test_decode_step_matches_full_forward_and_jax():
    """Prefill a left-padded prompt, then two single-token steps: the last
    logits equal the full forward's at those positions, and JAX
    ``decode_step``'s."""
    jm, params, model, cfg = _pair(True)
    ids, mask, _ = _batch(L=8, seed=2)
    B, L = ids.shape
    S = L + 2
    positions = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    nxt = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 2)).astype(np.int32)
    pad = np.concatenate([mask, np.zeros((B, 2), np.int32)], axis=1)
    pads = [pad.copy(), pad.copy(), pad.copy()]
    pads[1][:, L] = 1
    pads[2][:, L:L + 2] = 1
    steps = [(ids, positions), (nxt[:, :1], positions[:, -1:] + 1),
             (nxt[:, 1:], positions[:, -1:] + 2)]

    caches = model.init_cache(B, S)
    jcaches = jm.apply({"params": params}, B, S, method=JaxQwenLM.init_cache)
    with torch.no_grad():
        full = model(torch.as_tensor(np.concatenate([ids, nxt], axis=1)),
                     torch.as_tensor(pads[2]))
    for i, ((tok, pos), p) in enumerate(zip(steps, pads)):
        got, caches = model.decode_step(torch.as_tensor(tok), torch.as_tensor(pos), caches,
                                        torch.as_tensor(p))
        want, jcaches = jax.jit(
            lambda prm, t, q, c, m: jm.apply({"params": prm}, t, q, c, m,
                                             method=JaxQwenLM.decode_step)
        )(params, jnp.asarray(tok), jnp.asarray(pos), jcaches, jnp.asarray(p))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.detach().numpy(), full[:, L - 1 + i].numpy(), **TOL)
    assert caches[0]["idx"] == L + 2


def _tp_ranks(group, cases):
    """Rank side, per case: the rank's shard of the full parameters, its
    logits, hidden states and gradients (its shards) of
    sum(logits * weights)."""
    out = {}
    for tie, (full, cfg, ids, mask, weights) in cases.items():
        model = QwenLM(cfg, group=group, device="cpu")
        model.load_state_dict(shard_qwen_params(full, group.rank, group.size))
        logits, h = model(torch.as_tensor(ids), torch.as_tensor(mask), return_hidden=True)
        (logits * torch.as_tensor(weights)).sum().backward()
        out[tie] = (logits.detach().numpy(), h.detach().numpy(),
                    {n: p.grad.numpy() for n, p in model.named_parameters()})
    return out


def _tp_case(tie):
    cfg = QwenConfig(**CFG, tie_word_embeddings=tie)
    return (qwen_init_params(cfg, seed=4, device="cpu"), cfg, *_batch(seed=5))


@pytest.fixture(scope="module")
def tp_cases():
    return {tie: _tp_case(tie) for tie in (True, False)}


@pytest.fixture(scope="module")
def tp_ranks(tp_cases, tmp_path_factory):
    return spawn(_tp_ranks, 2, (tp_cases,), device="cpu", threads=1, timeout_s=120,
                 store_dir=tmp_path_factory.mktemp("store"))


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_tensor_parallel_matches_one_device(tie, tp_cases, tp_ranks):
    full, cfg, ids, mask, weights = tp_cases[tie]
    model = QwenLM(cfg, device="cpu")
    model.load_state_dict(full)
    logits, h = model(torch.as_tensor(ids), torch.as_tensor(mask), return_hidden=True)
    (logits * torch.as_tensor(weights)).sum().backward()
    ranks = [r[tie] for r in tp_ranks]
    for r_logits, r_h, _ in ranks:
        np.testing.assert_allclose(r_logits, logits.detach().numpy(), **TOL)
        np.testing.assert_allclose(r_h, h.detach().numpy(), **TOL)
    for name, p in model.named_parameters():
        dim = shard_dim(name)
        got = (ranks[0][2][name] if dim is None
               else np.concatenate([r[2][name] for r in ranks], axis=dim))
        _near_grad(got, p.grad.numpy(), name)
        if dim is None:  # replicated: the same gradient on every rank
            np.testing.assert_array_equal(ranks[1][2][name], ranks[0][2][name])


def test_converter_and_shards_check_their_inputs():
    jm, params, _, cfg = _pair(True)
    tree = jax.device_get(params)
    shards = [qwen_params_from_flax(tree, cfg, r, 2) for r in range(2)]
    assert shards[0]["embed_tokens.weight"].shape == (48, 32)
    assert shards[1]["layers.0.self_attn.k_proj.bias"].shape == (8,)
    assert shards[0]["layers.1.mlp.down_proj.weight"].shape == (32, 32)
    assert shards[1]["norm.weight"].shape == (32,)
    torch.testing.assert_close(
        torch.cat([s["layers.0.self_attn.o_proj.weight"] for s in shards], dim=1),
        qwen_params_from_flax(tree, cfg)["layers.0.self_attn.o_proj.weight"])
    missing = {k: v for k, v in tree.items() if k != "norm"}
    with pytest.raises(AssertionError, match="norm.weight"):
        qwen_params_from_flax(missing, cfg)
    with pytest.raises(ValueError, match="tensor_parallel"):
        shard_qwen_params({"embed_tokens.weight": torch.zeros(5, 2)}, 0, 2)


def test_unported_and_indivisible_layouts_raise():
    four = TPGroup(0, 4, "gloo", torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP A20"):
        QwenLM(QwenConfig(**{**CFG, "vocab_size": 96}), group=four, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        QwenLM(QwenConfig(**CFG, num_experts=4), device="cpu")


GOLDEN = Path(__file__).resolve().parent / "data" / "qwen_golden.npz"


def test_hf_state_dict_matches_the_golden_logits():
    g = np.load(GOLDEN)
    cfg = QwenConfig(**CFG, rms_norm_eps=1e-6, tie_word_embeddings=False)
    sd = {k: g[k] for k in g.files if k not in ("ids", "mask", "logits")}
    model = QwenLM(cfg, device="cpu")
    model.load_state_dict(params_from_hf_state_dict(sd, cfg))
    mask = torch.as_tensor(g["mask"])
    positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)  # HF: left-pad aware
    with torch.no_grad():
        logits = model(torch.as_tensor(g["ids"]).long(), attention_mask=mask,
                       positions=positions)
    valid = g["mask"].astype(bool)
    np.testing.assert_allclose(logits.numpy()[valid], g["logits"][valid], atol=3e-4, rtol=1e-3)


def test_hf_state_dict_refuses_what_it_cannot_map():
    g = np.load(GOLDEN)
    sd = {k: g[k] for k in g.files if k not in ("ids", "mask", "logits")}
    cfg = QwenConfig(**CFG, tie_word_embeddings=False)
    with pytest.raises(NotImplementedError, match="A14"):
        params_from_hf_state_dict(sd, QwenConfig(**CFG, num_experts=4))
    with pytest.raises(KeyError, match="lm_head"):
        params_from_hf_state_dict({k: v for k, v in sd.items() if k != "lm_head.weight"}, cfg)
    with pytest.raises(ValueError, match="shape"):
        params_from_hf_state_dict({**sd, "model.norm.weight": np.zeros(5, np.float32)}, cfg)
    # The tied head takes no lm_head.
    tied = params_from_hf_state_dict(sd, QwenConfig(**CFG, tie_word_embeddings=True))
    assert "lm_head" not in tied
