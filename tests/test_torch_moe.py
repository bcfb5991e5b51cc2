"""Mixture of experts and expert parallelism for the Qwen backbone, port
against the JAX package (one case for each test of tests/test_moe.py but
tensor x expert parallelism, which tests/test_torch_dp_2d.py holds).

Every case builds the JAX module, converts its parameters and holds the
port's ``QwenMoEMLP`` / ``QwenLM`` to the JAX output on the same numpy
inputs (and, where the JAX test does, to its first-principles claim):
top-k dispatch and combine, capacity overflow dropping to the residual,
rank priority of slot claims, padding that claims no slot and no aux, the
Switch aux loss, its collection over layers, the decode step against the
forward, and the expert-parallel forward and gradients on 4 gloo ranks
against JAX's replicated forward and the port's ep = 1 gradients. Then
``lcrec_trainer.train(num_experts=4)`` at ep = 1 and ep = 2 (2 ranks),
from the JAX trainer's own init, against the JAX trainer's per-step
losses, and ``config/lcrec/synthetic_moe.gin`` at its expert_parallel=4
on 4 ranks. Tolerances: 1e-5 (fp32 on both sides; the port gathers by
slot where JAX contracts one-hot tensors, so sums run in other orders).
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.data.lcrec_tasks import synthetic_lcrec_data as jax_synthetic_lcrec_data
from genrec_tpu.models import lcrec as jl
from genrec_tpu.models.backbones.qwen import QwenConfig as JaxQwenConfig
from genrec_tpu.models.backbones.qwen import QwenLM as JaxQwenLM
from genrec_tpu.models.backbones.qwen import QwenMoEMLP as JaxQwenMoEMLP
from genrec_tpu.models.backbones.qwen import collect_moe_aux as jax_collect_moe_aux
from genrec_tpu.trainers import lcrec_trainer as jax_lcrec_trainer
from genrec_tpu_torch import configlib
from genrec_tpu_torch.convert import qwen_params_from_flax
from genrec_tpu_torch.models.backbones.qwen import (
    QwenConfig,
    QwenLM,
    QwenMoEMLP,
    collect_moe_aux,
    qwen_param_specs,
)
from genrec_tpu_torch.parallel.mesh import spawn
from genrec_tpu_torch.parallel.shardings import expert_shard_dim, shard_expert_params
from genrec_tpu_torch.trainers import lcrec_trainer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = dict(epochs=2, batch_size=16, max_train_samples=64, max_eval_samples=16,
             eval_items_limit=16, eval_every_epoch=1, amp=False, device="cpu",
             wandb_log_interval=1, hidden_size=32, intermediate_size=64, n_layers=1,
             num_heads=2, num_kv_heads=2, max_text_len=64, eval_item_tasks=False,
             save_every_epoch=1, num_experts=4, num_experts_per_tok=2, seed=0)


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 180 s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(180)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _cfg(**kw):
    base = dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=64,
                rope_theta=10000.0, tie_word_embeddings=False, num_experts=4,
                num_experts_per_tok=2, moe_capacity_factor=4.0)
    base.update(kw)
    return base


def _port_moe(params, cfg):
    mod = QwenMoEMLP(QwenConfig(**cfg), torch.float32, None, "cpu")
    with torch.no_grad():
        mod.router.weight.copy_(torch.as_tensor(np.asarray(params["router"]["kernel"]).T))
        for name in ("gate_proj", "up_proj", "down_proj"):
            getattr(mod, name).copy_(torch.as_tensor(np.asarray(params[name])))
    return mod


def _jax_moe(cfg, x, mask=None, params=None):
    mod = JaxQwenMoEMLP(JaxQwenConfig(**cfg))
    if params is None:
        params = mod.init(jax.random.key(0), x)["params"]
    args = (x,) if mask is None else (x, mask)
    y, mut = mod.apply({"params": params}, *args, mutable=["losses"])
    return params, np.asarray(y), float(jax_collect_moe_aux(mut))


def _port_run(mod, x, mask=None):
    with torch.no_grad():
        y, aux = mod(torch.as_tensor(np.asarray(x)),
                     None if mask is None else torch.as_tensor(np.asarray(mask)))
    return y.numpy(), float(aux)


def _port_lm(params, cfg, rank=0, ep=1, group=None):
    c = QwenConfig(**cfg)
    model = QwenLM(c, device="cpu", expert_group=group)
    model.load_state_dict(shard_expert_params(qwen_params_from_flax(params, c), rank, ep))
    return model


def test_moe_matches_per_token_reference():
    cfg = _cfg()
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 6, cfg["hidden_size"])), jnp.float32)
    params, want, _ = _jax_moe(cfg, x)
    got, _ = _port_run(_port_moe(params, cfg), x)
    np.testing.assert_allclose(got, want, **TOL)
    # The JAX test's per-token numpy re-derivation (no capacity pressure).
    wr, wg, wu, wd = (np.asarray(params["router"]["kernel"]), np.asarray(params["gate_proj"]),
                      np.asarray(params["up_proj"]), np.asarray(params["down_proj"]))
    silu = lambda v: v / (1.0 + np.exp(-v))  # noqa: E731
    for b in range(2):
        for t in range(6):
            tok = np.asarray(x)[b, t]
            p = np.exp(tok @ wr - (tok @ wr).max())
            p /= p.sum()
            top = np.argsort(-p)[:2]
            ref = sum(g * ((silu(tok @ wg[e]) * (tok @ wu[e])) @ wd[e])
                      for g, e in zip(p[top] / p[top].sum(), top))
            np.testing.assert_allclose(got[b, t], ref, rtol=2e-4, atol=2e-5)


def test_capacity_overflow_drops_to_zero():
    cfg = _cfg(num_experts=1, num_experts_per_tok=1, moe_capacity_factor=1e-9)
    x = jnp.asarray(np.random.default_rng(1).normal(size=(1, 5, 16)), jnp.float32)
    params, want, _ = _jax_moe(cfg, x)
    mod = _port_moe(params, cfg)
    got, _ = _port_run(mod, x)
    assert np.abs(got[0, 0]).max() > 0
    np.testing.assert_array_equal(got[0, 1:], 0.0)
    np.testing.assert_allclose(got, want, **TOL)
    assert float(mod.dropped) == pytest.approx(4 / 5)


def test_rank_priority_beats_secondary_choices():
    cfg = _cfg(num_experts=2, num_experts_per_tok=2, moe_capacity_factor=1.0)
    rng = np.random.default_rng(2)
    D = cfg["hidden_size"]
    u = rng.normal(size=(D,))
    u /= np.linalg.norm(u)
    sign = np.repeat([1.0, -1.0], 4)[:, None]
    noise = rng.normal(size=(8, D)) * 0.05
    noise -= (noise @ u)[:, None] * u
    x = jnp.asarray((sign * u * 2.0 + noise)[None], jnp.float32)
    params, _, _ = _jax_moe(cfg, x)
    params = dict(params)
    params["router"] = {"kernel": np.stack([u * 3.0, -u * 3.0], axis=1).astype(np.float32)}
    _, want, _ = _jax_moe(cfg, x, params=params)
    got, _ = _port_run(_port_moe(params, cfg), x)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got[0]).min(axis=-1).max() > 0 or np.abs(got[0]).max() > 0
    # Every primary claim is served: no token's output is zero.
    assert (np.abs(got[0]).max(axis=-1) > 0).all()


def test_padding_tokens_claim_no_capacity_and_no_aux():
    cfg = _cfg(num_experts=1, num_experts_per_tok=1, moe_capacity_factor=1e-9,
               router_aux_coef=1.0)
    x = jnp.asarray(np.random.default_rng(5).normal(size=(1, 5, 16)), jnp.float32)
    mask = jnp.asarray([[0, 0, 1, 0, 0]], jnp.int32)
    params, want, want_aux = _jax_moe(cfg, x, mask)
    got, aux = _port_run(_port_moe(params, cfg), x, mask)
    assert np.abs(got[0, 2]).max() > 0
    np.testing.assert_array_equal(got[0, [0, 1, 3, 4]], 0.0)
    np.testing.assert_allclose(got, want, **TOL)
    assert aux == pytest.approx(1.0, rel=1e-6) and want_aux == pytest.approx(1.0, rel=1e-6)


def test_lm_padding_does_not_change_valid_logits():
    cfg = _cfg()
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg["vocab_size"], (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[:, 5:] = 0
    jm = JaxQwenLM(JaxQwenConfig(**cfg))
    params = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(ids))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    model = _port_lm(params, cfg)
    with torch.no_grad():
        full = model(torch.as_tensor(ids[:, :5]).long(), torch.ones((2, 5), dtype=torch.long))
        padded = model(torch.as_tensor(ids).long(), torch.as_tensor(mask).long())
    np.testing.assert_allclose(padded[:, :5].numpy(), full.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(padded.numpy(), want, **TOL)


def test_aux_loss_uniform_is_one():
    cfg = _cfg(router_aux_coef=1.0)
    x = jnp.zeros((2, 8, 16), jnp.float32)
    params, _, want_aux = _jax_moe(cfg, x)
    _, aux = _port_run(_port_moe(params, cfg), x)
    np.testing.assert_allclose(aux, 1.0, rtol=1e-6)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)


def test_qwen_lm_with_moe_and_aux_collection():
    cfg = _cfg()
    ids = np.arange(12).reshape(2, 6) % cfg["vocab_size"]
    jm = JaxQwenLM(JaxQwenConfig(**cfg))
    params = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(ids))["params"])
    want, mut = jm.apply({"params": params}, jnp.asarray(ids), mutable=["losses"])
    model = _port_lm(params, cfg)
    aux = []
    with torch.no_grad():
        logits = model(torch.as_tensor(ids).long(), moe_aux=aux)
    assert logits.shape == (2, 6, cfg["vocab_size"]) and len(aux) == cfg["num_hidden_layers"]
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(collect_moe_aux(aux)), float(jax_collect_moe_aux(mut)),
                               rtol=1e-6)
    assert float(collect_moe_aux(aux)) > 0
    dense = QwenLM(QwenConfig(**_cfg(num_experts=0)), device="cpu")
    dense_aux = []
    dense(torch.as_tensor(ids).long(), moe_aux=dense_aux)
    assert collect_moe_aux(dense_aux) == 0.0
    # The specs name the JAX leaves: router (E, D), stacks (E, D, F) / (E, F, D).
    specs = qwen_param_specs(QwenConfig(**cfg))
    assert specs["layers.0.moe.router.weight"][0] == (4, 16)
    assert specs["layers.1.moe.down_proj"][0] == (4, 32, 16)
    assert "layers.0.mlp.gate_proj.weight" not in specs


def test_moe_decode_step_matches_forward():
    cfg = _cfg()
    ids = np.random.default_rng(4).integers(0, cfg["vocab_size"], (2, 5)).astype(np.int32)
    jm = JaxQwenLM(JaxQwenConfig(**cfg))
    params = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(ids))["params"])
    model = _port_lm(params, cfg)
    t = torch.as_tensor(ids).long()
    with torch.no_grad():
        full = model(t)[:, -1]
        caches = model.init_cache(2, 8)
        pad = torch.zeros((2, 8), dtype=torch.long)
        for s in range(5):
            pad[:, s] = 1
            logits, caches = model.decode_step(t[:, s:s + 1], torch.full((2, 1), s), caches,
                                               pad)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(full.numpy(),
                               np.asarray(jm.apply({"params": params}, jnp.asarray(ids))[:, -1]),
                               **TOL)


# ---- expert parallelism on gloo ranks ---------------------------------------


def _grads(model, ids, mask, labels):
    loss = jl_port_loss(model, ids, mask, labels)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss), dict(zip(names, grads))


def jl_port_loss(model, ids, mask, labels):
    from genrec_tpu_torch.models.lcrec import sft_loss

    return sft_loss(model, ids, mask, labels)


def _ep_batch(vocab):
    rng = np.random.default_rng(3)
    ids = torch.as_tensor(rng.integers(0, vocab, (4, 8))).long()
    mask = torch.ones((4, 8), dtype=torch.long)
    mask[1, 6:] = 0
    labels = torch.where(torch.as_tensor(rng.random((4, 8))) < 0.3, -100, ids)
    labels[mask == 0] = -100
    return ids, mask, labels


def _ep4_rank(group, params, cfg, root):
    torch.set_num_threads(1)
    model = _port_lm(params, cfg, group.rank, group.size, group)
    ids, mask, labels = _ep_batch(cfg["vocab_size"])
    with torch.no_grad():
        logits = model(ids).numpy()
    loss, grads = _grads(model, ids, mask, labels)
    # config/lcrec/synthetic_moe.gin at its expert_parallel=4, cut to one short epoch.
    configlib.clear_bindings()
    configlib.clear_macros()
    configlib.parse_file(os.path.join(REPO, "config/lcrec/synthetic_moe.gin"))
    for b in ('train.device = "cpu"', f'train.save_dir_root = "{root}"', "train.epochs = 1",
              "train.max_train_samples = 64", "train.max_eval_samples = 16",
              "train.eval_every_epoch = 1", "train.eval_item_tasks = False",
              "train.eval_items_limit = 16", "train.amp = False"):
        configlib.parse_binding(b)
    metrics = lcrec_trainer.train()
    configlib.clear_bindings()
    configlib.clear_macros()
    return logits, loss, grads, metrics


def _jax_trainer_init(seed=0, num_codebooks=3, codebook_size=8):
    """The JAX trainer's own init at TRAIN's widths (JAX
    ``trainers/lcrec_trainer.py``: the backbone from init_rng, the codebook
    rows from vocab_rng)."""
    _, tok = jax_synthetic_lcrec_data(codebook_size=codebook_size,
                                      num_codebooks=num_codebooks, seed=seed)
    cfg = JaxQwenConfig(vocab_size=tok.base_vocab, hidden_size=TRAIN["hidden_size"],
                        intermediate_size=TRAIN["intermediate_size"],
                        num_hidden_layers=TRAIN["n_layers"],
                        num_attention_heads=TRAIN["num_heads"],
                        num_key_value_heads=TRAIN["num_kv_heads"],
                        max_position_embeddings=TRAIN["max_text_len"] + num_codebooks + 1,
                        rope_theta=10000.0, tie_word_embeddings=False,
                        num_experts=TRAIN["num_experts"],
                        num_experts_per_tok=TRAIN["num_experts_per_tok"])
    init_rng, vocab_rng, _ = jax.random.split(jax.random.key(seed), 3)
    params = JaxQwenLM(cfg).init(init_rng, jnp.zeros((1, 4), jnp.int32))["params"]
    _, params, _ = jl.extend_vocab(cfg, params, num_codebooks, codebook_size, vocab_rng,
                                   base=tok.base_vocab, pad_to=8)
    return jax.device_get(params)


def _pin_jax_init(params):
    """Point the port trainer's extend_vocab at the JAX trainer's init."""
    real = lcrec_trainer.extend_vocab

    def extend_vocab(cfg, full, *args, **kwargs):
        cfg, _, base = real(cfg, full, *args, **kwargs)
        return cfg, qwen_params_from_flax(params, cfg), base

    lcrec_trainer.extend_vocab = extend_vocab
    return real


def _ep2_rank(group, params, save_dir):
    torch.set_num_threads(1)
    _pin_jax_init(params)
    metrics = lcrec_trainer.train(save_dir_root=save_dir, expert_parallel=2, **TRAIN)
    try:
        lcrec_trainer.train(save_dir_root=None, tensor_parallel=2, expert_parallel=2,
                            **{**TRAIN, "epochs": 1})
        refused = None
    except ValueError as e:  # two ranks hold no tensor x expert layout of 2 x 2
        refused = str(e)
    return metrics, refused


@pytest.fixture(scope="module")
def ep4(tmp_path_factory):
    cfg = _cfg()
    ids = _ep_batch(cfg["vocab_size"])[0].numpy().astype(np.int32)
    jm = JaxQwenLM(JaxQwenConfig(**cfg))
    params = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(ids))["params"])
    root = str(tmp_path_factory.mktemp("moe_gin"))
    out = spawn(_ep4_rank, 4, (params, cfg, root), device="cpu", threads=1, timeout_s=300,
                store_dir=tmp_path_factory.mktemp("store"))
    return cfg, params, out, root


def test_expert_parallel_matches_replicated(ep4):
    cfg, params, out, _ = ep4
    ids, mask, labels = _ep_batch(cfg["vocab_size"])
    want = JaxQwenLM(JaxQwenConfig(**cfg)).apply({"params": params},
                                                 jnp.asarray(ids.numpy().astype(np.int32)))
    one = _port_lm(params, cfg)
    loss1, grads1 = _grads(one, ids, mask, labels)
    for logits, loss, grads, _ in out:
        np.testing.assert_allclose(logits, np.asarray(want), **TOL)
        assert loss == out[0][1]
    np.testing.assert_allclose(out[0][1], loss1, rtol=1e-6)
    sharded = 0
    for name, g in grads1.items():
        dim = expert_shard_dim(name)
        if dim is None:  # replicated: the same gradient on every rank, ep = 1's
            for _, _, grads, _ in out:
                assert torch.equal(grads[name], out[0][2][name]), name
            got = out[0][2][name]
        else:
            sharded += 1
            got = torch.cat([o[2][name] for o in out], dim=0)
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * float(g.abs().max()) + 1e-12, err_msg=name)
    assert sharded == 3 * cfg["num_hidden_layers"]


def test_synthetic_moe_gin_runs_at_expert_parallel_4(ep4):
    _, _, out, root = ep4
    metrics = [o[3] for o in out]
    assert all(m == metrics[0] for m in metrics)
    valid, test = metrics[0]
    assert all(np.isfinite(v) for v in (*valid.values(), *test.values()))
    for r in range(4):
        assert os.path.exists(os.path.join(root, f"final_model.rank{r}"))


def _losses(save_dir):
    out = {}
    for line in open(os.path.join(save_dir, "metrics.jsonl")):
        rec = json.loads(line)
        if "train/loss" in rec and "global_step" in rec:
            out[int(rec["global_step"])] = rec["train/loss"]
    return out


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    params = _jax_trainer_init()
    save_dir = str(tmp_path_factory.mktemp("jax_moe"))
    metrics = jax_lcrec_trainer.train(save_dir_root=save_dir,
                                      **{k: v for k, v in TRAIN.items() if k != "device"})
    return params, _losses(save_dir), metrics


def test_trainer_at_ep1_matches_jax(jax_trainer, tmp_path):
    params, want, _ = jax_trainer
    real = _pin_jax_init(params)
    try:
        metrics = lcrec_trainer.train(save_dir_root=str(tmp_path), **TRAIN)
    finally:
        lcrec_trainer.extend_vocab = real
    got = _losses(tmp_path)
    assert sorted(got) == sorted(want) and len(got) == 8
    np.testing.assert_allclose([got[s] for s in sorted(got)], [want[s] for s in sorted(want)],
                               **TOL)
    assert all(np.isfinite(v) for v in (*metrics[0].values(), *metrics[1].values()))


def test_trainer_at_ep2_matches_jax(jax_trainer, tmp_path):
    params, want, _ = jax_trainer
    out = spawn(_ep2_rank, 2, (params, str(tmp_path)), device="cpu", threads=1,
                timeout_s=300, store_dir=str(tmp_path))
    (m0, refused), (m1, _) = out
    assert m0 == m1  # the ranks report the same metrics
    got = _losses(tmp_path)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[s] for s in sorted(got)], [want[s] for s in sorted(want)],
                               **TOL)
    assert "do not split into tensor_parallel=2 x expert_parallel=2" in refused


def test_trainer_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="divisible"):
        lcrec_trainer.train(save_dir_root=None, **{**TRAIN, "num_experts": 3,
                                                   "expert_parallel": 2})
    with pytest.raises(ValueError, match="num_experts>0 is wired"):
        lcrec_trainer.train(save_dir_root=None, sequence_parallel=2, **TRAIN)
    with pytest.raises(ValueError, match="needs expert_parallel>1"):
        lcrec_trainer.train(save_dir_root=None, tensor_parallel=2, **TRAIN)
    with pytest.raises(RuntimeError, match="one process per rank"):
        lcrec_trainer.train(save_dir_root=None, expert_parallel=2, **TRAIN)
