"""LoRA (core/lora.py and the LCRec trainer's use_lora), port against the
JAX package.

- ``lora_from_flax`` carries JAX ``lora_init`` adapters across, and the
  port's ``lora_merge`` of them equals JAX's merged params; the port's own
  ``lora_init`` starts the merged model exactly at the base;
- the gradients into the adapters of the LCRec SFT loss under the merged
  weights equal ``jax.grad``'s, the dense and the fused CE;
- five steps of the LCRec trainer's LoRA step (``lcrec_trainer.
  lora_loss_fn`` + ``make_train_step``, AdamW over the adapters, clip 1.0,
  the fused CE) give JAX's losses and gradient norms, and leave the base
  bit-unchanged;
- ``lcrec_trainer.train(use_lora=True)`` from the JAX trainer's base and
  adapters gives the JAX trainer's per-step losses and eval metrics;
- ``lcrec_trainer.train(use_lora=True)``: its resume points and
  ``best_model`` hold only the adapters, ``final_model`` the merged
  parameters, and a mid-epoch SIGTERM resumes bit for bit;
- a frozen head: the fused CE's backward returns no dW and never calls
  the dW function (plain and vocab-sharded).

Tiny backbone: 2 layers, hidden 32, 4 heads / 2 KV heads, 90 base tokens +
3 x 8 codebook tokens padded to 120, rank 4, alpha 8. Tolerances, fp32:
merged params 1e-6; losses 1e-5 absolute plus 1e-5 relative; gradients
1e-5 of their largest element.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genrec_tpu.core import lora as jlora
from genrec_tpu.core.harness import make_train_step as jax_make_train_step
from genrec_tpu.core.state import TrainState as JaxTrainState
from genrec_tpu.data.lcrec_tasks import synthetic_lcrec_data as jax_synthetic_lcrec_data
from genrec_tpu.models import lcrec as jl
from genrec_tpu.models.backbones.qwen import QwenConfig as JaxQwenConfig
from genrec_tpu.models.backbones.qwen import QwenLM as JaxQwenLM
from genrec_tpu.ops.schedules import cosine_schedule_with_warmup as jax_cosine
from genrec_tpu.trainers import lcrec_trainer as jax_lcrec_trainer
from genrec_tpu_torch.convert import lora_from_flax, qwen_params_from_flax
from genrec_tpu_torch.core import chaos
from genrec_tpu_torch.core import lora as tlora
from genrec_tpu_torch.core.checkpoint import load_params, read_record
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data.lcrec_tasks import synthetic_lcrec_data
from genrec_tpu_torch.kernels import fused_ce as fc
from genrec_tpu_torch.models import lcrec as tl
from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM, qwen_init_params
from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
from genrec_tpu_torch.trainers import lcrec_trainer

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
BASE, C, K = 90, 3, 8
LIVE = BASE + C * K
CFG = dict(vocab_size=BASE, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
           rope_theta=10000.0, tie_word_embeddings=False)
RANK, ALPHA = 4, 8.0
LR, WARMUP, STEPS, WD = 1e-2, 2, 5, 0.01


@pytest.fixture(scope="module")
def setup():
    """JAX model + params (codebook tokens appended), JAX adapters with a
    nonzero B (so A's gradient is nonzero too), and the port's model on
    the same weights with the same adapters."""
    cfg0 = JaxQwenConfig(**CFG)
    params = JaxQwenLM(cfg0).init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    cfg, params, _ = jl.extend_vocab(cfg0, params, C, K, jax.random.key(1), pad_to=8)
    lora = jlora.lora_init(params, jax.random.key(2), RANK)
    rng = np.random.default_rng(0)
    lora = {p: {"a": v["a"], "b": jnp.asarray(rng.normal(size=v["b"].shape) * 0.1,
                                              jnp.float32)} for p, v in lora.items()}
    pcfg = QwenConfig(**{**CFG, "vocab_size": 120})
    model = QwenLM(pcfg, device="cpu")
    model.load_state_dict(qwen_params_from_flax(jax.device_get(params), pcfg))
    for p in model.parameters():
        p.requires_grad_(False)
    return JaxQwenLM(cfg), params, lora, model, lora_from_flax(jax.device_get(lora), pcfg)


def _batch(seed=0, Bn=4, Ln=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, LIVE, (Bn, Ln)).astype(np.int32)
    mask = np.ones((Bn, Ln), np.int32)
    mask[seed % Bn, :3] = 0
    labels = np.where(rng.random((Bn, Ln)) < 0.4, -100, ids).astype(np.int32)
    labels[mask == 0] = -100
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def _near_grad(got, want, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, f"{name}: max abs err {err} > 1e-5 x {scale}"


def test_merge_through_lora_from_flax_matches_jax(setup):
    jm, params, lora, model, plora = setup
    assert set(plora) == {f"layers.{i}.self_attn.{t}.weight" for i in range(2)
                          for t in ("q_proj", "v_proj")}
    assert tlora.lora_param_count(plora) == jlora.lora_param_count(lora)
    want = qwen_params_from_flax(jax.device_get(jlora.lora_merge(params, lora, ALPHA, RANK)),
                                 model.cfg)
    got = tlora.lora_merge(dict(model.named_parameters()), plora, ALPHA, RANK)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        if name not in plora:
            assert got[name] is dict(model.named_parameters())[name]


def test_port_lora_init_starts_at_the_base(setup):
    *_, model, _ = setup
    base = dict(model.named_parameters())
    lora = tlora.lora_init(base, torch.Generator().manual_seed(0), RANK, ("q_proj", "v_proj"))
    assert set(lora) == {f"layers.{i}.self_attn.{t}.weight" for i in range(2)
                         for t in ("q_proj", "v_proj")}
    for name, f in lora.items():
        d_out, d_in = base[name].shape
        assert f["a"].shape == (d_in, RANK) and f["b"].shape == (RANK, d_out)
        assert float(f["b"].abs().max()) == 0.0 and float(f["a"].abs().max()) > 0
        assert 0.5 / RANK < float(f["a"].std()) < 1.5 / RANK  # N(0, 1) / rank
    merged = tlora.lora_merge(base, lora, ALPHA, RANK)
    for name, w in base.items():
        assert torch.equal(merged[name], w), name


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_adapter_gradients_match_jax(setup, fused):
    jm, params, lora, model, plora = setup
    batch = _batch()

    def jax_loss(lp):
        merged = jlora.lora_merge(params, lp, ALPHA, RANK)
        return jl.sft_loss(jm, merged, batch["input_ids"], batch["attention_mask"],
                           batch["labels"], valid_vocab=LIVE, use_fused_ce=fused)

    want, want_g = jax.jit(jax.value_and_grad(jax_loss))(lora)
    adapters = tlora.LoraAdapters({n: {k: v.clone() for k, v in f.items()}
                                   for n, f in plora.items()})
    loss_fn = lcrec_trainer.lora_loss_fn(model, lambda m, b: tl.sft_loss(
        m, b["input_ids"], b["attention_mask"], b["labels"], valid_vocab=LIVE,
        use_fused_ce=fused), ALPHA, RANK)
    loss, _ = loss_fn(adapters, {k: torch.as_tensor(v) for k, v in batch.items()}, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    want_g = lora_from_flax(jax.device_get(want_g), model.cfg)
    for name, f in adapters.tree().items():
        for k in ("a", "b"):
            _near_grad(f[k].grad.numpy(), want_g[name][k].numpy(), f"{name}/{k}")
    assert all(p.grad is None for p in model.parameters())  # the base is frozen


def test_lora_train_steps_match_jax(setup):
    jm, params, lora, model, plora = setup
    batches = [_batch(seed) for seed in range(STEPS)]
    opt = optax.adamw(jax_cosine(LR, WARMUP, STEPS), weight_decay=WD)

    def jax_loss(lp, batch, rng):
        merged = jlora.lora_merge(params, lp, ALPHA, RANK)
        return jl.sft_loss(jm, merged, batch["input_ids"], batch["attention_mask"],
                           batch["labels"], valid_vocab=LIVE, use_fused_ce=True), {}

    step = jax.jit(jax_make_train_step(jax_loss, opt, clip_norm=1.0))
    state = JaxTrainState.create(lora, opt, jax.random.key(0))
    want = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(m["loss"]), float(m["grad_norm"])))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    adapters = tlora.LoraAdapters({n: {k: v.clone() for k, v in f.items()}
                                   for n, f in plora.items()})
    popt = Adam(cosine_schedule_with_warmup(LR, WARMUP, STEPS), weight_decay=WD)
    pstep = make_train_step(lcrec_trainer.lora_loss_fn(model, lambda m, b: tl.sft_loss(
        m, b["input_ids"], b["attention_mask"], b["labels"], valid_vocab=LIVE,
        use_fused_ce=True), ALPHA, RANK), popt, clip_norm=1.0)
    pstate = TrainState.create(adapters, popt, 0)
    got = []
    for b in batches:
        pstate, m = pstep(pstate, {k: torch.as_tensor(v) for k, v in b.items()})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), f"the frozen base changed: {k}"
    want_lora = lora_from_flax(jax.device_get(state.params), model.cfg)
    for name, f in adapters.tree().items():
        for k in ("a", "b"):
            np.testing.assert_allclose(f[k].detach().numpy(), want_lora[name][k].numpy(),
                                       atol=1e-5 * LR * 10, rtol=0, err_msg=f"{name}/{k}")


TRAIN = dict(epochs=2, batch_size=16, max_train_samples=64, max_eval_samples=16,
             eval_items_limit=16, eval_every_epoch=1, amp=False, device="cpu",
             wandb_log_interval=1, hidden_size=32, intermediate_size=64, n_layers=1,
             num_heads=2, num_kv_heads=2, max_text_len=64, eval_item_tasks=False,
             save_every_epoch=1, use_lora=True, lora_rank=RANK, lora_alpha=ALPHA, seed=0)


def _losses(save_dir):
    out = {}
    for line in open(os.path.join(save_dir, "metrics.jsonl")):
        rec = json.loads(line)
        if "train/loss" in rec and "global_step" in rec:
            assert int(rec["global_step"]) not in out
            out[int(rec["global_step"])] = rec["train/loss"]
    return out


def _jax_trainer_init(seed=0, num_codebooks=3, codebook_size=8):
    """The JAX trainer's own init at TRAIN's widths: the backbone from
    init_rng, the codebook rows from vocab_rng, the adapters from
    fold_in(key(seed), 7) (JAX ``trainers/lcrec_trainer.py:325-536``)."""
    _, tok = jax_synthetic_lcrec_data(codebook_size=codebook_size,
                                      num_codebooks=num_codebooks, seed=seed)
    cfg = JaxQwenConfig(vocab_size=tok.base_vocab, hidden_size=TRAIN["hidden_size"],
                        intermediate_size=TRAIN["intermediate_size"],
                        num_hidden_layers=TRAIN["n_layers"],
                        num_attention_heads=TRAIN["num_heads"],
                        num_key_value_heads=TRAIN["num_kv_heads"],
                        max_position_embeddings=TRAIN["max_text_len"] + num_codebooks + 1,
                        rope_theta=10000.0, tie_word_embeddings=False)
    rng = jax.random.key(seed)
    init_rng, vocab_rng, _ = jax.random.split(rng, 3)
    params = JaxQwenLM(cfg).init(init_rng, jnp.zeros((1, 4), jnp.int32))["params"]
    _, params, _ = jl.extend_vocab(cfg, params, num_codebooks, codebook_size, vocab_rng,
                                   base=tok.base_vocab, pad_to=8)
    lora = jlora.lora_init(params, jax.random.fold_in(rng, 7), RANK)
    return jax.device_get(params), jax.device_get(lora)


def test_lora_trainer_matches_jax_end_to_end(monkeypatch, tmp_path):
    """lcrec_trainer.train(use_lora=True) from the JAX trainer's base and
    adapters (the port's extend_vocab and lora_init pointed at them): the
    per-step losses at 1e-5 and equal eval metrics, so the adapters' wiring
    (the optimizer and schedule over them, the merged-weight eval) is JAX's."""
    params, lora = _jax_trainer_init()
    real_extend = lcrec_trainer.extend_vocab
    cfgs = []

    def extend_vocab(cfg, full, *args, **kwargs):
        cfg, _, base = real_extend(cfg, full, *args, **kwargs)
        cfgs.append(cfg)
        return cfg, qwen_params_from_flax(params, cfg), base

    def lora_init(named, generator, rank, targets):
        assert rank == RANK and tuple(targets) == ("q_proj", "v_proj")
        return lora_from_flax(lora, cfgs[-1])

    monkeypatch.setattr(lcrec_trainer, "extend_vocab", extend_vocab)
    monkeypatch.setattr(lcrec_trainer, "lora_init", lora_init)
    # LR 1e-2 after a 2-step warm-up, so that the adapters move the loss
    # well past the tolerance within the run.
    kw = dict(TRAIN, learning_rate=LR, num_warmup_steps=WARMUP)
    want_m = jax_lcrec_trainer.train(save_dir_root=str(tmp_path / "jax"),
                                     **{k: v for k, v in kw.items() if k != "device"})
    got_m = lcrec_trainer.train(save_dir_root=str(tmp_path / "port"), **kw)
    want, got = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) == 8
    np.testing.assert_allclose([got[s] for s in sorted(got)], [want[s] for s in sorted(want)],
                               **TOL)
    assert got_m == want_m and "Recall@10" in got_m[0]


def _final_point(save_dir):
    ck = os.path.join(save_dir, "checkpoints")
    steps = sorted(int(s) for s in os.listdir(ck) if s.isdigit())
    flat = read_record(os.path.join(ck, str(steps[-1])))
    return steps, {k: v for k, v in flat.items() if k.startswith("state/")}


def test_lora_trainer_saves_adapters_and_resumes_exactly(tmp_path):
    dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
    valid, test = lcrec_trainer.train(save_dir_root=dir_a, **TRAIN)
    assert all(np.isfinite(v) for v in (*valid.values(), *test.values()))
    steps_a, fin_a = _final_point(dir_a)
    model_keys = sorted(k for k in fin_a if k.startswith("state/model/"))
    # The resume point holds the adapters (and their Adam moments) only.
    assert model_keys and all(k.startswith(("state/model/a.", "state/model/b."))
                              for k in model_keys), model_keys
    assert len(model_keys) == 2 * 2  # one layer: q_proj and v_proj, a and b
    assert not any(k.startswith("state/model/layers") for k in fin_a)
    like = {k.removeprefix("state/model/"): fin_a[k] for k in model_keys}
    best = load_params(os.path.join(dir_a, "best_model"), like=like)
    assert set(best) == set(like)
    # final_model: the base (the trainer's init, rebuilt here) merged with
    # the best adapters, under the base's names.
    data, tok = synthetic_lcrec_data(codebook_size=8, num_codebooks=3, seed=0)
    cfg = QwenConfig(vocab_size=tok.base_vocab, hidden_size=32, intermediate_size=64,
                     num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
                     max_position_embeddings=64 + 3 + 1, rope_theta=10000.0,
                     tie_word_embeddings=False)
    cfg, base, _ = tl.extend_vocab(cfg, qwen_init_params(cfg, 0, "cpu"), 3, 8,
                                   torch.Generator().manual_seed(1), base=tok.base_vocab, pad_to=8)
    adapters = tlora.LoraAdapters({n.replace("/", "."): {"a": best[f"a.{n}"], "b": best[f"b.{n}"]}
                                   for n in {k[2:] for k in best}})
    want = tlora.lora_merge(base, adapters.tree(), ALPHA, RANK)
    final = read_record(os.path.join(dir_a, "final_model"))
    assert set(final) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(final[name].numpy(), w.detach().numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert not torch.equal(final["layers.0.self_attn.q_proj.weight"],
                           base["layers.0.self_attn.q_proj.weight"])

    with chaos.inject(chaos.ChaosPlan(kill_at_step=3)):  # 4 steps an epoch
        assert lcrec_trainer.train(save_dir_root=dir_b, **TRAIN) == ({}, {})
    lcrec_trainer.train(save_dir_root=dir_b, resume_from_checkpoint=True, **TRAIN)
    assert _losses(dir_a) == _losses(dir_b) and len(_losses(dir_a)) == 8
    steps_b, fin_b = _final_point(dir_b)
    assert steps_a[-1] == steps_b[-1] and 3 in steps_b
    assert fin_a.keys() == fin_b.keys()
    for k in fin_a:
        assert torch.equal(fin_a[k], fin_b[k]), k


class _Counting:
    """A plain version that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


class _OneRank:
    """A group of one rank: every collective is the identity."""

    rank, size = 0, 1

    @staticmethod
    def all_reduce(x, op="sum"):
        return x


@pytest.mark.parametrize("sharded", [False, True], ids=["fused", "sharded"])
def test_frozen_head_launches_no_dw(monkeypatch, sharded):
    fwd, dx, dw = (_Counting(f) for f in fc._versions(False))
    monkeypatch.setattr(fc, "_versions", lambda kernels: (fwd, dx, dw))
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(12, 16)).astype(np.float32)).requires_grad_()
    w = torch.as_tensor(rng.normal(size=(30, 16)).astype(np.float32))  # frozen
    t = torch.as_tensor(rng.integers(0, 30, 12).astype(np.int32))
    t[3] = -100
    if sharded:
        loss = fc.sharded_fused_linear_ce_ref(x, w, t, _OneRank(), -100, 30)
    else:
        loss = fc.fused_linear_ce(x, w, t, -100)
    loss.sum().backward()
    assert (fwd.calls, dx.calls, dw.calls) == (1, 1, 0)
    assert w.grad is None and x.grad is not None
    # Asked for both: both run, as every existing path asks.
    w.requires_grad_()
    x.grad = None
    loss = (fc.sharded_fused_linear_ce_ref(x, w, t, _OneRank(), -100, 30) if sharded
            else fc.fused_linear_ce(x, w, t, -100))
    loss.sum().backward()
    assert (fwd.calls, dx.calls, dw.calls) == (2, 2, 1) and w.grad is not None
