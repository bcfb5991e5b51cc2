"""NoteLLM, port against the JAX package.

genrec_tpu_torch/models/notellm.py pairs with genrec_tpu/models/notellm.py
on the same Flax parameters (``convert.qwen_params_from_flax``),
genrec_tpu_torch/data/notellm_pairs.py with its JAX original, and
genrec_tpu_torch/trainers/notellm_trainer.py with the JAX trainer:

- ``query2embedding_forward`` in fp32: the sentence embedding, the
  contrastive loss, the generation loss, their alpha mix and the
  fully-masked-labels guard, the ``hardneg`` and ``pair_groups`` cases,
  and every parameter's gradient (tau's too) against ``jax.grad``;
- ``paired_topk_accuracy`` with planted ties (lower index first);
- ``add_emb_token``: the shapes and the token's id;
- the train loop counts a pair row as two sequences;
- the trainer's step (losses and tau for five steps) and ``train()``
  end to end at fp32 (per-step losses, the final eval metric equal),
  from the JAX trainer's own initial parameters;
- an exact resume of ``train()`` after a mid-epoch SIGTERM.

Tiny backbone: 2 layers, hidden 32, 4 heads / 2 KV heads, 40 base tokens
+ [EMB]. Tolerances, fp32 on both sides: values 1e-5 absolute plus 1e-5
relative; a gradient 1e-5 of its largest element (sums over every
token's path in another order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genrec_tpu.core.harness import make_train_step as jax_make_train_step
from genrec_tpu.core.state import TrainState as JaxTrainState
from genrec_tpu.data.notellm_pairs import NoteLLMPairData as JaxPairData
from genrec_tpu.models import notellm as jn
from genrec_tpu.models.backbones.qwen import QwenConfig as JaxQwenConfig
from genrec_tpu.models.backbones.qwen import QwenLM as JaxQwenLM
from genrec_tpu.ops.schedules import cosine_schedule_with_warmup as jax_cosine
from genrec_tpu.trainers import notellm_trainer as jax_trainer
from genrec_tpu_torch.convert import notellm_params_from_flax, qwen_params_from_flax
from genrec_tpu_torch.core import chaos
from genrec_tpu_torch.core.checkpoint import read_record
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data.notellm_pairs import NoteLLMPairData
from genrec_tpu_torch.models import notellm as tn
from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM, qwen_init_params
from genrec_tpu_torch.trainers import notellm_trainer
from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = dict(vocab_size=40, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
           rope_theta=10000.0, tie_word_embeddings=False)
B, L = 8, 10  # 4 pairs


def _near_grad(got, want, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * max(scale, 1e-30), f"{name}: max abs err {err} > 1e-5 x {scale}"


@pytest.fixture(scope="module")
def tiny():
    """JAX model + params with [EMB] appended, the port's model on the
    same weights, and the token's id."""
    cfg0 = JaxQwenConfig(**CFG)
    params = JaxQwenLM(cfg0).init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    cfg, params, emb_id = jn.add_emb_token(cfg0, params, jax.random.key(1))
    pcfg = QwenConfig(**{**CFG, "vocab_size": cfg.vocab_size})
    model = QwenLM(pcfg, device="cpu")
    model.load_state_dict(qwen_params_from_flax(jax.device_get(params), pcfg))
    return JaxQwenLM(cfg), params, model, emb_id


def _inputs(emb_id, seed=0):
    """Right-padded rows of varied length, [EMB] after each row's text."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, L), np.int32)
    mask = np.zeros((B, L), np.int32)
    emb_idx = np.zeros((B, 1), np.int32)
    for i, n in enumerate(rng.integers(3, L, B)):
        ids[i, :n] = rng.integers(3, 40, n)
        ids[i, n] = emb_id
        mask[i, :n + 1] = 1
        emb_idx[i, 0] = n
    labels = np.where((rng.random((B, L)) < 0.5) & (mask > 0), ids, -100).astype(np.int32)
    return dict(input_ids=ids, attention_mask=mask, emb_idx=emb_idx, labels=labels,
                hardneg=np.array([False, True, False, True]),
                pair_groups=np.array([3, 5, 3, 7], np.int32))


CASES = {
    "plain": dict(),
    "labels": dict(labels=True, alpha=0.3),
    "masked_labels": dict(labels="masked", alpha=0.3),
    "hardneg": dict(hardneg=True, hardneg_r=0.2),
    "pair_groups": dict(pair_groups=True),
    "all": dict(labels=True, hardneg=True, pair_groups=True, alpha=0.05),
}


def _kwargs(case, x, lib):
    """The optional arguments of ``case`` as arrays of ``lib``."""
    as_ = jnp.asarray if lib == "jax" else torch.as_tensor
    kw = {}
    spec = CASES[case]
    if spec.get("labels"):
        labels = x["labels"] if spec["labels"] is True else np.full_like(x["labels"], -100)
        kw["labels"] = as_(labels)
    for name in ("hardneg", "pair_groups"):
        if spec.get(name):
            kw[name] = as_(x[name])
    kw.update({k: v for k, v in spec.items() if k in ("alpha", "hardneg_r")})
    return kw


def _jax_out(jm, params, x, tau, case):
    return jn.query2embedding_forward(
        jm, params, *(jnp.asarray(x[k]) for k in ("input_ids", "attention_mask", "emb_idx")),
        jnp.asarray(tau, jnp.float32), **_kwargs(case, x, "jax"))


def _port_out(model, x, tau, case):
    return tn.query2embedding_forward(
        model, *(torch.as_tensor(x[k]) for k in ("input_ids", "attention_mask", "emb_idx")),
        tau, **_kwargs(case, x, "torch"))


@pytest.mark.parametrize("case", list(CASES))
def test_query2embedding_forward_matches_jax(tiny, case):
    jm, params, model, emb_id = tiny
    x = _inputs(emb_id)
    want = _jax_out(jm, params, x, 3.0, case)
    with torch.no_grad():
        got = _port_out(model, x, torch.tensor(3.0), case)
    np.testing.assert_allclose(got.sentence_embedding.numpy(),
                               np.asarray(want.sentence_embedding), **TOL)
    np.testing.assert_allclose(np.linalg.norm(got.sentence_embedding.numpy(), axis=1),
                               np.ones(B), atol=1e-5)
    for name in ("loss", "cl_loss", "gen_loss"):
        w = getattr(want, name)
        g = getattr(got, name)
        assert (g is None) == (w is None), name
        if w is not None:
            np.testing.assert_allclose(g.item(), float(w), **TOL, err_msg=name)
    if CASES[case].get("labels") == "masked":
        # Fully-masked labels: the pure contrastive loss, not cl / (1 + alpha).
        assert got.loss.item() == got.cl_loss.item()
    elif CASES[case].get("labels"):
        alpha = CASES[case]["alpha"]
        np.testing.assert_allclose(got.loss.item(), (got.cl_loss.item()
                                                     + got.gen_loss.item() * alpha) / (1 + alpha),
                                   rtol=1e-6)
    # Embedding only: no loss, no head.
    with torch.no_grad():
        emb = tn.query2embedding_forward(
            model, *(torch.as_tensor(x[k]) for k in ("input_ids", "attention_mask", "emb_idx")),
            torch.tensor(3.0), return_loss=False)
    assert emb.loss is None and torch.equal(emb.sentence_embedding, got.sentence_embedding)


@pytest.mark.parametrize("case", ["labels", "all"])
def test_gradients_match_jax(tiny, case):
    jm, params, model, emb_id = tiny
    x = _inputs(emb_id, seed=1)
    want_loss, (want_g, want_tau) = jax.value_and_grad(
        lambda p, t: _jax_out(jm, p, x, t, case).loss, argnums=(0, 1))(params, jnp.float32(2.5))
    tau = torch.tensor(2.5, requires_grad=True)
    model.zero_grad()
    loss = _port_out(model, x, tau, case).loss
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    np.testing.assert_allclose(tau.grad.item(), float(want_tau), **TOL)
    want_g = qwen_params_from_flax(jax.device_get(want_g), model.cfg)
    for name, p in model.named_parameters():
        _near_grad(p.grad.numpy(), want_g[name].numpy(), name)
    model.zero_grad()


@pytest.mark.parametrize("topk", [1, 2, 5, 20])
def test_paired_topk_accuracy_matches_jax_with_ties(topk):
    rng = np.random.default_rng(0)
    base = rng.normal(size=(6, 8)).astype(np.float32)
    q = base[[0, 1, 1, 2, 3, 3, 4, 5, 0, 2]]  # repeated queries: exact ties
    p = base[[0, 1, 1, 2, 3, 5, 4, 0, 0, 1]]
    emb = np.empty((20, 8), np.float32)
    emb[::2], emb[1::2] = q, p
    want = jn.paired_topk_accuracy(jnp.asarray(emb), topk=topk)
    assert tn.paired_topk_accuracy(torch.as_tensor(emb), topk=topk) == want


def test_add_emb_token_shapes_and_id():
    cfg0 = QwenConfig(**CFG)
    full = qwen_init_params(cfg0, seed=0, device="cpu")
    cfg, new, emb_id = tn.add_emb_token(cfg0, full, torch.Generator().manual_seed(0))
    jcfg, jnew, jemb = jn.add_emb_token(
        JaxQwenConfig(**CFG), {"embed_tokens": jnp.zeros((40, 32)), "lm_head": jnp.zeros((40, 32))},
        jax.random.key(0))
    assert (cfg.vocab_size, emb_id) == (jcfg.vocab_size, jemb) == (41, 40)
    for name in ("embed_tokens.weight", "lm_head"):
        assert new[name].shape == (41, 32)
        torch.testing.assert_close(new[name][:40], full[name], rtol=0, atol=0)
        assert float(new[name][40].abs().min()) > 0


def test_pair_data_matches_jax():
    data = NoteLLMPairData(num_topics=8, eval_topics=2, max_len=10, seed=3)
    jdata = JaxPairData(num_topics=8, eval_topics=2, max_len=10, seed=3)
    assert data.emb_id == jdata.emb_id and data.tokenizer.vocab_size == jdata.tokenizer.vocab_size
    for got, want in ((data.train_arrays(3), jdata.train_arrays(3)),
                      (data.eval_arrays(), jdata.eval_arrays())):
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pair_rows_count_two_sequences_a_step():
    """seq/s counts sequences: the loop reads a (P, 2, L) pair row as two,
    as JAX's ``examples_per_row=2.0`` does, and a (N, L) row as one."""
    arrays = NoteLLMPairData(num_topics=8, eval_topics=2, max_len=10, seed=3).train_arrays(3)
    assert arrays["input_ids"].shape[1:] == (2, 10)
    for rows, per_row in ((arrays, 2.0), ({"input_ids": arrays["input_ids"][:, 0]}, 1.0)):
        loop = PackedTrainLoop(logger=notellm_trainer.setup_logger(None),
                               tracker=notellm_trainer.Tracker(), device="cpu",
                               rows_per_step=4, row_len=10, seed=0, pack_sequences=False,
                               train_arrays=rows)
        assert loop.examples_per_step == 4 * per_row


# -- the trainer ---------------------------------------------------------------

TRAIN = dict(epochs=2, batch_pairs=16, learning_rate=1e-3, num_warmup_steps=3, weight_decay=0.01,
             max_text_len=12, num_topics=16, eval_topics=16, pairs_per_topic=4, hidden_size=32,
             intermediate_size=64, n_layers=2, num_heads=4, num_kv_heads=2, tau_init=3.0,
             eval_topk=5, do_eval=True, eval_every_epoch=1, eval_batch_pairs=16,
             save_every_epoch=10, wandb_log_interval=1, amp=False, seed=0)


def _jax_trainer_params(cfg_kw, seed=0):
    """The JAX trainer's own initial backbone (its init_rng)."""
    data = JaxPairData(num_topics=cfg_kw["num_topics"], eval_topics=cfg_kw["eval_topics"],
                       max_len=cfg_kw["max_text_len"], seed=seed)
    cfg = JaxQwenConfig(
        vocab_size=data.tokenizer.vocab_size, hidden_size=cfg_kw["hidden_size"],
        intermediate_size=cfg_kw["intermediate_size"], num_hidden_layers=cfg_kw["n_layers"],
        num_attention_heads=cfg_kw["num_heads"], num_key_value_heads=cfg_kw["num_kv_heads"],
        max_position_embeddings=cfg_kw["max_text_len"], rope_theta=10000.0,
        tie_word_embeddings=False)
    init_rng, _ = jax.random.split(jax.random.key(seed))
    return cfg, JaxQwenLM(cfg).init(init_rng, jnp.zeros((1, 4), jnp.int32))["params"]


def _from_jax(monkeypatch, cfg_kw):
    """Point the port trainer's model factory at the JAX trainer's init."""
    _, backbone = _jax_trainer_params(cfg_kw)
    backbone = jax.device_get(backbone)

    def notellm_model(cfg, dtype, seed, tau_init, device):
        model = tn.NoteLLM(QwenLM(cfg, dtype=dtype, device=device), tau_init)
        model.load_state_dict(notellm_params_from_flax(
            {"backbone": backbone, "tau": np.float32(tau_init)}, cfg))
        return model

    monkeypatch.setattr(notellm_trainer, "notellm_model", notellm_model)


def _losses_by_step(save_dir):
    out = {}
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "train/loss" in rec and "global_step" in rec:
                step = int(rec["global_step"])
                assert step not in out, f"step {step} logged twice"
                out[step] = rec["train/loss"]
    return out


def test_trainer_step_matches_jax(monkeypatch):
    """Five steps of the trainer's own loss and optimizer (AdamW that decays
    only 2-D tensors, clip 1.0, tau trained jointly) against the JAX
    trainer's: the losses and tau after every step."""
    jcfg, backbone = _jax_trainer_params(TRAIN)
    data = NoteLLMPairData(num_topics=16, eval_topics=16, max_len=12, seed=0)
    arrays = data.train_arrays(4)
    batches = [{k: v[i * 16:(i + 1) * 16] for k, v in arrays.items()} for i in range(5)]
    jm = JaxQwenLM(jcfg)
    opt = optax.adamw(jax_cosine(1e-3, 2, 5), weight_decay=0.01,
                      mask=lambda p: jax.tree_util.tree_map(lambda x: jnp.ndim(x) >= 2, p))

    def jax_loss(p, batch, rng):
        flat = jax_trainer._flatten_pairs(batch)
        out = jn.query2embedding_forward(jm, p["backbone"], flat["input_ids"],
                                         flat["attention_mask"], flat["emb_idx"], p["tau"],
                                         pair_groups=batch["topic_id"])
        return out.loss, {"cl_loss": out.cl_loss}

    step = jax.jit(jax_make_train_step(jax_loss, opt, clip_norm=1.0))
    state = JaxTrainState.create({"backbone": backbone, "tau": jnp.float32(3.0)}, opt,
                                 jax.random.key(0))
    want = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(m["loss"]), float(m["grad_norm"]), float(state.params["tau"])))

    pcfg = QwenConfig(**{k: getattr(jcfg, k) for k in CFG})
    model = tn.NoteLLM(QwenLM(pcfg, device="cpu"))
    model.load_state_dict(notellm_params_from_flax(
        {"backbone": jax.device_get(backbone), "tau": np.float32(3.0)}, pcfg))
    optimizer = notellm_trainer.make_optimizer(1e-3, 2, 5, 0.01)
    pstep = make_train_step(notellm_trainer.notellm_loss, optimizer, clip_norm=1.0)
    pstate = TrainState.create(model, optimizer, 0)
    lm_head0 = model.backbone.lm_head.detach().clone()
    got = []
    for b in batches:
        pstate, m = pstep(pstate, {k: torch.as_tensor(v) for k, v in b.items()})
        got.append((float(m["loss"]), float(m["grad_norm"]), model.tau.item()))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
    assert got[-1][2] != 3.0  # tau moved
    # The untied head gets no gradient (no logits without labels) but is
    # decayed, as optax decays it.
    np.testing.assert_allclose(model.backbone.lm_head.detach().numpy(),
                               np.asarray(state.params["backbone"]["lm_head"]), atol=1e-7)
    assert not torch.equal(model.backbone.lm_head.detach(), lm_head0)


def test_train_matches_jax_end_to_end(monkeypatch, tmp_path):
    _from_jax(monkeypatch, TRAIN)
    want_m = jax_trainer.train(save_dir_root=str(tmp_path / "jax"), **TRAIN)
    got_m = notellm_trainer.train(save_dir_root=str(tmp_path / "port"), device="cpu", **TRAIN)
    want, got = _losses_by_step(tmp_path / "jax"), _losses_by_step(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) == 8
    np.testing.assert_allclose([got[s] for s in sorted(got)], [want[s] for s in sorted(want)],
                               **TOL)
    assert got_m == want_m and set(got_m) == {"top5_acc"}
    assert (tmp_path / "port" / "best_model").exists()


def test_exact_resume_after_midepoch_sigterm(tmp_path):
    cfg = dict(TRAIN, do_eval=False, save_every_epoch=1, device="cpu")
    dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
    notellm_trainer.train(save_dir_root=dir_a, **cfg)
    with chaos.inject(chaos.ChaosPlan(kill_at_step=3)):  # 4 steps an epoch
        assert notellm_trainer.train(save_dir_root=dir_b, **cfg) == {}
    notellm_trainer.train(save_dir_root=dir_b, resume_from_checkpoint=True, **cfg)
    la, lb = _losses_by_step(dir_a), _losses_by_step(dir_b)
    assert la == lb and sorted(la) == list(range(1, 9))
    points = []
    for d in (dir_a, dir_b):
        ck = os.path.join(d, "checkpoints")
        steps = sorted(int(s) for s in os.listdir(ck) if s.isdigit())
        flat = read_record(os.path.join(ck, str(steps[-1])))
        points.append((steps, {k: v for k, v in flat.items() if k.startswith("state/")}))
    (steps_a, fin_a), (steps_b, fin_b) = points
    assert steps_a[-1] == steps_b[-1] == 8 and 3 in steps_b
    assert fin_a.keys() == fin_b.keys() and "state/model/tau" in fin_a
    for k in fin_a:
        assert torch.equal(fin_a[k], fin_b[k]), k
