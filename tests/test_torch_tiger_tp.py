"""TIGER under tensor parallelism (JAX ``parallel/shardings.tiger_rules``),
port against the JAX package, on gloo CPU ranks.

- The padded vocabulary is inert: a port model with pad_vocab_to=4 and
  garbage in its pad rows and columns gives JAX's unpadded logits and loss
  (tests/test_tp_sharding.py:60).
- tensor_parallel=2 (2 ranks through ``parallel.mesh.spawn``): the loss
  equals JAX's replicated loss, and every gradient, gathered over the
  ranks, equals ``jax.grad``'s (tests/test_tp_sharding.py:105).
- Five train steps at tp=2 (AdamW after a cosine warm-up, clip 1.0, the
  clip's norm summed over the group) against JAX's steps on a dp x tp
  mesh (tests/test_tiger.py:338), from the same converted parameters.
- ``tiger_trainer.train(tensor_parallel=2)`` end to end at dropout 0.1
  against tensor_parallel=1 from the same seed (each rank draws the
  full-width FFN dropout mask and keeps its block), the ranks reporting
  the same metrics; a run killed on rank 1 and resumed against an
  uninterrupted one, bit for bit; the two ranks at tensor_parallel=1
  train data-parallel (tests/test_torch_dp_2d.py holds tp x dp), and a
  tensor_parallel the world does not divide raises.

Tolerances: 1e-5 relative, fp32 on both sides (sums in other orders:
the FFN's partial outputs are summed over the ranks).
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genrec_tpu.core.harness import make_train_step as jax_make_train_step
from genrec_tpu.core.state import TrainState as JaxTrainState
from genrec_tpu.models.tiger import Tiger as JaxTiger
from genrec_tpu.ops.schedules import cosine_schedule_with_warmup as jax_cosine
from genrec_tpu.parallel import make_mesh, shard_batch
from genrec_tpu.parallel.shardings import shard_params, tiger_rules
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.core import chaos
from genrec_tpu_torch.core.checkpoint import read_record
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.models.tiger import Tiger
from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
from genrec_tpu_torch.parallel.mesh import spawn
from genrec_tpu_torch.parallel.shardings import tiger_shard_dim
from genrec_tpu_torch.trainers import tiger_trainer

torch.set_num_threads(1)

SMALL = dict(embedding_dim=16, attn_dim=32, num_heads=2, n_layers=2, num_item_embeddings=8,
             num_user_embeddings=16, sem_id_dim=3, max_pos=64)
STEP_MODEL = dict(SMALL, num_heads=4, pad_vocab_to=2)
LR, WARMUP, STEPS, WD = 1e-3, 2, 5, 0.035
TRAIN = dict(epochs=2, batch_size=16, learning_rate=1e-3, num_warmup_steps=5, embedding_dim=16,
             attn_dim=32, num_heads=4, n_layers=2, sem_id_dim=2, codebook_size=16, max_items=4,
             num_users=60, num_user_embeddings=64, dataset="synthetic", do_eval=True,
             eval_every_epoch=2, eval_batch_size=32, save_every_epoch=1, wandb_log_interval=1,
             amp=False, dropout=0.1, pack_sequences=True, seed=0, device="cpu")


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test fails after 150 s instead of hanging."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 150 s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(150)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _batch(B=8, items=4, D=3, seed=0):
    rng = np.random.default_rng(seed)
    L = items * D
    return dict(user_ids=rng.integers(0, 16, (B,)).astype(np.int32),
                item_input_ids=rng.integers(0, 8, (B, L)).astype(np.int32),
                token_type_ids=np.tile(np.arange(D, dtype=np.int32), (B, items)),
                target_ids=rng.integers(0, 8, (B, D)).astype(np.int32),
                seq_mask=np.ones((B, L), np.int32))


def _jax_args(b):
    B, D = b["target_ids"].shape
    return (jnp.asarray(b["user_ids"]), jnp.asarray(b["item_input_ids"]),
            jnp.asarray(b["token_type_ids"]), jnp.asarray(b["target_ids"]),
            jnp.broadcast_to(jnp.arange(D), (B, D)), jnp.asarray(b["seq_mask"]))


def _port_args(b):
    B, D = b["target_ids"].shape
    t = {k: torch.as_tensor(v).long() for k, v in b.items()}
    return (t["user_ids"], t["item_input_ids"], t["token_type_ids"], t["target_ids"],
            torch.arange(D).expand(B, D), t["seq_mask"])


def _jax_init(model, b):
    return model.init(jax.random.key(0), *_jax_args(b))["params"]


def _port_model(params, cfg, group=None, tp=1):
    model = Tiger(**cfg, device="cpu", group=group)
    model.load_state_dict(tiger_params_from_flax(params, model, 0 if group is None
                                                 else group.rank, tp))
    return model


def _port_loss_and_grads(group, params):
    model = _port_model(params, dict(SMALL, pad_vocab_to=2), group, 2)
    out = model(*_port_args(_batch()))
    out.loss.backward()
    return float(out.loss), {n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None}


def _port_steps(group, params, batches):
    model = _port_model(params, STEP_MODEL, group, 2)
    opt = Adam(cosine_schedule_with_warmup(LR, WARMUP, STEPS), weight_decay=WD)

    def loss_fn(m, b, g):
        return m(*_port_args(b)).loss, {}

    step = make_train_step(loss_fn, opt, clip_norm=1.0, group=group)
    state = TrainState.create(model, opt, 0)
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _steps_of(save_dir, rank):
    root = os.path.join(save_dir, "checkpoints", f"p{rank}")
    return sorted(int(s) for s in os.listdir(root) if s.isdigit())


def _final_point(save_dir, rank):
    step = _steps_of(save_dir, rank)[-1]
    flat = read_record(os.path.join(save_dir, "checkpoints", f"p{rank}", str(step)))
    return step, {k: v for k, v in flat.items() if k.startswith("state/")}


def _ranks(group, grad_params, step_params, batches, root):
    """Rank side: loss and gradients, five steps, train() at tp=2, a
    killed-and-resumed tp=2 run, a data-parallel run and a refused layout."""
    torch.set_num_threads(1)
    loss = _port_loss_and_grads(group, grad_params)
    steps = _port_steps(group, step_params, batches)
    cfg = dict(TRAIN, tensor_parallel=2)
    dir_a, dir_b = os.path.join(root, "uninterrupted"), os.path.join(root, "interrupted")
    metrics = tiger_trainer.train(**cfg, save_dir_root=dir_a)
    n = _steps_of(dir_a, group.rank)[-1]
    kill = n // 2 + 1  # the ranks poll their OR every 8 steps
    with chaos.inject(chaos.ChaosPlan(kill_at_step=kill, only_process=1)):
        killed = tiger_trainer.train(**cfg, save_dir_root=dir_b)
    killed_steps = _steps_of(dir_b, group.rank)
    tiger_trainer.train(**cfg, save_dir_root=dir_b, resume_from_checkpoint=True)
    fa, fb = _final_point(dir_a, group.rank), _final_point(dir_b, group.rank)
    resumed_equal = fa[0] == fb[0] and fa[1].keys() == fb[1].keys() and all(
        torch.equal(fa[1][k], fb[1][k]) for k in fa[1])
    # Data parallelism is ported (A17): tensor_parallel=1 on two ranks
    # trains data-parallel; a tensor_parallel the world does not divide
    # raises.
    dp_metrics = tiger_trainer.train(**dict(TRAIN, epochs=1), save_dir_root=None)
    try:
        tiger_trainer.train(**dict(TRAIN, epochs=1, tensor_parallel=3), save_dir_root=None)
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(loss=loss, steps=steps, metrics=metrics, n=n, kill=kill, killed=killed,
                killed_steps=killed_steps, resumed_equal=resumed_equal, refused=refused,
                dp_metrics=dp_metrics)


def _step_batches():
    return [_batch(B=16, seed=s) for s in range(STEPS)]


@pytest.fixture(scope="module")
def grad_params():
    return jax.device_get(_jax_init(JaxTiger(dropout=0.0, **SMALL, pad_vocab_to=2), _batch()))


@pytest.fixture(scope="module")
def step_params():
    return jax.device_get(_jax_init(JaxTiger(dropout=0.0, **STEP_MODEL), _batch(B=16)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, grad_params, step_params):
    root = str(tmp_path_factory.mktemp("tiger_tp2"))
    batches = [{k: torch.as_tensor(v) for k, v in b.items()} for b in _step_batches()]
    out = spawn(_ranks, 2, (grad_params, step_params, batches, root), device="cpu",
                threads=1, timeout_s=600, store_dir=tmp_path_factory.mktemp("store"))
    return out, root


def test_padded_vocab_is_inert():
    b = _batch()
    jm = JaxTiger(dropout=0.0, **SMALL)
    p1 = jax.device_get(_jax_init(jm, b))
    want = jm.apply({"params": p1}, *_jax_args(b))
    rng = np.random.default_rng(1)
    p4 = dict(p1)
    head = np.asarray(p1["output_head"]["kernel"])
    p4["output_head"] = {"kernel": np.concatenate(
        [head, rng.normal(size=(head.shape[0], 3)).astype(np.float32)], 1)}
    tab = np.asarray(p1["sem_id_embedding"]["embedding"])
    p4["sem_id_embedding"] = {"embedding": np.concatenate(
        [tab, rng.normal(size=(3, tab.shape[1])).astype(np.float32)], 0)}
    model = _port_model(p4, dict(SMALL, pad_vocab_to=4))
    assert model.vocab_size == 25 and model.padded_vocab_size == 28
    with torch.no_grad():
        got = model(*_port_args(b))
    np.testing.assert_allclose(got.logits[..., :25].numpy(), np.asarray(want.logits), atol=1e-5)
    np.testing.assert_allclose(float(got.loss), float(want.loss), atol=1e-5)


def test_tp2_loss_and_gradients_match_jax(ranks, grad_params):
    (r0, r1), _ = ranks
    jm = JaxTiger(dropout=0.0, **SMALL, pad_vocab_to=2)
    b = _batch()
    want, jgrads = jax.value_and_grad(lambda p: jm.apply({"params": p}, *_jax_args(b)).loss)(
        grad_params)
    assert r0["loss"][0] == r1["loss"][0]
    np.testing.assert_allclose(r0["loss"][0], float(want), rtol=1e-5)
    model = Tiger(**SMALL, pad_vocab_to=2, device="cpu")
    want_grads = tiger_params_from_flax(jax.device_get(jgrads), model)
    g0, g1 = r0["loss"][1], r1["loss"][1]
    unused = set(want_grads) - set(g0)  # parameters the forward never reads
    assert unused == {"pos_embedding", "decoder_pos_embedding"}
    assert all(float(want_grads[n].abs().max()) == 0.0 for n in unused)
    for name, w in want_grads.items():
        if name in unused:
            continue
        dim = tiger_shard_dim(name)
        if dim is None:
            assert torch.equal(g0[name], g1[name]), name  # replicated: the same bits
            got = g0[name]
        else:
            got = torch.cat([g0[name], g1[name]], dim=dim)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()) + 1e-12, err_msg=name)


def test_five_tp2_steps_match_jax_dp_tp_mesh(ranks, step_params):
    (r0, r1), _ = ranks
    jm = JaxTiger(dropout=0.0, **STEP_MODEL)
    opt = optax.adamw(jax_cosine(LR, WARMUP, STEPS), weight_decay=WD)

    def loss_fn(p, b, key):
        return jm.apply({"params": p}, *_jax_args(b)).loss, {}

    step = jax.jit(jax_make_train_step(loss_fn, opt, clip_norm=1.0))
    mesh = make_mesh({"data": 4, "model": 2})
    fallbacks = []
    state = JaxTrainState.create(shard_params(mesh, step_params, tiger_rules(),
                                              log_fn=fallbacks.append), opt, jax.random.key(1))
    assert not fallbacks, fallbacks
    want = []
    for b in _step_batches():
        state, m = step(state, shard_batch(mesh, {k: jnp.asarray(v) for k, v in b.items()}))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    assert r0["steps"] == r1["steps"]  # every rank sees the same loss and norm
    np.testing.assert_allclose(np.asarray(r0["steps"]), np.asarray(want), rtol=1e-5, atol=0)


def _epoch_losses(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["train/loss"] for r in rows if "epoch" in r and "train/loss" in r]


def test_train_at_tp2_matches_tp1_at_dropout(ranks, tmp_path):
    (r0, r1), root = ranks
    valid1, test1 = tiger_trainer.train(**TRAIN, save_dir_root=str(tmp_path))
    assert r0["metrics"] == r1["metrics"]  # the ranks report the same metrics
    valid2, test2 = r0["metrics"]
    assert set(valid2) == set(valid1) and set(test2) == set(test1)
    assert all(np.isfinite(v) for v in (*valid2.values(), *test2.values()))
    losses2 = _epoch_losses(os.path.join(root, "uninterrupted"))
    losses1 = _epoch_losses(str(tmp_path))
    assert len(losses1) == len(losses2) == TRAIN["epochs"]
    np.testing.assert_allclose(losses2, losses1, rtol=1e-5, atol=0)
    for r in (0, 1):
        assert os.path.exists(os.path.join(root, "uninterrupted", f"final_model.rank{r}"))
        assert os.path.exists(os.path.join(root, "uninterrupted", f"best_model.rank{r}"))


def test_tp2_kill_on_one_rank_resumes_bit_for_bit(ranks):
    (r0, r1), _ = ranks
    assert r0["killed"] == r1["killed"] == ({}, {})
    poll = -(-r0["kill"] // 8) * 8  # the first poll of the OR at or after the kill
    assert poll <= r0["n"]
    assert poll in r0["killed_steps"] and r0["killed_steps"] == r1["killed_steps"]
    assert r0["resumed_equal"] and r1["resumed_equal"]


def test_data_parallelism_beside_tp_names_a17(ranks):
    """A17 is done: two ranks at tensor_parallel=1 train data-parallel and
    report the same metrics; a tensor_parallel that the world does not
    divide is refused as JAX's mesh refuses it."""
    (r0, r1), _ = ranks
    assert r0["dp_metrics"] == r1["dp_metrics"]
    assert all(np.isfinite(v) for m in r0["dp_metrics"] for v in m.values())
    assert "does not divide 2 ranks" in r0["refused"]
