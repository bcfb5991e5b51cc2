"""TIGER training, port against the JAX package.

Pairs: genrec_tpu_torch/trainers/tiger_trainer.py's loss and
``core/harness.make_train_step`` with the JAX TIGER trainer's step (its
loss function, optax AdamW on the cosine warm-up schedule, clip 1.0) at
the widths of config/tiger/synthetic.gin, from one init at dropout 0 in
float32 on the same batches: packed rows (accumulation 1 and 2, the
latter with the per-microbatch example-count rescale) and the padded
layout; data/tiger_seq.py with its JAX copy; data/batching.py's
first-fit packer with the JAX scan; and ``train()`` end to end on that
config on the CPU.

Tolerance: per-step losses 1e-5 relative (fp32 on both sides; only the
summation order differs); the pre-clip gradient norms 1e-4 (Adam's
m / sqrt(v) carries ~1e-7 differences of small gradients into the
weights, and the norm of the per-sequence-sum loss's gradient, ~30, reads
them at 1.2e-5 by the fourth step); real-token counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genrec_tpu.core.harness import make_train_step as jax_make_train_step
from genrec_tpu.core.state import TrainState as JaxTrainState
from genrec_tpu.data import batching as jax_batching
from genrec_tpu.data.tiger_seq import synthetic_tiger_data as jax_synthetic_tiger_data
from genrec_tpu.models.tiger import Tiger as JaxTiger
from genrec_tpu.ops.schedules import cosine_schedule_with_warmup as jax_cosine
from genrec_tpu_torch import configlib
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data import batching as tb
from genrec_tpu_torch.data.tiger_seq import synthetic_tiger_data
from genrec_tpu_torch.models.tiger import Tiger
from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
from genrec_tpu_torch.trainers import tiger_trainer
from tests._torch_amazon import tiny_amazon

torch.set_num_threads(1)

GIN = "config/tiger/synthetic.gin"
N_USERS = 60
STEPS, TOTAL_STEPS = 5, 40


def _gin():
    """The train bindings of config/tiger/synthetic.gin, read by the
    port's configlib."""
    configlib.clear_bindings()
    configlib.clear_macros()
    try:
        configlib.parse_file(GIN)
        return configlib.get_bindings("genrec_tpu_torch.trainers.tiger_trainer.train")
    finally:
        configlib.clear_bindings()
        configlib.clear_macros()


def _cfg(g):
    return dict(embedding_dim=g["embedding_dim"], attn_dim=g["attn_dim"],
                num_heads=g["num_heads"], n_layers=g["n_layers"],
                num_item_embeddings=g["codebook_size"],
                num_user_embeddings=g["num_user_embeddings"], sem_id_dim=g["sem_id_dim"])


def _data(g):
    return synthetic_tiger_data(codebook_size=g["codebook_size"], sem_id_dim=g["sem_id_dim"],
                                max_items=g["max_items"], seed=0, num_users=N_USERS)


def test_synthetic_data_matches_jax():
    g = _gin()
    got = _data(g)
    want = jax_synthetic_tiger_data(codebook_size=g["codebook_size"],
                                    sem_id_dim=g["sem_id_dim"], max_items=g["max_items"],
                                    seed=0, num_users=N_USERS)
    np.testing.assert_array_equal(got.sem_ids, want.sem_ids)
    for split in ("train", "valid", "test"):
        a = got.train_arrays() if split == "train" else got.eval_arrays(split)
        b = want.train_arrays() if split == "train" else want.eval_arrays(split)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split}/{k}")
    for e, f in zip(got.train_examples(), want.train_examples()):
        for k in f:
            np.testing.assert_array_equal(e[k], f[k])


@pytest.mark.parametrize("seed", range(4))
def test_first_fit_decreasing_matches_jax(seed):
    """The port's by-length first-fit against the JAX package's scan (one
    example at a time), with and without a segment cap, and TIGER's
    Beauty-like length mix."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        cap = int(rng.integers(4, 70))
        lengths = rng.integers(1, cap + 1, int(rng.integers(1, 300)))
        for max_segments in (None, 1, 2, 4):
            assert (tb.first_fit_decreasing(lengths, cap, max_segments)
                    == jax_batching.first_fit_decreasing(lengths, cap, max_segments))
    lengths = 1 + 3 * rng.integers(1, 21, 5000)
    assert (tb.first_fit_decreasing(lengths, 61, 4)
            == jax_batching.first_fit_decreasing(lengths, 61, 4))


@pytest.mark.parametrize("packed,accum", [(True, 1), (True, 2), (False, 1)],
                         ids=["packed", "packed_accum2", "padded"])
def test_train_steps_match_jax(packed, accum):
    g = _gin()
    data, D = _data(g), g["sem_id_dim"]
    rows = g["batch_size"] * accum
    if packed:
        arrays, rep = tb.pack_examples(data.train_examples(),
                                       row_len=1 + g["max_items"] * D,
                                       segment_keys=("target_ids",), max_segments=4,
                                       seed=(0, 0))
        expected = g["batch_size"] * rep.n_examples / rep.n_rows
    else:
        arrays, expected = data.train_arrays(), None
    batches = [b for b, _ in tb.batch_iterator(arrays, rows, shuffle=True, seed=0,
                                               drop_last=True)][:STEPS]
    assert len(batches) == STEPS

    jm = JaxTiger(dropout=0.0, **_cfg(g))
    L = g["max_items"] * D
    params = jm.init(jax.random.key(0), jnp.zeros((1,), jnp.int32),
                     jnp.zeros((1, L), jnp.int32), jnp.zeros((1, L), jnp.int32),
                     jnp.zeros((1, D), jnp.int32), jnp.zeros((1, D), jnp.int32),
                     jnp.ones((1, L), jnp.int32))["params"]
    opt = optax.adamw(jax_cosine(g["learning_rate"], g["num_warmup_steps"], TOTAL_STEPS),
                      weight_decay=g["weight_decay"])

    def loss_fn(p, batch, rng):  # the JAX trainer's
        if packed:
            out = jm.apply({"params": p}, batch["item_input_ids"], batch["token_type_ids"],
                           batch["user_token_ids"], batch["user_mask"], batch["segment_ids"],
                           batch["positions"], batch["target_ids"], batch["segment_valid"],
                           deterministic=False, rngs={"dropout": rng},
                           method=JaxTiger.forward_packed)
            loss = out.loss
            if accum > 1:
                loss = loss * jnp.sum(batch["segment_valid"]).astype(jnp.float32) / expected
            return loss, {"real_tokens": out.real_tokens.astype(jnp.float32)}
        B = batch["user_ids"].shape[0]
        out = jm.apply({"params": p}, batch["user_ids"], batch["item_input_ids"],
                       batch["token_type_ids"], batch["target_ids"],
                       jnp.broadcast_to(jnp.arange(D), (B, D)), batch["seq_mask"],
                       deterministic=False, rngs={"dropout": rng})
        return out.loss, {}

    jstep = jax.jit(jax_make_train_step(loss_fn, opt, accum_steps=accum, clip_norm=1.0))
    jstate = JaxTrainState.create(params, opt, jax.random.key(1))

    model = Tiger(**_cfg(g), device="cpu")
    model.load_state_dict(tiger_params_from_flax(jax.device_get(params), model))
    optimizer = Adam(cosine_schedule_with_warmup(g["learning_rate"], g["num_warmup_steps"],
                                                 TOTAL_STEPS), weight_decay=g["weight_decay"])
    step = make_train_step(tiger_trainer.make_loss_fn(D, packed, accum, expected), optimizer,
                           accum_steps=accum, clip_norm=1.0)
    state = TrainState.create(model, optimizer, seed=1)
    tols = {"loss": 1e-5, "grad_norm": 1e-4, **({"real_tokens": 0} if packed else {})}
    for i, b in enumerate(batches):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        for key, tol in tols.items():
            np.testing.assert_allclose(float(m[key]), float(jm_[key]), rtol=tol,
                                       err_msg=f"step {i} {key}")
    assert int(state.step) == int(jstate.step) == STEPS


def test_train_runs_end_to_end_on_the_cpu(tmp_path):
    """config/tiger/synthetic.gin through the port's trainer with
    device="cpu", one epoch on fewer users: metrics in [0, 1], the run's
    files, and the packing's occupancy line."""
    configlib.clear_bindings()
    configlib.clear_macros()
    try:
        configlib.parse_file(GIN)
        for binding in (f'train.save_dir_root = "{tmp_path}"', 'train.device = "cpu"',
                        "train.epochs = 1", f"train.num_users = {N_USERS}",
                        "train.eval_every_epoch = 1"):
            configlib.parse_binding(binding)
        valid, test = tiger_trainer.train()
    finally:
        configlib.clear_bindings()
        configlib.clear_macros()
    assert set(valid) == set(test) == {f"{m}@{k}" for m in ("Recall", "NDCG") for k in (5, 10)}
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in (*valid.values(), *test.values()))
    for name in ("train.log", "metrics.jsonl", "best_model"):
        assert (tmp_path / name).exists(), name
    log = (tmp_path / "train.log").read_text()
    assert "valid Recall@5=" in log and "batch occupancy" in log


def test_unported_options_raise(tmp_path):
    # The amazon branch is ported (A18): the dump's sequences and the sem-id
    # artifact, whose codebook size it takes, with the collision-resolving
    # fourth code where asked (4-code tuples, the trie over all of them).
    dump = tiny_amazon(tmp_path, levels=3)
    kw = dict(dataset="amazon", dataset_folder=dump["root"], sem_ids_path=dump["sem_ids"],
              codebook_size=999, epochs=1, batch_size=16, num_warmup_steps=2,
              embedding_dim=16, attn_dim=32, num_heads=4, n_layers=2, max_items=6,
              num_user_embeddings=64, eval_batch_size=32, device="cpu")
    for dedup in (False, True):
        valid, test = tiger_trainer.train(add_disambiguation=dedup,
                                          save_dir_root=str(tmp_path / f"run{dedup}"), **kw)
        assert all(np.isfinite(v) and 0 <= v <= 1 for v in (*valid.values(), *test.values()))
    with pytest.raises(ValueError, match="sem_ids_path"):
        tiger_trainer.train(**{**kw, "sem_ids_path": None}, save_dir_root="")
    # Resume, profiling and periodic checkpoints are ported (A12): the
    # refusals that remain come first whatever they are asked with.
    with pytest.raises(NotImplementedError, match="ROADMAP A29"):
        tiger_trainer.train(tensor_parallel=2, profile_steps=3, device="cpu", save_dir_root="")
    with pytest.raises(NotImplementedError, match="ROADMAP A29"):
        tiger_trainer.train(tensor_parallel=4, epochs=4, save_every_epoch=2, device="cpu",
                            save_dir_root=str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP A29"):
        tiger_trainer.train(tensor_parallel=2, device="cpu", save_dir_root="")


def test_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiger_trainer.train(epochs=0, save_dir_root="")
