"""COBRA training, port against the JAX package.

Pairs: genrec_tpu_torch/trainers/cobra_trainer.py's loss and
``core/harness.make_train_step`` with the JAX COBRA trainer's step (its
weighted sparse + dense loss, optax AdamW on the cosine warm-up schedule,
clip 1.0) at the widths of config/cobra/synthetic.gin, from one init at
dropout 0 in float32 on the same batches; the bf16 training forward
(``Cobra(dtype=bfloat16)``) with the Flax model's ``dtype=bfloat16``;
``compute_item_dense_vecs`` and ``evaluate`` (beam fusion, TopK and
per-codebook accuracy) with the JAX ones on the same weights and item
vectors; data/cobra_seq.py with its JAX copy; and ``train()`` on the CPU
through the callable-dataset hook (tests/test_cobra_trainer_factory.py's
case) and on config/cobra/synthetic.gin.

Tolerances: per-step losses 1e-5 relative, gradient norms 1e-3 (Adam's
m / sqrt(v) carries ~1e-7 gradient differences into the weights; they
read 1.1e-4 apart by the fifth step at lr 1e-3), step metrics
(accuracy, codebook entropy) 1e-5; bf16 losses 1e-2 relative (every
activation rounded to bf16, 2^-8, at different points of a sum); item
vectors 1e-5; eval metrics exact (the same candidates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genrec_tpu.core.harness import make_train_step as jax_make_train_step
from genrec_tpu.core.state import TrainState as JaxTrainState
from genrec_tpu.data.cobra_seq import synthetic_cobra_data as jax_synthetic_cobra_data
from genrec_tpu.models.cobra import Cobra as JaxCobra
from genrec_tpu.ops.schedules import cosine_schedule_with_warmup as jax_cosine
from genrec_tpu.parallel import get_mesh
from genrec_tpu.trainers import cobra_trainer as jtrainer
from genrec_tpu_torch import configlib
from genrec_tpu_torch.convert import cobra_params_from_flax
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data import batching as tb
from genrec_tpu_torch.data.cobra_seq import (
    CobraSeqData,
    amazon_cobra_data,
    synthetic_cobra_data,
)
from genrec_tpu_torch.data.sem_ids import random_unique_sem_ids
from genrec_tpu_torch.models.cobra import Cobra
from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
from genrec_tpu_torch.trainers import cobra_trainer

torch.set_num_threads(1)

GIN = "config/cobra/synthetic.gin"
STEPS, TOTAL_STEPS = 5, 40


def _gin():
    configlib.clear_bindings()
    configlib.clear_macros()
    try:
        configlib.parse_file(GIN)
        return configlib.get_bindings("genrec_tpu_torch.trainers.cobra_trainer.train")
    finally:
        configlib.clear_bindings()
        configlib.clear_macros()


def _cfg(g, dropout=0.0):
    return dict(encoder_n_layers=g["encoder_n_layers"],
                encoder_hidden_dim=g["encoder_hidden_dim"],
                encoder_num_heads=g["encoder_num_heads"],
                encoder_vocab_size=g["encoder_vocab_size"], id_vocab_size=g["id_vocab_size"],
                n_codebooks=g["n_codebooks"], d_model=g["d_model"], max_len=g["max_len"],
                decoder_n_layers=g["decoder_n_layers"],
                decoder_num_heads=g["decoder_num_heads"], decoder_dropout=dropout)


def _data(g):
    return synthetic_cobra_data(id_vocab_size=g["id_vocab_size"], n_codebooks=g["n_codebooks"],
                                text_vocab=g["encoder_vocab_size"], max_items=g["max_items"],
                                seed=0)


@pytest.fixture(scope="module")
def setup():
    """The config's JAX model, its init, and the port with those weights."""
    g = _gin()
    data = _data(g)
    jm = JaxCobra(**_cfg(g))
    params = jm.init(jax.random.key(0),
                     jnp.full((1, (g["max_items"] + 1) * g["n_codebooks"]), data.pad_id,
                              jnp.int32),
                     jnp.zeros((1, g["max_items"] + 1, data.item_texts.shape[1]),
                               jnp.int32))["params"]
    return g, data, jm, params


def _port(g, params, **kw):
    model = Cobra(**_cfg(g), device="cpu", **kw)
    model.load_state_dict(cobra_params_from_flax(jax.device_get(params), model))
    return model


def test_synthetic_data_matches_jax():
    g = _gin()
    got = _data(g)
    want = jax_synthetic_cobra_data(id_vocab_size=g["id_vocab_size"],
                                    n_codebooks=g["n_codebooks"],
                                    text_vocab=g["encoder_vocab_size"],
                                    max_items=g["max_items"], seed=0)
    np.testing.assert_array_equal(got.sem_ids, want.sem_ids)
    np.testing.assert_array_equal(got.item_texts, want.item_texts)
    for a, b in ((got.train_arrays(), want.train_arrays()),
                 (got.eval_arrays("valid"), want.eval_arrays("valid")),
                 (got.eval_arrays("test"), want.eval_arrays("test"))):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(NotImplementedError, match="ROADMAP A18"):
        amazon_cobra_data("dataset/amazon", "beauty", "sem_ids.npz")


def test_train_steps_match_jax(setup):
    g, data, jm, params = setup
    batches = [b for b, _ in tb.batch_iterator(data.train_arrays(), g["batch_size"],
                                               shuffle=True, seed=0, drop_last=True)][:STEPS]
    assert len(batches) == STEPS
    opt = optax.adamw(jax_cosine(g["learning_rate"], g["num_warmup_steps"], TOTAL_STEPS),
                      weight_decay=0.01)

    # The tower's dropout is 0.1 whatever the config says (the JAX Cobra
    # passes none to LightT5Encoder): the JAX forward runs deterministic,
    # the port's tower gets rate 0, the same function at dropout 0.
    def loss_fn(p, batch, rng):  # the JAX trainer's, at weights 1 and 1
        out = jm.apply({"params": p}, batch["input_ids"], batch["encoder_input_ids"],
                       deterministic=True)
        return out.loss_sparse + out.loss_dense, {
            "loss_sparse": out.loss_sparse, "loss_dense": out.loss_dense,
            "acc": out.acc_correct / jnp.maximum(out.acc_total, 1),
            "codebook_entropy": out.codebook_entropy,
        }

    jstep = jax.jit(jax_make_train_step(loss_fn, opt, clip_norm=1.0))
    jstate = JaxTrainState.create(params, opt, jax.random.key(1))
    model = _port(g, params)
    for layer in model.encoder.layers:
        layer.dropout_rate = layer.self_attn.dropout_rate = 0.0
    optimizer = Adam(cosine_schedule_with_warmup(g["learning_rate"], g["num_warmup_steps"],
                                                 TOTAL_STEPS), weight_decay=0.01)
    step = make_train_step(cobra_trainer.make_loss_fn(), optimizer, clip_norm=1.0)
    state = TrainState.create(model, optimizer, seed=1)
    tols = {"loss": 1e-5, "loss_sparse": 1e-5, "loss_dense": 1e-5, "acc": 1e-5,
            "codebook_entropy": 1e-5, "grad_norm": 1e-3}
    for i, b in enumerate(batches):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        for key, tol in tols.items():
            np.testing.assert_allclose(float(m[key]), float(jm_[key]), rtol=tol,
                                       err_msg=f"step {i} {key}")
    assert int(state.step) == int(jstate.step) == STEPS
    log = cobra_trainer.step_log(m, STEPS)
    assert set(log) == {"global_step", "train/loss", "train/loss_sparse", "train/loss_dense",
                        "train/acc", "train/codebook_entropy"}


def test_bf16_forward_matches_jax(setup):
    g, data, _, params = setup
    jm = JaxCobra(**_cfg(g), dtype=jnp.bfloat16)
    model = _port(g, params, dtype=torch.bfloat16)
    b = data.train_arrays()
    ids, txt = b["input_ids"][:16], b["encoder_input_ids"][:16]
    jout = jax.jit(jm.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(txt))
    with torch.no_grad():
        tout = model(torch.as_tensor(ids), torch.as_tensor(txt))
    for name in ("loss_sparse", "loss_dense", "vec_cos_sim"):
        assert float(getattr(tout, name)) == pytest.approx(float(getattr(jout, name)),
                                                           rel=1e-2), name


def test_evaluate_matches_jax(setup):
    """The item tower over every item, then beam fusion, TopK and
    per-codebook accuracy on the valid split: the same vectors and the same
    metrics from the same weights."""
    g, data, jm, params = setup
    model = _port(g, params)
    want_vecs = np.asarray(jtrainer.compute_item_dense_vecs(jm, params, data.item_texts))
    got_vecs = cobra_trainer.compute_item_dense_vecs(model, data.item_texts)
    np.testing.assert_allclose(got_vecs.numpy(), want_vecs, atol=1e-5)
    n_beam, arrays = g["n_beam"], data.eval_arrays("valid")
    jfuse = jtrainer.make_fusion_fn(jm, jnp.asarray(data.sem_ids), min(10, n_beam), n_beam, 0.5)
    want = jtrainer.evaluate(jfuse, params, arrays, jnp.asarray(want_vecs), 32, get_mesh(),
                             g["n_codebooks"])
    tfuse = cobra_trainer.make_fusion_fn(model, torch.as_tensor(data.sem_ids).long(),
                                         min(10, n_beam), n_beam, 0.5)
    got = cobra_trainer.evaluate(tfuse, arrays, torch.tensor(want_vecs), 32, "cpu",
                                 g["n_codebooks"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_train_accepts_data_factory(tmp_path):
    """The callable ``dataset`` hook, as tests/test_cobra_trainer_factory.py
    drives the JAX trainer."""
    rng = np.random.default_rng(0)
    n_items, C, K = 24, 3, 8
    sem_ids = random_unique_sem_ids(n_items, K, C, rng)
    texts = np.zeros((n_items, 6), np.int32)
    texts[:, :4] = rng.integers(2, 64, (n_items, 4))
    seqs = [np.asarray(rng.integers(1, n_items + 1, rng.integers(5, 9)), np.int64)
            for _ in range(48)]

    def factory():
        return CobraSeqData(seqs, sem_ids, texts, id_vocab_size=K, max_items=6)

    valid_m, test_m = cobra_trainer.train(
        dataset=factory, epochs=1, batch_size=8, learning_rate=1e-3,
        num_warmup_steps=2, encoder_n_layers=1, encoder_hidden_dim=16,
        encoder_num_heads=2, encoder_vocab_size=64, d_model=16,
        decoder_n_layers=1, decoder_num_heads=2, max_items=6, n_beam=4,
        do_eval=True, eval_every_epoch=1, eval_batch_size=8,
        test_on_best=False, save_dir_root=str(tmp_path), wandb_logging=False, device="cpu",
    )
    assert 0.0 <= test_m["Recall@10"] <= 1.0
    assert set(valid_m) == set(test_m) >= {f"codebook_acc_{c}" for c in range(C)}


def test_train_runs_on_the_synthetic_config(tmp_path):
    """config/cobra/synthetic.gin on the CPU, one epoch: finite metrics in
    [0, 1] and the step log's loss parts."""
    configlib.clear_bindings()
    configlib.clear_macros()
    try:
        configlib.parse_file(GIN)
        for binding in (f'train.save_dir_root = "{tmp_path}"', 'train.device = "cpu"',
                        "train.epochs = 1", "train.eval_every_epoch = 1",
                        "train.wandb_log_interval = 1"):
            configlib.parse_binding(binding)
        valid, test = cobra_trainer.train()
    finally:
        configlib.clear_bindings()
        configlib.clear_macros()
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in (*valid.values(), *test.values()))
    logged = (tmp_path / "metrics.jsonl").read_text()
    assert "train/loss_sparse" in logged and "train/codebook_entropy" in logged


def test_unported_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A18"):
        cobra_trainer.train(dataset="amazon", device="cpu", save_dir_root=str(tmp_path))
    # Resume and periodic checkpoints are ported (A12): the Amazon refusal
    # comes first whatever it is asked with.
    with pytest.raises(NotImplementedError, match="ROADMAP A18"):
        cobra_trainer.train(dataset="amazon", resume_from_checkpoint=True, device="cpu",
                            save_dir_root="")
    with pytest.raises(NotImplementedError, match="ROADMAP A18"):
        cobra_trainer.train(dataset="amazon", epochs=4, save_every_epoch=2, device="cpu",
                            save_dir_root=str(tmp_path))


def test_bf16_model_does_not_serve_paged():
    """A bf16 COBRA (the trainer's amp) once could not serve paged (the
    name predates bf16 pages); now its head takes it and lays its pools out
    in bf16, as JAX's does. tests/test_torch_bf16_serving.py serves it."""
    from genrec_tpu_torch.serving.heads import CobraGenerativeHead

    g = _gin()
    model = Cobra(**_cfg(g), dtype=torch.bfloat16, device="cpu")
    head = CobraGenerativeHead(model, item_sem_ids=np.asarray([[0, 1, 2]]),
                               item_vecs=np.zeros((1, g["d_model"]), np.float32))
    assert head.paged_layout()[3] == torch.bfloat16
    state = head.paged_state_zeros(2)
    assert state["cache_k"].dtype == torch.bfloat16 and state["h_last"].dtype == torch.float32
