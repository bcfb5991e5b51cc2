"""The RQ-VAE trainer, port against the JAX package.

genrec_tpu_torch/trainers/rqvae_trainer.py, core/optim.py's schedule and
data/sem_ids.py pair with the same paths under genrec_tpu/. Weights are
the JAX init carried across by ``convert.rqvae_params_from_flax``;
batches are made from a seed with numpy. Tolerances: train-step losses
1e-5 relative (fp32 both sides, only the summation order differs, and
Adam carries it from step to step); sem-ids exact outside near ties:
ids computed through the residual cascade (kernel B7's plain version)
are held to the JAX model path, and tests/test_torch_rq_cascade.py says
why rows whose two nearest codewords are within rounding are counted
apart.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genrec_tpu.core.harness import make_train_step as jax_make_train_step
from genrec_tpu.core.state import TrainState as JaxTrainState
from genrec_tpu.data import items as jitems
from genrec_tpu.data import p5_amazon as jp5
from genrec_tpu.data import sem_ids as jsem
from genrec_tpu.models import rqvae as jrq
from genrec_tpu.ops import schedules as jsched
from genrec_tpu.trainers import rqvae_trainer as jtrainer
from genrec_tpu_torch import configlib
from genrec_tpu_torch.convert import rqvae_params_from_flax
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data import items as titems
from genrec_tpu_torch.data import sem_ids as tsem
from genrec_tpu_torch.kernels.rq_cascade import near_tie_rows
from genrec_tpu_torch.models import rqvae as trq
from genrec_tpu_torch.ops import schedules as tsched
from genrec_tpu_torch.trainers import rqvae_trainer as ttrainer
from tests._torch_amazon import tiny_amazon

torch.set_num_threads(1)

M = jrq.QuantizeForwardMode
SMALL = dict(input_dim=24, embed_dim=8, hidden_dims=(16, 12), codebook_size=32,
             n_layers=3, commitment_weight=0.25, n_cat_features=0,
             codebook_mode=M.STE, codebook_last_layer_mode=M.SINKHORN)


def _pair(seed=0):
    """(jax model, jax params, port model with the same weights)."""
    jmodel = jrq.RqVae(**SMALL)
    params = jax.jit(jmodel.init, static_argnums=2)(
        {"params": jax.random.key(seed), "gumbel": jax.random.key(1)},
        jnp.zeros((2, SMALL["input_dim"]), jnp.float32), 0.2)["params"]
    tmodel = trq.RqVae(**{**SMALL, "codebook_mode": trq.QuantizeForwardMode.STE,
                          "codebook_last_layer_mode": trq.QuantizeForwardMode.SINKHORN},
                       device="cpu")
    tmodel.load_state_dict(rqvae_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tmodel))
    return jmodel, params, tmodel


def _x(seed, n=64, d=24):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_five_adamw_steps_match_jax():
    """AdamW with linear warm-up and decay, clip 1.0, STE + Sinkhorn, the
    trainer's loss: the losses of 5 steps on the same batches within 1e-5
    relative."""
    jmodel, params, tmodel = _pair()
    batches = [_x(20 + i) for i in range(5)]
    sched_args = (1e-2, 2, 5)

    def jloss(p, batch, rng):
        out = jmodel.apply({"params": p}, batch["x"], 0.2, training=True,
                           rngs={"gumbel": rng})
        return out.loss, {"rqvae_loss": out.rqvae_loss}

    opt = optax.adamw(jsched.linear_schedule_with_warmup(*sched_args), weight_decay=1e-4)
    jstep = jax.jit(jax_make_train_step(jloss, opt, clip_norm=1.0))
    jstate = JaxTrainState.create(params, opt, jax.random.key(1))
    topt = Adam(tsched.linear_schedule_with_warmup(*sched_args), weight_decay=1e-4)
    tstep = make_train_step(ttrainer.make_loss_fn(0.2), topt, clip_norm=1.0)
    tstate = TrainState.create(tmodel, topt, seed=1)
    want, got = [], []
    for b in batches:
        jstate, jm = jstep(jstate, {"x": jnp.asarray(b)})
        tstate, tm = tstep(tstate, {"x": torch.as_tensor(b)})
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert int(tstate.step) == 5 and got[0] != got[-1]


@functools.cache
def _trained_small():
    """A port model and its JAX twin after a k-means init, on clustered
    data, so that sem-ids spread over the codebooks."""
    jmodel, params, tmodel = _pair(seed=2)
    x = titems.SyntheticItemEmbeddings(num_items=300, dim=24, n_clusters=8, seed=2).embeddings
    params = jax.jit(functools.partial(jrq.kmeans_init_params, jmodel))(
        params, jnp.asarray(x), jax.random.key(4))
    tmodel.load_state_dict(rqvae_params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                  tmodel))
    return jmodel, params, tmodel, x


@pytest.mark.parametrize("use_pallas", [False, True])
def test_compute_sem_ids_and_collision_rate_match_jax(use_pallas):
    """Chunks of 64 padded rows, the last one ragged. JAX's model path on
    one side; the port's model path, or its residual cascade, on the
    other."""
    jmodel, params, tmodel, x = _trained_small()
    want = jtrainer.compute_sem_ids(jmodel, params, x, batch_size=64)
    got = ttrainer.compute_sem_ids(tmodel, x, batch_size=64, use_pallas=use_pallas)
    assert got.dtype == np.int32 and got.shape == want.shape
    with torch.no_grad():
        enc = tmodel.encode(torch.as_tensor(x))
    near = near_tie_rows(enc, tmodel.codebooks().detach(), torch.as_tensor(want)).numpy()
    differ = (got != want).any(axis=1)
    assert not (differ & ~near).any() and near.mean() <= 0.02
    if not differ.any():
        assert ttrainer.compute_collision_rate(tmodel, x, use_pallas) == \
            jtrainer.compute_collision_rate(jmodel, params, x)


def test_train_end_to_end_and_the_sem_id_artifact(tmp_path):
    """train() through config/rqvae/synthetic.gin (epochs cut to 3) on the
    CPU: a finite, exported artifact that JAX's load_sem_ids reads, and
    JAX's artifact reads in the port."""
    configlib.clear_bindings()
    configlib.clear_macros()
    try:
        configlib.parse_file("config/rqvae/synthetic.gin")
        for b in (f'train.save_dir_root = "{tmp_path}"', 'train.device = "cpu"',
                  "train.epochs = 3", "train.eval_every = 3"):
            configlib.parse_binding(b)
        model, sem_ids = ttrainer.train()
    finally:
        configlib.clear_bindings()
        configlib.clear_macros()
    assert sem_ids.shape == (2000, 3) and sem_ids.dtype == np.int32
    assert (sem_ids >= 0).all() and (sem_ids < 32).all()
    ids, k = jsem.load_sem_ids(str(tmp_path / "sem_ids.npz"))
    np.testing.assert_array_equal(ids, sem_ids)
    assert k == 32
    assert os.path.exists(tmp_path / "final_params.pt")
    jsem.save_sem_ids(str(tmp_path / "jax.npz"), sem_ids[::-1], 32)
    back, k = tsem.load_sem_ids(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(back, sem_ids[::-1])
    # The synthetic data is the JAX package's, row for row.
    np.testing.assert_array_equal(
        titems.SyntheticItemEmbeddings(dim=64).embeddings,
        jitems.SyntheticItemEmbeddings(dim=64).embeddings)
    assert titems.train_eval_split(50)[1].tolist() == jitems.train_eval_split(50)[1].tolist()


def test_train_iteration_mode(tmp_path):
    """Iterations instead of epochs: the run stops at the iteration count,
    mid-epoch, and evaluates on iterations (eval_every)."""
    model, sem_ids = ttrainer.train(
        iterations=3, eval_every=2, save_model_every=10, batch_size=128, vae_input_dim=16,
        vae_hidden_dims=(12,), vae_embed_dim=8, vae_codebook_size=8, num_items=400,
        kmeans_warmup_rows=200, device="cpu", save_dir_root=str(tmp_path))
    assert sem_ids.shape == (400, 3)
    logged = [line for line in open(tmp_path / "metrics.jsonl")]
    assert sum('"collision_rate"' in line for line in logged) == 1  # at iteration 2


def test_train_refuses_what_is_not_ported(tmp_path):
    kw = dict(device="cpu", save_dir_root=str(tmp_path))
    # dataset="p5" is ported (A18): the P5 layout's embeddings, split by the
    # seed-42 item mask (the JAX trainer's), the export over every item.
    dump = tiny_amazon(tmp_path, p5=True)
    p5 = dict(dataset="p5", dataset_folder=dump["p5"], batch_size=8, vae_input_dim=24,
              vae_hidden_dims=(16,), vae_embed_dim=8, vae_codebook_size=8,
              kmeans_warmup_rows=100, do_eval=True, eval_every=2, device="cpu")
    model, sem_ids = ttrainer.train(iterations=4, save_dir_root=str(tmp_path / "p5"), **p5)
    assert sem_ids.shape == (dump["items"], 3)
    mask = jp5.item_train_mask(dump["items"])
    assert 0 < (~mask).sum() < mask.sum()
    logged = (tmp_path / "p5" / "train.log").read_text()
    assert f"kmeans init on {int(mask.sum())} rows" in logged
    with pytest.raises(FileNotFoundError):
        ttrainer.train(epochs=1, **{**p5, "dataset_folder": str(tmp_path / "none")},
                       save_dir_root="")
    with pytest.raises(ValueError, match="exactly one"):
        ttrainer.train(**kw)
    with pytest.raises(FileNotFoundError):
        ttrainer.train(epochs=1, dataset="amazon", dataset_folder=str(tmp_path), **kw)
