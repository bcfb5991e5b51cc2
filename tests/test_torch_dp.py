"""Data parallelism (ROADMAP A17): parallel/mesh.py's data helpers,
core/harness.py's gradient all-reduce, trainers/packed_loop.py's batch
sharding and the HSTU, SASRec and RQ-VAE trainers over two gloo ranks on
the CPU, against the port on one rank and the JAX step on its 8-device
mesh (tests/conftest.py), which computes the one-device math of the
global batch.

One module-scoped spawn runs every rank-side case (tests/_torch_dp.py).
Tolerances: dp = 2 against one rank, losses 1e-5 relative and parameters
1e-5 relative plus 1e-2 x lr absolute (the two sum the batch's gradient
in another order, and Adam scales a near-zero gradient's rounding up to
~lr: SASRec's key biases are left out, as in its single-rank file);
against JAX, each trainer file's own: losses 1e-5 relative, parameters
1e-5 absolute plus relative (HSTU, RQ-VAE) or 1e-2 x lr absolute outside
the key biases (SASRec: tests/test_torch_sasrec_trainer.py says why).
Sem-ids, Sinkhorn ids and the resumed state are held exactly.
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
from genrec_tpu.models import rqvae as jrq
from genrec_tpu.models.hstu import HSTU as JaxHSTU
from genrec_tpu.models.sasrec import SASRec as JaxSASRec
from genrec_tpu.ops import schedules as jsched
from genrec_tpu.parallel import get_mesh, replicate
from genrec_tpu.parallel import shard_batch as jax_shard_batch
from genrec_tpu_torch.convert import (
    hstu_params_from_flax,
    rqvae_params_from_flax,
    sasrec_params_from_flax,
)
from genrec_tpu_torch.parallel import mesh as pm
from genrec_tpu_torch.trainers import hstu_trainer
from tests._torch_dp import (
    CASES,
    LR,
    RQ,
    RQ_SCHED,
    SAS_CFG,
    HSTU_CFG,
    TRAIN,
    WORLD,
    _export,
    _port_steps,
    _rank,
    _rqvae,
    _seq_batches,
    _uneven_sinkhorn,
)

torch.set_num_threads(1)

# -- the JAX references ------------------------------------------------------

def _jax_models():
    """(model, params, loss_fn, optimizer, clip) of each JAX case."""
    hstu = JaxHSTU(**HSTU_CFG, dropout=0.0)
    hp = jax.jit(hstu.init)(jax.random.key(0), jnp.zeros((1, 16), jnp.int32),
                            jnp.zeros((1, 16), jnp.int32))["params"]

    def hstu_loss(p, b, rng):
        _, loss = hstu.apply({"params": p}, b["input_ids"], b["timestamps"], b["targets"],
                             deterministic=False, segment_ids=b["segment_ids"],
                             rngs={"dropout": rng})
        return loss, {}

    sas = JaxSASRec(**SAS_CFG, dropout=0.0)
    sp = jax.jit(sas.init)(jax.random.key(0), jnp.zeros((1, 16), jnp.int32))["params"]

    def sas_loss(p, b, rng):
        _, loss = sas.apply({"params": p}, b["input_ids"], b["targets"], deterministic=False,
                            segment_ids=b["segment_ids"], positions=b["positions"],
                            rngs={"dropout": rng})
        return loss, {}

    M = jrq.QuantizeForwardMode
    rq = jrq.RqVae(**RQ, codebook_mode=M.STE, codebook_last_layer_mode=M.SINKHORN)
    rp = jax.jit(rq.init, static_argnums=2)(
        {"params": jax.random.key(0), "gumbel": jax.random.key(1)},
        jnp.zeros((2, 24), jnp.float32), 0.2)["params"]

    def rq_loss(p, b, rng):
        return rq.apply({"params": p}, b["x"], 0.2, training=True, rngs={"gumbel": rng}).loss, {}

    rq_opt = optax.adamw(jsched.linear_schedule_with_warmup(*RQ_SCHED), weight_decay=1e-4)
    return {"hstu": (hp, hstu_loss, optax.adam(LR, b2=0.98), None),
            "sasrec": (sp, sas_loss, optax.adam(LR, b2=0.98), None),
            "rqvae": (rp, rq_loss, rq_opt, 1.0)}


def _jax_steps(params, loss_fn, opt, clip, batches):
    """The JAX step over the 8-device data mesh (the JAX trainers' own
    placement: replicated state, batches sharded by rows)."""
    mesh = get_mesh()
    step = jax.jit(jax_make_train_step(loss_fn, opt, clip_norm=clip))
    state = replicate(mesh, JaxTrainState.create(params, opt, jax.random.key(1)))
    losses = []
    for b in batches:
        state, m = step(state, jax_shard_batch(mesh, b))
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params)


@pytest.fixture(scope="module")
def jax_models():
    return _jax_models()


@pytest.fixture(scope="module")
def ranks(jax_models, tmp_path_factory):
    params = {k: jax.device_get(v[0]) for k, v in jax_models.items()}
    root = str(tmp_path_factory.mktemp("dp"))
    out = pm.spawn(_rank, WORLD, (params, root), device="cpu", threads=1, timeout_s=240,
                   store_dir=str(tmp_path_factory.mktemp("store")))
    return params, out, root


def test_helpers_split_rows_count_and_gather_over_the_data_group(ranks):
    _, ranks_out, _ = ranks
    r0, r1 = (r["helpers"] for r in ranks_out)
    assert r0["shard"] == list(range(6)) and r1["shard"] == list(range(6, 12))
    # Each microbatch's block: rows 0-2 and 6-8 on rank 0.
    assert r0["shard_accum"] == [0, 1, 2, 6, 7, 8] and r1["shard_accum"] == [3, 4, 5, 9, 10, 11]
    assert "does not split over 2 data ranks" in r0["refused"]
    for r, (offset, rows) in zip((r0, r1), ((0, 3), (3, 5))):
        assert r["count"] == 8.0 and r["global_rows"] == 8 and r["offset"] == offset
        full = torch.rand((16, 3), generator=torch.Generator().manual_seed(5))
        assert r["draw"] == full[2 * offset:2 * (offset + rows)].tolist()
        assert r["gathered"] == list(np.arange(8.0))
        # The mean's shares sum to the global mean.
    assert r0["mean"] + r1["mean"] == pytest.approx(np.arange(8.0).mean(), rel=1e-6)
    # d/dx of sum(gathered * w) summed over both ranks' losses: 2 w.
    assert r0["grad"] + r1["grad"] == (2 * np.arange(1.0, 9.0)).tolist()


def test_sinkhorn_over_an_uneven_split_equals_one_rank(ranks):
    """The transport plan balances the global batch: each rank's ids are
    one rank's ids of its rows (the ranks run the plan on the gathered
    cost), and the distinct count covers every rank's rows."""
    _, (r0, r1), _ = ranks
    ids, distinct = _uneven_sinkhorn(None)
    assert r0["sinkhorn"][0] + r1["sinkhorn"][0] == ids
    assert r0["sinkhorn"][1] == r1["sinkhorn"][1] == distinct


@pytest.mark.parametrize("case", list(CASES))
def test_steps_at_dp2_equal_one_rank(ranks, case):
    params, (r0, r1), _ = ranks
    want_losses, want, want_metrics = _port_steps(None, case, params)
    assert r0[case][0] == r1[case][0]  # the ranks agree on the summed loss
    np.testing.assert_allclose(r0[case][0], want_losses, rtol=1e-5)
    # Every step metric (the aux ones too) is the global batch's value.
    assert r0[case][2] == r1[case][2]
    for got_m, want_m in zip(r0[case][2], want_metrics):
        assert got_m.keys() == want_m.keys()
        for k in want_m:
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5, atol=1e-7, err_msg=k)
    for k, v in want.items():
        assert np.array_equal(r0[case][1][k], r1[case][1][k]), k  # replicas stay equal
        if not k.endswith("k_proj.bias"):  # SASRec's: gradient rounding noise, as below
            np.testing.assert_allclose(r0[case][1][k], v, rtol=1e-5, atol=1e-2 * LR, err_msg=k)
    assert want_losses[0] != want_losses[-1]


@pytest.mark.parametrize("case", ["hstu", "sasrec", "rqvae"])
def test_steps_at_dp2_match_the_jax_mesh(ranks, jax_models, case):
    _, (r0, _), _ = ranks
    params, loss_fn, opt, clip = jax_models[case]
    _, _, _, _, batches = CASES[case][0](jax.device_get(params))
    jb_ = [{k: np.asarray(v) for k, v in b.items()} for b in
           (_seq_batches() if case != "rqvae" else batches)]
    losses, jparams = _jax_steps(params, loss_fn, opt, clip, jb_)
    np.testing.assert_allclose(r0[case][0], losses, rtol=1e-5)
    convert = {"hstu": hstu_params_from_flax, "sasrec": sasrec_params_from_flax}.get(case)
    want = (convert(jparams) if convert else
            rqvae_params_from_flax(jparams, _rqvae(jax.device_get(params))[0]))
    for k, v in want.items():
        if case == "sasrec":
            if not k.endswith("k_proj.bias"):  # gradient rounding noise (see the file)
                np.testing.assert_allclose(r0[case][1][k], v.numpy(), atol=1e-2 * LR,
                                           rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(r0[case][1][k], v.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=k)


def test_rqvae_export_gathers_the_one_rank_ids(ranks):
    _, (r0, r1), _ = ranks
    want = _export(None)
    assert np.array_equal(r0["export"], want) and np.array_equal(r1["export"], want)


def _losses(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["train/loss"] for r in rows if "train/loss" in r]


def test_hstu_trainer_at_dp2_equals_one_rank_and_resumes_bit_for_bit(ranks, tmp_path):
    _, (r0, r1), root = ranks
    metrics = hstu_trainer.train(**TRAIN, save_dir_root=str(tmp_path))
    got = _losses(os.path.join(root, "run", "a"))
    np.testing.assert_allclose(got, _losses(str(tmp_path)), rtol=1e-5)
    assert len(got) > 8 and np.mean(got[-3:]) < np.mean(got[:3])
    assert r0["trainer"]["metrics"] == r1["trainer"]["metrics"]
    for split in (0, 1):
        for k, v in metrics[split].items():
            assert r0["trainer"]["metrics"][split][k] == pytest.approx(v, rel=1e-4), k
    # Rank 1's signal: both ranks stop at the next poll (step 8), and data
    # rank 0 alone writes the one resume point of the shard.
    assert r0["trainer"]["killed"] == r1["trainer"]["killed"] == ({}, {})
    assert r0["trainer"]["killed_steps"][-1] == 8
    assert r0["trainer"]["resumed_equal"] and r1["trainer"]["resumed_equal"]
