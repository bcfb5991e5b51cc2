"""Two-dimensional layouts (ROADMAP A17) over four gloo ranks on the CPU:
parallel/mesh.py's row-major mesh, LCRec at tensor_parallel=2 x
data_parallel=2 (B8 over each data rank's model group) and at
tensor_parallel=2 x expert_parallel=2, the MoE's slot order and router
loss over the global batch (models/backbones/qwen.py), TIGER at
tensor_parallel=2 x data_parallel=2, and the JAX trainer's composition
rules (the rank side is tests/_torch_dp.py).

Every layout starts from one JAX init and is held to the port on one rank
and to the JAX step on an 8-device mesh (tests/conftest.py) of the same
axes. Tolerances: 1e-5 relative for losses and gradient norms against
one rank and JAX, as the single-rank files (tests/test_torch_lcrec_trainer.py,
tests/test_torch_tiger_tp.py, tests/test_torch_moe.py); parameters after
the steps 1e-5 relative plus 1e-2 x lr absolute (Adam scales the rounding
of a near-zero gradient, a key bias's, up to ~lr); one MoE call's output
and gradients 1e-5 relative plus 1e-7 absolute; the dropped share
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from genrec_tpu.core.harness import make_train_step as jax_make_train_step
from genrec_tpu.core.state import TrainState as JaxTrainState
from genrec_tpu.models import lcrec as jl
from genrec_tpu.models.backbones.qwen import QwenConfig as JaxQwenConfig
from genrec_tpu.models.backbones.qwen import QwenLM as JaxQwenLM
from genrec_tpu.models.tiger import Tiger as JaxTiger
from genrec_tpu.ops.schedules import cosine_schedule_with_warmup as jax_cosine
from genrec_tpu.parallel import make_mesh as jax_make_mesh
from genrec_tpu.parallel import shard_batch as jax_shard_batch
from genrec_tpu.parallel.shardings import make_place_state, moe_rules, qwen_rules
from genrec_tpu.parallel.shardings import shard_params as jax_shard_params
from genrec_tpu.parallel.shardings import tiger_rules
from genrec_tpu.trainers import lcrec_trainer as jax_lcrec_trainer
from genrec_tpu_torch.convert import qwen_params_from_flax
from genrec_tpu_torch.models.backbones.qwen import QwenConfig
from genrec_tpu_torch.parallel import mesh as pm
from genrec_tpu_torch.parallel.shardings import shard_qwen_params
from genrec_tpu_torch.trainers import lcrec_trainer
from tests._torch_dp import (
    LCREC_SCHED,
    MOE_CFG,
    QWEN_C,
    QWEN_CFG,
    QWEN_K,
    QWEN_LIVE,
    TIGER_MODEL,
    TIGER_SCHED,
    _lcrec_steps,
    _moe_split,
    _rank_2d,
    _tiger_steps,
)

torch.set_num_threads(1)

STEPS = 3
PARAM_ATOL = 1e-2 * LCREC_SCHED[0]  # Adam's scaling of near-zero gradients' rounding
JAX_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
            "rope_theta", "tie_word_embeddings")


def _qwen_params(cfg_kw):
    """JAX init at the base vocabulary, extended by the codebook tokens."""
    keys = JAX_KEYS + (("num_experts", "num_experts_per_tok", "moe_capacity_factor",
                        "router_aux_coef") if "num_experts" in cfg_kw else ())
    cfg0 = JaxQwenConfig(**{k: cfg_kw[k] for k in keys if k != "vocab_size"}, vocab_size=90)
    params = jax.jit(JaxQwenLM(cfg0).init)(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))
    cfg, params, _ = jl.extend_vocab(cfg0, params["params"], QWEN_C, QWEN_K,
                                     jax.random.key(1), pad_to=8)
    assert cfg.vocab_size == cfg_kw["vocab_size"]
    return JaxQwenLM(cfg), jax.device_get(params)


def _lcrec_batches():
    out = []
    for seed in range(STEPS):
        rng = np.random.default_rng(seed)
        ids = rng.integers(3, QWEN_LIVE, (8, 12)).astype(np.int32)
        mask = np.ones((8, 12), np.int32)
        mask[seed % 8, :3] = 0
        labels = np.where(rng.random((8, 12)) < 0.4, -100, ids).astype(np.int32)
        labels[mask == 0] = -100
        out.append({"input_ids": ids, "attention_mask": mask, "labels": labels})
    return out


def _tiger_batch(B=16, items=4, D=3, seed=0):
    rng = np.random.default_rng(seed)
    L = items * D
    return dict(user_ids=rng.integers(0, 16, (B,)).astype(np.int32),
                item_input_ids=rng.integers(0, 8, (B, L)).astype(np.int32),
                token_type_ids=np.tile(np.arange(D, dtype=np.int32), (B, items)),
                target_ids=rng.integers(0, 8, (B, D)).astype(np.int32),
                seq_mask=np.ones((B, L), np.int32))


def _tiger_jax_args(b):
    B, D = b["target_ids"].shape
    return (b["user_ids"], b["item_input_ids"], b["token_type_ids"], b["target_ids"],
            jnp.broadcast_to(jnp.arange(D), (B, D)), b["seq_mask"])


def _moe_split_inputs():
    rng = np.random.default_rng(3)
    E, D, F = MOE_CFG["num_experts"], MOE_CFG["hidden_size"], MOE_CFG["intermediate_size"]
    weights = {"router.weight": rng.normal(size=(E, D)).astype(np.float32),
               "gate_proj": (0.2 * rng.normal(size=(E, D, F))).astype(np.float32),
               "up_proj": (0.2 * rng.normal(size=(E, D, F))).astype(np.float32),
               "down_proj": (0.2 * rng.normal(size=(E, F, D))).astype(np.float32)}
    x = rng.normal(size=(4, 6, D)).astype(np.float32)
    mask = np.ones((4, 6), np.int64)
    mask[2, 4:] = 0
    return weights, x, mask, 1  # one row on data rank 0, three on data rank 1


@pytest.fixture(scope="module")
def setup():
    lcrec_jm, lcrec = _qwen_params(QWEN_CFG)
    moe_jm, moe = _qwen_params(MOE_CFG)
    tiger_jm = JaxTiger(dropout=0.0, **TIGER_MODEL)
    b0 = _tiger_batch()
    tiger = jax.device_get(jax.jit(tiger_jm.init)(jax.random.key(0), *_tiger_jax_args(
        {k: jnp.asarray(v) for k, v in b0.items()}))["params"])
    payload = dict(lcrec=lcrec, moe=moe, tiger=tiger, lcrec_batches=_lcrec_batches(),
                   tiger_batches=[{k: torch.as_tensor(v) for k, v in _tiger_batch(seed=s).items()}
                                  for s in range(STEPS)],
                   moe_split=_moe_split_inputs())
    return payload, dict(lcrec=lcrec_jm, moe=moe_jm, tiger=tiger_jm)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    return pm.spawn(_rank_2d, 4, (setup[0],), device="cpu", threads=1, timeout_s=240,
                    store_dir=str(tmp_path_factory.mktemp("store")))


def test_mesh_lays_its_axes_out_row_major(ranks):
    for r, out in enumerate(ranks):
        lay = out["layout"]
        dp_tp = lay["dp_tp"]
        assert dp_tp["coords"] == {"data": r // 2, "model": r % 2}
        assert (dp_tp["shard"], dp_tp["n_shards"], dp_tp["writer"]) == (r % 2, 2, r < 2)
        # model groups {0, 1} and {2, 3}; data groups {0, 2} and {1, 3}
        assert dp_tp["sums"]["model"] == (r % 2, 2, 3.0 if r < 2 else 7.0)
        assert dp_tp["sums"]["data"] == (r // 2, 2, 4.0 if r % 2 == 0 else 6.0)
        tp_ep = lay["tp_ep"]
        assert tp_ep["coords"] == {"data": 0, "model": r // 2, "expert": r % 2}
        assert (tp_ep["shard"], tp_ep["n_shards"], tp_ep["writer"]) == (r, 4, True)
        assert tp_ep["sums"]["data"] is None
        assert tp_ep["sums"]["model"] == (r // 2, 2, 4.0 if r % 2 == 0 else 6.0)
        assert tp_ep["sums"]["expert"] == (r % 2, 2, 3.0 if r < 2 else 7.0)
        dp_ep = lay["dp_ep"]
        assert dp_ep["sums"]["model"] is None and dp_ep["n_shards"] == 2
        assert dp_ep["coords"] == {"data": r // 2, "model": 0, "expert": r % 2}
        assert "!= 4 ranks" in lay["refused"][0] and "at most one axis" in lay["refused"][1]


def test_layouts_the_world_does_not_divide_are_refused(ranks):
    tiger, lcrec, moe = ranks[0]["refused"]
    assert "does not divide 4 ranks" in tiger
    assert "4 processes do not split into tensor_parallel=3" in lcrec
    assert "tensor_parallel=2 x expert_parallel=4" in moe


def _jax_lcrec_steps(jm, params, axes, rules=None):
    mesh = Mesh(np.array(jax.devices()).reshape([s for _, s in axes]),
                tuple(n for n, _ in axes))
    with mesh:
        loss = jl.make_tp_sharded_fused_sft_loss(jm, mesh, valid_vocab=QWEN_LIVE)
        opt = optax.adamw(jax_cosine(*LCREC_SCHED), weight_decay=0.01)
        step = jax.jit(jax_make_train_step(lambda p, b, r: (loss(p, b), {}), opt,
                                           clip_norm=1.0))
        state = JaxTrainState.create(params, opt, jax.random.key(0))
        if rules is not None:
            state = make_place_state(mesh, rules)(state)
        out = []
        for b in _lcrec_batches():
            state, m = step(state, jax_shard_batch(mesh, b))
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, jax.device_get(state.params)


def _held_to_one_rank(ranks, key, one, cfg, model_rank):
    """Losses and norms equal on every rank and to one rank's; each rank's
    parameters are its shard of one rank's."""
    want_steps, want = one
    for r, out in enumerate(ranks):
        steps, got = out[key]
        assert steps == ranks[0][key][0]
        np.testing.assert_allclose(steps, want_steps, rtol=1e-5)
        shard = want if model_rank(r) is None else shard_qwen_params(
            {k: torch.as_tensor(v) for k, v in want.items()}, *model_rank(r), cfg)
        for k, v in shard.items():
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-5, atol=PARAM_ATOL,
                                       err_msg=f"rank {r} {k}")


def test_lcrec_tp2_dp2_equals_one_rank_and_the_jax_mesh(setup, ranks):
    payload, jms = setup
    one = _lcrec_steps(None, "one", payload["lcrec"], payload["lcrec_batches"])
    _held_to_one_rank(ranks, "lcrec_tp_dp", one, QwenConfig(**QWEN_CFG),
                      lambda r: (r % 2, 2))
    for k in ranks[0]["lcrec_tp_dp"][1]:  # data ranks 0 and 2 hold one shard's replicas
        assert np.array_equal(ranks[0]["lcrec_tp_dp"][1][k], ranks[2]["lcrec_tp_dp"][1][k])
    want, jparams = _jax_lcrec_steps(jms["lcrec"], payload["lcrec"], (("data", 4), ("model", 2)))
    np.testing.assert_allclose(ranks[0]["lcrec_tp_dp"][0], want, rtol=1e-5)
    cfg = QwenConfig(**QWEN_CFG)
    for r in (0, 1):  # each model shard against its rows of JAX's parameters
        for k, v in qwen_params_from_flax(jparams, cfg, r, 2).items():
            np.testing.assert_allclose(ranks[r]["lcrec_tp_dp"][1][k], v.numpy(), rtol=1e-5,
                                       atol=PARAM_ATOL, err_msg=f"rank {r} {k}")


def test_moe_tp2_ep2_equals_one_rank_and_the_jax_mesh(setup, ranks):
    payload, jms = setup
    one = _lcrec_steps(None, "one", payload["moe"], payload["lcrec_batches"], moe=True)
    cfg = QwenConfig(**MOE_CFG)
    want_steps, want = one
    for r, out in enumerate(ranks):
        steps, got = out["moe_tp_ep"]
        np.testing.assert_allclose(steps, want_steps, rtol=1e-5)
        shard = shard_qwen_params({k: torch.as_tensor(v) for k, v in want.items()}, r // 2, 2,
                                  cfg)
        for k, v in shard.items():
            v = np.asarray(v)
            if k.endswith(("gate_proj", "up_proj", "down_proj")) and ".moe." in k:
                v = v[(r % 2) * 2:(r % 2) * 2 + 2]  # this rank's two experts
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=PARAM_ATOL,
                                       err_msg=f"{r} {k}")
    jax_steps, _ = _jax_lcrec_steps(jms["moe"], payload["moe"],
                                    (("data", 2), ("model", 2), ("expert", 2)),
                                    tuple(qwen_rules()) + tuple(moe_rules()))
    np.testing.assert_allclose(ranks[0]["moe_tp_ep"][0], jax_steps, rtol=1e-5)


def test_moe_dp2_equals_one_rank(setup, ranks):
    payload, _ = setup
    want_steps, want = _lcrec_steps(None, "one", payload["moe"], payload["lcrec_batches"],
                                    moe=True)
    for out in ranks:
        steps, got = out["moe_dp"]
        np.testing.assert_allclose(steps, want_steps, rtol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=PARAM_ATOL, err_msg=k)


def test_moe_slot_order_spans_an_uneven_split(setup, ranks):
    """Capacity binds (factor 1.0, top-2): the rows of data rank 1 claim
    slots only after data rank 0's of the same choice level."""
    y, aux, dropped, grads = _moe_split(None, *setup[0]["moe_split"])
    assert dropped > 0
    for lo, hi in ((0, 2), (1, 3)):  # the two data groups
        (y0, a0, d0, g0), (y1, a1, d1, g1) = ranks[lo]["moe_split"], ranks[hi]["moe_split"]
        np.testing.assert_allclose(np.concatenate([y0, y1]), y, rtol=1e-5, atol=1e-7)
        assert a0 == a1 and a0 == pytest.approx(aux, rel=1e-5)
        assert d0 == d1 == dropped
        for k, v in grads.items():
            np.testing.assert_allclose(g0[k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_tiger_tp2_dp2_equals_one_rank_and_the_jax_mesh(setup, ranks):
    payload, jms = setup
    want_steps, _ = _tiger_steps(None, "one", payload["tiger"], payload["tiger_batches"])
    for out in ranks:
        assert out["tiger_tp_dp"][0] == ranks[0]["tiger_tp_dp"][0]
    np.testing.assert_allclose(ranks[0]["tiger_tp_dp"][0], want_steps, rtol=1e-5)
    for k in ranks[0]["tiger_tp_dp"][1]:  # data ranks hold equal replicas
        assert np.array_equal(ranks[1]["tiger_tp_dp"][1][k], ranks[3]["tiger_tp_dp"][1][k])
    jm = jms["tiger"]
    opt = optax.adamw(jax_cosine(*TIGER_SCHED), weight_decay=0.035)
    step = jax.jit(jax_make_train_step(
        lambda p, b, key: (jm.apply({"params": p}, *_tiger_jax_args(b)).loss, {}), opt,
        clip_norm=1.0))
    mesh = jax_make_mesh({"data": 4, "model": 2})
    state = JaxTrainState.create(jax_shard_params(mesh, payload["tiger"], tiger_rules()), opt,
                                 jax.random.key(1))
    want = []
    for s in range(STEPS):
        state, m = step(state, jax_shard_batch(mesh, _tiger_batch(seed=s)))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(ranks[0]["tiger_tp_dp"][0], want, rtol=1e-5)


TRAIN = dict(epochs=1, batch_size=8, max_train_samples=16, max_eval_samples=8,
             eval_items_limit=8, amp=False, device="cpu", hidden_size=32,
             intermediate_size=64, n_layers=1, num_heads=2, num_kv_heads=2, max_text_len=32,
             eval_item_tasks=False)

# JAX's composition rules (trainers/lcrec_trainer.py:237-295), each refused
# with JAX's own message before anything is built.
RULES = {"two_axes": dict(sequence_parallel=2, tensor_parallel=2),
         "moe_beside_sp": dict(num_experts=4, sequence_parallel=2),
         "moe_tp_without_ep": dict(num_experts=4, tensor_parallel=2),
         "ep_with_lora": dict(num_experts=4, expert_parallel=2, use_lora=True),
         "ep_indivisible": dict(num_experts=3, expert_parallel=2),
         "tp_with_lora": dict(tensor_parallel=2, use_lora=True),
         "tp_ep_pp": dict(num_experts=4, tensor_parallel=2, expert_parallel=2,
                          pipeline_parallel=2)}


@pytest.mark.parametrize("rule", list(RULES))
def test_composition_rules_refuse_as_jax(rule, tmp_path):
    kw = {**TRAIN, **RULES[rule]}
    with pytest.raises(ValueError) as want:
        jax_lcrec_trainer.train(save_dir_root=str(tmp_path / "jax"),
                                **{k: v for k, v in kw.items() if k != "device"})
    with pytest.raises(ValueError) as got:
        lcrec_trainer.train(save_dir_root=None, **kw)
    assert str(got.value) == str(want.value)


def test_what_stays_unported_names_its_item():
    for kw, item in ((dict(sequence_parallel=2), "A15"), (dict(pipeline_parallel=2), "A16"),
                     (dict(tensor_parallel=2, pipeline_parallel=2), "A16")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            lcrec_trainer.train(save_dir_root=None, **TRAIN, **kw)
    with pytest.raises(RuntimeError, match="one process per rank"):
        lcrec_trainer.train(save_dir_root=None, tensor_parallel=2, expert_parallel=2,
                            num_experts=4, **TRAIN)


def test_qwen_state_converts_to_the_port(setup):
    """The payload's JAX params load into the port at every layout's
    shapes (the conversion under the tests above)."""
    payload, _ = setup
    full = qwen_params_from_flax(payload["lcrec"], QwenConfig(**QWEN_CFG))
    assert full["lm_head"].shape == (QWEN_CFG["vocab_size"], QWEN_CFG["hidden_size"])
    halves = [shard_qwen_params(full, r, 2, QwenConfig(**QWEN_CFG)) for r in range(2)]
    assert torch.equal(torch.cat([h["lm_head"] for h in halves]), full["lm_head"])
