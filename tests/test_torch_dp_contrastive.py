"""Data parallelism (ROADMAP A17) of the two losses that reach across the
batch: COBRA's dense in-batch InfoNCE (models/cobra.py, every row of the
global batch a negative) and NoteLLM's in-batch contrastive loss
(models/notellm.py, positives gathered with an autograd all-gather), over
two gloo ranks on the CPU (the rank side is tests/_torch_dp.py).

Each is held to the port on one rank and to the JAX trainer's step on its
8-device mesh (tests/conftest.py) for three steps from the JAX init, to
one rank on a batch split unevenly across the ranks (loss and every
gradient), and the trainers' dp = 2 runs to their one-rank runs.
Tolerances: dp = 2 against one rank 1e-5 relative (parameters 1e-2 x lr
absolute besides); against JAX each single-rank file's own: COBRA's
losses 1e-5 relative (tests/test_torch_cobra_trainer.py), NoteLLM's 1e-5
absolute plus relative (tests/test_torch_notellm.py), parameters 1e-5
absolute plus relative. COBRA's attention key biases are left out of the
parameter checks (``_without_key_bias`` says why).
"""

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
from genrec_tpu.models.cobra import Cobra as JaxCobra
from genrec_tpu.ops.schedules import cosine_schedule_with_warmup as jax_cosine
from genrec_tpu.parallel import get_mesh, replicate
from genrec_tpu.parallel import shard_batch as jax_shard_batch
from genrec_tpu.trainers import notellm_trainer as jax_notellm_trainer
from genrec_tpu_torch.convert import cobra_params_from_flax, notellm_params_from_flax
from genrec_tpu_torch.data import batching as tb
from genrec_tpu_torch.data.cobra_seq import synthetic_cobra_data
from genrec_tpu_torch.models.backbones.qwen import QwenConfig
from genrec_tpu_torch.parallel import mesh as pm
from tests._torch_dp import (
    _cobra_model,
    _contrastive_rank,
    _contrastive_steps,
    _contrastive_trainer,
    _split_grads,
)

torch.set_num_threads(1)

STEPS = 3
COBRA_CFG = dict(encoder_n_layers=1, encoder_hidden_dim=32, encoder_num_heads=2,
                 encoder_vocab_size=64, id_vocab_size=32, n_codebooks=3, d_model=32,
                 max_len=64, decoder_n_layers=2, decoder_num_heads=2, decoder_dropout=0.0)
COBRA_SCHED = (1e-3, 2, 20)
NOTELLM_SCHED = (1e-3, 2, 5)
QWEN_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
             "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
             "rope_theta", "tie_word_embeddings")


def _cobra_setup():
    data = synthetic_cobra_data(id_vocab_size=32, n_codebooks=3, text_vocab=64, max_items=8,
                                seed=0)
    jm = JaxCobra(**COBRA_CFG)
    arrays = data.train_arrays()
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.key(0), jnp.asarray(arrays["input_ids"][:1]),
        jnp.asarray(arrays["encoder_input_ids"][:1]))["params"])
    batches = [b for b, _ in tb.batch_iterator(arrays, 16, shuffle=True, seed=0,
                                               drop_last=True)][:STEPS]

    def loss_fn(p, batch, rng):  # the JAX trainer's, at weights 1 and 1
        out = jm.apply({"params": p}, batch["input_ids"], batch["encoder_input_ids"],
                       deterministic=True)
        return out.loss_sparse + out.loss_dense, {}

    opt = optax.adamw(jax_cosine(*COBRA_SCHED), weight_decay=0.01)
    payload = dict(cfg=COBRA_CFG, params=params, sched=COBRA_SCHED, batches=batches,
                   uneven={k: v[:8] for k, v in batches[0].items()}, cut=3)
    return payload, (loss_fn, opt)


def _notellm_setup():
    data = JaxPairData(num_topics=16, eval_topics=16, max_len=12, seed=0)
    cfg = JaxQwenConfig(vocab_size=data.tokenizer.vocab_size, hidden_size=32,
                        intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, max_position_embeddings=12,
                        rope_theta=10000.0, tie_word_embeddings=False)
    jm = JaxQwenLM(cfg)
    backbone = jax.device_get(jax.jit(jm.init)(jax.random.key(0),
                                                jnp.zeros((1, 4), jnp.int32))["params"])
    arrays = data.train_arrays(4)
    batches = [{k: v[i * 16:(i + 1) * 16] for k, v in arrays.items()} for i in range(STEPS)]
    # A batch of 5 pairs split 2 / 3 in which a topic spans the two ranks.
    topics = arrays["topic_id"]
    start = next(s for s in range(len(topics) - 5)
                 if set(topics[s:s + 2]) & set(topics[s + 2:s + 5]))
    uneven = {k: v[start:start + 5] for k, v in arrays.items()}

    def loss_fn(p, batch, rng):
        flat = jax_notellm_trainer._flatten_pairs(batch)
        out = jn.query2embedding_forward(jm, p["backbone"], flat["input_ids"],
                                         flat["attention_mask"], flat["emb_idx"], p["tau"],
                                         pair_groups=batch["topic_id"])
        return out.loss, {}

    opt = optax.adamw(jax_cosine(*NOTELLM_SCHED), weight_decay=0.01,
                      mask=lambda p: jax.tree_util.tree_map(lambda x: jnp.ndim(x) >= 2, p))
    params = {"backbone": backbone, "tau": np.float32(3.0)}
    payload = dict(cfg={k: getattr(cfg, k) for k in QWEN_KEYS}, params=params,
                   sched=NOTELLM_SCHED, batches=batches, uneven=uneven, cut=2)
    return payload, (loss_fn, opt)


@pytest.fixture(scope="module")
def setups():
    return {"cobra": _cobra_setup(), "notellm": _notellm_setup()}


@pytest.fixture(scope="module")
def ranks(setups, tmp_path_factory):
    payload = {k: v[0] for k, v in setups.items()}
    root = str(tmp_path_factory.mktemp("dp_contrastive"))
    return pm.spawn(_contrastive_rank, 2, (payload, root), device="cpu", threads=1,
                    timeout_s=240, store_dir=str(tmp_path_factory.mktemp("store")))


SCHED = {"cobra": COBRA_SCHED, "notellm": NOTELLM_SCHED}


def _without_key_bias(name, got, want):
    """COBRA's attention key biases left out: softmax ignores them, so
    their gradient is rounding noise that Adam scales up to ~lr in either
    package (as SASRec's, tests/test_torch_sasrec_trainer.py)."""
    if name.endswith("in_proj.bias"):
        d = len(want) // 3  # q, k, v
        keep = np.r_[0:d, 2 * d:3 * d]
        return got[keep], want[keep]
    return got, want


def _state_dict(case, payload, params):
    if case == "cobra":
        return cobra_params_from_flax(params, _cobra_model(payload["cfg"], payload["params"]))
    return notellm_params_from_flax(params, QwenConfig(**payload["cfg"]))


@pytest.mark.parametrize("case", ["cobra", "notellm"])
def test_steps_at_dp2_equal_one_rank(setups, ranks, case):
    want_losses, want, want_metrics = _contrastive_steps(None, case, setups[case][0])
    (l0, p0, m0), (l1, p1, m1) = (r[case]["steps"] for r in ranks)
    assert l0 == l1 and m0 == m1
    np.testing.assert_allclose(l0, want_losses, rtol=1e-5)
    # Every step metric (accuracy, codebook entropy, the loss parts) is the
    # global batch's value.
    for got_m, want_m in zip(m0, want_metrics):
        assert got_m.keys() == want_m.keys()
        for k in want_m:
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5, atol=1e-7, err_msg=k)
    for k, v in want.items():
        assert np.array_equal(p0[k], p1[k]), k
        got, v = _without_key_bias(k, p0[k], v)
        np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-2 * SCHED[case][0], err_msg=k)


@pytest.mark.parametrize("case", ["cobra", "notellm"])
def test_steps_at_dp2_match_the_jax_mesh(setups, ranks, case):
    payload, (loss_fn, opt) = setups[case]
    mesh = get_mesh()
    step = jax.jit(jax_make_train_step(loss_fn, opt, clip_norm=1.0))
    state = replicate(mesh, JaxTrainState.create(payload["params"], opt, jax.random.key(1)))
    losses = []
    for b in payload["batches"]:
        state, m = step(state, jax_shard_batch(mesh, b))
        losses.append(float(m["loss"]))
    got_losses, got, _ = ranks[0][case]["steps"]
    tol = dict(rtol=1e-5) if case == "cobra" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_losses, losses, **tol)
    want = _state_dict(case, payload, jax.device_get(state.params))
    for k, v in want.items():
        g, v = _without_key_bias(k, got[k], v.numpy())
        np.testing.assert_allclose(g, v, atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["cobra", "notellm"])
def test_an_uneven_split_gives_the_one_rank_loss_and_gradients(setups, ranks, case):
    payload = setups[case][0]
    if case == "notellm":  # the duplicate topic spans the ranks
        t = payload["uneven"]["topic_id"]
        assert set(t[:payload["cut"]]) & set(t[payload["cut"]:])
    want_loss, want = _split_grads(None, case, payload, payload["cut"])
    (l0, g0), (l1, g1) = (r[case]["uneven"] for r in ranks)
    assert l0 == l1 and l0 == pytest.approx(want_loss, rel=1e-5)
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(g0[k], v, rtol=1e-5, atol=1e-6 * scale, err_msg=k)


@pytest.mark.parametrize("case", ["cobra", "notellm"])
def test_trainer_at_dp2_equals_one_rank(ranks, case, tmp_path):
    want_losses, want_metrics = _contrastive_trainer(None, case, str(tmp_path))
    (l0, m0), (_, m1) = (r[case]["trainer"] for r in ranks)
    assert m0 == m1 and len(l0) == len(want_losses) > 1
    np.testing.assert_allclose(l0, want_losses, rtol=1e-5)
    flat = [m0] if case == "notellm" else list(m0)
    want_flat = [want_metrics] if case == "notellm" else list(want_metrics)
    for got, exp in zip(flat, want_flat):
        assert set(got) == set(exp)
        for k in exp:
            assert got[k] == pytest.approx(exp[k], rel=1e-4, abs=1e-6), k
