"""Tensor parallelism that does not divide the KV heads, port against the
JAX package.

JAX ``qwen_rules`` leaves an axis that tp does not divide replicated and
GSPMD computes each rank's q heads against the KV heads they use. The
port gives rank r the KV heads its contiguous q heads use
(``parallel.shardings.kv_range``): at (H 4, KV 2, tp 4) each KV head sits on
two ranks (replicated), at (H 6, KV 2, tp 3) rank 1 holds both (split),
at (H 6, KV 3, tp 2) KV head 1 sits on both ranks, each reading it for
fewer q heads than its other head.
The holders' partial gradients of a replicated ``k_proj`` / ``v_proj`` row
are summed, and the clip counts each row once.

Held on gloo CPU ranks (``parallel.mesh.spawn``, one spawn a layout) to
JAX on a (1, tp) mesh of the conftest's virtual devices, from the same
converted weights: the forward's logits at 1e-5, five SFT train steps'
losses and grad norms at rtol 1e-5 (fp32 both sides; the heads' outputs
are summed over the ranks in another order; the uneven layout at 2e-4,
for the reason its entry gives), and the replicated rows of
``k_proj`` / ``v_proj`` bit-equal on their holders after the steps.
"""

import signal

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
from genrec_tpu.ops.schedules import cosine_schedule_with_warmup as jax_cosine
from genrec_tpu.parallel.shardings import qwen_rules, shard_params
from genrec_tpu_torch.convert import qwen_params_from_flax
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM
from genrec_tpu_torch.models.lcrec import sft_loss
from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
from genrec_tpu_torch.parallel.mesh import spawn
from genrec_tpu_torch.parallel.shardings import kv_holders, kv_range

torch.set_num_threads(1)

LAYOUTS = {  # name: (config, tp, the five steps' rtol)
    "replicated_H4_KV2_tp4": (dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                                   num_attention_heads=4), 4, 1e-5),
    "split_H6_KV2_tp3": (dict(vocab_size=66, hidden_size=36, intermediate_size=48,
                              num_attention_heads=6), 3, 1e-5),
    # Rank 0's q heads read KV heads 0, 0, 1: uneven copies of its two. Its
    # gradients match one rank's to ~1e-6, but the k_proj biases' gradient
    # is zero up to rounding (softmax ignores a shift of every key), and
    # Adam at LR 1e-2 scales that noise to ~LR in either package: the
    # losses part by ~1e-4 in five steps.
    "uneven_H6_KV3_tp2": (dict(vocab_size=64, hidden_size=36, intermediate_size=48,
                               num_attention_heads=6, num_key_value_heads=3), 2, 2e-4),
}
BASE = dict(num_hidden_layers=2, num_key_value_heads=2, max_position_embeddings=32,
            rope_theta=10000.0, tie_word_embeddings=False)
LR, WARMUP, STEPS, WD = 1e-2, 2, 5, 0.01


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _cfg(name):
    return {**BASE, **LAYOUTS[name][0]}


def _batches(vocab):
    out = []
    for seed in range(STEPS):
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, vocab, (3, 10)).astype(np.int32)
        mask = np.ones((3, 10), np.int32)
        mask[seed % 3, :2] = 0
        labels = np.where(rng.random((3, 10)) < 0.3, -100, ids).astype(np.int32)
        labels[mask == 0] = -100
        out.append({"input_ids": ids, "attention_mask": mask, "labels": labels})
    return out


def _jax_params(name):
    return JaxQwenLM(JaxQwenConfig(**_cfg(name))).init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]


def _ranks(group, name, params, batches):
    cfg = QwenConfig(**_cfg(name))
    model = QwenLM(cfg, group=group, device="cpu")
    model.load_state_dict(qwen_params_from_flax(params, cfg, group.rank, group.size))
    b0 = {k: torch.as_tensor(v).long() for k, v in batches[0].items()}
    with torch.no_grad():
        logits = model(b0["input_ids"], attention_mask=b0["attention_mask"]).numpy()
    opt = Adam(cosine_schedule_with_warmup(LR, WARMUP, STEPS), weight_decay=WD)

    def loss_fn(m, b, g):
        return sft_loss(m, b["input_ids"], b["attention_mask"], b["labels"]), {}

    step = make_train_step(loss_fn, opt, clip_norm=1.0, group=group)
    state = TrainState.create(model, opt, 0)
    steps = []
    for b in batches:
        state, m = step(state, {k: torch.as_tensor(v).long() for k, v in b.items()})
        steps.append((float(m["loss"]), float(m["grad_norm"])))
    kv = {n: p.detach().clone() for n, p in model.named_parameters()
          if n.split(".")[-2:-1] in (["k_proj"], ["v_proj"])}
    return logits, steps, kv


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def layout(request, tmp_path_factory):
    name = request.param
    params = jax.device_get(_jax_params(name))
    batches = _batches(LAYOUTS[name][0]["vocab_size"])
    out = spawn(_ranks, LAYOUTS[name][1], (name, params, batches), device="cpu", threads=1,
                timeout_s=120, store_dir=tmp_path_factory.mktemp("store"))
    return name, params, batches, out


def _mesh(tp):
    return Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("data", "model"))


def test_kv_ownership_replicates_or_splits():
    assert [kv_range(4, 2, r, 4) for r in range(4)] == [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert [kv_range(6, 2, r, 3) for r in range(3)] == [(0, 1), (0, 2), (1, 2)]
    assert kv_holders(4, 2, 4) == [2, 2] and kv_holders(6, 2, 3) == [2, 2]
    assert [kv_range(12, 2, r, 4) for r in range(4)] == [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert [kv_range(4, 4, r, 2) for r in range(2)] == [(0, 2), (2, 4)]  # divides: a split
    assert [kv_range(6, 3, r, 2) for r in range(2)] == [(0, 2), (1, 3)]
    assert kv_holders(6, 3, 2) == [1, 2, 1]


def test_logits_match_jax(layout):
    name, params, batches, out = layout
    jm = JaxQwenLM(JaxQwenConfig(**_cfg(name)))
    tp = LAYOUTS[name][1]
    b = batches[0]
    with _mesh(tp) as mesh:
        sp = shard_params(mesh, params, qwen_rules())
        want = jax.jit(lambda p, i, m: jm.apply({"params": p}, i, m))(
            sp, jnp.asarray(b["input_ids"]), jnp.asarray(b["attention_mask"]))
    for logits, _, _ in out:
        np.testing.assert_allclose(logits, np.asarray(want), rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_five_steps_match_jax(layout):
    name, params, batches, out = layout
    jm = JaxQwenLM(JaxQwenConfig(**_cfg(name)))
    tp = LAYOUTS[name][1]
    opt = optax.adamw(jax_cosine(LR, WARMUP, STEPS), weight_decay=WD)

    def loss_fn(p, b, key):
        return jl.sft_loss(jm, p, b["input_ids"], b["attention_mask"], b["labels"]), {}

    with _mesh(tp) as mesh:
        step = jax.jit(jax_make_train_step(loss_fn, opt, clip_norm=1.0))
        state = JaxTrainState.create(shard_params(mesh, params, qwen_rules()), opt,
                                     jax.random.key(0))
        want = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            want.append((float(m["loss"]), float(m["grad_norm"])))
    for _, steps, _ in out:
        assert steps == out[0][1]  # every rank sees the same loss and norm
    np.testing.assert_allclose(np.asarray(out[0][1]), np.asarray(want),
                               rtol=LAYOUTS[name][2], atol=0)


def test_replicated_kv_rows_stay_bit_equal(layout):
    name, _, _, out = layout
    cfg = QwenConfig(**_cfg(name))
    H, KV, hd, tp = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, len(out)
    shared = 0
    for h in range(KV):
        holders = [r for r in range(tp) if kv_range(H, KV, r, tp)[0] <= h < kv_range(
            H, KV, r, tp)[1]]
        assert len(holders) == kv_holders(H, KV, tp)[h]
        for key in out[0][2]:
            rows = [out[r][2][key][(h - kv_range(H, KV, r, tp)[0]) * hd:
                                   (h - kv_range(H, KV, r, tp)[0] + 1) * hd] for r in holders]
            assert all(torch.equal(rows[0], x) for x in rows[1:]), (key, h)
            shared += len(holders) > 1
    assert shared > 0  # the layout really shares rows
