"""The LCRec trainer, port against the JAX package.

- Five train steps at tensor_parallel=2 (2 ranks on a gloo group on the
  CPU): the port's ``make_train_step`` (AdamW after a cosine warm-up,
  clip 1.0, the clip's norm summed over the group) over
  ``make_tp_sharded_fused_sft_loss``, against JAX ``make_train_step`` over
  its ``make_tp_sharded_fused_sft_loss`` on a ``model=2`` mesh, from the
  same converted parameters on the same batches.
- ``train()`` end to end on the CPU at tensor_parallel 1 and 2, from the
  same seed: the epochs' mean losses agree.
- LoRA runs at tensor_parallel=1 and refuses tensor or expert
  parallelism (ValueError, as in JAX); the options the port does not run
  yet raise, naming their ROADMAP item.

One spawn serves the module. Tolerance: losses 1e-5 relative, fp32 on
both sides (each step's gradients differ by GEMM summation order, and
Adam carries that into the next step's weights).
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
from jax.sharding import Mesh

from genrec_tpu.core.harness import make_train_step as jax_make_train_step
from genrec_tpu.core.state import TrainState as JaxTrainState
from genrec_tpu.models import lcrec as jl
from genrec_tpu.models.backbones.qwen import QwenConfig as JaxQwenConfig
from genrec_tpu.models.backbones.qwen import QwenLM as JaxQwenLM
from genrec_tpu.ops.schedules import cosine_schedule_with_warmup as jax_cosine
from genrec_tpu_torch.convert import qwen_params_from_flax
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM
from genrec_tpu_torch.models.lcrec import make_tp_sharded_fused_sft_loss
from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
from genrec_tpu_torch.parallel.mesh import spawn
from genrec_tpu_torch.trainers import lcrec_trainer
from tests._torch_amazon import tiny_amazon

torch.set_num_threads(1)

TOK_DIR = os.path.join(os.path.dirname(__file__), "data", "tiny_hf_tokenizer")

BASE, C, K = 90, 3, 8
LIVE = BASE + C * K
CFG = dict(vocab_size=BASE, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
           rope_theta=10000.0, tie_word_embeddings=False)
LR, WARMUP, STEPS, WD = 1e-2, 2, 5, 0.01
TRAIN = dict(epochs=2, batch_size=16, max_train_samples=64, max_eval_samples=16,
             eval_items_limit=16, eval_every_epoch=1, amp=False, device="cpu",
             wandb_log_interval=1000)


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test fails after 120 s instead of hanging."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _batches():
    out = []
    for seed in range(STEPS):
        rng = np.random.default_rng(seed)
        ids = rng.integers(3, LIVE, (4, 12)).astype(np.int32)
        mask = np.ones((4, 12), np.int32)
        mask[seed % 4, :3] = 0
        labels = np.where(rng.random((4, 12)) < 0.4, -100, ids).astype(np.int32)
        labels[mask == 0] = -100
        out.append({"input_ids": ids, "attention_mask": mask, "labels": labels})
    return out


def _jax_params():
    cfg0 = JaxQwenConfig(**CFG)
    params = JaxQwenLM(cfg0).init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    cfg, params, _ = jl.extend_vocab(cfg0, params, C, K, jax.random.key(1), pad_to=8)
    return JaxQwenLM(cfg), params


def _port_steps(group, params, batches):
    cfg = QwenConfig(**{**CFG, "vocab_size": 120})
    model = QwenLM(cfg, group=group, device="cpu")
    model.load_state_dict(qwen_params_from_flax(params, cfg, group.rank, group.size))
    loss = make_tp_sharded_fused_sft_loss(model, LIVE)
    opt = Adam(cosine_schedule_with_warmup(LR, WARMUP, STEPS), weight_decay=WD)
    step = make_train_step(lambda m, b, g: (loss(b), {}), opt, clip_norm=1.0, group=group)
    state = TrainState.create(model, opt, 0)
    out = []
    for b in batches:
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _ranks(group, params, batches, save_dir):
    """Rank side: the five steps, train() at tensor_parallel=2, and the
    refusal of sequence parallelism on a group (data parallelism beside it
    is ported: ROADMAP A17)."""
    steps = _port_steps(group, params, batches)
    metrics = lcrec_trainer.train(tensor_parallel=2, save_dir_root=save_dir, **TRAIN)
    try:
        lcrec_trainer.train(sequence_parallel=2, save_dir_root=None, **TRAIN)
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    return steps, metrics, refused


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _, params = _jax_params()
    save_dir = str(tmp_path_factory.mktemp("tp2"))
    out = spawn(_ranks, 2, (jax.device_get(params), _batches(), save_dir), device="cpu",
                threads=1, timeout_s=120, store_dir=tmp_path_factory.mktemp("store"))
    return out, save_dir


def test_five_tp2_steps_match_jax(ranks):
    jm, params = _jax_params()
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    with mesh:
        loss = jl.make_tp_sharded_fused_sft_loss(jm, mesh, valid_vocab=LIVE)
        opt = optax.adamw(jax_cosine(LR, WARMUP, STEPS), weight_decay=WD)
        step = jax.jit(jax_make_train_step(lambda p, b, r: (loss(p, b), {}), opt,
                                           clip_norm=1.0))
        state = JaxTrainState.create(params, opt, jax.random.key(0))
        want = []
        for b in _batches():
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            want.append((float(m["loss"]), float(m["grad_norm"])))
    (steps0, _, _), (steps1, _, _) = ranks[0]
    assert steps1 == steps0  # every rank sees the same loss and norm
    np.testing.assert_allclose(np.asarray(steps0), np.asarray(want), rtol=1e-5, atol=0)


def _epoch_losses(save_dir):
    with open(f"{save_dir}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [r["train/loss"] for r in rows if "train/loss" in r]


def test_train_end_to_end_at_tp1_and_tp2(ranks, tmp_path):
    (_, (valid2, test2), _), (_, (valid2b, _), _) = ranks[0]
    valid1, test1 = lcrec_trainer.train(save_dir_root=str(tmp_path), **TRAIN)
    assert valid2 == valid2b  # the ranks report the same metrics
    assert set(valid2) == set(valid1) and set(test2) == set(test1)
    assert "item2index_exact" in test2 and "index2item_match" in test2
    assert all(np.isfinite(v) for v in (*valid2.values(), *test2.values()))
    losses1, losses2 = _epoch_losses(tmp_path), _epoch_losses(ranks[1])
    assert len(losses1) == len(losses2) == TRAIN["epochs"]
    np.testing.assert_allclose(losses2, losses1, rtol=1e-5, atol=0)
    assert (tmp_path / "final_model").exists()


def test_unported_options_name_their_roadmap_items(ranks, tmp_path):
    (_, _, refused), _ = ranks[0]
    assert "sequence_parallel (ring attention)" in refused
    assert "ROADMAP A15" in refused
    with pytest.raises(RuntimeError, match="torchrun --standalone --nproc_per_node=2"):
        lcrec_trainer.train(tensor_parallel=2, **TRAIN)
    # LoRA is ported (A13): it runs at tensor_parallel=1 (tests/test_torch_lora.py
    # holds it to JAX) and, as in JAX, refuses tensor or expert parallelism
    # before anything else.
    valid, test = lcrec_trainer.train(save_dir_root=None, use_lora=True,
                                      **{**TRAIN, "epochs": 1})
    assert all(np.isfinite(v) for v in (*valid.values(), *test.values()))
    for kwargs in (dict(tensor_parallel=2), dict(expert_parallel=2),
                   dict(tensor_parallel=2, resume_from_checkpoint=True)):
        with pytest.raises(ValueError, match="with use_lora is not wired"):
            lcrec_trainer.train(save_dir_root=None, use_lora=True, **{**TRAIN, **kwargs})
    # MoE and expert parallelism are ported (A14; tests/test_torch_moe.py
    # holds them to JAX): MoE runs at tensor_parallel=1, expert parallelism
    # wants one process a rank, and without experts it is refused as in JAX.
    valid, test = lcrec_trainer.train(save_dir_root=None, num_experts=4,
                                      **{**TRAIN, "epochs": 1})
    assert all(np.isfinite(v) for v in (*valid.values(), *test.values()))
    with pytest.raises(RuntimeError, match="one process per rank"):
        lcrec_trainer.train(save_dir_root=None, num_experts=4, expert_parallel=2, **TRAIN)
    with pytest.raises(ValueError, match="needs num_experts>0"):
        lcrec_trainer.train(save_dir_root=None, expert_parallel=2, **TRAIN)
    for kwargs, item in [(dict(sequence_parallel=2), "A15"),
                         (dict(pipeline_parallel=2), "A16"),
                         # Resume, eval_only and profiling are ported (A12): the
                         # refusals that remain come first whatever they are asked with.
                         (dict(eval_only=True, sequence_parallel=2), "A15"),
                         (dict(profile_steps=3, pipeline_parallel=2), "A16")]:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            lcrec_trainer.train(save_dir_root=None, **{**TRAIN, **kwargs})
    # The amazon branch and an HF pretrained_path are ported (A18): the
    # dump's words (WordTokenizer) or a tokenizer-only directory, the
    # codebooks from the artifact (its 3 x 8, whatever num_codebooks says).
    dump = tiny_amazon(tmp_path, levels=C, codebook_size=K)
    amazon = dict(TRAIN, epochs=1, max_train_samples=16, max_eval_samples=8, eval_items_limit=8,
                  dataset="amazon", dataset_folder=dump["root"], num_codebooks=5,
                  codebook_size=64, max_text_len=96, index2item_max_new=6)
    with pytest.raises(ValueError, match="sem_ids_path"):
        lcrec_trainer.train(save_dir_root=None, **amazon)
    for path in (None, TOK_DIR):
        valid, test = lcrec_trainer.train(save_dir_root=None, sem_ids_path=dump["sem_ids"],
                                          pretrained_path=path, **amazon)
        assert {f"codebook_acc_{c}" for c in range(C)} <= set(valid)
        assert "codebook_acc_3" not in valid
        assert all(np.isfinite(v) for v in (*valid.values(), *test.values()))
