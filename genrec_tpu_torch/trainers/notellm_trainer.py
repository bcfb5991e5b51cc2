"""NoteLLM (Query2Embedding) trainer (port of
genrec_tpu/trainers/notellm_trainer.py).

    python -m genrec_tpu_torch.trainers.notellm_trainer config/notellm/synthetic.gin \
        [--gin 'train.device="cpu"']

Paired contrastive SFT over interleaved (query, positive) batches, the
learnable temperature tau trained jointly with the backbone, evaluated as
paired top-k retrieval accuracy over the whole held-out-topic eval set.
AdamW on a cosine schedule after a linear warm-up, decaying only the
tensors of two or more dimensions (not tau, the biases or the norms),
global-norm clip 1.0. The step runs on the port's ``PackedTrainLoop``
(pair rows, never packed), with the same fault tolerance as the other
trainers: resume points every ``save_every_epoch`` epochs, on
SIGTERM/SIGINT (the run then returns ``{}``) and, unconditionally, after
the last epoch; exact resume with ``resume_from_checkpoint=True``.
``BestTracker`` keeps the parameters of the best ``top{eval_topk}_acc``.

The model, the loss and the optimizer are module-level functions
(``notellm_model``, ``notellm_loss``, ``make_optimizer``), so a caller can
drive the trainer's own step outside ``train``. Runs on
``device="cuda"`` by default (it raises without a card unless given
``device="cpu"``).
"""

from __future__ import annotations

import os

import torch

from genrec_tpu_torch import configlib
from genrec_tpu_torch.core.checkpoint import BestTracker, CheckpointManager
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.logging import Tracker, setup_logger
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.preemption import PreemptionGuard
from genrec_tpu_torch.core.profiling import ProfileWindow
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data.batching import batch_iterator
from genrec_tpu_torch.data.notellm_pairs import NoteLLMPairData
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM, qwen_init_params
from genrec_tpu_torch.models.notellm import (
    NoteLLM,
    paired_topk_accuracy,
    query2embedding_forward,
)
from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop


def flatten_pairs(batch: dict) -> dict:
    """(B, 2, ...) pair-unit tensors -> (2B, ...) interleaved rows (the
    per-pair ``topic_id`` (B,) stays as it is)."""
    return {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}


def notellm_model(cfg: QwenConfig, dtype, seed: int, tau_init: float, device) -> NoteLLM:
    """The backbone from ``seed`` (``qwen_init_params``) and tau at
    ``tau_init``, on ``device``."""
    backbone = QwenLM(cfg, dtype=dtype, device=device)
    backbone.load_state_dict(qwen_init_params(cfg, seed, device))
    return NoteLLM(backbone, tau_init)


def notellm_loss(model: NoteLLM, batch: dict, generator=None):
    """The train loss of a pair batch: (loss, {"cl_loss"}), same-topic
    pairs masked out of the InfoNCE softmax."""
    flat = flatten_pairs(batch)
    out = query2embedding_forward(model.backbone, flat["input_ids"], flat["attention_mask"],
                                  flat["emb_idx"], model.tau, pair_groups=batch["topic_id"])
    return out.loss, {"cl_loss": out.cl_loss}


def make_optimizer(learning_rate: float, num_warmup_steps: int, total_steps: int,
                   weight_decay: float) -> Adam:
    """AdamW on the cosine warm-up schedule; only tensors of 2+ dims decay."""
    return Adam(cosine_schedule_with_warmup(learning_rate, num_warmup_steps, total_steps),
                weight_decay=weight_decay, decay_mask=lambda p: p.ndim >= 2)


@torch.no_grad()
def embed(model: NoteLLM, batch: dict) -> torch.Tensor:
    """L2-normalised [EMB] embeddings (rows, d) of flattened pair rows."""
    return query2embedding_forward(model.backbone, batch["input_ids"],
                                   batch["attention_mask"], batch["emb_idx"], model.tau,
                                   return_loss=False).sentence_embedding


def evaluate_retrieval(model: NoteLLM, arrays: dict, batch_pairs: int, device,
                       topk: int = 5) -> dict:
    """Paired top-k accuracy over the whole eval set (the similarity matrix
    spans every eval pair, not one batch)."""
    was_training = model.training
    model.eval()
    embs = []
    for host, valid in batch_iterator(arrays, batch_pairs):
        dev_batch = {k: torch.as_tensor(host[k], device=device)
                     for k in ("input_ids", "attention_mask", "emb_idx")}
        e = embed(model, flatten_pairs(dev_batch)).cpu()
        embs.append(e.reshape(-1, 2, e.shape[-1])[:int(valid.sum())])
    model.train(was_training)
    flat = torch.cat(embs).reshape(-1, embs[0].shape[-1])
    return {f"top{topk}_acc": paired_topk_accuracy(flat, topk=topk)}


@configlib.configurable
def train(
    epochs=4,
    batch_pairs=16,
    learning_rate=1e-3,
    num_warmup_steps=20,
    weight_decay=0.01,
    max_text_len=12,
    num_topics=64,
    eval_topics=16,
    pairs_per_topic=4,
    hidden_size=64,
    intermediate_size=128,
    n_layers=2,
    num_heads=4,
    num_kv_heads=2,
    tau_init=3.0,
    eval_topk=5,
    do_eval=True,
    eval_every_epoch=2,
    eval_batch_pairs=16,
    resume_from_checkpoint=False,
    save_dir_root="out/notellm",
    save_every_epoch=10,
    wandb_logging=False,
    wandb_project="notellm_training",
    wandb_log_interval=50,
    amp=True,
    mixed_precision_type="bf16",
    profile_steps=0,
    seed=0,
    device="cuda",
):
    """Train NoteLLM; returns the paired top-k accuracy of the best
    parameters on the eval topics ({} when preempted)."""
    dev = resolve_device(device)
    logger = setup_logger(save_dir_root)
    tracker = Tracker(wandb_logging, wandb_project, save_dir=save_dir_root, logger=logger)
    compute_dtype = (torch.bfloat16 if (amp and mixed_precision_type == "bf16")
                     else torch.float32)

    data = NoteLLMPairData(num_topics=num_topics, eval_topics=eval_topics,
                           max_len=max_text_len, seed=seed)
    cfg = QwenConfig(
        vocab_size=data.tokenizer.vocab_size, hidden_size=hidden_size,
        intermediate_size=intermediate_size, num_hidden_layers=n_layers,
        num_attention_heads=num_heads, num_key_value_heads=num_kv_heads,
        max_position_embeddings=max_text_len, rope_theta=10000.0,
        tie_word_embeddings=False,
    )
    model = notellm_model(cfg, compute_dtype, seed, tau_init, dev)
    logger.info(f"NoteLLM backbone {hidden_size}d x {n_layers} layers, "
                f"vocab {cfg.vocab_size}, tau_init {tau_init}")

    train_arrays = data.train_arrays(pairs_per_topic)
    eval_arrays = data.eval_arrays()
    steps_per_epoch = max(1, len(train_arrays["input_ids"]) // batch_pairs)
    optimizer = make_optimizer(learning_rate, num_warmup_steps, epochs * steps_per_epoch,
                               weight_decay)
    step_fn = make_train_step(notellm_loss, optimizer, clip_norm=1.0)
    state = TrainState.create(model, optimizer, seed)

    ckpt = CheckpointManager(os.path.join(save_dir_root, "checkpoints")) if save_dir_root else None
    metric = f"top{eval_topk}_acc"
    best = BestTracker(save_dir_root, metric=metric)
    prof = ProfileWindow(os.path.join(save_dir_root, "profile") if save_dir_root else "",
                         profile_steps)
    loop = PackedTrainLoop(
        logger=logger, tracker=tracker, device=dev, prof=prof, guard=PreemptionGuard(logger),
        ckpt=ckpt, rows_per_step=batch_pairs, row_len=max_text_len, seed=seed,
        pack_sequences=False, train_arrays=train_arrays,
        wandb_log_interval=wandb_log_interval, save_dir_root=save_dir_root,
    )
    start_epoch, start_batch, global_step = 0, 0, 0
    if resume_from_checkpoint:
        # Step-granular exact resume: the next batch of a possibly
        # mid-epoch resume point.
        state, start_epoch, start_batch, global_step = loop.resume(state)
    for epoch in range(start_epoch, epochs):
        res = loop.run_epoch(state, step_fn, epoch, global_step,
                             start_batch=start_batch if epoch == start_epoch else 0)
        state, global_step = res.state, res.global_step
        if res.preempted:
            # The loop wrote a durable resume point: exit cleanly so that the
            # scheduler restarts the run with resume_from_checkpoint.
            loop.shutdown(preempted_epoch=epoch)
            return {}
        if ckpt is not None and (epoch + 1) % save_every_epoch == 0:
            # Epoch-boundary resume point: cursor = (next epoch, batch 0).
            loop.save(state, epoch=epoch + 1, next_batch=0, global_step=global_step)
        if do_eval and (epoch + 1) % eval_every_epoch == 0:
            m = evaluate_retrieval(model, eval_arrays, eval_batch_pairs, dev, topk=eval_topk)
            logger.info(f"epoch {epoch} eval " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
            tracker.log({"epoch": epoch, **{f"eval/{k}": v for k, v in m.items()}})
            best.update(m[metric], model.state_dict())

    # Unconditional final resume point (of the trained state, before the
    # best parameters are loaded for the test eval).
    loop.save(state, epoch=epochs, next_batch=0, global_step=global_step)
    best_params = best.best_params(like=model.state_dict())
    if best_params is not None:
        model.load_state_dict(best_params)
    test_m = evaluate_retrieval(model, eval_arrays, eval_batch_pairs, dev, topk=eval_topk)
    logger.info("test " + ", ".join(f"{k}={v:.4f}" for k, v in test_m.items()))
    tracker.log({f"test/{k}": v for k, v in test_m.items()})
    loop.shutdown()
    return test_m


if __name__ == "__main__":
    configlib.parse_config()
    train()
