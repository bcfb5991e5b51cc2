"""COBRA trainer (port of genrec_tpu/trainers/cobra_trainer.py).

    python -m genrec_tpu_torch.trainers.cobra_trainer config/cobra/synthetic.gin \
        [--gin 'train.device="cpu"']

The same config files drive both packages. Epoch loop, AdamW on the
cosine warm-up schedule, a global-norm clip of 1.0, the weighted sparse
and dense losses (the step log adds ``loss_sparse``, ``loss_dense``,
``acc`` and ``codebook_entropy``); eval re-encodes every item's dense
vector with the current tower, runs ``beam_fusion`` (``n_beam`` beams,
``min(10, n_beam)`` candidates, ``fusion_alpha``) and accumulates
Recall/NDCG@1/5/10 plus each codebook's top-1 accuracy; the final valid
and test runs take the best-valid-Recall@10 snapshot (``test_on_best``).
``dataset`` may be a callable returning a ``CobraSeqData`` (the JAX
trainer's hook for injected data). ``amp`` with
``mixed_precision_type="bf16"`` computes in bf16 (parameters float32).

Fault tolerance as the JAX trainer's: resume points under
``<save_dir_root>/checkpoints`` every ``save_every_epoch`` epochs, on
SIGTERM/SIGINT (the run then returns ``({}, {})``) and, unconditionally,
after the last epoch; exact resume with ``resume_from_checkpoint=True``;
the best parameters under ``best_model`` (`core.checkpoint.BestTracker`);
``profile_steps`` steps under torch.profiler in
``<save_dir_root>/profile``.

``dataset="amazon"`` reads the review and meta dumps under
``<dataset_folder>/raw/<split>/`` and the RQ-VAE's sem-id artifact
(``sem_ids_path``) through `data.cobra_seq.amazon_cobra_data`, whose item
text takes the sentence-T5 tokenizer by its hub name: it loads where that
tokenizer is cached locally (``transformers`` is imported only there).

Runs on one device, ``device="cuda"`` by default (it raises without a
card unless given ``device="cpu"``). Not ported yet: wandb forwarding.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from genrec_tpu_torch import configlib
from genrec_tpu_torch.core.checkpoint import BestTracker, CheckpointManager, save_params
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.logging import Tracker, setup_logger
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.preemption import PreemptionGuard
from genrec_tpu_torch.core.profiling import ProfileWindow
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data.batching import batch_iterator, prefetch_to_device
from genrec_tpu_torch.data.cobra_seq import amazon_cobra_data, synthetic_cobra_data
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.cobra import Cobra, beam_fusion
from genrec_tpu_torch.ops.metrics import TopKAccumulator
from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop


@torch.no_grad()
def compute_item_dense_vecs(model, item_texts: np.ndarray, batch_size: int = 256,
                            device=None) -> torch.Tensor:
    """(N, d) dense vectors of every item from the CURRENT tower, encoded
    ``batch_size`` items at a time on the model's device."""
    model.eval()
    text = torch.as_tensor(np.asarray(item_texts), device=device or model.device)
    return torch.cat([model.encode_items(chunk[:, None, :])[:, 0]
                      for chunk in text.split(batch_size)])


def make_fusion_fn(model, item_sem_ids, n_candidates, n_beam, alpha):
    """``fuse(batch, item_vecs) -> BeamFusionOutput``; ``item_sem_ids`` a
    (N, C) tensor on the model's device."""

    def fuse(batch, item_vecs):
        model.eval()
        return beam_fusion(model, batch["input_ids"], batch["encoder_input_ids"], item_vecs,
                           item_sem_ids, n_candidates=n_candidates, n_beam=n_beam, alpha=alpha)

    return fuse


def evaluate(fusion_fn, arrays, item_vecs, batch_size, device, C: int) -> dict:
    """Recall/NDCG@1/5/10 of the fused candidates' sem-ids against the
    targets, and ``codebook_acc_<c>``: the top candidate's code c equal to
    the target's (the padded last batch's rows left out)."""
    acc = TopKAccumulator(ks=(1, 5, 10))
    cb_correct = np.zeros(C)
    cb_total = 0
    for batch, valid in prefetch_to_device(batch_iterator(arrays, batch_size), device):
        out = fusion_fn(batch, item_vecs)
        n = int(valid.sum())
        topk = out.sem_ids[:n]
        target = batch["target_sem_ids"][:n]
        acc.accumulate(target, topk)
        cb_correct += (topk[:, 0, :] == target).sum(dim=0).cpu().numpy()
        cb_total += n
    metrics = acc.reduce()
    metrics.update({f"codebook_acc_{c}": cb_correct[c] / max(cb_total, 1) for c in range(C)})
    return metrics


def make_loss_fn(sparse_loss_weight: float = 1.0, dense_loss_weight: float = 1.0):
    """``loss_fn(model, batch, generator) -> (loss, aux)``: the weighted
    sparse + dense loss of the training forward (dropout from
    ``generator``); aux carries the parts, the token accuracy and the
    codebook entropy."""

    def loss_fn(model, batch, generator):
        out = model(batch["input_ids"], batch["encoder_input_ids"], deterministic=False,
                    generator=generator)
        loss = sparse_loss_weight * out.loss_sparse + dense_loss_weight * out.loss_dense
        return loss, {
            "loss_sparse": out.loss_sparse,
            "loss_dense": out.loss_dense,
            "acc": out.acc_correct / out.acc_total.clamp_min(1),
            "codebook_entropy": out.codebook_entropy,
        }

    return loss_fn


def step_log(m: dict, global_step: int) -> dict:
    return {
        "global_step": global_step,
        "train/loss": float(m["loss"]),
        "train/loss_sparse": float(m["loss_sparse"]),
        "train/loss_dense": float(m["loss_dense"]),
        "train/acc": float(m["acc"]),
        "train/codebook_entropy": float(m["codebook_entropy"]),
    }


@configlib.configurable
def train(
    epochs=50,
    batch_size=64,
    learning_rate=3e-4,
    num_warmup_steps=100,
    weight_decay=0.01,
    sparse_loss_weight=1.0,
    dense_loss_weight=1.0,
    encoder_n_layers=1,
    encoder_hidden_dim=768,
    encoder_num_heads=8,
    encoder_vocab_size=32128,
    id_vocab_size=512,
    n_codebooks=3,
    d_model=768,
    max_len=1024,
    infonce_temperature=0.2,
    decoder_n_layers=8,
    decoder_num_heads=6,
    decoder_dropout=0.1,
    max_items=20,
    n_beam=20,
    fusion_alpha=0.5,
    dataset="synthetic",
    dataset_folder="dataset/amazon",
    split="beauty",
    sem_ids_path=None,
    do_eval=True,
    eval_every_epoch=10,
    eval_batch_size=32,
    test_on_best=True,
    save_dir_root="out/cobra",
    save_every_epoch=50,
    resume_from_checkpoint=False,
    wandb_logging=False,
    wandb_project="cobra_training",
    wandb_log_interval=100,
    amp=True,
    mixed_precision_type="bf16",
    profile_steps=0,
    seed=0,
    device="cuda",
):
    """Train COBRA; returns (valid metrics, test metrics) of the best
    parameters by valid Recall@10 (``test_on_best``) or of the last."""
    dev = resolve_device(device)
    logger = setup_logger(save_dir_root)
    tracker = Tracker(wandb_logging, wandb_project, save_dir=save_dir_root, logger=logger)

    if callable(dataset):
        data = dataset()
        id_vocab_size = data.id_vocab_size
        n_codebooks = data.C
    elif dataset == "synthetic":
        data = synthetic_cobra_data(id_vocab_size=id_vocab_size, n_codebooks=n_codebooks,
                                    text_vocab=encoder_vocab_size, max_items=max_items,
                                    seed=seed)
    else:
        if sem_ids_path is None:
            raise ValueError("amazon dataset needs sem_ids_path (RQ-VAE artifact)")
        data = amazon_cobra_data(dataset_folder, split, sem_ids_path, max_items=max_items)
        id_vocab_size = data.id_vocab_size
        n_codebooks = data.C
    train_arrays = data.train_arrays()
    valid_arrays = data.eval_arrays("valid")
    test_arrays = data.eval_arrays("test")
    item_sem_ids = torch.as_tensor(data.sem_ids, dtype=torch.int64, device=dev)

    compute_dtype = (torch.bfloat16 if (amp and mixed_precision_type == "bf16")
                     else torch.float32)
    model = Cobra(
        encoder_n_layers=encoder_n_layers, encoder_hidden_dim=encoder_hidden_dim,
        encoder_num_heads=encoder_num_heads, encoder_vocab_size=encoder_vocab_size,
        id_vocab_size=id_vocab_size, n_codebooks=n_codebooks, d_model=d_model,
        max_len=max_len, temperature=infonce_temperature, decoder_n_layers=decoder_n_layers,
        decoder_num_heads=decoder_num_heads, decoder_dropout=decoder_dropout,
        dtype=compute_dtype, device=dev, seed=seed,
    )
    total_steps = epochs * max(1, len(train_arrays["input_ids"]) // batch_size)
    optimizer = Adam(cosine_schedule_with_warmup(learning_rate, num_warmup_steps, total_steps),
                     weight_decay=weight_decay)
    step_fn = make_train_step(make_loss_fn(sparse_loss_weight, dense_loss_weight), optimizer,
                              clip_norm=1.0)
    state = TrainState.create(model, optimizer, seed)
    # The reference's eval: 10 candidates of n_beam beams, clamped for
    # small-beam runs.
    fusion_fn = make_fusion_fn(model, item_sem_ids, min(10, n_beam), n_beam, fusion_alpha)
    ckpt = CheckpointManager(os.path.join(save_dir_root, "checkpoints")) if save_dir_root else None
    best = BestTracker(save_dir_root)
    prof = ProfileWindow(os.path.join(save_dir_root, "profile") if save_dir_root else "",
                         profile_steps)
    loop = PackedTrainLoop(
        logger=logger, tracker=tracker, device=dev, prof=prof, guard=PreemptionGuard(logger),
        ckpt=ckpt, rows_per_step=batch_size, row_len=(max_items + 1) * n_codebooks, seed=seed,
        pack_sequences=False, train_arrays=train_arrays, wandb_log_interval=wandb_log_interval,
        save_dir_root=save_dir_root, step_log=step_log,
    )

    def run_eval(arrays, item_vecs):
        return evaluate(fusion_fn, arrays, item_vecs, eval_batch_size, dev, n_codebooks)

    start_epoch, start_batch, global_step = 0, 0, 0
    if resume_from_checkpoint:
        # Step-granular exact resume: continues at the exact next batch of a
        # possibly mid-epoch resume point.
        state, start_epoch, start_batch, global_step = loop.resume(state)
    for epoch in range(start_epoch, epochs):
        res = loop.run_epoch(state, step_fn, epoch, global_step,
                             start_batch=start_batch if epoch == start_epoch else 0)
        state, global_step = res.state, res.global_step
        if res.preempted:
            # The loop wrote a durable resume point (mid-final-epoch too):
            # exit cleanly so that the scheduler restarts the run with
            # resume_from_checkpoint.
            loop.shutdown(preempted_epoch=epoch)
            return {}, {}
        if ckpt is not None and (epoch + 1) % save_every_epoch == 0:
            # Epoch-boundary resume point: cursor = (next epoch, batch 0).
            loop.save(state, epoch=epoch + 1, next_batch=0, global_step=global_step)
        if do_eval and (epoch + 1) % eval_every_epoch == 0:
            m = run_eval(valid_arrays, compute_item_dense_vecs(model, data.item_texts))
            logger.info(f"epoch {epoch} valid " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
            tracker.log({"epoch": epoch, **{f"eval/{k}": v for k, v in m.items()}})
            best.update(m["Recall@10"], model.state_dict())

    # Unconditional final resume point: a save_every_epoch cadence that
    # never fires must not leave a finished run with nothing to resume from.
    loop.save(state, epoch=epochs, next_batch=0, global_step=global_step)
    best_params = best.best_params(like=model.state_dict()) if test_on_best else None
    if best_params is not None:
        model.load_state_dict(best_params)
    item_vecs = compute_item_dense_vecs(model, data.item_texts)
    valid_metrics = run_eval(valid_arrays, item_vecs)
    test_metrics = run_eval(test_arrays, item_vecs)
    logger.info("test " + ", ".join(f"{k}={v:.4f}" for k, v in test_metrics.items()))
    tracker.log({f"test/{k}": v for k, v in test_metrics.items()})
    if save_dir_root and best.value < 0:  # no eval ran: snapshot the final params
        save_params(os.path.join(save_dir_root, "best_model"), model.state_dict())
    loop.shutdown()
    return valid_metrics, test_metrics


if __name__ == "__main__":
    configlib.parse_config()
    train()
