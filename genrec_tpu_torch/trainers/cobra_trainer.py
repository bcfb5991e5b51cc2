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

Runs on one device, ``device="cuda"`` by default (it raises without a
card unless given ``device="cpu"``). Not ported yet: the ``amazon``
dataset branch (ROADMAP A18), resume and periodic checkpoints, profiling
windows (A12) -- including the JAX trainer's final unconditional resume
point (``loop.save`` after the last epoch), which is a resume point like
the others -- and wandb forwarding.
"""

from __future__ import annotations

import numpy as np
import torch

from genrec_tpu_torch import configlib
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.logging import Tracker, setup_logger
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data.batching import batch_iterator, prefetch_to_device
from genrec_tpu_torch.data.cobra_seq import synthetic_cobra_data
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.cobra import Cobra, beam_fusion
from genrec_tpu_torch.ops.metrics import TopKAccumulator
from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
from genrec_tpu_torch.trainers.evaluation import BestTracker
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
    if not callable(dataset) and dataset != "synthetic":
        raise NotImplementedError(
            f"dataset={dataset!r}: amazon_cobra_data reads the review files and a "
            "sentence-transformers tokenizer, neither in the repository (ROADMAP A18); "
            "use dataset='synthetic' or a callable dataset")
    if resume_from_checkpoint or profile_steps or (save_dir_root and save_every_epoch <= epochs):
        raise NotImplementedError(
            "resume_from_checkpoint, profile_steps and periodic checkpoints "
            f"(save_every_epoch={save_every_epoch} <= epochs={epochs}) are not ported "
            "yet (ROADMAP A12)")
    logger = setup_logger(save_dir_root)
    tracker = Tracker(wandb_logging, wandb_project, save_dir=save_dir_root, logger=logger)

    if callable(dataset):
        data = dataset()
        id_vocab_size = data.id_vocab_size
        n_codebooks = data.C
    else:
        data = synthetic_cobra_data(id_vocab_size=id_vocab_size, n_codebooks=n_codebooks,
                                    text_vocab=encoder_vocab_size, max_items=max_items,
                                    seed=seed)
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
    best = BestTracker(save_dir_root)
    loop = PackedTrainLoop(
        logger=logger, tracker=tracker, device=dev, rows_per_step=batch_size,
        row_len=(max_items + 1) * n_codebooks, seed=seed, pack_sequences=False,
        train_arrays=train_arrays, wandb_log_interval=wandb_log_interval, step_log=step_log,
    )

    def run_eval(arrays, item_vecs):
        return evaluate(fusion_fn, arrays, item_vecs, eval_batch_size, dev, n_codebooks)

    global_step = 0
    for epoch in range(epochs):
        res = loop.run_epoch(state, step_fn, epoch, global_step)
        state, global_step = res.state, res.global_step
        if do_eval and (epoch + 1) % eval_every_epoch == 0:
            m = run_eval(valid_arrays, compute_item_dense_vecs(model, data.item_texts))
            logger.info(f"epoch {epoch} valid " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
            tracker.log({"epoch": epoch, **{f"eval/{k}": v for k, v in m.items()}})
            best.update(m["Recall@10"], model)

    if test_on_best and best.params is not None:
        model.load_state_dict(best.params)
    if save_dir_root and best.value < 0:  # no eval ran: snapshot the final params
        best.update(np.inf, model)
    item_vecs = compute_item_dense_vecs(model, data.item_texts)
    valid_metrics = run_eval(valid_arrays, item_vecs)
    test_metrics = run_eval(test_arrays, item_vecs)
    logger.info("test " + ", ".join(f"{k}={v:.4f}" for k, v in test_metrics.items()))
    tracker.log({f"test/{k}": v for k, v in test_metrics.items()})
    loop.shutdown()
    return valid_metrics, test_metrics


if __name__ == "__main__":
    configlib.parse_config()
    train()
