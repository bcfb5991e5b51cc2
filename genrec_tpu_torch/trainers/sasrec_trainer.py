"""SASRec trainer (port of genrec_tpu/trainers/sasrec_trainer.py).

    python -m genrec_tpu_torch.trainers.sasrec_trainer config/sasrec/synthetic.gin \
        [--gin 'train.device="cpu"']

The same config files drive both packages. Epoch loop, Adam(b2=0.98) (or
AdamW with weight decay), no LR schedule and no clipping, full-vocab eval
every epoch, best-Recall@10 snapshot, first-fit-decreasing sequence
packing with segment-masked attention and within-segment positions (eval
rows right-aligned, predictions read at the last valid slot).
``use_fused_ce`` keeps its JAX name; ``"auto"`` means True: the CUDA
kernels (B3, B4) on the card, their plain versions on the CPU, through
the same ``fused_ce_mean_loss``.

Fault tolerance as the JAX trainer's: resume points under
``<save_dir_root>/checkpoints`` every ``save_every_epoch`` epochs and on
SIGTERM/SIGINT (the run then returns ``({}, {})``), exact resume with
``resume_from_checkpoint=True``, the best parameters under
``best_model`` (`core.checkpoint.BestTracker`), ``profile_steps`` steps
under torch.profiler in ``<save_dir_root>/profile``.

``dataset="amazon"`` reads the review dump under
``<dataset_folder>/raw/<split>/`` (`data.amazon.AmazonSASRecData`; the
``num_items`` binding is then ignored, as in JAX).

Runs on one device, ``device="cuda"`` by default (it raises without a
card unless given ``device="cpu"``), or data-parallel over the ranks of
``torchrun --nproc_per_node N``: each rank keeps its rows of the global
``batch_size``. Not ported yet: wandb forwarding.
"""

from __future__ import annotations

import os

import torch

from genrec_tpu_torch import configlib
from genrec_tpu_torch.core.checkpoint import BestTracker, CheckpointManager, save_params
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.logging import Tracker, setup_logger
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.preemption import PreemptionGuard
from genrec_tpu_torch.core.profiling import ProfileWindow
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data.amazon import AmazonSASRecData
from genrec_tpu_torch.data.batching import pack_examples, right_align
from genrec_tpu_torch.data.synthetic import SyntheticSeqDataset
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.sasrec import SASRec
from genrec_tpu_torch.parallel.mesh import distributed_init
from genrec_tpu_torch.trainers.evaluation import evaluate, topk_sums
from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop


def make_eval_step(model, last_from_length: bool = False):
    """``eval_step(batch, valid) -> dict of device sums``: ``topk_sums`` of
    the logits at the last slot, or with ``last_from_length`` at the last
    valid slot of a right-aligned row (packed training's position
    indexing)."""

    @torch.no_grad()
    def eval_step(batch, valid):
        model.eval()
        ids = batch["input_ids"]
        logits, _ = model(ids)
        if last_from_length:
            idx = ((ids != 0).sum(dim=1) - 1).clamp_min(0)
            last = logits[torch.arange(ids.shape[0], device=ids.device), idx]
        else:
            last = logits[:, -1, :]
        return topk_sums(last, batch["targets"], valid)

    return eval_step


def make_loss_fn():
    """``loss_fn(model, batch, generator) -> (loss, aux)``: the training
    forward with dropout from ``generator``; packed batches pass their
    segment ids and positions and add the real-token count to aux."""

    def loss_fn(model, batch, generator):
        _, loss = model(batch["input_ids"], batch["targets"], deterministic=False,
                        segment_ids=batch.get("segment_ids"),
                        positions=batch.get("positions"), generator=generator)
        aux = {}
        if "segment_ids" in batch:
            aux["real_tokens"] = (batch["segment_ids"] != 0).sum().to(torch.float32)
        return loss, aux

    return loss_fn


@configlib.configurable
def train(
    epochs=10,
    batch_size=128,
    learning_rate=1e-3,
    weight_decay=0.0,
    max_seq_len=50,
    embed_dim=64,
    num_heads=2,
    num_blocks=2,
    ffn_dim=256,
    dropout=0.2,
    dataset="synthetic",
    dataset_folder="dataset/amazon",
    split="beauty",
    num_items=None,
    do_eval=True,
    eval_every_epoch=1,
    eval_batch_size=256,
    save_dir_root="out/sasrec",
    save_every_epoch=50,
    resume_from_checkpoint=False,
    wandb_logging=False,
    wandb_project="sasrec_training",
    wandb_log_interval=100,
    amp=True,
    mixed_precision_type="bf16",
    use_fused_ce="auto",
    pack_sequences=True,
    profile_steps=0,
    seed=0,
    device="cuda",
):
    """Train SASRec; returns (valid metrics, test metrics) of the best
    parameters (by valid Recall@10), as the JAX trainer does."""
    mesh = distributed_init(device)  # data-parallel over torchrun's ranks, if any
    dev = mesh.device or resolve_device(device)
    # Rank 0 writes the run's files; every rank logs to its own stdout.
    logger = setup_logger(save_dir_root if mesh.lead else None)
    tracker = Tracker(wandb_logging and mesh.lead, wandb_project,
                      save_dir=save_dir_root if mesh.lead else None, logger=logger)

    if dataset == "synthetic":
        ds = SyntheticSeqDataset(max_seq_len=max_seq_len, seed=seed)
        n_items = num_items or ds.num_items
    else:
        ds = AmazonSASRecData(root=dataset_folder, split=split, max_seq_len=max_seq_len)
        n_items = ds.num_items
    valid_arrays = ds.eval_arrays("valid")
    test_arrays = ds.eval_arrays("test")

    repack, train_arrays = None, None
    if pack_sequences:
        examples = ds.train_examples()

        def repack(epoch: int):
            arrays, rep = pack_examples(examples, row_len=max_seq_len, seed=(seed, epoch))
            arrays.pop("segment_valid")  # unused by SASRec's token-level CE
            return arrays, rep

        # Eval rows index positions as packed training does (token t at
        # position t); predictions come from the last valid slot.
        valid_arrays = right_align(valid_arrays)
        test_arrays = right_align(test_arrays)
    else:
        train_arrays = ds.train_arrays()

    compute_dtype = (torch.bfloat16 if (amp and mixed_precision_type == "bf16")
                     else torch.float32)
    model = SASRec(
        num_items=n_items, max_seq_len=max_seq_len, embed_dim=embed_dim,
        num_heads=num_heads, num_blocks=num_blocks, ffn_dim=ffn_dim, dropout=dropout,
        fused_ce=use_fused_ce == "auto" or bool(use_fused_ce), dtype=compute_dtype,
        device=dev, seed=seed,
    )
    optimizer = Adam(learning_rate, b2=0.98, weight_decay=weight_decay)
    step_fn = make_train_step(make_loss_fn(), optimizer, clip_norm=None, data_group=mesh.data)
    state = TrainState.create(model, optimizer, seed)
    eval_step = make_eval_step(model, last_from_length=pack_sequences)
    ckpt = CheckpointManager(os.path.join(save_dir_root, "checkpoints")) if save_dir_root else None
    best = BestTracker(save_dir_root)
    prof = ProfileWindow(os.path.join(save_dir_root, "profile") if save_dir_root else "",
                         profile_steps)
    loop = PackedTrainLoop(
        logger=logger, tracker=tracker, device=dev, prof=prof, guard=PreemptionGuard(logger),
        ckpt=ckpt, rows_per_step=batch_size, row_len=max_seq_len, seed=seed,
        pack_sequences=pack_sequences, repack=repack, train_arrays=train_arrays,
        wandb_log_interval=wandb_log_interval, save_dir_root=save_dir_root,
        data_group=mesh.data,
    )
    start_epoch, start_batch, global_step = 0, 0, 0
    if resume_from_checkpoint:
        # Step-granular exact resume: the TrainState and the data cursor
        # through the integrity ladder, continuing at the exact next batch
        # of a possibly mid-epoch resume point.
        state, start_epoch, start_batch, global_step = loop.resume(state)
    for epoch in range(start_epoch, epochs):
        res = loop.run_epoch(state, step_fn, epoch, global_step,
                             start_batch=start_batch if epoch == start_epoch else 0)
        state, global_step = res.state, res.global_step
        if res.preempted:
            # The loop wrote a durable resume point: exit cleanly so that the
            # scheduler restarts the run with resume_from_checkpoint.
            loop.shutdown(preempted_epoch=epoch)
            return {}, {}
        if ckpt is not None and (epoch + 1) % save_every_epoch == 0:
            # Epoch-boundary resume point: cursor = (next epoch, batch 0).
            loop.save(state, epoch=epoch + 1, next_batch=0, global_step=global_step)
        if do_eval and (epoch + 1) % eval_every_epoch == 0:
            m = evaluate(eval_step, valid_arrays, eval_batch_size, dev, mesh.data)
            logger.info(f"epoch {epoch} valid " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
            tracker.log({"epoch": epoch, **{f"eval/{k}": v for k, v in m.items()}})
            best.update(m["Recall@10"], model.state_dict())

    best_params = best.best_params(like=model.state_dict())
    if best_params is not None:
        model.load_state_dict(best_params)
    valid_metrics = evaluate(eval_step, valid_arrays, eval_batch_size, dev, mesh.data)
    test_metrics = evaluate(eval_step, test_arrays, eval_batch_size, dev, mesh.data)
    logger.info("test " + ", ".join(f"{k}={v:.4f}" for k, v in test_metrics.items()))
    tracker.log({f"test/{k}": v for k, v in test_metrics.items()})
    if save_dir_root and best.value < 0:  # no eval ran: the final params
        save_params(os.path.join(save_dir_root, "best_model"), model.state_dict())
    loop.shutdown()
    return valid_metrics, test_metrics


if __name__ == "__main__":
    configlib.parse_config()
    train()
