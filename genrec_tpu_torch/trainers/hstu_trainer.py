"""HSTU trainer (port of genrec_tpu/trainers/hstu_trainer.py).

    python -m genrec_tpu_torch.trainers.hstu_trainer config/hstu/amazon.gin \
        [--gin 'train.dataset="synthetic"'] [--gin 'train.device="cpu"']

The same config files drive both packages. Epoch loop, Adam(b2=0.98) (or
AdamW with weight decay), no LR schedule, full-vocab eval, timestamps
passed through, first-fit-decreasing sequence packing with
segment-masked attention. ``use_pallas`` and ``use_fused_ce`` keep their
JAX names; ``"auto"`` means True: the CUDA kernels on the card, their
plain versions on the CPU.

Fault tolerance as the JAX trainer's: resume points under
``<save_dir_root>/checkpoints`` every ``save_every_epoch`` epochs and on
SIGTERM/SIGINT (the run then returns ``({}, {})``), exact resume with
``resume_from_checkpoint=True``, the best parameters under
``best_model`` (`core.checkpoint.BestTracker`), ``profile_steps`` steps
under torch.profiler in ``<save_dir_root>/profile``.

``dataset="amazon"`` reads the review dump under
``<dataset_folder>/raw/<split>/`` (`data.amazon.AmazonSASRecData` with
timestamps; the ``num_items`` binding is then ignored, as in JAX).

Runs on one device, ``device="cuda"`` by default (it raises without a
card unless given ``device="cpu"``). Not ported yet: wandb forwarding.
"""

from __future__ import annotations

import functools
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
from genrec_tpu_torch.data.batching import pack_examples
from genrec_tpu_torch.data.synthetic import SyntheticSeqDataset
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.hstu import HSTU
from genrec_tpu_torch.trainers.evaluation import evaluate, topk_sums
from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop


def make_eval_step(model):
    """``eval_step(batch, valid) -> dict of device sums``: ``topk_sums`` of
    the last slot's logits."""

    @torch.no_grad()
    def eval_step(batch, valid):
        model.eval()
        logits, _ = model(batch["input_ids"], batch.get("timestamps"))
        return topk_sums(logits[:, -1, :], batch["targets"], valid)

    return eval_step


def make_loss_fn():
    """``loss_fn(model, batch, generator) -> (loss, aux)``: the training
    forward with dropout from ``generator``; packed batches add the
    real-token count to aux."""

    def loss_fn(model, batch, generator):
        _, loss = model(batch["input_ids"], batch.get("timestamps"), batch["targets"],
                        deterministic=False, segment_ids=batch.get("segment_ids"),
                        generator=generator)
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
    dropout=0.2,
    num_position_buckets=32,
    num_time_buckets=64,
    max_position_distance=128,
    use_temporal_bias=True,
    use_pallas="auto",
    use_fused_ce="auto",
    pack_sequences=True,
    dataset="synthetic",
    dataset_folder="dataset/amazon",
    split="beauty",
    num_items=None,
    do_eval=True,
    eval_every_epoch=1,
    eval_batch_size=256,
    save_dir_root="out/hstu",
    save_every_epoch=50,
    resume_from_checkpoint=False,
    wandb_logging=False,
    wandb_project="hstu_training",
    wandb_log_interval=100,
    amp=True,
    mixed_precision_type="bf16",
    profile_steps=0,
    seed=0,
    device="cuda",
):
    """Train HSTU; returns (valid metrics, test metrics) of the best
    parameters (by valid Recall@10), as the JAX trainer does."""
    dev = resolve_device(device)
    logger = setup_logger(save_dir_root)
    tracker = Tracker(wandb_logging, wandb_project, save_dir=save_dir_root, logger=logger)

    if dataset == "synthetic":
        ds = SyntheticSeqDataset(max_seq_len=max_seq_len, seed=seed)
        n_items = num_items or ds.num_items
        valid_arrays = ds.eval_arrays_with_time("valid")
        test_arrays = ds.eval_arrays_with_time("test")
        train_examples = functools.partial(ds.train_examples, with_time=True)
        padded_train = ds.train_arrays_with_time
    else:
        ds = AmazonSASRecData(root=dataset_folder, split=split, max_seq_len=max_seq_len,
                              with_timestamps=True)
        n_items = ds.num_items
        valid_arrays = ds.eval_arrays("valid")
        test_arrays = ds.eval_arrays("test")
        train_examples = ds.train_examples
        padded_train = ds.train_arrays

    repack, train_arrays = None, None
    if pack_sequences:
        examples = train_examples()

        def repack(epoch: int):
            arrays, rep = pack_examples(examples, row_len=max_seq_len, seed=(seed, epoch))
            # HSTU has no absolute positions and segment_valid has no
            # consumer in its token-level CE: not shipped to the device.
            arrays.pop("positions")
            arrays.pop("segment_valid")
            return arrays, rep
    else:
        train_arrays = padded_train()

    compute_dtype = (torch.bfloat16 if (amp and mixed_precision_type == "bf16")
                     else torch.float32)
    model = HSTU(
        num_items=n_items, max_seq_len=max_seq_len, embed_dim=embed_dim,
        num_heads=num_heads, num_blocks=num_blocks, dropout=dropout,
        num_position_buckets=num_position_buckets, num_time_buckets=num_time_buckets,
        max_position_distance=max_position_distance, use_temporal_bias=use_temporal_bias,
        use_pallas=use_pallas == "auto" or bool(use_pallas),
        fused_ce=use_fused_ce == "auto" or bool(use_fused_ce),
        dtype=compute_dtype, device=dev, seed=seed,
    )
    optimizer = Adam(learning_rate, b2=0.98, weight_decay=weight_decay)
    step_fn = make_train_step(make_loss_fn(), optimizer, clip_norm=None)
    state = TrainState.create(model, optimizer, seed)
    eval_step = make_eval_step(model)
    ckpt = CheckpointManager(os.path.join(save_dir_root, "checkpoints")) if save_dir_root else None
    best = BestTracker(save_dir_root)
    prof = ProfileWindow(os.path.join(save_dir_root, "profile") if save_dir_root else "",
                         profile_steps)
    loop = PackedTrainLoop(
        logger=logger, tracker=tracker, device=dev, prof=prof, guard=PreemptionGuard(logger),
        ckpt=ckpt, rows_per_step=batch_size, row_len=max_seq_len, seed=seed,
        pack_sequences=pack_sequences, repack=repack, train_arrays=train_arrays,
        wandb_log_interval=wandb_log_interval, save_dir_root=save_dir_root,
    )
    start_epoch, start_batch, global_step = 0, 0, 0
    if resume_from_checkpoint:
        # Step-granular exact resume through the integrity ladder.
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
            m = evaluate(eval_step, valid_arrays, eval_batch_size, dev)
            logger.info(f"epoch {epoch} valid " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
            tracker.log({"epoch": epoch, **{f"eval/{k}": v for k, v in m.items()}})
            best.update(m["Recall@10"], model.state_dict())

    best_params = best.best_params(like=model.state_dict())
    if best_params is not None:
        model.load_state_dict(best_params)
    valid_metrics = evaluate(eval_step, valid_arrays, eval_batch_size, dev)
    test_metrics = evaluate(eval_step, test_arrays, eval_batch_size, dev)
    logger.info("test " + ", ".join(f"{k}={v:.4f}" for k, v in test_metrics.items()))
    tracker.log({f"test/{k}": v for k, v in test_metrics.items()})
    if save_dir_root and best.value < 0:  # no eval ran: snapshot the final params
        save_params(os.path.join(save_dir_root, "best_model"), model.state_dict())
    loop.shutdown()
    return valid_metrics, test_metrics


if __name__ == "__main__":
    configlib.parse_config()
    train()
