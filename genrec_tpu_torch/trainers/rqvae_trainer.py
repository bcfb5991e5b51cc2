"""RQ-VAE trainer (port of genrec_tpu/trainers/rqvae_trainer.py).

    python -m genrec_tpu_torch.trainers.rqvae_trainer config/tiger/amazon/rqvae.gin \
        --gin 'train.dataset="synthetic"' [--gin 'train.device="cpu"']

The same config files drive both packages (their ``genrec_tpu.`` names
read as this package's, see ``configlib``). Epoch- or iteration-based,
AdamW with a linear warm-up schedule, clip 1.0, a fixed Gumbel
temperature, a seeded k-means warm-up of the codebooks before step 0,
eval losses and the collision rate over the full item set, and, on exit,
the portable sem-id artifact (``data/sem_ids.py``) that the TIGER stage
reads.

**Semantic ids through kernel B7.** ``compute_sem_ids`` keeps the JAX
``use_pallas`` switch, and ``train`` calls it with ``use_pallas=True``:
with raw codebooks (no ``sim_vq``, no normalisation, as in the shipped
configs) the collision eval and the export encode with the MLP and run
the residual cascade through ``kernels.rq_cascade`` (the CUDA kernel on
the card, its plain version on the CPU); otherwise the model's own
``get_semantic_ids``. This is the port's choice: the JAX trainer leaves
the Pallas cascade off by default because it was slower than XLA's
fusion on a TPU v5e; on the H100 the card's numbers decide, and there
the kernel takes about half the plain cascade's time (PERF.md, B7).

Runs on one device, ``device="cuda"`` by default (it raises without a
card unless given ``device="cpu"``), or data-parallel over the ranks of
``torchrun --nproc_per_node N``: each rank keeps its rows of the global
``batch_size``; the Sinkhorn level and the Gumbel noise see the global
batch (``models.rqvae``), and the export runs B7 on each rank's rows of
every chunk and gathers the ids (B7 is row-wise, so they are the
one-rank ids bit for bit). ``dataset="synthetic"`` makes
clustered item embeddings; ``"amazon"`` reads the cached
``<dataset_folder>/processed/<split>_item_emb.npy`` (95/5 split by a seeded
permutation); ``"p5"`` reads the same file beside a P5 directory
(`data.p5_amazon.P5AmazonData`; split by the seed-42 item mask).
``num_items`` sizes the synthetic item set (default 2,000, as the JAX
trainer's). Fault tolerance as the JAX trainer's: resume points under
``<save_dir_root>/checkpoints`` every ``save_model_every`` epochs (or
iterations, in iteration mode), after the last epoch and on
SIGTERM/SIGINT (the run then returns ``(model, None)``); exact resume
with ``resume_from_checkpoint=True``; ``profile_steps`` steps under
torch.profiler in ``<save_dir_root>/profile``. The final parameters also
go to ``<save_dir_root>/final_params.pt`` with ``torch.save``. wandb
forwarding is not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from genrec_tpu_torch import configlib
from genrec_tpu_torch.core.checkpoint import CheckpointManager
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.logging import Tracker, setup_logger
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.preemption import PreemptionGuard
from genrec_tpu_torch.core.profiling import ProfileWindow
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data.batching import pad_to_batch
from genrec_tpu_torch.data.items import ItemEmbeddingData, SyntheticItemEmbeddings
from genrec_tpu_torch.data.p5_amazon import P5AmazonData, item_train_mask
from genrec_tpu_torch.data.sem_ids import save_sem_ids
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.kernels.rq_cascade import rq_cascade
from genrec_tpu_torch.models.rqvae import (
    QuantizeForwardMode,
    RqVae,
    count_distinct,
    kmeans_init_params,
)
from genrec_tpu_torch.ops.schedules import linear_schedule_with_warmup
from genrec_tpu_torch.parallel.mesh import distributed_init, shard_batch, to_host
from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop


@torch.no_grad()
def compute_sem_ids(model: RqVae, embeddings: np.ndarray, batch_size: int = 4096,
                    use_pallas: bool = False, data_group=None) -> np.ndarray:
    """Semantic ids for every item (row i -> item id i+1), (N, L) int32,
    in chunks padded to ``batch_size`` rows. With ``use_pallas`` and raw
    codebooks each chunk is one residual-cascade call (one launch of
    kernel B7 on the card: ceil(N / batch_size) for the whole set). With a
    ``data_group`` each rank encodes its rows of every chunk and the ids
    are gathered over the group (``parallel.mesh.to_host``)."""
    fused_ok = use_pallas and not (model.codebook_sim_vq or model.codebook_normalize)
    codebooks = model.codebooks().detach() if fused_ok else None
    chunks = []
    for s in range(0, len(embeddings), batch_size):
        chunk = {"x": embeddings[s:s + batch_size]}
        n_real = len(chunk["x"])
        padded, _ = pad_to_batch(chunk, batch_size)
        x = torch.as_tensor(shard_batch(padded, data_group)["x"], device=model.device)
        if fused_ok:
            ids, _ = rq_cascade(model.encode(x), codebooks)
        else:
            ids = model.get_semantic_ids(x, 0.001).sem_ids
        chunks.append(to_host(ids.to(torch.int32), data_group)[:n_real])
    return np.concatenate(chunks)


def compute_collision_rate(model: RqVae, embeddings: np.ndarray, use_pallas: bool = False,
                           data_group=None):
    """(collision rate, items, distinct sem-id tuples) over ``embeddings``."""
    sem_ids = compute_sem_ids(model, embeddings, use_pallas=use_pallas, data_group=data_group)
    n = len(sem_ids)
    unique = int(count_distinct(torch.as_tensor(sem_ids)))
    return (n - unique) / n, n, unique


def make_loss_fn(gumbel_temperature: float):
    """``loss_fn(model, batch, generator) -> (loss, aux)``: the training
    forward, Gumbel noise from ``generator``."""

    def loss_fn(model, batch, generator):
        out = model(batch["x"], gumbel_temperature, training=True, generator=generator)
        return out.loss, {"reconstruction_loss": out.reconstruction_loss,
                          "rqvae_loss": out.rqvae_loss, "p_unique_ids": out.p_unique_ids}

    return loss_fn


@configlib.configurable
def train(
    epochs=None,
    iterations=None,
    warmup_epochs=0,
    warmup_iters=0,
    batch_size=1024,
    learning_rate=1e-3,
    weight_decay=1e-4,
    vae_input_dim=768,
    vae_n_cat_feats=0,
    vae_hidden_dims=(512, 256, 128, 64),
    vae_embed_dim=32,
    vae_codebook_size=256,
    vae_codebook_normalize=False,
    vae_sim_vq=False,
    vae_n_layers=3,
    vae_codebook_mode=QuantizeForwardMode.STE,
    vae_codebook_last_layer_mode=QuantizeForwardMode.SINKHORN,
    commitment_weight=0.25,
    gumbel_temperature=0.2,
    use_kmeans_init=True,
    kmeans_warmup_rows=20000,
    dataset="synthetic",
    dataset_folder="dataset/amazon",
    split="beauty",
    num_items=2000,
    do_eval=True,
    eval_every=50,
    save_model_every=50,
    save_dir_root="out/rqvae",
    resume_from_checkpoint=False,
    sem_ids_path=None,
    wandb_logging=False,
    wandb_project="rqvae_training",
    wandb_log_interval=100,
    profile_steps=0,
    seed=0,
    device="cuda",
):
    """Train the RQ-VAE and export its semantic ids; returns (model, sem_ids
    (N, L) int32)."""
    if (epochs is None) == (iterations is None):
        raise ValueError("specify exactly one of 'epochs' or 'iterations'")
    use_epochs = epochs is not None
    mesh = distributed_init(device)  # data-parallel over torchrun's ranks, if any
    dev = mesh.device or resolve_device(device)
    # Rank 0 writes the run's files; every rank logs to its own stdout.
    logger = setup_logger(save_dir_root if mesh.lead else None)
    tracker = Tracker(wandb_logging and mesh.lead, wandb_project,
                      save_dir=save_dir_root if mesh.lead else None, logger=logger)

    if dataset == "p5":
        # The reference's default source (P5AmazonReviewsItemDataset): items
        # split by the seed-42 train mask (p5_amazon.py:365-367).
        all_x = P5AmazonData(dataset_folder, split).item_embeddings()
        mask = item_train_mask(len(all_x))
        train_x, eval_x = all_x[mask], all_x[~mask]
    else:
        src = (SyntheticItemEmbeddings(num_items=num_items, dim=vae_input_dim, seed=seed)
               if dataset == "synthetic" else ItemEmbeddingData(root=dataset_folder, split=split))
        train_x, eval_x = src.arrays()
        all_x = src.embeddings

    model = RqVae(
        input_dim=vae_input_dim, embed_dim=vae_embed_dim,
        hidden_dims=tuple(vae_hidden_dims), codebook_size=vae_codebook_size,
        codebook_normalize=vae_codebook_normalize, codebook_sim_vq=vae_sim_vq,
        codebook_mode=vae_codebook_mode,
        codebook_last_layer_mode=vae_codebook_last_layer_mode, n_layers=vae_n_layers,
        commitment_weight=commitment_weight, n_cat_features=vae_n_cat_feats,
        device=dev, seed=seed,
    )
    if use_kmeans_init:
        warm = train_x[:kmeans_warmup_rows]
        gen = torch.Generator(device=dev).manual_seed(seed + 1)  # a stream of its own
        kmeans_init_params(model, torch.as_tensor(warm, device=dev), gen)
        logger.info(f"kmeans init on {len(warm)} rows")

    steps_per_epoch = max(1, len(train_x) // batch_size)
    if use_epochs:
        total_steps = epochs * steps_per_epoch
        warmup_steps = warmup_epochs * steps_per_epoch
    else:
        total_steps = iterations
        warmup_steps = warmup_iters
        epochs = (iterations + steps_per_epoch - 1) // steps_per_epoch

    schedule = linear_schedule_with_warmup(learning_rate, warmup_steps, total_steps)
    optimizer = Adam(schedule, weight_decay=weight_decay)
    step_fn = make_train_step(make_loss_fn(gumbel_temperature), optimizer, clip_norm=1.0,
                              data_group=mesh.data)
    state = TrainState.create(model, optimizer, seed)
    eval_t = torch.as_tensor(eval_x, device=dev)

    def evaluate(label: str) -> None:
        with torch.no_grad():
            le = model(eval_t, gumbel_temperature, training=False)
        cr, n, uniq = compute_collision_rate(model, all_x, use_pallas=True,
                                             data_group=mesh.data)
        logger.info(f"{label} eval loss {float(le.loss):.4f} rec "
                    f"{float(le.reconstruction_loss):.4f} vq {float(le.rqvae_loss):.4f} "
                    f"collision {cr:.4f} ({uniq}/{n})")
        tracker.log({"eval_total_loss": float(le.loss),
                     "eval_reconstruction_loss": float(le.reconstruction_loss),
                     "eval_rqvae_loss": float(le.rqvae_loss),
                     "collision_rate": cr, "unique_semantic_ids": uniq})

    ckpt = CheckpointManager(os.path.join(save_dir_root, "checkpoints")) if save_dir_root else None
    prof = ProfileWindow(os.path.join(save_dir_root, "profile") if save_dir_root else "",
                         profile_steps)

    def step_hook(hook_state, metrics, g, epoch, next_batch):
        if use_epochs:
            return
        # Iteration mode gates eval and save on iterations, not derived
        # epochs.
        if do_eval and g % eval_every == 0:
            evaluate(f"iter {g}")
        if g % save_model_every == 0:
            loop.save(hook_state, epoch=epoch, next_batch=next_batch, global_step=g)

    loop = PackedTrainLoop(
        logger=logger, tracker=tracker, device=dev, prof=prof, guard=PreemptionGuard(logger),
        ckpt=ckpt, rows_per_step=batch_size, row_len=1, seed=seed, pack_sequences=False,
        train_arrays={"x": train_x}, wandb_log_interval=wandb_log_interval,
        save_dir_root=save_dir_root, step_hook=step_hook, data_group=mesh.data,
    )
    start_epoch, start_batch, global_step = 0, 0, 0
    if resume_from_checkpoint:
        # Step-granular exact resume: continues at the exact next batch of a
        # possibly mid-epoch resume point.
        state, start_epoch, start_batch, global_step = loop.resume(state)
    for epoch in range(start_epoch, epochs):
        res = loop.run_epoch(state, step_fn, epoch, global_step,
                             start_batch=start_batch if epoch == start_epoch else 0,
                             max_steps=None if use_epochs else total_steps)
        state, global_step = res.state, res.global_step
        if res.preempted:
            # The loop wrote a durable resume point: exit cleanly so that the
            # scheduler restarts the run with resume_from_checkpoint.
            loop.shutdown(preempted_epoch=epoch)
            return model, None
        if use_epochs and do_eval and ((epoch + 1) % eval_every == 0 or epoch + 1 == epochs):
            evaluate(f"epoch {epoch + 1}")
        if ckpt is not None and (
                (use_epochs and ((epoch + 1) % save_model_every == 0 or epoch + 1 == epochs))
                or (not use_epochs and epoch + 1 == epochs)):
            # Epoch-boundary resume point (cursor = next epoch, batch 0); the
            # last epoch always saves, so a signal in its eval window still
            # leaves a resumable record.
            loop.save(state, epoch=epoch + 1, next_batch=0, global_step=global_step)

    if save_dir_root and mesh.writer:
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                   os.path.join(save_dir_root, "final_params.pt"))
    sem_ids = compute_sem_ids(model, all_x, use_pallas=True, data_group=mesh.data)
    out_path = sem_ids_path or os.path.join(save_dir_root, "sem_ids.npz")
    save_sem_ids(out_path, sem_ids, vae_codebook_size)
    logger.info(f"exported semantic ids -> {out_path}")
    loop.shutdown()
    return model, sem_ids


if __name__ == "__main__":
    configlib.parse_config()
    train()
