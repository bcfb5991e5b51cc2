"""TIGER trainer (port of genrec_tpu/trainers/tiger_trainer.py).

    python -m genrec_tpu_torch.trainers.tiger_trainer config/tiger/synthetic.gin \
        [--gin 'train.device="cpu"']
    torchrun --standalone --nproc_per_node=2 -m genrec_tpu_torch.trainers.tiger_trainer \
        config/tiger/synthetic.gin --gin 'train.tensor_parallel=2'
    torchrun --standalone --nproc_per_node=4 ... --gin 'train.tensor_parallel=2'  # tp x dp

The same config files drive both packages. Epoch loop, AdamW on the
cosine warm-up schedule, gradient accumulation and a global-norm clip of
1.0 inside the step, first-fit-decreasing packing of the encoder stream
(``pack_max_segments`` examples a row at most, re-packed every epoch; the
decoders stay per example) or the padded one-example-a-row layout, and
eval by trie-constrained sampled ``tiger_generate`` into Recall@5/10 and
NDCG@5/10, with the best-valid-Recall@10 snapshot for the final valid and
test runs (``test_on_best``). ``amp`` with ``mixed_precision_type="bf16"``
computes in bf16 (parameters float32, as the Flax model's ``dtype``).

Fault tolerance as the JAX trainer's: resume points under
``<save_dir_root>/checkpoints`` every ``save_every_epoch`` epochs and on
SIGTERM/SIGINT (the run then returns ``({}, {})``), exact resume with
``resume_from_checkpoint=True``, the best parameters under
``best_model`` (`core.checkpoint.BestTracker`), ``profile_steps`` steps
under torch.profiler in ``<save_dir_root>/profile``.

Runs on one device, ``device="cuda"`` by default (it raises without a
card unless given ``device="cpu"``). The step's dropout bits come from the
train state's generator, the eval's Gumbel noise from a generator seeded
``seed + 1``.

The ranks of torchrun (or ``parallel.mesh.spawn``) form JAX's mesh
``{"data": -1, "model": tensor_parallel}`` (row-major: the model groups
are runs of tp consecutive ranks; a world that tp does not divide
raises). Along the model axis each rank holds its shard of the model
under JAX ``tiger_rules`` (the vocab head, the sem-id rows and the FFNs;
the vocabulary padded to a multiple of tp, as JAX's
``pad_vocab_to=tensor_parallel``); every rank starts from the same full
parameters, made from ``seed`` and sliced. Along the data axis each rank
keeps its block of every global batch (of each accumulation microbatch),
its dropout bits drawn for the whole batch, and the gradients are summed
over the data group, so the run computes what one process computes on
the global batch; the ranks report the same metrics. Each model shard
keeps its resume points (``checkpoints/p<model rank>`` under tp > 1),
written by its data rank 0, and writes ``best_model.rank<r>`` and
``final_model.rank<r>``.

``dataset="amazon"`` reads the review dump under
``<dataset_folder>/raw/<split>/`` and the RQ-VAE's sem-id artifact
(``sem_ids_path``, whose codebook size it takes; ``add_disambiguation``
appends the collision-resolving code). Not ported yet: wandb forwarding.
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
from genrec_tpu_torch.data.amazon import load_sequences
from genrec_tpu_torch.data.batching import pack_examples
from genrec_tpu_torch.data.sem_ids import dedup_sem_ids, load_sem_ids
from genrec_tpu_torch.data.tiger_seq import TigerSeqData, synthetic_tiger_data
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.tiger import Tiger, tiger_generate
from genrec_tpu_torch.ops.metrics import TopKAccumulator
from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
from genrec_tpu_torch.ops.trie import build_trie
from genrec_tpu_torch.parallel.mesh import (
    data_parallel,
    distributed_init,
    global_count,
)
from genrec_tpu_torch.trainers.evaluation import eval_batches
from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop

TORCHRUN = ("torchrun --standalone --nproc_per_node=2 -m genrec_tpu_torch.trainers."
            "tiger_trainer <config.gin> --gin 'train.tensor_parallel=2'")


def make_generate_fn(model, trie, temperature, n_candidates):
    """``gen(batch, generator) -> (B, K, D)`` sem-ids: sampled
    trie-constrained beam search, KV-cached."""

    def gen(batch, generator):
        model.eval()
        return tiger_generate(
            model, trie, batch["user_ids"], batch["item_input_ids"], batch["token_type_ids"],
            batch["seq_mask"], generator, temperature=temperature,
            n_top_k_candidates=n_candidates,
        ).sem_ids

    return gen


def evaluate(gen_fn, arrays, batch_size, device, generator, data_group=None) -> dict:
    """Recall@5/10 and NDCG@5/10 of the generated beams against the
    targets (the padded last batch's rows left out). With a
    ``data_group`` each rank generates for its rows of every batch, its
    sampling noise drawn for the whole batch (``parallel.mesh.draw_rows``),
    and the sums are added over the group."""
    acc = TopKAccumulator(ks=(5, 10))
    for batch, valid, _ in eval_batches(arrays, batch_size, data_group, device):
        with data_parallel(data_group, valid.shape[0]):
            top = gen_fn(batch, generator)
        acc.accumulate(batch["target_ids"][valid], top[valid])
    return acc.reduce(data_group)


def make_loss_fn(sem_id_dim: int, pack_sequences: bool, accum_steps: int = 1,
                 expected_per_micro: float | None = None):
    """``loss_fn(model, batch, generator) -> (loss, aux)``, the training
    forward with dropout from ``generator``. Packed: ``forward_packed``
    (aux: the real-token count); under accumulation each microbatch's
    loss is scaled by its valid-segment count over ``expected_per_micro``,
    so every example weighs the same in the averaged gradient. Unpacked:
    the padded forward."""
    if pack_sequences:
        def loss_fn(model, batch, generator):
            out = model.forward_packed(
                batch["item_input_ids"], batch["token_type_ids"], batch["user_token_ids"],
                batch["user_mask"], batch["segment_ids"], batch["positions"],
                batch["target_ids"], batch["segment_valid"], deterministic=False,
                generator=generator,
            )
            loss = out.loss
            if accum_steps > 1:
                count = global_count(batch["segment_valid"].sum().to(torch.float32))
                loss = loss * count / expected_per_micro
            return loss, {"real_tokens": out.real_tokens.to(torch.float32)}
    else:
        def loss_fn(model, batch, generator):
            B = batch["user_ids"].shape[0]
            types = torch.arange(sem_id_dim, device=batch["target_ids"].device)
            out = model(batch["user_ids"], batch["item_input_ids"], batch["token_type_ids"],
                        batch["target_ids"], types.expand(B, sem_id_dim), batch["seq_mask"],
                        deterministic=False, generator=generator)
            return out.loss, {}

    return loss_fn


@configlib.configurable
def train(
    epochs=100,
    batch_size=256,
    learning_rate=1e-4,
    num_warmup_steps=100,
    weight_decay=0.035,
    gradient_accumulate_every=1,
    embedding_dim=128,
    attn_dim=384,
    dropout=0.1,
    num_heads=6,
    n_layers=8,
    sem_id_dim=3,
    codebook_size=256,
    max_items=20,
    num_user_embeddings=10_000,
    dataset="synthetic",
    dataset_folder="dataset/amazon",
    split="beauty",
    num_users=500,
    sem_ids_path=None,
    add_disambiguation=False,
    tensor_parallel=1,
    pack_sequences=True,
    pack_max_segments=4,
    generate_temperature=0.2,
    do_eval=True,
    eval_every_epoch=10,
    eval_batch_size=64,
    test_on_best=True,
    save_dir_root="out/tiger",
    save_every_epoch=100,
    resume_from_checkpoint=False,
    wandb_logging=False,
    wandb_project="tiger_training",
    wandb_log_interval=100,
    amp=True,
    mixed_precision_type="bf16",
    profile_steps=0,
    seed=0,
    device="cuda",
):
    """Train TIGER; returns (valid metrics, test metrics) of the best
    parameters by valid Recall@10 (``test_on_best``) or of the last."""
    if tensor_parallel > 1 and int(os.environ.get("WORLD_SIZE", "1")) == 1 \
            and not torch.distributed.is_initialized():
        raise RuntimeError(f"tensor_parallel={tensor_parallel} runs one process per rank: "
                           f"{TORCHRUN}")
    # JAX's {"data": -1, "model": tp}: the world's ranks that tp leaves over
    # train data-parallel (a world that tp does not divide raises).
    mesh = distributed_init(device, {"data": -1, "model": tensor_parallel})
    rank = mesh.rank("model")
    tp_group, dgroup = mesh.group("model"), mesh.data
    dev = mesh.device or resolve_device(device)
    # Rank 0 writes the run's files; every rank logs to its own stdout.
    logger = setup_logger(save_dir_root if mesh.lead else None)
    tracker = Tracker(wandb_logging and mesh.lead, wandb_project,
                      save_dir=save_dir_root if mesh.lead else None, logger=logger)

    if dataset == "synthetic":
        data = synthetic_tiger_data(codebook_size=codebook_size, sem_id_dim=sem_id_dim,
                                    max_items=max_items, seed=seed, num_users=num_users)
    else:
        seqs, _, _ = load_sequences(dataset_folder, split)
        if sem_ids_path is None:
            raise ValueError("amazon dataset needs sem_ids_path (RQ-VAE artifact)")
        sem_ids, codebook_size = load_sem_ids(sem_ids_path)
        if add_disambiguation:
            # Optional 4th code resolving sem-id collisions (reference
            # amazon.py:323-353; off in its shipped configs).
            sem_ids = dedup_sem_ids(sem_ids, codebook_size)
        data = TigerSeqData(seqs, sem_ids, max_items=max_items,
                            user_hash_size=num_user_embeddings)
        sem_id_dim = data.D
    valid_arrays = data.eval_arrays("valid")
    test_arrays = data.eval_arrays("test")
    trie = build_trie(data.valid_item_sem_ids(), codebook_size, device=dev)

    pack_row_len = 1 + max_items * sem_id_dim  # user token + item stream
    repack, train_arrays = None, None
    if pack_sequences:
        examples = data.train_examples()

        def repack(epoch: int):
            return pack_examples(examples, row_len=pack_row_len, segment_keys=("target_ids",),
                                 max_segments=pack_max_segments, seed=(seed, epoch))
    else:
        train_arrays = data.train_arrays()

    # Each model shard keeps its own records, written by its data rank 0.
    ckpt = (CheckpointManager(os.path.join(save_dir_root, "checkpoints"),
                              per_host=tp_group is not None) if save_dir_root else None)
    prof = ProfileWindow(os.path.join(save_dir_root, "profile") if save_dir_root else "",
                         profile_steps)
    rows_per_step = batch_size * gradient_accumulate_every
    loop = PackedTrainLoop(
        logger=logger, tracker=tracker, device=dev, prof=prof, guard=PreemptionGuard(logger),
        ckpt=ckpt, rows_per_step=rows_per_step, row_len=pack_row_len, seed=seed,
        pack_sequences=pack_sequences, repack=repack, train_arrays=train_arrays,
        tokens_scale=float(gradient_accumulate_every), wandb_log_interval=wandb_log_interval,
        save_dir_root=save_dir_root, data_group=dgroup, accum_steps=gradient_accumulate_every,
    )
    pack_report = loop.pack_report

    compute_dtype = (torch.bfloat16 if (amp and mixed_precision_type == "bf16")
                     else torch.float32)
    model = Tiger(
        embedding_dim=embedding_dim, attn_dim=attn_dim, num_heads=num_heads,
        n_layers=n_layers, num_item_embeddings=codebook_size,
        num_user_embeddings=num_user_embeddings, sem_id_dim=sem_id_dim, dropout=dropout,
        pad_vocab_to=tensor_parallel, dtype=compute_dtype, device=dev, seed=seed,
        group=tp_group,
    )
    n_train_rows = (pack_report.n_rows if pack_sequences
                    else next(iter(train_arrays.values())).shape[0])
    total_steps = epochs * max(1, n_train_rows // rows_per_step)
    optimizer = Adam(cosine_schedule_with_warmup(learning_rate, num_warmup_steps, total_steps),
                     weight_decay=weight_decay)
    expected_per_micro = (batch_size * pack_report.n_examples / pack_report.n_rows
                          if pack_sequences else None)
    step_fn = make_train_step(
        make_loss_fn(sem_id_dim, pack_sequences, gradient_accumulate_every,
                     expected_per_micro),
        optimizer, accum_steps=gradient_accumulate_every, clip_norm=1.0, group=tp_group,
        data_group=dgroup,
    )
    state = TrainState.create(model, optimizer, seed)
    gen_fn = make_generate_fn(model, trie, generate_temperature, 10)
    eval_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    start_epoch, start_batch, global_step = 0, 0, 0
    if resume_from_checkpoint:
        # Step-granular exact resume through the integrity ladder.
        state, start_epoch, start_batch, global_step = loop.resume(state)
    suffix = "" if tp_group is None else f".rank{rank}"
    best = BestTracker(save_dir_root, name=f"best_model{suffix}")
    for epoch in range(start_epoch, epochs):
        res = loop.run_epoch(state, step_fn, epoch, global_step,
                             start_batch=start_batch if epoch == start_epoch else 0)
        state, global_step = res.state, res.global_step
        if res.preempted:
            # The loop wrote a durable resume point: exit cleanly so that the
            # scheduler restarts the run with resume_from_checkpoint.
            loop.shutdown(preempted_epoch=epoch)
            return {}, {}
        if do_eval and (epoch + 1) % eval_every_epoch == 0:
            m = evaluate(gen_fn, valid_arrays, eval_batch_size, dev, eval_gen, dgroup)
            logger.info(f"epoch {epoch} valid " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
            tracker.log({"epoch": epoch, **{f"eval/{k}": v for k, v in m.items()}})
            best.update(m["Recall@10"], model.state_dict())
        if ckpt is not None and (epoch + 1) % save_every_epoch == 0:
            # Epoch-boundary resume point: cursor = (next epoch, batch 0).
            loop.save(state, epoch=epoch + 1, next_batch=0, global_step=global_step)

    best_params = best.best_params(like=model.state_dict()) if test_on_best else None
    if best_params is not None:
        model.load_state_dict(best_params)
    valid_metrics = evaluate(gen_fn, valid_arrays, eval_batch_size, dev, eval_gen, dgroup)
    test_metrics = evaluate(gen_fn, test_arrays, eval_batch_size, dev, eval_gen, dgroup)
    logger.info("test " + ", ".join(f"{k}={v:.4f}" for k, v in test_metrics.items()))
    tracker.log({f"test/{k}": v for k, v in test_metrics.items()})
    if save_dir_root and best.value < 0:  # no eval ran: the final params
        save_params(os.path.join(save_dir_root, f"best_model{suffix}"), model.state_dict())
    if save_dir_root and tp_group is not None:
        save_params(os.path.join(save_dir_root, f"final_model{suffix}"), model.state_dict())
    loop.shutdown()
    return valid_metrics, test_metrics


if __name__ == "__main__":
    configlib.parse_config()
    train()
